"""The port's spans, profiler ranges and traces (``utils.profiling``).

Spans: ``stage`` records nested spans (ids, parents, one ``call`` id under
each outermost span) into a bounded buffer that ``summary`` totals; device
time only from timing events that have completed, and none while a stream
captures; ``region`` opens no ``record_function`` without a profiler, and
under one the decode chunk's ranges appear in the trace, on the spans'
clock. Traces: ``start_trace`` / ``stop_trace``.

The JAX package's ``start_trace(log_dir=None) -> bool`` / ``stop_trace()``
on ``torch.profiler``: the directory comes from the argument or
``RHO_TTS_TPU_TRACE_DIR``; ``False`` comes back with no directory or with a
trace already active, as in the JAX package; ``stop_trace`` writes one
``*.pt.trace.json`` (TensorBoard's profiler plugin format), and does
nothing without a trace. On the CPU the trace records CPU activity; the
card's kernels are held in a written trace by phase 14 c of
``chip_smoke.py``. The profiler is off after every test, also after a stop
that failed: left on, it records every later op of the test worker.

Each test runs on a thread of its own under ``within`` of
``test_torch_port_parallel_ranks`` (:func:`on_one_thread`) and fails after
``WAIT_S``: torch's profiler session belongs to the thread that started it,
so the test's stop, and the check that the profiler is off, run there too.
"""

import functools
import glob
import json
import os
from unittest.mock import patch

import pytest
import torch

from rho_tts_tpu.utils import profiling as jprofiling
from rho_tts_tpu_torch.models.qwen import PRESETS, QwenTTSModel
from rho_tts_tpu_torch.models.qwen import model as qmodel
from rho_tts_tpu_torch.utils import profiling
from test_torch_port_parallel_ranks import within

torch.set_num_threads(1)  # several test workers share the cores

WAIT_S = 60


def _profiler_on():
    return torch.autograd.profiler._is_profiler_enabled or torch._C._autograd._profiler_enabled()


def on_one_thread(test):
    """Run ``test``, then ``stop_trace``, on one thread under ``within``; fail
    if the profiler is still on there (turned off first, as a later test
    would otherwise run under it)."""
    @functools.wraps(test)
    def run(*args, **kwargs):
        def body():
            try:
                return test(*args, **kwargs)
            finally:
                profiling.stop_trace()
                if _profiler_on():
                    torch.autograd._disable_profiler()
                    torch.autograd.profiler._set_is_profiler_enabled(False)
                    pytest.fail("the test left the autograd profiler on")

        return within(body, WAIT_S)

    return run


@pytest.fixture(autouse=True)
def _no_trace_left(monkeypatch):
    monkeypatch.delenv(profiling.TRACE_DIR_ENV, raising=False)
    yield
    assert profiling._trace is None and not _profiler_on()


def _traces(d):
    return glob.glob(os.path.join(str(d), "*.pt.trace.json"))


def _work():
    with profiling.stage("port-trace-stage"):
        x = torch.randn(64, 64)
        return (x @ x).sum()


@on_one_thread
def test_trace_written_to_the_given_directory(tmp_path):
    d = tmp_path / "trace"
    assert profiling.start_trace(str(d)) is True
    assert profiling.start_trace(str(d)) is False  # one trace at a time, as in JAX
    _work()
    profiling.stop_trace()
    files = _traces(d)
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "port-trace-stage" in names and "aten::mm" in names
    assert profiling.summary()["port-trace-stage"]["calls"] >= 1


@on_one_thread
def test_trace_directory_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("RHO_TTS_TPU_TRACE_DIR", str(tmp_path / "env"))
    assert profiling.TRACE_DIR_ENV == "RHO_TTS_TPU_TRACE_DIR"
    assert profiling.start_trace() is True
    _work()
    profiling.stop_trace()
    assert len(_traces(tmp_path / "env")) == 1
    # the argument wins over the environment
    assert profiling.start_trace(str(tmp_path / "arg")) is True
    profiling.stop_trace()
    assert len(_traces(tmp_path / "arg")) == 1 and len(_traces(tmp_path / "env")) == 1


@on_one_thread
def test_no_directory_returns_false_as_in_jax(tmp_path):
    assert profiling.start_trace() is False
    assert profiling.start_trace("") is False
    assert jprofiling.start_trace() is False
    assert profiling._trace is None


@on_one_thread
def test_stop_without_a_trace_does_nothing(tmp_path):
    profiling.stop_trace()
    profiling.stop_trace()
    jprofiling.stop_trace()
    assert profiling._trace is None and not os.listdir(tmp_path)


@on_one_thread
def test_a_trace_can_follow_another(tmp_path):
    for i in range(2):
        assert profiling.start_trace(str(tmp_path / str(i))) is True
        _work()
        profiling.stop_trace()
        assert len(_traces(tmp_path / str(i))) == 1


@on_one_thread
def test_a_profiler_that_cannot_start_returns_false(tmp_path):
    with patch.object(torch.profiler, "profile", side_effect=RuntimeError("busy")):
        assert profiling.start_trace(str(tmp_path)) is False
    assert profiling._trace is None
    assert profiling.start_trace(str(tmp_path)) is True


@on_one_thread
def test_cuda_activity_only_with_a_device(tmp_path):
    seen = {}
    real = torch.profiler.profile

    def spy(*args, **kwargs):
        seen["activities"] = kwargs["activities"]
        return real(*args, **kwargs)

    with patch.object(torch.profiler, "profile", side_effect=spy), \
            patch.object(torch.cuda, "is_available", return_value=False):
        assert profiling.start_trace(str(tmp_path)) is True
    profiling.stop_trace()
    assert seen["activities"] == [torch.profiler.ProfilerActivity.CPU]
    with patch.object(torch.profiler, "profile", side_effect=spy), \
            patch.object(torch.cuda, "is_available", return_value=True):
        prof_started = profiling.start_trace(str(tmp_path / "cuda"))
    assert seen["activities"] == [torch.profiler.ProfilerActivity.CPU,
                                  torch.profiler.ProfilerActivity.CUDA]
    if prof_started:
        profiling.stop_trace()


@on_one_thread
def test_a_failed_stop_leaves_the_profiler_off(tmp_path):
    """A session whose stop raises (torch synchronizes its device first) is
    turned off all the same: left on, it recorded every later op of the
    process, each with a failed device event, and a test worker that ran
    this file took minutes for its next file's milliseconds of work."""
    with patch.object(torch.cuda, "is_available", return_value=True):
        assert profiling.start_trace(str(tmp_path)) is True
    _work()
    with patch.object(torch.cuda, "synchronize", side_effect=RuntimeError("device lost")):
        profiling.stop_trace()
    assert profiling._trace is None
    assert not _profiler_on()
    assert profiling.start_trace(str(tmp_path / "next")) is True  # a new session starts
    _work()
    profiling.stop_trace()
    assert len(_traces(tmp_path / "next")) == 1


# ---------------------------------------------------------------------------
# Spans and ranges
# ---------------------------------------------------------------------------


def _span(name):
    return next(s for s in profiling.spans() if s["name"] == name)


def test_spans_nest_with_their_parents_and_one_call_id():
    profiling.reset()
    with profiling.stage("outer", rows=2) as attrs:
        with profiling.stage("mid"):
            with profiling.stage("inner"):
                pass
        with profiling.stage("sibling"):
            pass
        attrs["frames"] = 7
    with profiling.stage("next"):
        pass
    outer, mid, inner, sibling, nxt = (_span(n) for n in ("outer", "mid", "inner", "sibling",
                                                          "next"))
    assert outer["parent"] is None and outer["call"] == outer["id"]
    assert mid["parent"] == outer["id"] and inner["parent"] == mid["id"]
    assert sibling["parent"] == outer["id"]
    assert {mid["call"], inner["call"], sibling["call"]} == {outer["id"]}
    assert nxt["parent"] is None and nxt["call"] == nxt["id"] != outer["id"]
    assert outer["attrs"] == {"rows": 2, "frames": 7}
    assert outer["start_ns"] <= mid["start_ns"] <= inner["start_ns"] <= inner["end_ns"] \
        <= mid["end_ns"] <= sibling["start_ns"] <= sibling["end_ns"] <= outer["end_ns"]
    assert all(s["device_ms"] is None and not s["profiled"] for s in profiling.spans())
    assert len({outer["thread"], nxt["thread"]}) == 1


def test_a_span_is_kept_when_its_body_raises():
    profiling.reset()
    with pytest.raises(ValueError):
        with profiling.stage("fails"):
            raise ValueError("x")
    with profiling.stage("after"):
        pass
    assert _span("fails")["end_ns"] >= _span("fails")["start_ns"]
    assert _span("after")["parent"] is None  # the failed span left the stack


def test_the_buffer_drops_its_oldest_spans_and_counts_them(monkeypatch):
    profiling.reset()
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    for i in range(5):
        with profiling.stage(f"s{i}"):
            pass
    assert [s["name"] for s in profiling.spans()] == ["s2", "s3", "s4"]
    assert profiling.dropped() == 2
    profiling.reset()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_summary_is_computed_from_the_spans():
    profiling.reset()
    for _ in range(3):
        _work()
    spans = [s for s in profiling.spans() if s["name"] == "port-trace-stage"]
    summary = profiling.summary()["port-trace-stage"]
    assert summary["calls"] == 3 == len(spans)
    assert summary["seconds"] == pytest.approx(sum(s["host_ms"] for s in spans) / 1e3)
    assert "device_seconds" not in summary  # no CUDA context: no events


class _FakeEvent:
    """A timing event whose completion the test decides."""

    done = False
    made = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.recorded = False
        _FakeEvent.made.append(self)

    def record(self):
        self.recorded = True

    def query(self):
        return _FakeEvent.done

    def elapsed_time(self, end):
        assert _FakeEvent.done, "read before completion"
        return 2.5


def test_device_time_is_read_only_once_the_end_event_completes(monkeypatch):
    profiling.reset()
    _FakeEvent.done, _FakeEvent.made = False, []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: pytest.fail("the recorder synchronised"))
    with profiling.stage("on-card"):
        pass
    assert len(_FakeEvent.made) == 2 and all(e.recorded for e in _FakeEvent.made)
    assert _span("on-card")["device_ms"] is None  # not complete: not read
    _FakeEvent.done = True
    assert _span("on-card")["device_ms"] == 2.5
    assert profiling.summary()["on-card"]["device_seconds"] == pytest.approx(0.0025)


def test_no_event_is_recorded_while_the_stream_captures(monkeypatch):
    profiling.reset()
    _FakeEvent.done, _FakeEvent.made = True, []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    with profiling.stage("captured"):
        pass
    assert _FakeEvent.made == [] and _span("captured")["device_ms"] is None


def _tiny_int8():
    return QwenTTSModel(PRESETS["tiny"], device="cpu", quantization="int8")


def test_a_synthesize_call_records_its_stages_as_one_call(monkeypatch):
    monkeypatch.setenv("RHO_TTS_TPU_DECODE_CHUNK", "8")
    profiling.reset()
    m = _tiny_int8()
    m.synthesize(["hello", "a second row"], min_frames=20, max_frames=20, seeds=[0, 1])
    spans = profiling.spans()
    assert [s["name"] for s in spans if s["parent"] is None] == ["qwen/model_init",
                                                                "qwen/synthesize"]
    call = _span("qwen/synthesize")
    assert call["attrs"] == {"rows": 2, "frames": 25}  # 3 chunks of 8, and frame 0
    inner = [s for s in spans if s["call"] == call["id"] and s["id"] != call["id"]]
    names = [s["name"] for s in inner]
    assert names[:2] == ["qwen/prompt_build", "qwen/prefill"]
    assert names.count("qwen/decode_chunk") == 3 and names.count("qwen/done_check") == 2
    assert {"qwen/fetch_done", "qwen/vocode"} <= set(names)
    assert all(s["parent"] == call["id"] for s in inner)
    assert all(s["attrs"] == {"steps": 8, "graph": "eager"}
               for s in inner if s["name"] == "qwen/decode_chunk")
    profiling.reset()
    m.generate_codes(["hello"], min_frames=8, max_frames=8, seeds=[0])
    call = _span("qwen/generate_codes")
    assert call["attrs"] == {"rows": 1, "frames": 9}
    assert _span("qwen/fetch_codes")["parent"] == call["id"]


def test_cpu_decode_chunks_run_eagerly_and_their_spans_say_so(monkeypatch):
    """On the CPU the decode step is never captured: every ``qwen/decode_chunk``
    span, of a batch call and of a stream, carries ``graph="eager"``, the
    graph counters stay 0 and the model keeps no graph, nor an arena."""
    monkeypatch.setenv("RHO_TTS_TPU_DECODE_CHUNK", "8")
    profiling.reset()
    m = _tiny_int8()
    m.generate_codes(["hello"], min_frames=16, max_frames=16, seeds=[0])
    assert len(list(m.stream_chunks("hello", min_frames=16, max_frames=16, seed=0,
                                    context_frames=4))) >= 2
    chunks = [s for s in profiling.spans() if s["name"] == "qwen/decode_chunk"]
    assert len(chunks) == 4
    assert all(s["attrs"] == {"steps": 8, "graph": "eager"} for s in chunks)
    assert qmodel.graph_captures == qmodel.graph_replays == 0
    assert not m._step_graphs._graphs and m._step_graphs._arena is None
    assert not profiling.profiler_active()


def test_fine_ranges_open_no_record_function_without_a_profiler(monkeypatch):
    """The ranges inside the decode chunk cost a flag read without a profiler."""
    real = qmodel._decode_chunk

    def no_range(*args, **kwargs):
        raise AssertionError("a range opened")

    def guarded(*args, **kwargs):
        with patch.object(torch.profiler, "record_function", no_range), \
                patch.object(torch.autograd.profiler, "record_function", no_range), \
                patch.object(torch._C._profiler, "_RecordFunctionFast", no_range):
            return real(*args, **kwargs)

    monkeypatch.setattr(qmodel, "_decode_chunk", guarded)
    monkeypatch.setenv("RHO_TTS_TPU_DECODE_CHUNK", "4")
    _tiny_int8().generate_codes(["hello"], min_frames=4, max_frames=4, seeds=[0])
    with patch.object(torch._C._profiler, "_RecordFunctionFast", no_range):
        with profiling.region("talker/mlp"):
            pass


def _profiled_chunk(monkeypatch):
    """One tiny int8 decode chunk under a CPU profiler, as a benchmark traces
    one: the profiler starts inside the ``qwen/decode_chunk`` span."""
    real, box = qmodel._decode_chunk, {}

    def traced(*args, **kwargs):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            out = real(*args, **kwargs)
        box["events"] = prof.profiler.kineto_results.events()
        return out

    monkeypatch.setattr(qmodel, "_decode_chunk", traced)
    monkeypatch.setenv("RHO_TTS_TPU_DECODE_CHUNK", "4")
    profiling.reset()
    _tiny_int8().generate_codes(["hello"], min_frames=4, max_frames=4, seeds=[0])
    return box["events"]


@on_one_thread
def test_a_profiled_decode_chunk_holds_the_fine_ranges(monkeypatch):
    names = {e.name() for e in _profiled_chunk(monkeypatch)}
    assert {"qwen/chunk_prologue", "qwen/step", "qwen/embed", "talker/attention",
            "talker/mlp", "quant/int8_matmul", "qwen/sample", "qwen/residuals"} <= names
    # the chunk's span (opened before the profiler started) and its call are
    # marked profiled; the prefill's is not
    assert _span("qwen/decode_chunk")["profiled"] and _span("qwen/generate_codes")["profiled"]
    assert not _span("qwen/prefill")["profiled"]


@on_one_thread
def test_span_stamps_agree_with_their_ranges_in_the_profile():
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            _work()
    ranges = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "port-trace-stage"), key=lambda e: e.start_ns())
    spans = [s for s in profiling.spans() if s["name"] == "port-trace-stage"]
    assert len(ranges) == len(spans) == 3 and all(s["profiled"] for s in spans)
    for e, s in zip(ranges, spans):
        assert abs(e.start_ns() - s["start_ns"]) < 1e6
        assert abs(e.start_ns() + e.duration_ns() - s["end_ns"]) < 1e6


def test_the_benchmark_still_hooks_the_model():
    """The batch cells' traffic wraps ``QwenTTSModel._generate_codes_arrays``
    and the module's ``_decode_chunk(..., key_valid=, steps=)``."""
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark import registry

    registry.load_generator("closed_batch").hooks(qmodel)
