"""The port's profiler traces: ``utils.profiling.start_trace`` / ``stop_trace``.

The JAX package's ``start_trace(log_dir=None) -> bool`` / ``stop_trace()``
on ``torch.profiler``: the directory comes from the argument or
``RHO_TTS_TPU_TRACE_DIR``; ``False`` comes back with no directory or with a
trace already active, as in the JAX package; ``stop_trace`` writes one
``*.pt.trace.json`` (TensorBoard's profiler plugin format), and does
nothing without a trace. On the CPU the trace records CPU activity; the
card's kernels are held in a written trace by phase 14 c of
``chip_smoke.py``.
"""

import glob
import json
import os
from unittest.mock import patch

import pytest
import torch

from rho_tts_tpu.utils import profiling as jprofiling
from rho_tts_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _no_trace_left(monkeypatch):
    monkeypatch.delenv(profiling.TRACE_DIR_ENV, raising=False)
    yield
    profiling.stop_trace()
    assert profiling._trace is None


def _traces(d):
    return glob.glob(os.path.join(str(d), "*.pt.trace.json"))


def _work():
    with profiling.stage("port-trace-stage"):
        x = torch.randn(64, 64)
        return (x @ x).sum()


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


def test_no_directory_returns_false_as_in_jax(tmp_path):
    assert profiling.start_trace() is False
    assert profiling.start_trace("") is False
    assert jprofiling.start_trace() is False
    assert profiling._trace is None


def test_stop_without_a_trace_does_nothing(tmp_path):
    profiling.stop_trace()
    profiling.stop_trace()
    jprofiling.stop_trace()
    assert profiling._trace is None and not os.listdir(tmp_path)


def test_a_trace_can_follow_another(tmp_path):
    for i in range(2):
        assert profiling.start_trace(str(tmp_path / str(i))) is True
        _work()
        profiling.stop_trace()
        assert len(_traces(tmp_path / str(i))) == 1


def test_a_profiler_that_cannot_start_returns_false(tmp_path):
    with patch.object(torch.profiler, "profile", side_effect=RuntimeError("busy")):
        assert profiling.start_trace(str(tmp_path)) is False
    assert profiling._trace is None
    assert profiling.start_trace(str(tmp_path)) is True


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
