"""The metrics that read the program's spans (``benchmark/spans.py``),
against counts by hand on spans made up here, and in a whole traced run on
the CPU, where no device time exists."""

from __future__ import annotations

import sys
import time
import types

import pytest

from conftest import tiny_cell

from benchmark import registry, run
from benchmark.spans import RECORDER

B17 = "qwen3-tts-1.7b-int8.batch8"
NEW = ("decode.step_ms.window.batch", "decode.enqueue_share.batch", "prefill.ms.batch",
       "vocode.ms.batch", "setup.model_s", "setup.first_call_s")
RECORD = {"kind": "batch", "t0": 100.0, "seconds": 10.0,
          "calls": [{"t_end": 105.0}, {"t_end": 111.0}]}


def _span(name, start_s, host_ms, device_ms, call, profiled=False, parent=None, **attrs):
    start = int(start_s * 1e9)
    return {"name": name, "id": round(start_s * 10), "parent": parent, "call": call, "thread": 1,
            "start_ns": start, "end_ns": start + int(host_ms * 1e6), "host_ms": host_ms,
            "device_ms": device_ms, "profiled": profiled, "attrs": attrs}


SPANS = [
    # an earlier model of the same process, and its warm-up
    _span("qwen/model_init", 1.0, 900.0, 950.0, 1),
    _span("qwen/synthesize", 2.0, 800.0, 850.0, 2),
    # the run's model and warm-up call, a second call before the window
    _span("qwen/decode_chunk", 3.0, 100.0, 100.0, 2, profiled=True, steps=64),
    _span("qwen/model_init", 50.0, 2000.0, 2500.0, 3),
    _span("qwen/synthesize", 60.0, 3000.0, 3200.0, 4),
    _span("qwen/decode_chunk", 60.5, 1000.0, 6400.0, 4, steps=64),
    _span("qwen/synthesize", 70.0, 1000.0, 1100.0, 5),
    # the window: three calls, the second with a profiled chunk (its call
    # span marked profiled too)
    _span("qwen/prefill", 100.1, 5.0, 40.0, 10),
    _span("qwen/decode_chunk", 100.2, 1900.0, 1920.0, 10, steps=64),
    _span("qwen/decode_chunk", 102.2, 2048.0, 2048.0, 10, steps=64),
    _span("qwen/vocode", 104.5, 1.0, 30.0, 10),
    _span("qwen/vocode", 104.6, 1.0, 10.0, 10),
    _span("qwen/synthesize", 105.0, 5000.0, 5000.0, 20, profiled=True),
    _span("qwen/prefill", 105.1, 5.0, 50.0, 20, parent=1050),
    _span("qwen/decode_chunk", 105.2, 2304.0, 2560.0, 20, parent=1050, steps=64),
    _span("qwen/decode_chunk", 107.6, 1000.0, 1000.0, 20, profiled=True, parent=1050, steps=64),
    # after the profiler: left out
    _span("qwen/decode_chunk", 108.7, 1000.0, 1000.0, 20, parent=1050, steps=64),
    _span("qwen/vocode", 109.9, 1.0, 60.0, 20, parent=1050),
    _span("qwen/prefill", 110.1, 5.0, 100.0, 30),
    # after the window's last call
    _span("qwen/decode_chunk", 112.0, 10.0, 10.0, 40, steps=64),
]

#: by hand: chunk steps 30, 32, 40 ms; host / device 98.96, 100, 90 %;
#: prefill 40, 50; vocode 30 + 10; model_init max(2.0, 2.5) s; the first
#: call after it max(3.0, 3.2) s
EXPECTED = {"decode.step_ms.window.batch": 32.0, "decode.enqueue_share.batch": 1900 / 19.2,
            "prefill.ms.batch": 45.0, "vocode.ms.batch": 40.0, "setup.model_s": 2.5,
            "setup.first_call_s": 3.2}


def _program(monkeypatch, spans):
    mod = types.ModuleType(RECORDER)
    mod.spans = lambda: [dict(s) for s in spans]
    monkeypatch.setitem(sys.modules, RECORDER, mod)


@pytest.mark.parametrize("name", NEW)
def test_metric_counts_by_hand(monkeypatch, name):
    _program(monkeypatch, SPANS)
    assert registry.load_metric(name).read(RECORD) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_spans_reads_nothing(monkeypatch, name):
    metric = registry.load_metric(name)
    monkeypatch.setitem(sys.modules, RECORDER, types.ModuleType(RECORDER))  # no spans()
    assert metric.read(RECORD) is None
    monkeypatch.delitem(sys.modules, RECORDER)
    assert metric.read(RECORD) is None


@pytest.mark.parametrize("name", NEW)
def test_without_device_times_only_set_up_reads(monkeypatch, name):
    _program(monkeypatch, [dict(s, device_ms=None) for s in SPANS])
    value = registry.load_metric(name).read(RECORD)
    assert value == ({"setup.model_s": 2.0, "setup.first_call_s": 3.0}.get(name))


def test_a_traced_cpu_run_reads_set_up_and_no_device_time():
    # no cell lists these metrics yet: the run is given their readers
    resolved = tiny_cell(B17, "int8")
    resolved["per_layer"].update({n: registry.load_metric(n) for n in NEW})
    r = run.run_cell(resolved, 2**31 + 78, 4.0, True, "cpu", time.time())[0]
    assert r["correct"] is True
    got = {n for n in NEW if n in r["metrics"]}
    assert got == {"setup.model_s", "setup.first_call_s"}
    assert 0 < r["metrics"]["setup.model_s"]["value"] < r["metrics"]["setup.first_call_s"]["value"]
