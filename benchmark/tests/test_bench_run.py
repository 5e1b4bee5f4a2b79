"""A whole run on the CPU at the tiny sizes: the result line's keys, the
refusals, and ``correct`` against the control and against planted faults."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

from conftest import ROOT, tiny_cell

from benchmark import check, run

B17, B06, SERVE = ("qwen3-tts-1.7b-int8.batch8", "qwen3-tts-0.6b-bf16.batch8",
                   "qwen3-tts-1.7b-int8.stream-open")
QUANT = {B17: "int8", B06: "none", SERVE: "int8"}
SEED = 2**31 + 77


#: windows long enough for a greedy and a sampled call to complete on the CPU
SECONDS = {B17: 4.0, B06: 4.0, SERVE: 2.0}


def _run(cell, trace=False, **kw):
    return run.run_cell(tiny_cell(cell, QUANT[cell]), SEED, SECONDS[cell], trace, "cpu",
                        time.time(), **kw)[0]


@pytest.mark.parametrize("cell", [B17, SERVE])
def test_result_line_has_the_contracts_keys(cell):
    r = _run(cell)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    names = set(tiny_cell(cell)["cell"]["end_to_end"])
    assert set(r["metrics"]) == names
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(r["checks"]) == set(tiny_cell(cell)["cell"]["limits"])
    json.dumps(r)


def test_traced_line_adds_the_breakdown():
    r = _run(B17, trace=True)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                       "checks"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", B17, "--seed", "1", "--seconds", "1"]) == 1
    assert capsys.readouterr().out == ""


def test_an_unknown_cell_gives_no_result(capsys):
    assert run.main(["--workload", "nope.batch8", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", B17, "--seed", "1",
                          "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_forbidden_modules_compare_whole_names(monkeypatch):
    for name in ("rho_tts_tpu_torch.models", "benchmark.run", "chipper", "benchmarks"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == []
    for name in ("rho_tts_tpu.models.qwen", "jaxlib.xla_client", "chip_smoke", "bench"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == ["bench", "chip_smoke", "jaxlib", "rho_tts_tpu"]


def test_decide_compares_only_limited_numbers():
    ok, checks = check.decide({"a": 0.1, "b": 9.0}, {"a": 0.2}, compared=3)
    assert ok and checks == {"a": {"value": 0.1, "limit": 0.2}}
    assert not check.decide({"a": 0.3}, {"a": 0.2}, 3)[0]
    assert not check.decide({"a": 0.1}, {"a": 0.2}, 0)[0]  # nothing compared
    assert not check.decide({}, {"a": 0.2}, 3)[0]  # not read
    assert not check.decide({"a": float("nan")}, {"a": 0.2}, 3)[0]
    assert not check.decide({"a": 0.1}, {}, 3)[0]  # no limit set


@pytest.mark.parametrize("cell", [B17, B06, SERVE])
def test_the_control_is_not_correct(cell):
    """The program one precision lower, the reference's vocoder in float8."""
    resolved = tiny_cell(cell, QUANT[cell])
    # the configurations' control precisions: int8 under bf16, int4 under int8
    resolved["config"]["control"] = {"quantization": "int8" if cell == B06 else "int4"}
    seconds = 9.0 if cell == B17 else SECONDS[cell]  # int4's plain path is slow on the CPU
    r = run.run_cell(resolved, SEED, seconds, False, "cpu", time.time(), control=True)[0]
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def _fault(monkeypatch, cell, what):
    from rho_tts_tpu_torch import serving
    from rho_tts_tpu_torch.models.qwen import model as qmodel

    module = serving if cell == SERVE else qmodel
    if what == "token":  # a primary code altered where it is sampled: the worst one
        sample = module._sample_with_noise
        monkeypatch.setattr(module, "_sample_with_noise",
                            lambda logits, *a, **k: sample(-logits, *a, **k))
    elif what == "residual":  # a residual code altered where it is predicted: the worst one
        predict = module._predict_residuals

        def worst(params, *a, **k):
            cp = dict(params["code_predictor"], w2=-params["code_predictor"]["w2"])
            return predict(dict(params, code_predictor=cp), *a, **k)

        monkeypatch.setattr(module, "_predict_residuals", worst)
    elif what == "waveform":  # the answer altered where it is vocoded
        vocode = qmodel._vocode_rows
        monkeypatch.setattr(qmodel, "_vocode_rows",
                            lambda *a, **k: (lambda w, c: (w * 0.5, c))(*vocode(*a, **k)))
    elif what == "piece":  # a streamed piece altered
        piece = serving.ServingEngine._stream_piece
        monkeypatch.setattr(serving.ServingEngine, "_stream_piece",
                            lambda self, w, *a: piece(self, w, *a) * 0.5)
    elif what == "half_batch":  # half of each call's rows left out
        synth = qmodel.QwenTTSModel.synthesize

        def half(self, texts, **k):
            waves, sr = synth(self, texts, **k)
            return waves[: len(waves) // 2], sr

        monkeypatch.setattr(qmodel.QwenTTSModel, "synthesize", half)


@pytest.mark.parametrize("cell, what", [
    (B17, "token"), (B17, "residual"), (B17, "waveform"), (B17, "half_batch"),
    (B06, "token"), (B06, "residual"),
    (SERVE, "token"), (SERVE, "residual"), (SERVE, "piece"),
])
def test_a_fault_makes_the_run_incorrect(monkeypatch, cell, what):
    _fault(monkeypatch, cell, what)
    r = _run(cell)
    assert r["correct"] is False, r["checks"]


def test_a_missing_hook_stops_the_run(monkeypatch):
    """The window hooks private names of the program; where one is renamed or
    re-signatured the run stops with the name rather than read the wrong thing."""
    import types as _types

    from rho_tts_tpu_torch.models.qwen import model as qmodel

    from benchmark import registry

    batch, stream = registry.load_generator("closed_batch"), registry.load_generator("open_stream")
    batch.hooks(qmodel)  # the program as it stands
    monkeypatch.setattr(qmodel, "_decode_chunk", lambda params, cfg, cache_k, cache_v, valid,
                        *rest: None)
    with pytest.raises(RuntimeError, match="key_valid"):
        batch.hooks(qmodel)
    monkeypatch.delattr(qmodel.QwenTTSModel, "_generate_codes_arrays")
    with pytest.raises(RuntimeError, match="_generate_codes_arrays"):
        batch.hooks(qmodel)
    engine = _types.SimpleNamespace(_dispatch=print, _key_valid=None, _active=None, ring=8,
                                    chunk=4)
    with pytest.raises(RuntimeError, match="_col"):
        stream.hooks(engine)
