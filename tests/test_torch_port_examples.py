"""The port's examples (``examples/torch/*.py``) run end to end on the CPU.

Each example's ``main(argv)`` takes ``--model-path`` (a preset, model id or
checkpoint; the 1.7B by default) and ``--device`` (``cuda`` by default);
here each runs on the ``tiny`` presets with ``--device cpu`` and random
weights, and the test checks what it returns: files written, audio of the
right kind, losses that fall. ``multi_chip_serving`` runs in a spawned
gloo world of 2 ranks (``test_torch_port_parallel_ranks.start_world``), as
under ``torchrun``: every rank gets the whole, equal result.
"""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_port_parallel_ranks import start_world

torch.set_num_threads(1)  # several test workers share the cores

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch"
CPU = ["--device", "cpu"]


def _load(name):
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_jax_example_has_a_port():
    jax_examples = {p.stem for p in EXAMPLES.parent.glob("*.py")}
    assert {p.stem for p in EXAMPLES.glob("*.py")} == jax_examples
    assert len(jax_examples) == 8
    for path in EXAMPLES.glob("*.py"):
        text = path.read_text()
        assert "def main(argv=None)" in text and '"--device", default="cuda"' in text


def test_basic_usage(tmp_path):
    results = _load("basic_usage").main(["--model-path", "tiny-CustomVoice", *CPU,
                                         "--out-dir", str(tmp_path)])
    assert (tmp_path / "output.wav").is_file()
    assert [os.path.basename(r.path) for r in results] == ["batch_output_0.wav",
                                                           "batch_output_1.wav"]


def test_custom_provider(tmp_path):
    from rho_tts_tpu_torch import TTSFactory

    saved = dict(TTSFactory._providers)
    try:
        result = _load("custom_provider").main([*CPU, "--out-dir", str(tmp_path)])
    finally:
        TTSFactory._providers = saved
    assert os.path.isfile(result.path) and result.segments_count >= 1
    assert result.duration_sec > 1.0  # two sentences of tone, crossfaded


def test_voice_cloning(tmp_path):
    from rho_tts_tpu_torch.audio_io import save_wav

    t = np.arange(12000) / 24000
    ref = tmp_path / "ref.wav"
    save_wav(str(ref), (0.3 * np.sin(2 * np.pi * 190 * t)).astype(np.float32), 24000)
    cb_result, qwen_result = _load("voice_cloning").main(
        ["--model-path", "tiny", "--chatterbox-implementation", "tiny", *CPU,
         "--reference-audio", str(ref), "--reference-text", "a reference line",
         "--out-dir", str(tmp_path)])
    assert os.path.isfile(cb_result.path) and os.path.isfile(qwen_result.path)


def test_continuous_serving():
    stats = _load("continuous_serving").main(["--model-path", "tiny", *CPU])
    assert stats["requests_done"] == 7


def test_chatterbox_serving():
    stats = _load("chatterbox_serving").main(["--model-path", "tiny", *CPU])
    assert stats["requests_done"] == 7


def test_export_and_serve(tmp_path):
    result, spec = _load("export_and_serve").main(
        ["--model-path", "tiny-CustomVoice", "--draft-model-path", "draft", *CPU,
         "--workdir", str(tmp_path)])
    assert (tmp_path / "qwen-int8").is_dir() and os.path.isfile(result.path)
    assert isinstance(spec.audio, torch.Tensor) and spec.audio.numel() > 0


def test_lora_voice_adaptation():
    losses, wave = _load("lora_voice_adaptation").main(["--model-path", "tiny", *CPU])
    assert len(losses) == 20 and losses[-1] < losses[0]
    assert wave.dtype == torch.float32 and wave.ndim == 1 and bool(torch.isfinite(wave).all())


def multi_chip_rank(rank, n, path):
    """One rank of ``multi_chip_serving.main`` (its process group is up)."""
    spec = importlib.util.spec_from_file_location("torch_example_multi_chip_serving", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    results, one = mod.main(["--model-path", "tiny-CustomVoice", *CPU])
    return {"dp": [r.numpy() for r in results], "tp": one.numpy()}


def test_multi_chip_serving_in_a_world_of_two(tmp_path):
    out = start_world(tmp_path, 2, multi_chip_rank, str(EXAMPLES / "multi_chip_serving.py"),
                      timeout=240).join()
    assert len(out[0]["dp"]) == 4
    for key in ("dp", "tp"):
        a, b = out[0][key], out[1][key]
        a, b = (a, b) if key == "dp" else ([a], [b])
        for x, y in zip(a, b):
            assert x.size > 0 and np.isfinite(x).all()
            np.testing.assert_array_equal(x, y)
