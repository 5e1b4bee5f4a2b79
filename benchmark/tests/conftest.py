"""Shared set-up of the benchmark's own tests.

They run on the CPU (``python -m pytest benchmark/tests``), the program's
plain PyTorch paths standing in for its kernels, at the ``tiny`` sizes
below. Tests that need a CUDA card carry the ``chip`` marker and take the
``cuda_card`` fixture, which skips them where there is none; run them on the
card with ``python -m pytest benchmark/tests -m chip``.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

torch.set_num_threads(1)  # several test workers may share the cores

#: a small configuration: two layers at a width where the heads' logits
#: spread as at the published sizes, and the program's ``tiny`` codec
TINY = {
    "name": "tiny", "source": "tests", "reduced": [], "quantization": "int8", "dtype": "bfloat16",
    "talker": {"hidden": 1024, "layers": 2, "q_heads": 8, "kv_heads": 4, "head_dim": 128,
               "ffn": 2048, "rope_theta": 1000000.0, "rms_eps": 1e-06},
    "text_vocab": 512, "n_speakers": 16, "code_predictor_hidden": 1024,
    "codec": {"sample_rate": 24000, "upsample_rates": [4, 2], "n_codebooks": 2,
              "codebook_size": 64, "codebook_dim": 32, "decoder_channels": [32, 16, 8],
              "encoder_channels": [8, 16, 32], "resblock_dilations": [1, 3, 9]},
    "control": {"quantization": "int4", "vocoder": "float8_e4m3"},
}

#: CPU-sized traffic for each generator
TINY_TRAFFIC = {
    "closed_batch": {"batch": 2, "frames": 64, "chars": [20, 40]},
    "open_stream": {"rate": 4.0, "median_frames": 80, "min_frames": 64, "max_frames": 192,
                    "chars": [10, 30], "warmup": 2, "drain_s": 30,
                    "judge": {"greedy": 1, "sampled": 1}},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skipped without one")


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m chip)")
    return torch.device("cuda")


#: cells the tests drive that BENCHMARK.json does not hold: the streaming
#: server, whose traffic generator and metrics are kept for a later cell
#: (PERF.md, Open questions)
TEST_CELLS = Path(__file__).resolve().parent / "cells"


def stored_cell(name: str) -> dict:
    """A test-only cell, resolved as ``registry.resolve`` resolves a cell."""
    import json

    from benchmark import registry

    cell = json.loads((TEST_CELLS / f"{name}.json").read_text())
    return {"cell": cell, "config": registry.load_config(cell["config"]),
            "generator": registry.load_generator(cell["traffic"]["generator"]),
            "end_to_end": {m: registry.load_metric(m) for m in cell["end_to_end"]},
            "per_layer": {m: registry.load_metric(m) for m in cell["per_layer"]}}


def tiny_cell(name: str, quantization: str = "int8"):
    """The cell ``name`` as ``registry.resolve`` gives it (or a test-only
    cell), on the tiny configuration and CPU-sized traffic, with the cell's
    own limits."""
    from benchmark import registry

    is_test = (TEST_CELLS / f"{name}.json").is_file()
    resolved = stored_cell(name) if is_test else registry.resolve(name)
    cell = copy.deepcopy(resolved["cell"])
    params = cell["traffic"]["params"]
    params.update(TINY_TRAFFIC[cell["traffic"]["generator"]])
    if "engine" in params:
        params["engine"].update(n_slots=4, max_frames=192)
    resolved["cell"] = cell
    resolved["config"] = dict(TINY, quantization=quantization)
    return resolved
