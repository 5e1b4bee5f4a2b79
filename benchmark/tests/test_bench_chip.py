"""On the card: one short run of each cell through the command, as the
benchmark is run (``python -m pytest benchmark/tests -m chip``)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]


@pytest.mark.chip
@pytest.mark.parametrize("cell", [w["name"] for w in CELLS])
def test_a_short_run_is_correct(cuda_card, cell):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(2**31 + 3), "--seconds", "20", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
