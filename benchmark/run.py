"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout that holds the program under ``src/``
(the PyTorch port, ``rho_tts_tpu_torch``) on a machine with at least as
many CUDA cards as the cell asks for. The cell, its configuration, its
traffic generator and its metrics are files found by name (``registry.py``).
The run builds the model from weights drawn from ``--seed``, warms up the
cell's shapes (``setup_s``: from the process's start to the window's), runs
the window, reads the peak memory, frees the program, holds what the window
produced against the plain reference (``reference/``), and prints one JSON
line last on stdout: the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics, read from one profiled stretch, the run's counters and
its request stamps. It exits non-zero with no result without the cards,
with a cell whose files do not resolve, or when the JAX package, JAX or a
bring-up script was imported.
"""

from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level modules that no run may load: JAX, the JAX package, the bring-up scripts
FORBIDDEN = ("jax", "jaxlib", "flax", "rho_tts_tpu", "bench")
FORBIDDEN_PREFIX = "chip_"


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``rho_tts_tpu_torch`` is not ``rho_tts_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN or t.startswith(FORBIDDEN_PREFIX))


def run_cell(resolved: dict, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, control: bool = False):
    """One run: set-up, window, peak memory, the check, the metrics.
    Returns the result line's object, the check's verdict (its readings) and
    the host's readings over the window (``host.py``).

    ``control`` builds the program in the configuration's control
    quantization and judges the reference's float8 vocoder in the program's
    place: the control of the output check (``tools/readings.py --control``).
    """
    import torch

    from benchmark import check, host
    from benchmark import trace as trace_lib

    cell, cfg, generator = resolved["cell"], resolved["config"], resolved["generator"]
    ctx = {"cell": cell, "config": cfg, "params": cell["traffic"]["params"], "seed": int(seed),
           "seconds": float(seconds), "trace": bool(trace), "device": device,
           "control": control}
    cuda = torch.device(device).type == "cuda"
    state = generator.setup(ctx)
    before = host.snapshot()
    record = generator.window(ctx, state)
    host_readings = host.report(before, host.snapshot(), time.time() - record["t0"])
    if record.get("calls"):
        host_readings["calls_s"] = [round(c["t_end"] - c["t_start"], 4) for c in record["calls"]]
    record["setup_s"] = record["t0"] - t_start
    mem = torch.cuda.max_memory_allocated() if cuda else 0
    verdict = generator.judge(ctx, state, record)
    correct, checks = check.decide(verdict["readings"], cell["limits"], verdict["compared"])
    readers = resolved["per_layer"] if trace else resolved["end_to_end"]
    metrics = {}
    for name, mod in readers.items():
        value = mod.read(record)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": mod.UNIT}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(mem)}
    if cuda:
        dev["power_limit"] = _power_limit()
    result = {"correct": bool(correct), "attempted": int(verdict["attempted"]),
              "failed": int(verdict["failed"]), "metrics": metrics, "device": dev}
    stretch = record.get("stretch")
    if trace and stretch is not None:
        dev["busy_s"] = stretch["busy_ns"] / 1e9
        dev["window_s"] = stretch["window_ns"] / 1e9
        result["breakdown"] = trace_lib.breakdown(stretch)
    result["checks"] = checks
    return result, verdict, host_readings


def _power_limit() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="one run of one benchmark cell")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from benchmark import check, registry

    try:
        resolved = registry.resolve(args.workload)
    except registry.CellError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch

    chips = int(resolved["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: cell {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "rho_tts_tpu_torch").is_dir():
        print(f"benchmark: the program is not at {src}/rho_tts_tpu_torch", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    os.environ.setdefault("USE_FLAX", "0")
    try:
        result, verdict, host_readings = run_cell(resolved, args.seed, args.seconds,
                                                  bool(args.trace), "cuda", T_PROCESS)
    except Exception:  # noqa: BLE001 — the run failed: say why, print no result
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules were imported: {found}", file=sys.stderr)
        return 3
    print(f"host: {json.dumps(host_readings)}", file=sys.stderr)
    check.print_checks(result["checks"], verdict["compared"], verdict["readings"])
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
