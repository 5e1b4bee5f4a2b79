"""The output check's readings of one cell over many seeds, in one process.

    python3 benchmark/tools/readings.py --workload <cell> --seconds <s> --seeds 1 2 3 [--control]

Each seed is a whole run (set-up, a window of ``--seconds`` at the cell's own
load, the comparison with the reference); one JSON line a seed holds the
numbers the check compares. ``--control`` runs the control instead: the
program in the configuration's ``control`` quantization (the precision below
the one it states) with the reference's vocoder in float8 in the program's
place. The limits in the cell's file are set between the two (PERF.md).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", action="store_true")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from benchmark import registry, run

    if not torch.cuda.is_available():
        print("readings: a CUDA card is required", file=sys.stderr)
        return 1
    resolved = registry.resolve(args.workload)
    for seed in args.seeds:
        t = time.time()
        r, verdict, _host = run.run_cell(resolved, seed, args.seconds, False, "cuda", t,
                                  control=args.control)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "correct": r["correct"], "checks": r["checks"],
                          "readings": verdict["readings"],
                          "compared": verdict["compared"], "attempted": r["attempted"],
                          "failed": r["failed"], "metrics": r["metrics"],
                          "run_s": time.time() - t}), flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
