"""Sweep the offered rate of an ``open_stream`` cell, to find its knee.

    python3 benchmark/tools/knee.py --workload <cell> --seed <n> --seconds <s> --rates 3 5 7

One process, one model and one engine: for each rate, the cell's traffic at
that rate for ``--seconds``, then a drain until every request has finished.
One JSON line a rate: the queue wait, time to first audio and latency (p50
and p95 from the due time, as the cell's metrics take them), the queue wait
of the first and the last third of the arrivals, and how many requests were
still unfinished when the window closed. The knee is the highest rate whose
last third waits no longer than its first (no backlog growing through the
window); the cell offers a fixed share of it. No output is judged here.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _median(xs):
    return statistics.median(xs) if xs else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--rates", type=float, nargs="+", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from benchmark import registry
    from benchmark.stats import p95

    if not torch.cuda.is_available():
        print("knee: a CUDA card is required", file=sys.stderr)
        return 1
    resolved = registry.resolve(args.workload)
    generator = resolved["generator"]
    base = resolved["cell"]["traffic"]["params"]
    ctx = {"cell": resolved["cell"], "config": resolved["config"], "params": base,
           "seed": args.seed, "seconds": args.seconds, "trace": False, "device": "cuda"}
    state = generator.setup(ctx)
    try:
        for rate in args.rates:
            params = copy.deepcopy(base)
            params.update(rate=rate, drain_s=600)
            rctx = dict(ctx, params=params)
            t_close = time.time() + args.seconds
            record = generator.window(rctx, state)
            reqs = record["requests"]
            for r in reqs:
                r["client"].join(timeout=600)
            unfinished = sum(1 for r in reqs if r["client"].t_last is None
                             or r["client"].t_last > t_close)
            waits = [r["req"].t_admit - r["req"].t_submit for r in reqs]
            first = [r["client"].t_first - r["t_due"] for r in reqs]
            last = [r["client"].t_last - r["t_due"] for r in reqs]
            third = max(1, len(reqs) // 3)
            print(json.dumps({
                "rate": rate, "requests": len(reqs),
                "queue_wait_p50": _median(waits), "queue_wait_p95": p95(waits),
                "queue_wait_first_third": _median(waits[:third]),
                "queue_wait_last_third": _median(waits[-third:]),
                "first_audio_p50": _median(first), "first_audio_p95": p95(first),
                "latency_p50": _median(last), "latency_p95": p95(last),
                "unfinished_at_close": unfinished,
                "late_max_s": max(r["late_s"] for r in reqs),
                "frames_offered_per_s": sum(r["frames"] for r in reqs) / args.seconds,
                "counters_window": record["counters_window"]}), flush=True)
    finally:
        state["engine"].close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
