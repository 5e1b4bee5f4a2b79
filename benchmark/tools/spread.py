"""Spread of each end-to-end metric over sets of runs, and the bound it suggests.

    python3 benchmark/tools/spread.py --set A a1.out a2.out ... --set B b1.out ...

Each file holds one run's standard output (its last JSON line is read). For
each metric and set: the median and the spread, the distance between the
first and third quartiles (``statistics.quantiles(values, n=4)``) as a share
of the median; then the wider of the sets' spreads and five times it, the
bound it suggests (at least 1%, at most 25%); and the spread a check reads
for tightness, the mean over the sets of each set's spread without its run
farthest from the median, which has to stay under half the bound.
``setup_s`` leaves out each set's first run, which may have compiled the
kernels.
"""

from __future__ import annotations

import argparse
import json
import statistics


def last_line(path: str) -> dict:
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


def spread(values) -> float:
    q1, _q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed_spread(values) -> float:
    """The spread without the value farthest from the median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread([v for i, v in enumerate(values) if i != far])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--set", nargs="+", action="append", required=True,
                        metavar=("NAME", "FILE"))
    args = parser.parse_args(argv)
    sets = {s[0]: [last_line(p) for p in s[1:]] for s in args.set}
    names = sorted({m for runs in sets.values() for r in runs for m in r["metrics"]})
    report = {}
    for name in names:
        per_set = {}
        for label, runs in sets.items():
            values = [r["metrics"][name]["value"] for r in runs if name in r["metrics"]]
            if name == "setup_s":
                values = values[1:]
            if len(values) >= 2:
                per_set[label] = {"n": len(values), "median": statistics.median(values),
                                  "spread": spread(values), "values": values}
                if len(values) >= 3:
                    per_set[label]["trimmed_spread"] = trimmed_spread(values)
        widest = max(s["spread"] for s in per_set.values())
        trimmed = [s["trimmed_spread"] for s in per_set.values() if "trimmed_spread" in s]
        report[name] = {"sets": per_set, "widest_spread": widest,
                        "bound_5x": min(max(5 * widest, 0.01), 0.25),
                        "mean_trimmed_spread": statistics.mean(trimmed) if trimmed else None}
    report["correct"] = {label: [r["correct"] for r in runs] for label, runs in sets.items()}
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
