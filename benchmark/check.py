"""The comparison that decides ``correct``: each number read beside its limit.

The traffic generator's ``judge`` holds what the timed path produced against
``benchmark/reference`` and returns its numbers (a widest gap of a served
token's logit below the reference's best, a waveform's relative error) and
the count of what it compared. A run is correct when it compared something,
and every number the cell's ``limits`` name was read and lies at or under
its limit. Numbers the cell sets no limit on are read and printed, not
compared.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, Tuple


def decide(readings: Dict[str, float], limits: Dict[str, float],
           compared: int) -> Tuple[bool, Dict]:
    """``(correct, {name: {"value", "limit"}})`` over every limited number."""
    checks = {}
    ok = compared > 0 and bool(limits)
    for name, limit in limits.items():
        value = readings.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok, checks


def print_checks(checks: Dict, compared: int, readings: Dict[str, float]) -> None:
    """The numbers read but not compared, then the compared numbers beside
    their limits, as the last lines on stderr."""
    for name, value in readings.items():
        if name not in checks:
            print(f"reading {name}: {value!r} (not compared)", file=sys.stderr)
    print(f"check compared: {compared} utterances", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
