"""Small statistics shared by the metric readers."""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional


def p95(values: Iterable[float]) -> Optional[float]:
    """The 95th percentile by nearest rank: the smallest value with at least
    95% of the sample at or under it (None for no sample)."""
    v = sorted(values)
    return v[math.ceil(0.95 * len(v)) - 1] if v else None


def stretch(record: Dict, what: str) -> Optional[Dict]:
    """The run's profiled stretch if it is of kind ``what``, else None."""
    st = record.get("stretch")
    return st if st is not None and st.get("what") == what else None


def kernel_ns(st: Dict, name: str) -> tuple:
    """``(total ns, launches)`` of the device operations whose name holds ``name``."""
    hits = [v for k, v in st["by_name"].items() if name in k]
    return sum(v["ns"] for v in hits), sum(v["count"] for v in hits)


def due_times(record: Dict, stamp: str) -> list:
    """Seconds from each request's due time to ``stamp``; a request that did
    not finish counts as the drain deadline (it missed every limit)."""
    out = []
    for r in record["requests"]:
        t = r.get(stamp) if r["ok"] else None
        out.append((t if t is not None else record["deadline"]) - r["t_due"])
    return out
