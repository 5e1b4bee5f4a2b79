"""The program's own spans (``rho_tts_tpu_torch.utils.profiling``), for the
metrics that read them.

The spans are taken from the program's recorder as the run left it in
``sys.modules``: nothing is imported here, so a run of a program that
records no spans (or has no ``spans()``) reads nothing, and those metrics
report nothing. Host stamps are ``time.time_ns()`` nanoseconds, the clock
of ``record["t0"]``. Spans that ended before ``t0`` belong to set-up.

The window's spans leave out those a profiler saw (``profiled``), as the
profiler slows what it watches, and every span that ended after the
profiler started: in a traced run the calls after the profiled chunk ran
20-70% slower than the one before it (``PERF.md``, Open questions). So a
traced run's window reads the chunks, prefills and vocodes that ran before
its profiled chunk. In a batch cell that chunk is the second call's second,
so at 192 frames in chunks of 64 the window holds 4 decode chunks, 2
prefills and 1 call's vocode: about one call of the window's, not all of
them.
"""

from __future__ import annotations

import statistics
import sys
from collections import defaultdict
from typing import Dict, List, Optional

RECORDER = "rho_tts_tpu_torch.utils.profiling"


def recorded() -> Optional[List[Dict]]:
    """Every span the program holds, or None where it records none."""
    read = getattr(sys.modules.get(RECORDER), "spans", None)
    return None if read is None else read()


def window(record: Dict, name: str) -> List[Dict]:
    """The window's spans named ``name`` that ran without a profiler: begun
    at or after ``t0``, ended by the end of the window's last call and
    before the first profiled stretch began."""
    spans = recorded()
    if not spans:
        return []
    t0 = record["t0"] * 1e9
    ends = [c["t_end"] for c in record.get("calls", [])]
    end = (max(ends) if ends else record["t0"] + record["seconds"]) * 1e9
    # The profiled stretch: the innermost profiled spans (their callers are
    # marked profiled too, and began before the profiler did).
    outer = {s["parent"] for s in spans if s["profiled"]}
    starts = [s["start_ns"] for s in spans
              if s["profiled"] and s["id"] not in outer and s["start_ns"] >= t0]
    if starts:
        end = min(end, min(starts))
    return [s for s in spans if s["name"] == name and not s["profiled"]
            and s["start_ns"] >= t0 and s["end_ns"] <= end]


def setup(record: Dict, name: str) -> List[Dict]:
    """Set-up's spans named ``name``: ended before ``t0``, and begun at or
    after the start of the last ``qwen/model_init`` before it (the run's
    model; a process may have built others before)."""
    spans = recorded()
    if not spans:
        return []
    t0 = record["t0"] * 1e9
    inits = [s["start_ns"] for s in spans if s["name"] == "qwen/model_init" and s["end_ns"] < t0]
    if not inits:
        return []
    return sorted((s for s in spans if s["name"] == name and max(inits) <= s["start_ns"]
                   and s["end_ns"] < t0), key=lambda s: s["start_ns"])


def per_call_device_ms(spans: List[Dict]) -> Optional[float]:
    """Median over calls of the summed device ms of each call's spans; None
    where a span's device time was not read."""
    calls: Dict[int, float] = defaultdict(float)
    for s in spans:
        if s["device_ms"] is None:
            return None
        calls[s["call"]] += s["device_ms"]
    return statistics.median(calls.values()) if calls else None


def seconds(span: Dict) -> float:
    """A span's larger of host and device seconds (host alone without a device time)."""
    return max(span["host_ms"], span["device_ms"] or 0.0) / 1e3
