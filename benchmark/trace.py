"""One short stretch of the run under ``torch.profiler``, reduced to intervals.

:class:`Stretch` profiles one call into the program (a decode chunk, a serving
dispatch) on the thread that makes it: the device is synchronised before
and after, so every kernel the call launches, and only those, lands in the
profile. The benchmark's own ``record_function`` range around the call
marks where the host began. The reduction, after the window has closed,
keeps the device operations (kernels, copies, fills) by name and time, the
host operations of the calling thread, and from them:

* the stretch: from the host's start of the call to the end of the last
  device operation it launched;
* busy time: the union of the device operations' intervals;
* idle gaps: the stretches with no device operation, each named by the
  innermost host operation running on the calling thread when it began.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

SPAN = "bench/stretch"


class Stretch:
    """Profiles, once, the first call of ``fn`` for which ``when()`` is true.

    ``before(*args, **kwargs)``, if given, runs just before that call and
    returns what the metrics need to know of its inputs (rows, keys).
    """

    def __init__(self, fn: Callable, when: Callable[[], bool],
                 before: Optional[Callable] = None):
        self.fn = fn
        self.when = when
        self.before = before
        self.prof = None
        self.meta: Dict = {}

    def __call__(self, *args, **kwargs):
        if self.prof is not None or not self.when():
            return self.fn(*args, **kwargs)
        if self.before is not None:
            self.meta.update(self.before(*args, **kwargs))
        cuda = torch.cuda.is_available()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(SPAN):
                out = self.fn(*args, **kwargs)
            if cuda:
                torch.cuda.synchronize()
        self.prof = prof
        return out

    def reduce(self) -> Optional[Dict]:
        """The stretch's intervals and sums (None if the call never came)."""
        if self.prof is None:
            return None
        out = reduce_events(self.prof.profiler.kineto_results.events())
        out.update(self.meta)
        return out


def _union(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def reduce_events(events) -> Dict:
    """Reduce kineto events to the stretch's device operations and host names."""
    span = next(e for e in events if e.name() == SPAN and e.device_type() != _CUDA)
    t0, thread = span.start_ns(), span.start_thread_id()
    host_names = {e.name() for e in events if e.device_type() != _CUDA}
    # A device-side event named as a host one is a range's shadow on the
    # device timeline (``record_function``), not an operation.
    dev = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
           if e.device_type() == _CUDA and e.name() not in host_names]
    host = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events
                  if e.device_type() != _CUDA and e.start_thread_id() == thread
                  and e.name() != SPAN)
    busy = _union([(s, e) for _, s, e in dev])
    t1 = busy[-1][1] if busy else t0
    by_name: Dict[str, List] = defaultdict(lambda: [0, 0])
    for name, s, e in dev:
        by_name[name][0] += e - s
        by_name[name][1] += 1
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    return {
        "start_ns": t0, "end_ns": t1, "window_ns": t1 - t0,
        "busy_ns": sum(e - s for s, e in busy),
        "device_ops": len(dev),
        "by_name": {k: {"ns": v[0], "count": v[1]} for k, v in by_name.items()},
        "idle_by_host": _name_gaps(gaps, host),
    }


_CUDA = torch.autograd.DeviceType.CUDA


def _name_gaps(gaps: List[Tuple[int, int]], host: List[Tuple[int, int, str]]) -> Dict[str, int]:
    """Idle nanoseconds by the innermost host operation running when each gap began."""
    starts = [h[0] for h in host]
    out: Dict[str, int] = defaultdict(int)
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0)
        name = "host (no operation)"
        # The innermost operation covering g0 is the latest-starting one that does.
        for _s, e, n in reversed(host[max(0, i - 64): i]):
            if e >= g0:
                name = n
                break
        out[name] += g1 - g0
    return dict(out)


def breakdown(stretch: Dict, top: int = 10) -> Dict:
    """The ``breakdown`` of a traced result line, in seconds."""
    ops = sorted(stretch["by_name"].items(), key=lambda kv: -kv[1]["ns"])[:top]
    gaps = sorted(stretch["idle_by_host"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:200], v["ns"] / 1e9] for n, v in ops],
            "idle_gaps": [[n[:200], ns / 1e9] for n, ns in gaps]}
