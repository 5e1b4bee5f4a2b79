"""Stage timers for the port's pipeline.

``stage("name")`` wraps a pipeline stage in a ``torch.profiler``
``record_function`` range (visible in a profiler trace) and a host
wall-clock accumulator queryable via :func:`summary`. On a GPU the host
clock measures the enqueue unless the stage ends in a synchronisation.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

_lock = threading.Lock()
_wall: Dict[str, float] = defaultdict(float)
_count: Dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    """Annotate a pipeline stage (profiler range + host wall-clock)."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    dt = time.perf_counter() - t0
    with _lock:
        _wall[name] += dt
        _count[name] += 1


def summary() -> Dict[str, Dict[str, float]]:
    """Accumulated wall-clock per stage: {name: {seconds, calls}}."""
    with _lock:
        return {
            name: {"seconds": _wall[name], "calls": _count[name]} for name in _wall
        }


def reset() -> None:
    with _lock:
        _wall.clear()
        _count.clear()
