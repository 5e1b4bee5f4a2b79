"""Stage timers and profiler traces for the port's pipeline.

``stage("name")`` wraps a pipeline stage in a ``torch.profiler``
``record_function`` range (visible in a profiler trace) and a host
wall-clock accumulator queryable via :func:`summary`. On a GPU the host
clock measures the enqueue unless the stage ends in a synchronisation.

Device traces are captured with :func:`start_trace` / :func:`stop_trace`
(directory from the argument or the ``RHO_TTS_TPU_TRACE_DIR`` env var):
a ``torch.profiler`` session recording CPU activity, and CUDA activity
whenever the process has a CUDA device, written at :func:`stop_trace` as a
``*.pt.trace.json`` that TensorBoard's profiler plugin (or Perfetto) opens.
The kernels of ``ops/cuda`` are launched through ctypes, not PyTorch's
dispatcher; CUPTI records them all the same, under their own names.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

logger = logging.getLogger(__name__)

TRACE_DIR_ENV = "RHO_TTS_TPU_TRACE_DIR"

_lock = threading.Lock()
_wall: Dict[str, float] = defaultdict(float)
_count: Dict[str, int] = defaultdict(int)
#: the active ``torch.profiler.profile`` session, if any
_trace: Optional[torch.profiler.profile] = None


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


def start_trace(log_dir: Optional[str] = None) -> bool:
    """Start a profiler trace written to ``log_dir`` (or ``$RHO_TTS_TPU_TRACE_DIR``)
    by :func:`stop_trace`. False with no directory or a trace already active."""
    global _trace
    log_dir = log_dir or os.environ.get(TRACE_DIR_ENV)
    if not log_dir or _trace is not None:
        return False
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        prof = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
        )
        prof.start()
    except Exception as e:  # noqa: BLE001
        logger.warning("Could not start profiler trace: %s", e)
        return False
    _trace = prof
    return True


def stop_trace() -> None:
    """Stop the active trace and write it; nothing without one."""
    global _trace
    if _trace is None:
        return
    prof, _trace = _trace, None
    try:
        prof.stop()
    except Exception as e:  # noqa: BLE001
        logger.warning("Could not write profiler trace: %s", e)
