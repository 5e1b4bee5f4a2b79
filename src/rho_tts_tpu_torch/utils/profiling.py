"""Spans, profiler ranges and profiler traces for the port's pipeline.

**Spans** (always on). ``stage(name, **attrs)`` is the port's span recorder:
the stages of a call and its chunks, about 25 spans in a 192-frame
``QwenTTSModel.synthesize``. Each span opens a ``torch.profiler``
``record_function`` range under its name and records:

* an id, its parent's id (the thread's innermost open span) and a ``call``
  id, shared by every span under one outermost span of the thread;
* the thread (``threading.get_ident``);
* host start and end in ns on ``time.time_ns``'s wall clock, the clock
  ``torch.profiler`` stamps its events on, so a span lies on a device
  trace's timeline and compares with ``time.time()`` stamps;
* ``profiled``: whether a profiler was active at its entry or exit, or
  while a :func:`region` ran inside it;
* the ``attrs`` passed (the ``with`` statement yields them, so a stage can
  add what it learns: ``qwen/synthesize`` its ``frames``, ``qwen/decode_chunk``
  its ``graph``);
* once the process has a CUDA context, two timing events recorded on the
  current stream at entry and exit, read as ``device_ms``: the stream's
  time from reaching the first to reaching the second.

The recorder never synchronises: an event is read only by :func:`spans`,
and only once ``query()`` says it has completed (``device_ms`` is None
before that). No event is recorded while the current stream is capturing
a CUDA graph. Spans are kept in memory, at most ``MAX_SPANS``, the oldest
dropped first (:func:`dropped` counts them); :func:`summary` totals them
by name and :func:`reset` clears them.

Always-on spans: ``qwen/model_init``, ``qwen/synthesize`` and
``qwen/generate_codes`` (the calls, attrs ``rows`` and ``frames``),
``qwen/prompt_build``, ``qwen/prefill`` (a talker with Mamba layers adds
``ssm_chunks``, the chunks of its prefill's scan), ``qwen/decode_chunk`` (attrs
``steps`` and ``graph``: ``"capture"``, ``"replay"`` or ``"eager"``; a
talker with routed experts adds ``experts_touched``, a list a step of the
distinct experts each expert layer ran, counted on the device and fetched
with the call's codes),
``qwen/done_check`` (the host's wait on the lagged all-done flag),
``qwen/fetch_done``, ``qwen/fetch_codes``, ``qwen/vocode``, and the
``serve/``, ``chatterbox/``, ``generate/``, ``validate/`` and ``dsp/``
stages of the other paths.

**Ranges** (only under a profiler). ``region(name)`` opens a profiler
range while a profiler is active and is a no-op otherwise (one read of the
profiler's flag); it records no span. They lie inside the decode step, at
the granularity of its layers, so that a trace names the layer whose host
code runs in each idle gap of the device: ``qwen/chunk_prologue``,
``qwen/step``, ``qwen/embed``, ``qwen/sample``, ``qwen/residuals``
(``models/qwen/model.py``: ``_decode_chunk``); ``talker/attention``,
``talker/mlp``, and a hybrid talker's ``talker/conv``, ``talker/mamba``,
``talker/moe`` and, inside it, ``talker/shared_expert``
(``models/transformer.py``: each cached block);
``quant/int8_matmul``, ``quant/w8a8_matmul`` (``models/quantization.py``);
and ``kernels/attention``, ``kernels/decode_attention``,
``kernels/int4_matmul``, ``kernels/w8a8_matmul``, ``kernels/moe_experts``,
``kernels/ssm_step`` around the launches of ``ops/cuda``.

**Traces**: :func:`start_trace` / :func:`stop_trace` (directory from the
argument or the ``RHO_TTS_TPU_TRACE_DIR`` env var) run a ``torch.profiler``
session recording CPU activity, and CUDA activity whenever the process has
a CUDA device, written at :func:`stop_trace` as a ``*.pt.trace.json`` that
TensorBoard's profiler plugin (or Perfetto) opens. The kernels of
``ops/cuda`` are launched through ctypes, not PyTorch's dispatcher; CUPTI
records them all the same, under their own names.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import os
import threading
import time
from typing import Deque, Dict, Iterator, List, Optional

import torch

logger = logging.getLogger(__name__)

TRACE_DIR_ENV = "RHO_TTS_TPU_TRACE_DIR"

#: spans kept in memory; the oldest is dropped first
MAX_SPANS = 16384

_lock = threading.Lock()
_spans: Deque["_Span"] = collections.deque()
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()
#: the module whose ``_is_profiler_enabled`` a profiler session sets
_autograd_profiler = torch.autograd.profiler
_NO_RANGE = contextlib.nullcontext()
#: the active ``torch.profiler.profile`` session, if any
_trace: Optional[torch.profiler.profile] = None


class _Span:
    __slots__ = ("name", "id", "parent", "call", "thread", "start_ns", "end_ns", "profiled",
                 "attrs", "events", "device_ms")


def _open_spans() -> List[_Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _event() -> Optional[torch.cuda.Event]:
    """A timing event recorded on the current stream; None without a CUDA
    context or while the stream is capturing a graph."""
    if not torch.cuda.is_initialized() or torch.cuda.is_current_stream_capturing():
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


@contextlib.contextmanager
def stage(name: str, **attrs) -> Iterator[Dict]:
    """Record a span named ``name`` (and a profiler range); yields ``attrs``."""
    stack = _open_spans()
    span = _Span()
    span.name, span.id, span.attrs = name, next(_ids), attrs
    span.parent = stack[-1].id if stack else None
    span.call = stack[0].call if stack else span.id
    span.thread = threading.get_ident()
    span.profiled = _autograd_profiler._is_profiler_enabled
    span.device_ms = None
    start = end = None
    stack.append(span)
    try:
        with torch.profiler.record_function(name):
            start = _event()
            span.start_ns = time.time_ns()
            try:
                yield attrs
            finally:
                span.end_ns = time.time_ns()
                if start is not None:
                    end = _event()
    finally:
        stack.pop()
        span.profiled = span.profiled or _autograd_profiler._is_profiler_enabled
        span.events = (start, end) if end is not None else None
        _keep(span)


def profiler_active() -> bool:
    """Whether a ``torch.profiler`` session is recording."""
    return bool(_autograd_profiler._is_profiler_enabled)


def _keep(span: _Span) -> None:
    global _dropped
    with _lock:
        while _spans and len(_spans) >= MAX_SPANS:
            _spans.popleft()
            _dropped += 1
        _spans.append(span)


def region(name: str):
    """A profiler range named ``name`` while a profiler is active; otherwise
    a no-op that costs one read of the profiler's flag. Records no span,
    and marks the thread's open spans ``profiled``.

    The range is torch's C++ ``_RecordFunctionFast``, not the Python
    ``record_function``: under a profiler it costs about a tenth as much on
    the host, so the ranges slow the step they trace less.
    """
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_RANGE
    stack = getattr(_local, "stack", None)
    if stack and not stack[-1].profiled:
        for span in stack:
            span.profiled = True
    return torch._C._profiler._RecordFunctionFast(name)


def _device_ms(span: _Span) -> Optional[float]:
    """The span's device milliseconds once its end event has completed."""
    events = span.events
    if span.device_ms is None and events is not None and events[1].query():
        span.device_ms = events[0].elapsed_time(events[1])
        span.events = None
    return span.device_ms


def spans() -> List[Dict]:
    """The spans held, in the order they closed, as plain dicts."""
    with _lock:
        held = list(_spans)
    return [{"name": s.name, "id": s.id, "parent": s.parent, "call": s.call,
             "thread": s.thread, "start_ns": s.start_ns, "end_ns": s.end_ns,
             "host_ms": (s.end_ns - s.start_ns) / 1e6, "device_ms": _device_ms(s),
             "profiled": s.profiled, "attrs": dict(s.attrs)} for s in held]


def dropped() -> int:
    """Spans dropped from the full buffer since the last :func:`reset`."""
    return _dropped


def summary() -> Dict[str, Dict[str, float]]:
    """The held spans by name: {name: {seconds, calls[, device_seconds]}};
    ``seconds`` on the host clock, ``device_seconds`` where events were read."""
    out: Dict[str, Dict[str, float]] = {}
    for s in spans():
        entry = out.setdefault(s["name"], {"seconds": 0.0, "calls": 0})
        entry["seconds"] += s["host_ms"] / 1e3
        entry["calls"] += 1
        if s["device_ms"] is not None:
            entry["device_seconds"] = entry.get("device_seconds", 0.0) + s["device_ms"] / 1e3
    return out


def reset() -> None:
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0


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
    """Stop the active trace and write it; nothing without one. The profiler
    is off afterwards even when stopping or writing fails."""
    global _trace
    if _trace is None:
        return
    prof, _trace = _trace, None
    try:
        prof.stop()
    except Exception as e:  # noqa: BLE001
        logger.warning("Could not write profiler trace: %s", e)
        # torch's stop synchronizes the session's device before it disables
        # the profiler. When that raises (a CUDA activity without a usable
        # device) the profiler stays on and records every later op of the
        # process, each with a failed device event: exit again without the
        # device.
        inner = prof.profiler
        if inner is not None and torch.autograd.profiler._is_profiler_enabled:
            inner.use_device = None
            inner.__exit__(None, None, None)
