"""Decode step time without the profiler: the median, over the window's
unprofiled ``qwen/decode_chunk`` spans of the program, of each chunk's
device milliseconds (its stream from the chunk's first launch to its last
one's end) over its steps. A traced batch run's window ends where its
profiled chunk, the second call's second, begins (``benchmark/spans.py``):
at 192 frames in chunks of 64 this reads 4 chunks, the first call's 3 and
the second call's first."""

import statistics

from benchmark.spans import window

UNIT = "ms"


def read(record):
    chunks = window(record, "qwen/decode_chunk")
    if not chunks or any(s["device_ms"] is None for s in chunks):
        return None
    return statistics.median(s["device_ms"] / s["attrs"]["steps"] for s in chunks)
