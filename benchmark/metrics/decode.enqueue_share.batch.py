"""The host's share of a decode chunk: the median, over the window's
unprofiled ``qwen/decode_chunk`` spans, of the host's milliseconds enqueuing
the chunk over its device milliseconds, in %. Near 100 when the host sets
the pace; lower when the device does. In a traced batch run: the 4 chunks
before the profiled one, as ``decode.step_ms.window.batch``."""

import statistics

from benchmark.spans import window

UNIT = "%"


def read(record):
    chunks = window(record, "qwen/decode_chunk")
    if not chunks or any(not s["device_ms"] for s in chunks):
        return None
    return statistics.median(100.0 * s["host_ms"] / s["device_ms"] for s in chunks)
