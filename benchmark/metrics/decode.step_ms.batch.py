"""Decode step time in the traced chunk: from the host's start of the decode
chunk to the end of the last device operation it launched, over its steps."""

from benchmark.stats import stretch

UNIT = "ms"


def read(record):
    st = stretch(record, "decode_chunk")
    return None if st is None else st["window_ns"] / st["steps"] / 1e6
