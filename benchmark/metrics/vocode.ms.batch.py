"""Vocoder: the median over the window's calls of each call's summed
``qwen/vocode`` device milliseconds (one span a length bucket). In a
traced batch run: the first call's vocode alone (its rows share one
bucket); the second call's comes after the profiled chunk."""

from benchmark.spans import per_call_device_ms, window

UNIT = "ms"


def read(record):
    return per_call_device_ms(window(record, "qwen/vocode"))
