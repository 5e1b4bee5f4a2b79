"""Prefill: the median over the window's calls of each call's ``qwen/prefill``
device milliseconds (prompt embeddings, the talker over the prompt, the
first logits). In a traced batch run: 2 prefills, those of the first two
calls, which begin before the profiled chunk (the second call's second)."""

from benchmark.spans import per_call_device_ms, window

UNIT = "ms"


def read(record):
    return per_call_device_ms(window(record, "qwen/prefill"))
