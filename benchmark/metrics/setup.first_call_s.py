"""Set-up's warm-up call: the first ``qwen/synthesize`` span after the run's
model was built, before the window, the larger of its host and device
seconds (first-call library handles, plans and allocations)."""

from benchmark.spans import seconds, setup

UNIT = "s"


def read(record):
    spans = setup(record, "qwen/synthesize")
    return seconds(spans[0]) if spans else None
