"""Set-up's model placement: the run's ``qwen/model_init`` span (weights
registered, the talker quantized on the device), the larger of its host
and device seconds."""

from benchmark.spans import seconds, setup

UNIT = "s"


def read(record):
    spans = setup(record, "qwen/model_init")
    return seconds(spans[-1]) if spans else None
