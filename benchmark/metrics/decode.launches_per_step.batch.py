"""Device operations (kernels, copies, fills) launched in the traced decode
chunk, over its steps: a count that repeats exactly."""

from benchmark.stats import stretch

UNIT = "launches"


def read(record):
    st = stretch(record, "decode_chunk")
    return None if st is None else st["device_ops"] / st["steps"]
