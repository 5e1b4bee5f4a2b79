"""The Mamba decode kernel's share of its roofline in the traced decode
chunk: the bound time of its launches (the scan's f32 state read and written
once, its inputs, convolution state and output, one launch a Mamba layer a
step; ``roofline_granite.py``) over their device time."""

from benchmark import roofline_granite
from benchmark.stats import kernel_ns, stretch

UNIT = "%"
KERNEL = "ssm_step_kernel"


def read(record):
    st = stretch(record, "decode_chunk")
    if st is None or "ssm_bytes" not in st:
        return None  # no Mamba layers
    ns, launches = kernel_ns(st, KERNEL)
    if launches != st["ssm_calls"] or ns <= 0:
        return None  # the kernel is not (or not alone) the steps' Mamba scan
    bound, _by = roofline_granite.ssm_step_bound_s(st["ssm_bytes"], st["ssm_ops"])
    return 100.0 * bound / (ns / 1e9)
