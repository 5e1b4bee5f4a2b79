"""The Mamba decode kernel's share of the traced decode chunk's busy device
time (the union of its device operations' intervals)."""

from benchmark.stats import kernel_ns, stretch

UNIT = "%"
KERNEL = "ssm_step_kernel"


def read(record):
    st = stretch(record, "decode_chunk")
    if st is None or st["busy_ns"] <= 0:
        return None
    ns, launches = kernel_ns(st, KERNEL)
    return 100.0 * ns / st["busy_ns"] if launches else None
