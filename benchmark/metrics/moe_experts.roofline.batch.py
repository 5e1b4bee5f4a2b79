"""The routed-expert kernel's share of its roofline in the traced decode
chunk: the bound time of its calls (the weights of the experts the rows
chose, counted by the program on the device at each step and expert layer,
read once, and the slots' activations; ``roofline_hybrid.py``) over the
device time of its two launches a call."""

from benchmark import roofline
from benchmark.stats import kernel_ns, stretch

UNIT = "%"
KERNEL = "moe_kernel"


def read(record):
    st = stretch(record, "decode_chunk")
    if st is None or "expert_bytes" not in st:
        return None  # no routed experts, or the program counts none
    ns, launches = kernel_ns(st, KERNEL)
    if launches != 2 * st["expert_calls"] or ns <= 0:
        return None  # the kernel is not (or not alone) the step's experts
    bound, _by = roofline.bound_s(st["expert_bytes"], st["expert_ops"])
    return 100.0 * bound / (ns / 1e9)
