"""The decode-attention kernel's share of its roofline in the traced serving
dispatch: the bound time of its calls (every slot row's valid keys in the
ring, the kernel's inputs: their bytes, or their products, whichever bounds;
``roofline.py``) over their device time."""

from benchmark import roofline
from benchmark.stats import kernel_ns, stretch

UNIT = "%"
KERNEL = "split_decode_kernel"


def read(record):
    st = stretch(record, "serve_dispatch")
    if st is None:
        return None
    ns, calls = kernel_ns(st, KERNEL)
    if calls != st["attention_calls"] or ns <= 0:
        return None  # the kernel is not (or not alone) the step's attention
    bound, _by = roofline.bound_s(st["attention_bytes"], st["attention_ops"])
    return 100.0 * bound / (ns / 1e9)
