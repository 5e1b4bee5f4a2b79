"""Model FLOPs of the traced serving dispatch's decode steps (the rows that
hold a request: matmuls and attention over their valid keys; ``roofline.py``)
over its time (host start of the dispatch to its last device operation's end),
as a share of the H100's bf16 peak."""

from benchmark import roofline
from benchmark.stats import stretch

UNIT = "%"


def read(record):
    st = stretch(record, "serve_dispatch")
    if st is None or st["window_ns"] <= 0:
        return None
    return 100.0 * st["model_flops"] / (st["window_ns"] / 1e9) / roofline.BF16_FLOP_PER_S
