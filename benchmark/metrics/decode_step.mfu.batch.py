"""Model FLOPs of the traced decode chunk's steps (every row, its matmuls and
its attention over its valid keys; ``roofline.py``) over the chunk's time
(as ``decode.step_ms.batch``), as a share of the H100's bf16 peak."""

from benchmark import roofline
from benchmark.stats import stretch

UNIT = "%"


def read(record):
    st = stretch(record, "decode_chunk")
    if st is None or st["window_ns"] <= 0:
        return None
    return 100.0 * st["model_flops"] / (st["window_ns"] / 1e9) / roofline.BF16_FLOP_PER_S
