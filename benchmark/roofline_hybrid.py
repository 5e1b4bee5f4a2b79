"""Operations and bytes of the hybrid talker's decode step (``lfm2.py``'s
configuration), for the roofline and the model-FLOPs metrics.

A row of a decode step runs every layer's matmuls once: each short
convolution's ``in_proj`` and ``out_proj`` (and its K depthwise taps on H
channels), each attention layer's ``wqkv`` and ``wo`` (and the attention
over its valid keys, ``roofline.attention_flops`` over the attention layers
only), each dense layer's SwiGLU, and in each expert layer the router and
its ``num_experts_per_tok`` experts; then the audio head and the residual
code predictor. Two FLOPs a multiply-add.

The routed-expert kernel (``csrc/moe_experts.cu``), per expert layer and
step, reads the weights of the experts some row chose (``touched``, which
the program counts on the device), each once, the rows' activations, and
writes and reads each slot's activation and partial output; its operations
are each slot's three expert matmuls.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

from . import roofline
from .lfm2 import sizes


def attention_config(cfg: Dict) -> Dict:
    """The attention layers alone, in ``roofline.py``'s terms."""
    z = sizes(cfg)
    return {"talker": {"layers": z["attn"], "q_heads": z["q_heads"], "kv_heads": z["kv_heads"],
                       "head_dim": z["head_dim"]}}


def row_matmul_params(cfg: Dict) -> int:
    """Weights one row of a decode step multiplies by in the talker."""
    z = sizes(cfg)
    h = z["hidden"]
    qkv = (z["q_heads"] + 2 * z["kv_heads"]) * z["head_dim"]
    conv = z["conv"] * (3 * h * h + h * h)
    attn = z["attn"] * (h * qkv + z["q_heads"] * z["head_dim"] * h)
    dense = z["dense"] * 3 * h * z["ffn"]
    moe = z["moe"] * (h * z["experts"] + z["topk"] * 3 * h * z["expert_ffn"])
    return conv + attn + dense + moe


def head_params(cfg: Dict) -> int:
    """Weights of the audio head and of the residual code predictor."""
    h, c = sizes(cfg)["hidden"], cfg["codec"]
    cp = cfg["code_predictor_hidden"]
    return h * (c["codebook_size"] + 3) + (c["n_codebooks"] - 1) * (2 * h * cp + cp * c["codebook_size"])


def decode_row_flops(cfg: Dict) -> int:
    """FLOPs of one row of one decode step, attention apart."""
    z = sizes(cfg)
    taps = 2 * z["conv"] * z["taps"] * z["hidden"]
    return 2 * (row_matmul_params(cfg) + head_params(cfg)) + taps


def decode_step_flops(cfg: Dict, live_keys: Iterable[int]) -> int:
    """Model FLOPs of one decode step: for each live row, its valid keys."""
    keys = list(live_keys)
    att = attention_config(cfg)
    return len(keys) * decode_row_flops(cfg) + sum(roofline.attention_flops(att, k) for k in keys)


def expert_work(cfg: Dict, rows: int, touched: int, act_bytes: int = 2) -> Tuple[int, int]:
    """``(bytes, operations)`` of ONE call of the routed-expert kernel (its two
    launches, one expert layer) over ``rows`` rows that chose ``touched``
    distinct experts."""
    z = sizes(cfg)
    h, fe, k = z["hidden"], z["expert_ffn"], z["topk"]
    slots = rows * k
    n_bytes = (touched * 3 * h * fe * 2  # each touched expert's gate, up and down, once
               + rows * h * act_bytes  # x
               + 2 * slots * fe * act_bytes  # act written, then read
               + slots * h * 4  # partial written
               + slots * (8 + 4))  # idx (int64) and weights (f32)
    return n_bytes, 2 * slots * 3 * h * fe
