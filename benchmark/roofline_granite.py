"""Operations and bytes of the state-space hybrid talker's decode step
(``granite.py``'s configuration), for the roofline and the model-FLOPs metrics.

A row of a decode step runs every layer's matmuls once: each Mamba layer's
``in_proj`` and ``out_proj`` (and its convolution's taps on the conv
channels, and its scan: the state's update and read-out), each attention
layer's ``wqkv`` and ``wo`` (and the attention over its valid keys,
``roofline.attention_flops`` over the attention layers only), and in every
layer the router, its ``num_experts_per_tok`` experts and the shared
expert; then the audio head and the residual code predictor. Two FLOPs a
multiply-add; the scan's update ``S exp(dt A) + (dt x) B`` three a state
value, its read-out ``S C`` two.

The routed-expert kernel (``csrc/moe_experts.cu``) is counted as
``roofline_hybrid.py`` counts it: the weights of the experts some row chose
(``touched``, which the program counts on the device), each once, the rows'
activations, each slot's activation and partial output written and read.

The Mamba decode kernel (``csrc/ssm_step.cu``), per Mamba layer and step,
reads and writes the scan's state in f32 once, reads the ``in_proj`` output
(z, xBC, dt) and the convolution's state (written back), its taps, bias and
the heads' parameters once, and writes its output; its operations are the
scan's and the convolution's. It runs on the CUDA cores: its operations
are bounded at the f32 peak.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

from . import roofline
from .granite import sizes

#: the H100's f32 peak outside the tensor cores (SXM data sheet, dense)
FP32_FLOP_PER_S = 67e12


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
    mamba = z["mamba"] * (h * z["in_proj"] + z["ssm_inner"] * h)
    attn = z["attn"] * (h * qkv + z["q_heads"] * z["head_dim"] * h)
    moe = z["layers"] * (h * z["experts"] + z["topk"] * 3 * h * z["expert_ffn"]
                         + 3 * h * z["shared_ffn"])
    return mamba + attn + moe


def head_params(cfg: Dict) -> int:
    """Weights of the audio head and of the residual code predictor."""
    h, c = sizes(cfg)["hidden"], cfg["codec"]
    cp = cfg["code_predictor_hidden"]
    return (h * (c["codebook_size"] + 3)
            + (c["n_codebooks"] - 1) * (2 * h * cp + cp * c["codebook_size"]))


def scan_values(cfg: Dict) -> int:
    """Values of one row's scan state in one Mamba layer: heads x P x N."""
    z = sizes(cfg)
    return z["ssm_heads"] * z["ssm_head_dim"] * z["ssm_state"]


def ssm_row_ops(cfg: Dict) -> int:
    """Operations of one row of one Mamba layer's decode step outside its
    matmuls: the convolution's taps and the scan's update and read-out."""
    z = sizes(cfg)
    return 2 * z["taps"] * z["conv_dim"] + 5 * scan_values(cfg)


def decode_row_flops(cfg: Dict) -> int:
    """FLOPs of one row of one decode step, attention apart."""
    return (2 * (row_matmul_params(cfg) + head_params(cfg))
            + sizes(cfg)["mamba"] * ssm_row_ops(cfg))


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


def ssm_step_work(cfg: Dict, rows: int) -> Tuple[int, int]:
    """``(bytes, operations)`` of ONE launch of the Mamba decode kernel (one
    Mamba layer) over ``rows`` rows."""
    z = sizes(cfg)
    nh, cd, taps = z["ssm_heads"], z["conv_dim"], z["taps"]
    n_bytes = (rows * scan_values(cfg) * 4 * 2  # S read and written
               + rows * z["in_proj"] * 2  # z, xBC, dt (bf16)
               + rows * (taps - 1) * cd * 4 * 2  # the convolution's state read and written
               + cd * (taps + 1) * 2 + 3 * nh * 4  # taps and bias (bf16), dt_bias, A_log, D
               + rows * z["ssm_inner"] * 2)  # the output (bf16)
    return n_bytes, rows * ssm_row_ops(cfg)


def ssm_step_bound_s(n_bytes: int, n_ops: int) -> Tuple[float, str]:
    """The least time of the Mamba decode kernel's work, its operations at
    the f32 peak."""
    return roofline.bound_s(n_bytes, n_ops, FP32_FLOP_PER_S)
