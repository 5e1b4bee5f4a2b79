"""The H100's published peaks, and the operations and bytes of the work, from shapes.

The bound of a call is the larger of its bytes over the memory bandwidth and
its operations over the peak rate: the least time the card could take. The
decode attention's bytes count q, the output and the mask once, and the K and
V of the valid keys only (a row with no valid key reads every key), as the
kernel's inputs need them; its operations are the products of the same keys.
A decode step's model FLOPs are its matmuls' (two per multiply-add) and its
attention's, over the rows that hold a request.

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def bound_s(n_bytes: float, n_ops: float, ops_per_s: float = BF16_FLOP_PER_S) -> Tuple[float, str]:
    """Least time of the work, and which of the two bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / ops_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def talker_matmul_params(cfg: Dict) -> int:
    """Weights of the talker's matmuls (``wqkv``, ``wo``, ``w_gate``, ``w_up``, ``w_down``)."""
    t = cfg["talker"]
    h, d = t["hidden"], t["head_dim"]
    qkv = (t["q_heads"] + 2 * t["kv_heads"]) * d
    per_layer = h * qkv + t["q_heads"] * d * h + 3 * h * t["ffn"]
    return t["layers"] * per_layer


def head_params(cfg: Dict) -> int:
    """Weights of the audio head and of the residual code predictor."""
    h, c = cfg["talker"]["hidden"], cfg["codec"]
    cp = cfg["code_predictor_hidden"]
    lm = h * (c["codebook_size"] + 3)
    predictor = (c["n_codebooks"] - 1) * (2 * h * cp + cp * c["codebook_size"])
    return lm + predictor


def decode_row_flops(cfg: Dict) -> int:
    """Matmul FLOPs of one row of one decode step (attention apart)."""
    return 2 * (talker_matmul_params(cfg) + head_params(cfg))


def attention_flops(cfg: Dict, keys: int) -> int:
    """FLOPs of one row's decode attention over ``keys`` valid keys, every layer:
    scores and the weighted sum, two per multiply-add."""
    t = cfg["talker"]
    return 4 * t["layers"] * t["q_heads"] * t["head_dim"] * keys


def decode_step_flops(cfg: Dict, live_keys: Iterable[int]) -> int:
    """Model FLOPs of one decode step: for each live row, its valid keys."""
    keys = list(live_keys)
    return len(keys) * decode_row_flops(cfg) + sum(attention_flops(cfg, k) for k in keys)


def decode_attention_work(cfg: Dict, row_keys: Iterable[int], cache_len: int,
                          kv_bytes: int = 2, act_bytes: int = 2) -> Tuple[int, int]:
    """``(bytes, operations)`` of ONE decode-attention call (one layer) over a
    batch whose rows hold ``row_keys`` valid keys in a cache of ``cache_len``."""
    t = cfg["talker"]
    hq, hkv, d = t["q_heads"], t["kv_heads"], t["head_dim"]
    rows = list(row_keys)
    keys = sum(k if k > 0 else cache_len for k in rows)
    n_bytes = (2 * len(rows) * hq * d * act_bytes  # q in, the output
               + len(rows) * cache_len  # the bool mask
               + 2 * keys * hkv * d * kv_bytes)  # K and V of the valid keys
    return n_bytes, 4 * keys * hq * d
