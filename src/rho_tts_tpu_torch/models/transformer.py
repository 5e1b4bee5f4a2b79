"""Decoder-only transformer core (PyTorch port).

Counterpart of ``rho_tts_tpu/models/transformer.py``: grouped-query
attention over a preallocated stacked KV cache, rotary position embeddings,
RMSNorm and a SwiGLU MLP, f32 softmax over bf16 weights. Parameters are
nested dicts of tensors with the reference's names; the per-layer weights
are stacked ``(L, ...)`` as in ``init_stack``.

This slice ports the cached path that prefill and decode use: the
batch-uniform slot write with ``slot_causal=True``. Attention goes through
the port's kernels: a prefill into an empty cache (T > 1) runs
``ops.cuda.attention.fused_gqa_attention`` over the fresh q/k/v, and a
decode step (T == 1) runs ``ops.cuda.decode_attention.decode_gqa_attention``
over the cache with the complete ``key_valid & (key_pos <= slot)`` mask. On
CUDA tensors those are the hand-written kernels; on CPU tensors, their
plain versions.

Unlike the JAX package, the stacked caches are updated IN PLACE: the
caller's ``(L, B, S, Hkv, D)`` tensors are written and returned.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cuda.attention import fused_gqa_attention
from ..ops.cuda.decode_attention import decode_gqa_attention
from .quantization import matmul as qmm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    hidden: int = 2048
    layers: int = 28
    q_heads: int = 16
    kv_heads: int = 8
    head_dim: int = 128
    ffn: int = 6144
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    dtype: Any = torch.bfloat16


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def _dense_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """N(0, 1/in_dim) weights of shape (..., in, out), drawn in f32."""
    scale = 1.0 / np.sqrt(shape[-2])
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def init_stack(gen: torch.Generator, cfg: TransformerConfig, device) -> Params:
    """Random stacked ``(layers, ...)`` block weights, shapes and scales as JAX."""
    L = cfg.layers
    qkv_out = (cfg.q_heads + 2 * cfg.kv_heads) * cfg.head_dim
    ones = lambda *shape: torch.ones(shape, dtype=torch.float32, device=device)  # noqa: E731
    blocks = {
        "attn_norm": ones(L, cfg.hidden),
        "wqkv": _dense_init(gen, (L, cfg.hidden, qkv_out), cfg.dtype, device),
        "wo": _dense_init(gen, (L, cfg.q_heads * cfg.head_dim, cfg.hidden), cfg.dtype, device),
        "mlp_norm": ones(L, cfg.hidden),
        "w_gate": _dense_init(gen, (L, cfg.hidden, cfg.ffn), cfg.dtype, device),
        "w_up": _dense_init(gen, (L, cfg.hidden, cfg.ffn), cfg.dtype, device),
        "w_down": _dense_init(gen, (L, cfg.ffn, cfg.hidden), cfg.dtype, device),
    }
    return {"blocks": blocks, "final_norm": ones(cfg.hidden)}


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight).to(x.dtype)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


@functools.lru_cache(maxsize=32)
def _inv_freq(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    # Cached per device: a host->device copy inside the decode loop would
    # synchronise the stream.
    return torch.from_numpy(rope_freqs(head_dim, theta).astype(np.float32)).to(device)


def _rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    inv = _inv_freq(head_dim, float(theta), positions.device)
    angles = positions[..., None].float() * inv  # (B, T, D/2)
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2 :].float()
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate pairs (x[..., :d/2], x[..., d/2:]), Llama/Qwen convention.

    x: (B, T, H, D); positions: (B, T).
    """
    cos, sin = _rope_tables(positions, x.shape[-1], theta)
    return _rotate(x, cos, sin)


def _split_qkv(qkv: torch.Tensor, cfg: TransformerConfig):
    b, t, _ = qkv.shape
    q_sz = cfg.q_heads * cfg.head_dim
    kv_sz = cfg.kv_heads * cfg.head_dim
    q = qkv[..., :q_sz].reshape(b, t, cfg.q_heads, cfg.head_dim)
    k = qkv[..., q_sz : q_sz + kv_sz].reshape(b, t, cfg.kv_heads, cfg.head_dim)
    v = qkv[..., q_sz + kv_sz :].reshape(b, t, cfg.kv_heads, cfg.head_dim)
    return q, k, v


# ---------------------------------------------------------------------------
# Cached block forward (prefill and single-step decode)
# ---------------------------------------------------------------------------


def _block_forward_cached(
    params: Params,
    cfg: TransformerConfig,
    x: torch.Tensor,  # (B, T, hidden)
    rope: Tuple[torch.Tensor, torch.Tensor],  # cos/sin tables of the positions
    ck_all: torch.Tensor,  # (L, B, S, Hkv, D), written in place
    cv_all: torch.Tensor,
    layer: int,
    slot: int,  # batch-uniform write slot
    attn_mask: Optional[torch.Tensor],  # (B, T) validity of the new tokens
    decode_mask: Optional[torch.Tensor],  # (B, S) complete mask when T == 1
) -> torch.Tensor:
    """One cached transformer block writing its K/V at ``[slot, slot+T)``."""
    b, t, _ = x.shape

    h = rms_norm(x, params["attn_norm"], cfg.rms_eps)
    qkv = qmm(h, params["wqkv"])
    q, k, v = _split_qkv(qkv, cfg)
    q = _rotate(q, *rope)
    k = _rotate(k, *rope)

    ck_all[layer, :, slot : slot + t] = k.to(ck_all.dtype)
    cv_all[layer, :, slot : slot + t] = v.to(cv_all.dtype)

    if t > 1:
        # The chunk IS the whole attention context (empty cache): the
        # prefill kernel runs over the fresh q/k/v directly.
        mask = attn_mask if attn_mask is not None else torch.ones(
            (b, t), dtype=torch.bool, device=x.device
        )
        attn = fused_gqa_attention(q, k, v, mask, causal=True)
    else:
        attn = decode_gqa_attention(q, ck_all[layer], cv_all[layer], decode_mask)

    attn = attn.reshape(b, t, cfg.q_heads * cfg.head_dim).to(x.dtype)
    x = x + qmm(attn, params["wo"])

    h = rms_norm(x, params["mlp_norm"], cfg.rms_eps)
    gate = F.silu(qmm(h, params["w_gate"]).float())
    up = qmm(h, params["w_up"]).float()
    x = x + qmm((gate * up).to(x.dtype), params["w_down"])
    return x


def stack_forward(
    params: Params,
    cfg: TransformerConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    kv_caches: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_len=None,
    attn_mask: Optional[torch.Tensor] = None,
    key_valid: Optional[torch.Tensor] = None,
    fused_prefill: bool = False,
    kv_window: Optional[int] = None,
    slot_causal: bool = True,
    block_causal: bool = False,
    sp_mesh=None,
):
    """Run the block stack over the stacked caches.

    Returns ``(hidden_states, (ck_all, cv_all))``; the caches are the
    caller's tensors, updated in place. ``key_valid`` is not modified: the
    new slots count as valid for this forward only, as in JAX.

    Ported here: ``cache_len`` an int slot shared by the batch, a prefill
    chunk (T > 1) into an empty cache with ``fused_prefill=True``, and
    single-token decode (T == 1). The other modes of the JAX function wait
    for the serving slice and raise ``NotImplementedError``.
    """
    if kv_caches is None:
        raise NotImplementedError("cache-less block_forward is not ported yet")
    if kv_window is not None or not slot_causal or block_causal or sp_mesh is not None:
        raise NotImplementedError(
            "kv_window, slot_causal=False, block_causal and sp_mesh are not ported yet"
        )
    if isinstance(cache_len, torch.Tensor):
        if cache_len.dim() != 0:
            raise NotImplementedError("per-row (B,) cache slots are not ported yet")
        cache_len = int(cache_len)
    slot = int(cache_len)
    ck_all, cv_all = kv_caches
    b, t, _ = x.shape
    s = ck_all.shape[2]
    if t > 1 and not (fused_prefill and slot == 0):
        raise NotImplementedError(
            "multi-token forwards are ported only as a prefill into an empty cache "
            "(cache_len=0, fused_prefill=True)"
        )

    decode_mask = None
    if t == 1:
        # Complete (B, S) mask, built once for all layers: the new slot is
        # valid, and slot causality bounds the keys.
        key_pos = torch.arange(s, device=x.device)[None, :]
        decode_mask = key_pos <= slot
        if key_valid is not None:
            if attn_mask is None:
                valid = key_valid | (key_pos == slot)
            else:
                valid = torch.where(key_pos == slot, attn_mask[:, :1].bool(), key_valid)
            decode_mask = decode_mask & valid
        decode_mask = decode_mask.expand(b, s).contiguous()

    rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    blocks = params["blocks"]
    for layer in range(int(ck_all.shape[0])):
        lp = {name: _layer(w, layer) for name, w in blocks.items()}
        x = _block_forward_cached(
            lp, cfg, x, rope, ck_all, cv_all, layer, slot, attn_mask, decode_mask
        )
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return x, (ck_all, cv_all)


def _layer(w, layer: int):
    if isinstance(w, dict):
        return {k: v[layer] for k, v in w.items()}
    return w[layer]


def kv_cache_dtype(batch=None, max_len=None):
    """KV-cache storage dtype, env-selectable (``RHO_TTS_TPU_KV_DTYPE``).

    ``bf16`` (default), ``f8`` (float8_e4m3fn), or ``auto`` (f8 when
    ``batch * max_len >= RHO_TTS_TPU_KV_AUTO_THRESHOLD``, default 2048), the
    same selection as the JAX package.
    """
    name = os.environ.get("RHO_TTS_TPU_KV_DTYPE", "bf16")
    if name == "auto":
        if batch is None or max_len is None:
            return torch.bfloat16
        threshold = int(os.environ.get("RHO_TTS_TPU_KV_AUTO_THRESHOLD", "2048"))
        return torch.float8_e4m3fn if batch * max_len >= threshold else torch.bfloat16
    table = {"bf16": torch.bfloat16, "f8": torch.float8_e4m3fn, "fp8": torch.float8_e4m3fn}
    if name not in table:
        raise ValueError(f"RHO_TTS_TPU_KV_DTYPE={name!r}; expected bf16|f8|auto")
    return table[name]


def make_kv_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None, device=None):
    if dtype is None:
        dtype = kv_cache_dtype(batch, max_len)
    shape = (cfg.layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
    return (
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )
