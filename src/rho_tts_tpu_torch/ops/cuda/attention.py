"""Fused GQA prefill attention: a hand-written Hopper kernel and its plain version.

Counterpart of ``rho_tts_tpu/ops/pallas/attention.py``.

Kernel: ``csrc/attention.cu`` replaces the Pallas kernel
``fused_gqa_attention`` (``_attention_kernel``). At the 1.7B main-path
shape (q ``(5,128,16,128)`` bf16, k/v ``(5,128,8,128)``) it is bound by
its bytes (~7.9 MB, ~2.3 us at 3.35 TB/s), far above its products; in
practice the launch costs more than either. Design: one block per
(64-query tile, query head, row), an online softmax in f32 over key tiles
staged in shared memory, the ``(B,T,H,D)`` / ``(B,S,Hkv,D)`` layouts read
in place through strides (no transpose, no KV copy for GQA), and the
reference's finite -1e30 fill so that fully masked (left-padded) rows stay
finite. See the source for the details.

Dispatch: CPU tensors take :func:`reference_gqa_attention`; CUDA tensors
launch the kernel or raise. ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

#: number of times the CUDA kernel was launched
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SUPPORTED_D = range(16, 129, 16)


def reference_gqa_attention(q, k, v, attn_mask, causal: bool = True, q_offset: Optional[int] = None):
    """Plain PyTorch version; same semantics as the JAX reference.

    q ``(B,T,Hq,D)``, k/v ``(B,S,Hkv,D)``, attn_mask ``(B,S)`` bool key
    validity. Causal at the global query position ``q_offset + row``.
    Returns ``(B,T,Hq,D)`` in q's dtype.
    """
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)

    qg = q.reshape(b, t, hkv, group, d).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    scores = scores.reshape(b, hq, t, s)

    valid = attn_mask[:, None, None, :].bool()
    if causal:
        off = 0 if q_offset is None else int(q_offset)
        key_pos = torch.arange(s, device=q.device)[None, None, None, :]
        q_pos = off + torch.arange(t, device=q.device)[None, None, :, None]
        valid = valid & (key_pos <= q_pos)
    scores = scores.masked_fill(~valid, -1e30)
    probs = torch.softmax(scores, dim=-1)
    pg = probs.reshape(b, hkv, group, t, s)
    out = torch.einsum("bhgqk,bkhd->bqhgd", pg, v.float())
    return out.reshape(b, t, hq, d).to(q.dtype)


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("attention").rho_prefill_attention
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        _fn = fn
    return _fn


def _check(q, k, v, attn_mask):
    if not (q.is_cuda and k.device == q.device and v.device == q.device
            and attn_mask.device == q.device):
        raise ValueError("fused_gqa_attention: q, k, v and attn_mask must share one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"fused_gqa_attention: q/k/v must all be float32 or bfloat16, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if attn_mask.dtype != torch.bool:
        raise TypeError(f"fused_gqa_attention: attn_mask must be bool, got {attn_mask.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"fused_gqa_attention: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    b, t, hq, d = q.shape
    _, s, hkv, dk = k.shape
    if k.shape[0] != b or dk != d or hkv == 0 or hq % hkv:
        raise ValueError(f"fused_gqa_attention: q{tuple(q.shape)} does not match k{tuple(k.shape)}")
    if d not in _SUPPORTED_D:
        raise ValueError(f"fused_gqa_attention: head_dim {d} must be a multiple of 16 up to 128")
    if tuple(attn_mask.shape) != (b, s):
        raise ValueError(f"fused_gqa_attention: attn_mask {tuple(attn_mask.shape)} != {(b, s)}")
    if t == 0 or s == 0:
        raise ValueError("fused_gqa_attention: empty query or key axis")
    for name, x in (("q", q), ("k", k), ("v", v), ("attn_mask", attn_mask)):
        if x.stride(-1) != 1:
            raise ValueError(f"fused_gqa_attention: {name}'s last dimension must be contiguous")


def fused_gqa_attention(q, k, v, attn_mask, causal: bool = True, q_offset: Optional[int] = None):
    """Fused attention; returns ``(B,T,Hq,D)`` in q's dtype.

    CPU tensors run :func:`reference_gqa_attention`; CUDA tensors launch
    ``csrc/attention.cu`` (or raise).
    """
    global launches
    if q.device.type == "cpu":
        return reference_gqa_attention(q, k, v, attn_mask, causal=causal, q_offset=q_offset)
    _check(q, k, v, attn_mask)
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 13)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        attn_mask.stride(0),
    )
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), attn_mask.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, t, s, hq, hkv, d, strides,
            0 if q_offset is None else int(q_offset), int(bool(causal)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"prefill attention kernel launch failed: cudaError_t {rc}")
    launches += 1
    return out
