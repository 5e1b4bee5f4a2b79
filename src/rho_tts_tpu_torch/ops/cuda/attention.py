"""Fused GQA prefill attention: a hand-written Hopper kernel and its plain version.

Counterpart of ``rho_tts_tpu/ops/pallas/attention.py``.

Kernel: ``csrc/attention.cu`` replaces the Pallas kernel
``fused_gqa_attention`` (``_attention_kernel``). At the 1.7B main-path
shape (q ``(5,128,16,128)`` bf16, k/v ``(5,128,8,128)``) it is bound by
its bytes (~7.9 MB, ~2.3 us at 3.35 TB/s), far above its products, and
beyond them by latency. Design, for bf16: one block per (64-query tile,
query head, row); Q and 64-key K/V tiles copied by 16-byte ``cp.async``
into a double-buffered ring in shared memory, read in place through the
caller's strides (no transpose, no KV copy for GQA); QK^T and PV on the
tensor cores (``mma.sync`` m16n8k16) with an online softmax in f32, P
entering as a hi + lo pair of bf16 so that the probabilities keep ~16
bits; key tiles past the causal diagonal skipped where that is exact. f32
inputs (and bf16 not 16-byte aligned) take a SIMT loop in f32. Both keep
the reference's finite -1e30 fill, so fully masked (left-padded) rows
average V and stay finite. See the source for the details.

Dispatch: CPU tensors take :func:`reference_gqa_attention`; CUDA tensors
launch the kernel or raise. Inputs that require grad under grad mode raise on
either device (``check_no_autograd``): the kernel has no backward.
``launches`` counts the kernel's launches, not those recorded into a CUDA
graph under capture, which run when the graph is replayed.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from ...utils import profiling
from . import _build, check_no_autograd

#: number of times the CUDA kernel was launched
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SUPPORTED_D = range(16, 129, 16)


def reference_gqa_attention(q, k, v, attn_mask, causal: bool = True, q_offset: Optional[int] = None,
                            scale: Optional[float] = None):
    """Plain PyTorch version; same semantics as the JAX reference.

    q ``(B,T,Hq,D)``, k/v ``(B,S,Hkv,D)``, attn_mask ``(B,S)`` bool key
    validity. Causal at the global query position ``q_offset + row``.
    ``scale`` multiplies the scores (None: ``1 / sqrt(D)``). Returns
    ``(B,T,Hq,D)`` in q's dtype.
    """
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
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
_plans: Dict[tuple, tuple] = {}


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("attention").rho_prefill_attention
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p,
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


def _plan(key, q, k, v, attn_mask):
    """Checks and the strides array of one call signature, computed once."""
    _check(q, k, v, attn_mask)
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    # out is allocated contiguous (B,T,Hq,D).
    strides = (ctypes.c_longlong * 13)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        t * hq * d, hq * d, d,
        attn_mask.stride(0),
    )
    plan = ((b, t, hq, d), q.device.index, (_DTYPES[q.dtype], b, t, s, hq, hkv, d, strides))
    _plans[key] = plan
    return plan


def fused_gqa_attention(q, k, v, attn_mask, causal: bool = True, q_offset: Optional[int] = None,
                        scale: Optional[float] = None):
    """Fused attention; returns ``(B,T,Hq,D)`` in q's dtype. ``scale``
    multiplies the scores (None: ``1 / sqrt(D)``, which the kernel computes
    as it always has).

    CPU tensors run :func:`reference_gqa_attention`; CUDA tensors launch
    ``csrc/attention.cu`` (or raise).
    """
    global launches
    check_no_autograd("fused_gqa_attention", "reference_gqa_attention", q, k, v)
    if q.device.type == "cpu":
        return reference_gqa_attention(q, k, v, attn_mask, causal=causal, q_offset=q_offset,
                                       scale=scale)
    with profiling.region("kernels/attention"):
        key = (q.shape, q.stride(), q.dtype, q.device, k.shape, k.stride(), k.dtype, k.device,
               v.shape, v.stride(), v.dtype, v.device, attn_mask.shape, attn_mask.stride(),
               attn_mask.dtype, attn_mask.device)
        plan = _plans.get(key)
        if plan is None:
            plan = _plan(key, q, k, v, attn_mask)
        out_shape, dev_index, args = plan
        out = torch.empty(out_shape, dtype=q.dtype, device=q.device)
        rc = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), attn_mask.data_ptr(), out.data_ptr(), *args,
            0 if q_offset is None else int(q_offset), int(bool(causal)),
            0.0 if scale is None else float(scale), dev_index,
            # torch.cuda.current_stream(device).cuda_stream, without building a Stream
            torch._C._cuda_getCurrentRawStream(dev_index),
        )
        if rc != 0:
            raise RuntimeError(f"prefill attention kernel launch failed: cudaError_t {rc}")
        if not torch.cuda.is_current_stream_capturing():  # a graph's node runs on replay
            launches += 1
        return out


def sp_fused_gqa_attention(q, k, v, attn_mask, axis, causal: bool = True):
    """Sequence-parallel prefill attention (JAX's ``sp_fused_gqa_attention``).

    ``q`` ``(B, T/n, Hq, D)`` is this rank's query shard of a prompt split
    over ``axis`` (``parallel.mesh.Axis``, n members), at global positions
    ``[axis.index * T/n, ...)``. ``k``, ``v`` and ``attn_mask`` are this
    rank's shards, all-gathered here over the axis, or already the whole
    sequence (``(B, T, ...)``, as the SP prefill passes them after writing
    its cache). The kernel then runs on the local queries at their global
    ``q_offset``; the output is the local ``(B, T/n, Hq, D)``.
    """
    from ...parallel.collectives import all_gather

    tl = q.shape[1]
    whole = tl * axis.size
    if k.shape[1] != whole:
        k, v = all_gather(k, 1, axis), all_gather(v, 1, axis)
    if attn_mask.shape[1] != whole:
        attn_mask = all_gather(attn_mask, 1, axis)
    return fused_gqa_attention(q, k, v, attn_mask, causal=causal, q_offset=axis.index * tl)
