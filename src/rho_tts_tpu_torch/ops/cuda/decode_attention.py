"""Single-token GQA decode attention: a hand-written Hopper kernel and its plain version.

Counterpart of ``rho_tts_tpu/ops/pallas/decode_attention.py``.

Kernel: ``csrc/decode_attention.cu`` replaces the Pallas kernel
``decode_gqa_attention`` (``_decode_kernel``). In the JAX package that
kernel is opt-in; in the port it is the attention of every decode step. At
the 1.7B main-path shape (q ``(5,1,16,128)`` bf16, a ``(5,384,8,128)`` bf16
cache per layer) it is bound by reading K and V (~7.9 MB, ~2.3 us at
3.35 TB/s); the launch costs more. Design: one block per (KV head, row)
holding that head's G = Hq/Hkv queries, four warps splitting the keys with
an online softmax each, merged in shared memory. K/V are converted to f32
as they load (f32, bf16 or float8 e4m3 storage) and the probabilities stay
f32, as in the Pallas kernel and :func:`reference_decode_attention` (JAX's
default einsum path casts probabilities to bf16 for f8 caches only). The
40 blocks of the main path underfill the card's 132 SMs; split-S is later
work.

Dispatch: CPU tensors take :func:`reference_decode_attention`; CUDA tensors
launch the kernel or raise. ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

#: number of times the CUDA kernel was launched
launches = 0

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
_MAX_GROUP = 8
_MAX_D = 128


def reference_decode_attention(q, k, v, mask):
    """Plain PyTorch version; same semantics as the JAX reference.

    q ``(B,1,Hq,D)``, k/v ``(B,S,Hkv,D)`` in any float storage (converted to
    f32), mask ``(B,S)`` bool, the complete key validity. Returns
    ``(B,1,Hq,D)`` in q's dtype.
    """
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, t, hkv, group, d).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    scores = scores.masked_fill(~mask[:, None, None, None, :].bool(), -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, t, hq, d).to(q.dtype)


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("decode_attention").rho_decode_attention
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
        ]
        _fn = fn
    return _fn


def _check(q, k, v, mask):
    if not (q.is_cuda and k.device == q.device and v.device == q.device
            and mask.device == q.device):
        raise ValueError("decode_gqa_attention: q, k, v and mask must share one CUDA device")
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"decode_gqa_attention: q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype not in _KV_DTYPES or v.dtype != k.dtype:
        raise TypeError(
            f"decode_gqa_attention: k/v must both be float32, bfloat16 or float8_e4m3fn, "
            f"got {k.dtype}/{v.dtype}"
        )
    if mask.dtype != torch.bool:
        raise TypeError(f"decode_gqa_attention: mask must be bool, got {mask.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"decode_gqa_attention: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}"
        )
    b, _, hq, d = q.shape
    _, s, hkv, dk = k.shape
    if k.shape[0] != b or dk != d or hkv == 0 or hq % hkv:
        raise ValueError(f"decode_gqa_attention: q{tuple(q.shape)} does not match k{tuple(k.shape)}")
    if hq // hkv > _MAX_GROUP or d > _MAX_D or s == 0:
        raise ValueError(
            f"decode_gqa_attention: needs Hq/Hkv <= {_MAX_GROUP}, head_dim <= {_MAX_D}, S > 0"
        )
    if tuple(mask.shape) != (b, s):
        raise ValueError(f"decode_gqa_attention: mask {tuple(mask.shape)} != {(b, s)}")
    for name, x in (("q", q), ("k", k), ("v", v), ("mask", mask)):
        if x.stride(-1) != 1:
            raise ValueError(f"decode_gqa_attention: {name}'s last dimension must be contiguous")


def decode_gqa_attention(q, k, v, mask):
    """Decode attention; returns ``(B,1,Hq,D)`` in q's dtype.

    CPU tensors run :func:`reference_decode_attention`; CUDA tensors launch
    ``csrc/decode_attention.cu`` (or raise).
    """
    global launches
    if q.device.type == "cpu":
        return reference_decode_attention(q, k, v, mask)
    _check(q, k, v, mask)
    b, _, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, 1, hq, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 11)(
        q.stride(0), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(2),
        mask.stride(0),
    )
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            _Q_DTYPES[q.dtype], _KV_DTYPES[k.dtype], b, s, hq, hkv, d, strides, stream,
        )
    if rc != 0:
        raise RuntimeError(f"decode attention kernel launch failed: cudaError_t {rc}")
    launches += 1
    return out
