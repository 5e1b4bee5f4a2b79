"""Rotary position embedding of q and k: a hand-written Hopper kernel and its
plain version.

No counterpart in the JAX package, which writes the rotation as jnp code
(``apply_rope``) and leaves it to XLA's fusion. Eager PyTorch runs
:func:`reference_rotate` as ten launches a tensor, twice a layer; the
kernel rotates q and k in one.

Kernel: ``csrc/rope_qk.cu``. bf16 ``q (B, T, Hq, D)`` and ``k (B, T, Hkv,
D)`` read through their strides (views of the QKV projection's output),
with the f32 tables ``cos``, ``sin`` broadcastable to ``(B, T, 1, D/2)``
(``models.transformer._rope_tables``): ``x1 cos - x2 sin`` and ``x2 cos +
x1 sin`` over the halves of each head, in f32, each product, difference and
sum rounded on its own, then one rounding to bf16. That is
:func:`reference_rotate`'s arithmetic, so the kernel's outputs are its bits.
q and k come back contiguous.

Dispatch: CPU tensors take :func:`reference_rope_qk`; CUDA tensors launch
the kernel or raise. Inputs that require grad under grad mode raise on
either device (``check_no_autograd``): the kernel has no backward.
``launches`` counts the kernel's launches, not those recorded into a CUDA
graph under capture, which run when the graph is replayed.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ...utils import profiling
from . import _build, check_no_autograd

#: number of times the CUDA kernel was launched
launches = 0


def reference_rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch rotation of the pairs ``(x[..., :D/2], x[..., D/2:])`` in
    f32, cast back to x's dtype (the Llama / Qwen convention)."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2 :].float()
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def reference_rope_qk(q, k, cos, sin) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: :func:`reference_rotate` of q, then of k."""
    return reference_rotate(q, cos, sin), reference_rotate(k, cos, sin)


_fn = None
_plans: Dict[tuple, tuple] = {}


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("rope_qk").rho_rope_qk
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 8
                       + [ctypes.c_int, ctypes.c_void_p])
        _fn = fn
    return _fn


def _strides(t: torch.Tensor, dims: int):
    """The first ``dims`` strides of t, 0 for a dim of one (never stepped)."""
    return [s if n > 1 else 0 for n, s in zip(t.shape[:dims], t.stride()[:dims])]


def _tables(q, cos, sin):
    """cos and sin as ``(B, T, D/2)`` views."""
    b, t, _, d = q.shape
    return cos.expand(b, t, 1, d // 2)[:, :, 0], sin.expand(b, t, 1, d // 2)[:, :, 0]


def _check(q, k, cos, sin):
    """Raise on what the kernel does not take: dtypes, shapes and layout
    first, the device last. Returns the launch's integer arguments."""
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16:
        raise TypeError(f"rope_qk: q and k must be bfloat16, got {q.dtype}/{k.dtype}")
    if cos.dtype != torch.float32 or sin.dtype != torch.float32:
        raise TypeError(f"rope_qk: cos and sin must be float32, got {cos.dtype}/{sin.dtype}")
    if q.dim() != 4 or k.dim() != 4 or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"rope_qk: q{tuple(q.shape)} and k{tuple(k.shape)} are not "
                         f"(B, T, H, D) of one B, T and D")
    b, t, hq, d = q.shape
    if b * t * hq == 0 or k.shape[2] == 0:
        raise ValueError("rope_qk: q and k have no rows")
    if d < 16 or d % 16:
        raise ValueError(f"rope_qk: head dim {d}; the kernel takes multiples of 16")
    if cos.shape != sin.shape:
        raise ValueError(f"rope_qk: cos{tuple(cos.shape)} and sin{tuple(sin.shape)} differ")
    try:
        cs, sn = _tables(q, cos, sin)
    except RuntimeError:
        raise ValueError(f"rope_qk: cos{tuple(cos.shape)} does not broadcast to "
                         f"({b}, {t}, 1, {d // 2})") from None
    for name, x, mult in (("q", q, 8), ("k", k, 8), ("cos", cs, 4), ("sin", sn, 4)):
        if x.stride(-1) != 1 or any(s % mult for s in _strides(x, x.dim() - 1)):
            raise ValueError(f"rope_qk: {name}'s last dim must be contiguous and its other "
                             f"strides multiples of {mult}, got {x.stride()}")
        if x.data_ptr() % 16:
            raise ValueError(f"rope_qk: {name} must be 16-byte aligned")
    if _strides(cs, 2) != _strides(sn, 2):
        raise ValueError("rope_qk: cos and sin must share their strides")
    dev = q.device
    if not (q.is_cuda and all(x.device == dev for x in (k, cos, sin))):
        raise ValueError("rope_qk: q, k, cos and sin must share one CUDA device")
    return (b, t, hq, k.shape[2], d, *_strides(q, 3), *_strides(k, 3), *_strides(cs, 2))


def rope_qk(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """q and k rotated by the tables ``cos``, ``sin``; contiguous on a card.

    CPU tensors run :func:`reference_rope_qk`; CUDA tensors launch
    ``csrc/rope_qk.cu`` (or raise).
    """
    global launches
    check_no_autograd("rope_qk", "reference_rope_qk", q, k, cos, sin)
    if q.device.type == "cpu":
        return reference_rope_qk(q, k, cos, sin)
    with profiling.region("kernels/rope_qk"):
        key = tuple((x.shape, x.stride(), x.dtype, x.device) for x in (q, k, cos, sin))
        args = _plans.get(key)
        if args is None:
            args = _check(q, k, cos, sin)
            _plans[key] = args
        qo = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        ko = torch.empty(k.shape, dtype=k.dtype, device=k.device)
        dev = q.device.index
        # torch.cuda.current_stream(device).cuda_stream, without building a Stream
        stream = torch._C._cuda_getCurrentRawStream(dev)
        rc = _kernel()(q.data_ptr(), k.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                       qo.data_ptr(), ko.data_ptr(), *args, dev, stream)
        if rc != 0:
            _check(q, k, cos, sin)  # names a per-call fault (alignment) if any
            raise RuntimeError(f"rope_qk kernel launch failed: cudaError_t {rc}")
        if not torch.cuda.is_current_stream_capturing():  # a graph's node runs on replay
            launches += 1
        return qo, ko
