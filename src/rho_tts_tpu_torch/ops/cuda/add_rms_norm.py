"""Residual add + RMSNorm: a hand-written Hopper kernel and its plain version.

No counterpart in the JAX package, which writes ``rms_norm`` and the
block's residual adds as jnp code and leaves them to XLA's fusion. Eager
PyTorch runs :func:`reference_rms_norm` as eight launches and an add as one
more; the talker block (``models.transformer``) has two norms a layer, each
after a residual add, so the port fuses the pair.

Kernel: ``csrc/add_rms_norm.cu``. bf16 ``x (..., D)`` read through its
strides (the QK-norm's heads are views of the QKV projection's output), an
optional bf16 ``delta`` of x's shape, the f32 weight ``(D,)`` and a scale on
``delta`` (a talker's residual multiplier; 1 by default): ``res = x + scale
* delta`` in f32 (the product rounded, then the sum), rounded once to bf16,
as PyTorch's add of two bf16 tensors rounds it where the scale is 1 (the
new residual stream), and the RMSNorm of ``res`` in
:func:`reference_rms_norm`'s order of arithmetic, one rounding to bf16 at
the end. Rows of up to ``MAX_D`` values (the Mamba mixer's gated norm has
8,192). The mean's sum runs in
another order than PyTorch's reduction, so the normed output can differ
from the plain chain by one bf16 unit in the last place where two f32 sums
round apart; ``res`` is bit-equal.

:func:`reference_add_rms_norm` is the plain version: the add, then
:func:`reference_rms_norm`, the chain the block ran before the kernel.

Dispatch: CPU tensors take :func:`reference_add_rms_norm`; CUDA tensors
launch the kernel or raise. Inputs that require grad under grad mode raise
on either device (``check_no_autograd``): the kernel has no backward.
``launches`` counts the kernel's launches, not those recorded into a CUDA
graph under capture, which run when the graph is replayed.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ...utils import profiling
from . import _build, check_no_autograd

#: number of times the CUDA kernel was launched
launches = 0

MAX_D = 8192  # row length the kernel takes at most (a multiple of 8)


def reference_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain PyTorch RMSNorm over the last dim: the f32 value, the mean of its
    squares, ``rsqrt(var + eps)``, ``* x``, ``* weight``, cast to x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight).to(x.dtype)


def reference_add_rms_norm(x: torch.Tensor, delta: Optional[torch.Tensor],
                           weight: torch.Tensor, eps: float,
                           scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``(res, rms_norm(res))`` with ``res = x + scale *
    delta`` (x itself where ``delta`` is None): in f32, rounded once to x's
    dtype (PyTorch's own add where the scale is 1)."""
    if delta is not None:
        x = x + delta if scale == 1.0 else (x.float() + delta.float() * scale).to(x.dtype)
    return x, reference_rms_norm(x, weight, eps)


_fn = None
_plans: Dict[tuple, tuple] = {}


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("add_rms_norm").rho_add_rms_norm
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 4
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        _fn = fn
    return _fn


def row_view(x: torch.Tensor, what: str) -> Tuple[int, int, int, int]:
    """``(rows, groups, row stride, group stride)``: x's leading dims as at most
    two strided dims, x being ``(rows, groups, D)`` at those element strides
    with its last dim contiguous. Dims of one drop out; a dim merges into the
    one before it where their strides chain. Raises where more than two
    remain (the caller can make x contiguous)."""
    if x.dim() < 1 or (x.shape[-1] > 1 and x.stride(-1) != 1):
        raise ValueError(f"{what}: the last dim of x must be contiguous")
    dims = []
    for n, s in zip(x.shape[:-1], x.stride()[:-1]):
        if n == 1:
            continue
        if dims and dims[-1][1] == n * s:
            dims[-1] = (dims[-1][0] * n, s)
        else:
            dims.append((n, s))
    if len(dims) > 2:
        raise ValueError(f"{what}: x{tuple(x.shape)} at strides {x.stride()} is not "
                         f"(rows, groups, D) at two strides")
    dims = [(1, 0)] * (2 - len(dims)) + dims
    return dims[0][0], dims[1][0], dims[0][1], dims[1][1]


def _check(x, delta, weight):
    """Raise on what the kernel does not take: dtypes, shapes and layout
    first, the device last. Returns x's ``row_view``."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"add_rms_norm: x must be bfloat16, got {x.dtype}")
    if delta is not None and delta.dtype != torch.bfloat16:
        raise TypeError(f"add_rms_norm: delta must be bfloat16, got {delta.dtype}")
    if weight.dtype != torch.float32:
        raise TypeError(f"add_rms_norm: weight must be float32, got {weight.dtype}")
    d = x.shape[-1] if x.dim() else 0
    if not (8 <= d <= MAX_D and d % 8 == 0):
        raise ValueError(f"add_rms_norm: rows of {d}; the kernel takes multiples of 8 up to "
                         f"{MAX_D}")
    if x.numel() == 0:
        raise ValueError("add_rms_norm: x has no rows")
    if tuple(weight.shape) != (d,) or not weight.is_contiguous():
        raise ValueError(f"add_rms_norm: weight{tuple(weight.shape)} is not a contiguous ({d},)")
    if delta is not None and (delta.shape != x.shape or not delta.is_contiguous()):
        raise ValueError(f"add_rms_norm: delta{tuple(delta.shape)} is not a contiguous "
                         f"{tuple(x.shape)}")
    rows, groups, sr, sg = row_view(x, "add_rms_norm")
    if sr % 8 or sg % 8:
        raise ValueError(f"add_rms_norm: x's strides {x.stride()} must be multiples of 8")
    for name, t in (("x", x), ("delta", delta), ("weight", weight)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"add_rms_norm: {name} must be 16-byte aligned")
    dev = x.device
    if not (x.is_cuda and weight.device == dev and (delta is None or delta.device == dev)):
        raise ValueError("add_rms_norm: x, delta and weight must share one CUDA device")
    return rows, groups, sr, sg


def add_rms_norm(x: torch.Tensor, delta: Optional[torch.Tensor], weight: torch.Tensor,
                 eps: float, scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(res, rms_norm(res))`` with ``res = x + scale * delta`` (x itself
    where ``delta`` is None), both bf16 and contiguous on a card.

    CPU tensors run :func:`reference_add_rms_norm`; CUDA tensors launch
    ``csrc/add_rms_norm.cu`` (or raise).
    """
    global launches
    check_no_autograd("add_rms_norm", "reference_add_rms_norm",
                      *(t for t in (x, delta, weight) if t is not None))
    if x.device.type == "cpu":
        return reference_add_rms_norm(x, delta, weight, eps, scale)
    with profiling.region("kernels/add_rms_norm"):
        key = (x.shape, x.stride(), x.dtype, x.device,
               None if delta is None else (delta.shape, delta.stride(), delta.dtype, delta.device),
               weight.shape, weight.stride(), weight.dtype, weight.device)
        args = _plans.get(key)
        if args is None:
            args = (*_check(x, delta, weight), x.shape[-1])
            _plans[key] = args
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        res = x if delta is None else torch.empty(x.shape, dtype=x.dtype, device=x.device)
        dev = x.device.index
        # torch.cuda.current_stream(device).cuda_stream, without building a Stream
        stream = torch._C._cuda_getCurrentRawStream(dev)
        rc = _kernel()(x.data_ptr(), None if delta is None else delta.data_ptr(),
                       weight.data_ptr(), None if delta is None else res.data_ptr(),
                       out.data_ptr(), *args, float(eps), float(scale), dev, stream)
        if rc != 0:
            _check(x, delta, weight)  # names a per-call fault (alignment) if any
            raise RuntimeError(f"add_rms_norm kernel launch failed: cudaError_t {rc}")
        if not torch.cuda.is_current_stream_capturing():  # a graph's node runs on replay
            launches += 1
        return res, out
