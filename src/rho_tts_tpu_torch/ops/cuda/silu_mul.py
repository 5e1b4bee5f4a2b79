"""SwiGLU's activation ``silu(gate) * up``: a hand-written Hopper kernel and its
plain version.

No counterpart in the JAX package, which writes ``jax.nn.silu(gate) * up``
as jnp code and leaves it to XLA's fusion. Eager PyTorch runs
:func:`reference_silu_mul` as five launches a layer; the kernel is one.

Kernel: ``csrc/silu_mul.cu``. bf16 ``gate`` and ``up`` of one shape,
contiguous (the gate and up projections' outputs): ``silu(float(gate)) *
float(up)`` in f32, ``silu(g) = g / (1 + exp(-g))`` with the formula,
roundings and math-library call of PyTorch's silu on the card, then one
rounding to bf16. That is :func:`reference_silu_mul`'s arithmetic on the
card, so the kernel's outputs are its bits there.

Dispatch: CPU tensors take :func:`reference_silu_mul`; CUDA tensors launch
the kernel or raise. Inputs that require grad under grad mode raise on
either device (``check_no_autograd``): the kernel has no backward.
``launches`` counts the kernel's launches, not those recorded into a CUDA
graph under capture, which run when the graph is replayed.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...utils import profiling
from . import _build, check_no_autograd

#: number of times the CUDA kernel was launched
launches = 0


def reference_silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: ``silu(gate)`` and ``up`` in f32, their product cast to
    gate's dtype."""
    return (F.silu(gate.float()) * up.float()).to(gate.dtype)


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("silu_mul").rho_silu_mul
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        _fn = fn
    return _fn


def _check(gate, up):
    """Raise on what the kernel does not take: dtypes, shapes and layout
    first, the device last."""
    if gate.dtype != torch.bfloat16 or up.dtype != torch.bfloat16:
        raise TypeError(f"silu_mul: gate and up must be bfloat16, got {gate.dtype}/{up.dtype}")
    if gate.shape != up.shape:
        raise ValueError(f"silu_mul: gate{tuple(gate.shape)} and up{tuple(up.shape)} differ")
    n = gate.numel()
    if n == 0 or n % 8:
        raise ValueError(f"silu_mul: {n} values; the kernel takes a positive multiple of 8")
    for name, t in (("gate", gate), ("up", up)):
        if not t.is_contiguous():
            raise ValueError(f"silu_mul: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"silu_mul: {name} must be 16-byte aligned")
    if not (gate.is_cuda and up.device == gate.device):
        raise ValueError("silu_mul: gate and up must share one CUDA device")


def silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up`` in gate's shape and dtype.

    CPU tensors run :func:`reference_silu_mul`; CUDA tensors launch
    ``csrc/silu_mul.cu`` (or raise).
    """
    global launches
    check_no_autograd("silu_mul", "reference_silu_mul", gate, up)
    if gate.device.type == "cpu":
        return reference_silu_mul(gate, up)
    with profiling.region("kernels/silu_mul"):
        if not (gate.dtype == up.dtype == torch.bfloat16 and gate.shape == up.shape
                and up.device == gate.device and gate.is_contiguous() and up.is_contiguous()):
            _check(gate, up)
        out = torch.empty(gate.shape, dtype=gate.dtype, device=gate.device)
        dev = gate.device.index
        # torch.cuda.current_stream(device).cuda_stream, without building a Stream
        stream = torch._C._cuda_getCurrentRawStream(dev)
        rc = _kernel()(gate.data_ptr(), up.data_ptr(), out.data_ptr(), gate.numel(), dev, stream)
        if rc != 0:
            _check(gate, up)  # names the fault (size, alignment, device) if any
            raise RuntimeError(f"silu_mul kernel launch failed: cudaError_t {rc}")
        if not torch.cuda.is_current_stream_capturing():  # a graph's node runs on replay
            launches += 1
        return out
