"""w8a8 matmul with a fused rescale: a hand-written Hopper kernel and its plain version.

Counterpart of ``rho_tts_tpu/ops/pallas/w8a8_matmul.py``.

Kernel: ``csrc/w8a8_matmul.cu`` replaces the Pallas kernel
``w8a8_matmul_kernel`` (``_kernel``). It computes int8 ``xq (M,K)`` times
int8 ``q (K,N)`` with an exact int32 accumulation, then
``(float(acc) * sx) * ws`` in f32 and one rounding to the output dtype.
The per-row activation quantize stays outside (``models.quantization``), as
in JAX. At the 1.7B prefill shapes (M = 640) it is bound by its int8
operations (8.1 us for (2048,6144) at 1979 TOP/s). Design: a TMA-fed s8
``wgmma`` mainloop with A and B swapped (the N-major weight is the register
A operand, gathered four k-consecutive bytes a register; xq the K-major
shared-memory B operand), rescale and cast fused into the epilogue
(:func:`plan` picks the token tile); N that TMA cannot take (N % 16 != 0)
runs 64x64 tiles of ``mma.sync`` m16n8k32 in the same library. The integer
sum is exact and the two f32 multiplies come in the plain version's order,
so kernel and plain version agree bit for bit. Unlike the Pallas kernel's
``shapes_ok``, any M is taken; K must be a multiple of 16 and N of 4.

Dispatch: CPU tensors take :func:`reference_w8a8_matmul`; CUDA tensors
launch the kernel or raise. ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build

#: number of times the CUDA kernel was launched
launches = 0

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reference_w8a8_matmul(xq, sx, q, ws, out_dtype):
    """Plain PyTorch version: the XLA expression of ``quantization._w8a8_matmul``.

    ``xq (M,K)`` int8, ``sx (M,1)`` f32, ``q (K,N)`` int8, ``ws (N,)`` f32.
    The dot runs in float64, where every product and partial sum of int8
    values is an exact integer (|acc| <= 127*127*K < 2**53), so it equals the
    int32 dot; then ``(acc.float() * sx) * ws`` and a cast to ``out_dtype``.
    """
    acc = xq.double() @ q.double()
    return ((acc.float() * sx) * ws).to(out_dtype)


_MM_COLS = 128  # output columns of a wgmma block


def plan(m: int, k: int, n: int, sms: int) -> int:
    """Tokens a block of the wgmma path: 128 where 128-token tiles already
    fill the SMs, else 64; 0 (the mma.sync path) where N % 16 != 0."""
    if n % 16:
        return 0
    return 128 if -(-n // _MM_COLS) * -(-m // 128) >= sms else 64


_fn = None
_sms: Dict[torch.device, int] = {}
_plans: Dict[tuple, tuple] = {}


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("w8a8_matmul").rho_w8a8_matmul
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        _fn = fn
    return _fn


def _check(xq, sx, q, ws, out_dtype):
    dev = xq.device
    if not (xq.is_cuda and sx.device == dev and q.device == dev and ws.device == dev):
        raise ValueError("w8a8_matmul: xq, sx, q and ws must share one CUDA device")
    if xq.dtype != torch.int8 or q.dtype != torch.int8:
        raise TypeError(f"w8a8_matmul: xq and q must be int8, got {xq.dtype}/{q.dtype}")
    if sx.dtype != torch.float32 or ws.dtype != torch.float32:
        raise TypeError(f"w8a8_matmul: sx and ws must be float32, got {sx.dtype}/{ws.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"w8a8_matmul: out_dtype must be float32 or bfloat16, got {out_dtype}")
    if xq.dim() != 2 or q.dim() != 2 or xq.shape[1] != q.shape[0]:
        raise ValueError(f"w8a8_matmul: bad shapes xq{tuple(xq.shape)} q{tuple(q.shape)}")
    m, k = xq.shape
    n = q.shape[1]
    if m == 0 or k % 16 or n % 4 or n == 0 or k == 0:
        raise ValueError(f"w8a8_matmul: needs M, N > 0, K % 16 == 0, N % 4 == 0; got {m},{k},{n}")
    if sx.numel() != m or tuple(ws.shape) != (n,):
        raise ValueError(f"w8a8_matmul: sx{tuple(sx.shape)} / ws{tuple(ws.shape)} do not match "
                         f"M={m}, N={n}")
    for name, t in (("xq", xq), ("sx", sx), ("q", q), ("ws", ws)):
        if not t.is_contiguous():
            raise ValueError(f"w8a8_matmul: {name} must be contiguous")
    for name, t in (("xq", xq), ("q", q)):
        if t.data_ptr() % 16:
            raise ValueError(f"w8a8_matmul: {name} must be 16-byte aligned")


def _plan(key, xq, sx, q, ws, out_dtype):
    """Checks and launch arguments of one call signature, computed once."""
    _check(xq, sx, q, ws, out_dtype)
    m, k = xq.shape
    n = q.shape[1]
    dev = xq.device
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    out = ((m, n), (_OUT_DTYPES[out_dtype], m, k, n, plan(m, k, n, _sms[dev]), dev.index))
    _plans[key] = out
    return out


def w8a8_matmul(xq, sx, q, ws, out_dtype):
    """``(xq @ q) * sx * ws`` -> ``(M,N)`` in ``out_dtype``.

    CPU tensors run :func:`reference_w8a8_matmul`; CUDA tensors launch
    ``csrc/w8a8_matmul.cu`` (or raise).
    """
    global launches
    if xq.device.type == "cpu":
        return reference_w8a8_matmul(xq, sx, q, ws, out_dtype)
    key = (xq.shape, xq.stride(), xq.dtype, xq.device, sx.shape, sx.stride(), sx.dtype,
           sx.device, q.shape, q.stride(), q.dtype, q.device, ws.shape, ws.stride(), ws.dtype,
           ws.device, out_dtype)
    p = _plans.get(key)
    if p is None:
        p = _plan(key, xq, sx, q, ws, out_dtype)
    out_shape, args = p
    out = torch.empty(out_shape, dtype=out_dtype, device=xq.device)
    # torch.cuda.current_stream(device).cuda_stream, without building a Stream
    stream = torch._C._cuda_getCurrentRawStream(args[-1])
    rc = _kernel()(xq.data_ptr(), sx.data_ptr(), q.data_ptr(), ws.data_ptr(), out.data_ptr(),
                   *args, stream)
    if rc != 0:
        _check(xq, sx, q, ws, out_dtype)  # names a per-call fault (alignment) if there is one
        raise RuntimeError(f"w8a8 matmul kernel launch failed: cudaError_t {rc}")
    launches += 1
    return out
