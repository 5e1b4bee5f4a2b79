"""w8a8 matmul with a fused rescale: a hand-written Hopper kernel and its plain version.

Counterpart of ``rho_tts_tpu/ops/pallas/w8a8_matmul.py``.

Kernel: ``csrc/w8a8_matmul.cu`` replaces the Pallas kernel
``w8a8_matmul_kernel`` (``_kernel``). It computes int8 ``xq (M,K)`` times
int8 ``q (K,N)`` with an exact int32 accumulation, then
``(float(acc) * sx) * ws`` in f32 and one rounding to the output dtype.
The per-row activation quantize stays outside (``models.quantization``), as
in JAX. At the 1.7B prefill shapes (M = 640) it is bound by its int8
operations (8.1 us for (2048,6144) at 1979 TOP/s). Design: 64x64 tiles of
``mma.sync`` m16n8k32 s8 tensor-core products, B transposed into shared
memory in registers, rescale and cast fused into the epilogue. The integer
sum is exact and the two f32 multiplies come in the plain version's order,
so kernel and plain version agree bit for bit. Unlike the Pallas kernel's
``shapes_ok``, any M is taken; K must be a multiple of 16 and N of 4.

Dispatch: CPU tensors take :func:`reference_w8a8_matmul`; CUDA tensors
launch the kernel or raise. ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

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


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("w8a8_matmul").rho_w8a8_matmul
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
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


def w8a8_matmul(xq, sx, q, ws, out_dtype):
    """``(xq @ q) * sx * ws`` -> ``(M,N)`` in ``out_dtype``.

    CPU tensors run :func:`reference_w8a8_matmul`; CUDA tensors launch
    ``csrc/w8a8_matmul.cu`` (or raise).
    """
    global launches
    if xq.device.type == "cpu":
        return reference_w8a8_matmul(xq, sx, q, ws, out_dtype)
    _check(xq, sx, q, ws, out_dtype)
    m, k = xq.shape
    n = q.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    fn = _kernel()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        rc = fn(xq.data_ptr(), sx.data_ptr(), q.data_ptr(), ws.data_ptr(), out.data_ptr(),
                _OUT_DTYPES[out_dtype], m, k, n, stream)
    if rc != 0:
        raise RuntimeError(f"w8a8 matmul kernel launch failed: cudaError_t {rc}")
    launches += 1
    return out
