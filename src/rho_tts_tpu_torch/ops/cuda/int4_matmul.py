"""Weight-only int4 matmul: a hand-written Hopper kernel and its plain version.

Counterpart of ``rho_tts_tpu/ops/pallas/int4_matmul.py``.

Kernel: ``csrc/int4_matmul.cu`` replaces the Pallas kernel
``_int4_matmul_call`` (``_kernel``). The weight is packed half-split (byte
i of a column holds row i in the low nibble and row i + K/2 in the high
nibble, signed, as ``models.quantization.pack_int4`` writes it); the kernel
unpacks the nibbles in registers, multiplies them by x and adds both halves
into ONE f32 accumulator, then applies the per-channel scale and rounds once
to x's dtype. It never writes a dequantized weight. At decode (M = 5) it is
bound by reading the packed bytes (1.9 us for (2048,6144) at 3.35 TB/s): a
split-K GEMV with a fixed-order reduction fills the card even at N = 2048.
At prefill (M = 640, bf16) it is bound by the bf16 operations: 64x64 tiles
of ``mma.sync`` m16n8k16 products. f32 inputs take the GEMV path at any M.

:func:`reference_int4_matmul` follows the same order of arithmetic: one
f32 dot of x against the unpacked (K,N) nibble matrix, then ``* s``, then
the cast. JAX's default path, ``dequant_matmul_reference``, instead rounds
each of its two half-dots to x's dtype before adding them; at bf16 the two
packages therefore differ by up to two bf16 roundings (at f32, by the
order of the sums only).

Dispatch: CPU tensors take :func:`reference_int4_matmul`; CUDA tensors
launch the kernel or raise. ``launches`` counts the kernel's launches. The
GEMV path's tickets are kept per (device, stream) and reset by the kernel
itself, so int4 products on several streams of one device do not share
them.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import _build

#: number of times the CUDA kernel was launched
launches = 0

_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def unpack_int4(q4: torch.Tensor) -> torch.Tensor:
    """(..., K/2, N) int8 -> (..., K, N) float32 of the signed nibble values:
    rows [0, K/2) from the low nibbles, [K/2, K) from the high ones."""
    w32 = q4.to(torch.int32)
    lo = (w32 << 28) >> 28  # sign-extended low nibble
    hi = w32 >> 4  # arithmetic shift: sign-extended high nibble
    return torch.cat([lo, hi], dim=-2).float()


def reference_int4_matmul(x, q4, s):
    """Plain PyTorch version: ``x (..., K)`` by packed ``q4 (K/2, N)``, scale ``s (N,)``.

    One f32 dot over the full K (both halves in one accumulator), ``* s``,
    then the cast to x's dtype.
    """
    acc = x.float() @ unpack_int4(q4)
    return (acc * s).to(x.dtype)


_fns = None
_tickets: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _kernel():
    global _fns
    if _fns is None:
        lib = _build.load("int4_matmul")
        fn = lib.rho_int4_matmul
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        ws = lib.rho_int4_workspace
        ws.restype = None
        ws.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)] * 2
        _fns = (fn, ws)
    return _fns


def _ticket_buffer(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The split-K tickets of launches on ``stream``: launches on one stream
    run in order and each leaves its tickets zero, so they can share them;
    each stream has its own, so launches on two streams never race."""
    key = (device, stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf


def _check(x2, q4, s):
    dev = x2.device
    if not (x2.is_cuda and q4.device == dev and s.device == dev):
        raise ValueError("int4_matmul: x, q4 and s must share one CUDA device")
    if x2.dtype not in _X_DTYPES:
        raise TypeError(f"int4_matmul: x must be float32 or bfloat16, got {x2.dtype}")
    if q4.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"int4_matmul: q4 must be int8 and s float32, got {q4.dtype}/{s.dtype}")
    if q4.dim() != 2 or x2.shape[1] != 2 * q4.shape[0]:
        raise ValueError(f"int4_matmul: x (..., {x2.shape[1]}) does not match packed "
                         f"q4{tuple(q4.shape)} (K = 2 * K/2)")
    kh, n = q4.shape
    if x2.shape[0] == 0 or kh == 0 or n == 0 or n % 4:
        raise ValueError(f"int4_matmul: needs M, K, N > 0 and N % 4 == 0; got "
                         f"{x2.shape[0]},{2 * kh},{n}")
    if tuple(s.shape) != (n,):
        raise ValueError(f"int4_matmul: s{tuple(s.shape)} != ({n},)")
    for name, t in (("x", x2), ("q4", q4), ("s", s)):
        if not t.is_contiguous():
            raise ValueError(f"int4_matmul: {name} must be contiguous")
    for name, t in (("x", x2), ("q4", q4)):
        if t.data_ptr() % 16:
            raise ValueError(f"int4_matmul: {name} must be 16-byte aligned")


def int4_matmul(x, q4, s):
    """``x (..., K) @ dequant(q4, s)`` -> ``(..., N)`` in x's dtype.

    CPU tensors run :func:`reference_int4_matmul`; CUDA tensors launch
    ``csrc/int4_matmul.cu`` (or raise).
    """
    global launches
    if x.device.type == "cpu":
        return reference_int4_matmul(x, q4, s)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    _check(x2, q4, s)
    m = x2.shape[0]
    kh, n = q4.shape
    fn, workspace = _kernel()
    work_floats, n_tickets = ctypes.c_longlong(0), ctypes.c_longlong(0)
    workspace(_X_DTYPES[x.dtype], m, kh, n, ctypes.byref(work_floats), ctypes.byref(n_tickets))
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        work = tickets = None
        if work_floats.value:
            work = torch.empty(work_floats.value, dtype=torch.float32, device=x.device)
            tickets = _ticket_buffer(x.device, stream, n_tickets.value)
        rc = fn(x2.data_ptr(), q4.data_ptr(), s.data_ptr(), out.data_ptr(),
                work.data_ptr() if work is not None else None,
                tickets.data_ptr() if tickets is not None else None,
                _X_DTYPES[x.dtype], m, kh, n, stream)
    if rc != 0:
        raise RuntimeError(f"int4 matmul kernel launch failed: cudaError_t {rc}")
    launches += 1
    return out.reshape(*lead, n)
