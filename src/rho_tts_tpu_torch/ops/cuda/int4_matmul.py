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
GEMV whose K-splits of one column tile form a thread block cluster and
merge their partial sums in split order through distributed shared memory
(:func:`plan_gemv` picks the tile width and the cluster). At prefill (M >
16, bf16) it is bound by the bf16 operations: a TMA-fed ``wgmma`` mainloop
with the unpacked weight as the register A operand (:func:`plan`). f32
inputs take the GEMV path at any M.

:func:`reference_int4_matmul` follows the same order of arithmetic: one
f32 dot of x against the unpacked (K,N) nibble matrix, then ``* s``, then
the cast. JAX's default path, ``dequant_matmul_reference``, instead rounds
each of its two half-dots to x's dtype before adding them; at bf16 the two
packages therefore differ by up to two bf16 roundings (at f32, by the
order of the sums only).

Dispatch: CPU tensors take :func:`reference_int4_matmul`; CUDA tensors
launch the kernel or raise. Inputs that require grad under grad mode raise on
either device (``check_no_autograd``): the kernel has no backward.
``launches`` counts the kernel's launches, not those recorded into a CUDA
graph under capture, which run when the graph is replayed. The
kernel keeps no state between launches, so products on several streams
never share anything.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ...utils import profiling
from . import _build, check_no_autograd

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


GEMV_MAX_M = 16  # bf16 rows up to which the GEMV path runs; f32 always takes it
MAX_CLUSTER = 8  # the portable thread block cluster size
_MIN_SPLIT_ROWS = 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_gemv(m: int, kh: int, n: int, sms: int) -> Tuple[int, int, int]:
    """``(ct, cluster, slice)`` of the GEMV for M rows, kh packed rows, N columns.

    ct is the column tile (bytes of a packed row a block reads), cluster the
    number of K-splits of one tile (the blocks of one thread block cluster),
    slice the packed rows of a split, a multiple of 16. The cluster is the
    largest up to ``MAX_CLUSTER`` that keeps 16 packed rows a split (more,
    shorter splits finish sooner: each block's copies, x and merge are a
    chain of latencies); the tile is 128 columns where that grid fills every
    SM, else 64. Split i covers packed rows ``[i*slice, min(kh,
    (i+1)*slice))``: every row exactly once, every split non-empty.
    """
    cluster = max(1, min(MAX_CLUSTER, kh // _MIN_SPLIT_ROWS))
    slice_ = _cdiv(_cdiv(kh, cluster), 16) * 16
    cluster = _cdiv(kh, slice_)
    tiles = (1 if m <= 16 else _cdiv(m, 8)) * cluster
    ct = 128 if _cdiv(n, 128) * tiles >= sms else 64
    return ct, cluster, slice_


def plan(x_dtype: torch.dtype, m: int, kh: int, n: int, sms: int) -> tuple:
    """The kernel's launch plan: ``("wgmma", bt)`` for bf16 x with M > 16
    (kh % 8 == 0, N % 16 == 0, as TMA needs): blocks of 128 columns by
    ``bt`` tokens, 128, or 64 for M <= 64; otherwise ``("gemv", ct,
    cluster, slice)`` from :func:`plan_gemv`. ``sms`` is the card's count
    of streaming multiprocessors."""
    if x_dtype == torch.bfloat16 and m > GEMV_MAX_M and kh % 8 == 0 and n % 16 == 0:
        return ("wgmma", 128 if m > 64 else 64)
    return ("gemv",) + plan_gemv(m, kh, n, sms)


_fn = None
_sms: Dict[torch.device, int] = {}
_plans: Dict[tuple, tuple] = {}


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("int4_matmul").rho_int4_matmul
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        _fn = fn
    return _fn


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


def _plan(key, x, q4, s):
    """Checks and launch arguments of one call signature, computed once:
    the decode loop calls with the same shapes 140 times a step."""
    x2 = x.reshape(-1, x.shape[-1])
    _check(x2, q4, s)
    if not x.is_contiguous():
        raise ValueError("int4_matmul: x must be contiguous")
    m = x2.shape[0]
    kh, n = q4.shape
    dev = x.device
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    p = plan(x.dtype, m, kh, n, _sms[dev])
    bt, ct, cluster, slice_ = (p[1], 0, 0, 0) if p[0] == "wgmma" else (0, *p[1:])
    out = ((*x.shape[:-1], n), (_X_DTYPES[x.dtype], m, kh, n, bt, ct, cluster, slice_, dev.index))
    _plans[key] = out
    return out


def int4_matmul(x, q4, s):
    """``x (..., K) @ dequant(q4, s)`` -> ``(..., N)`` in x's dtype.

    CPU tensors run :func:`reference_int4_matmul`; CUDA tensors launch
    ``csrc/int4_matmul.cu`` (or raise).
    """
    global launches
    check_no_autograd("int4_matmul", "reference_int4_matmul", x, s)
    if x.device.type == "cpu":
        return reference_int4_matmul(x, q4, s)
    with profiling.region("kernels/int4_matmul"):
        key = (x.shape, x.stride(), x.dtype, x.device, q4.shape, q4.stride(), q4.dtype, q4.device,
               s.shape, s.stride(), s.dtype, s.device)
        p = _plans.get(key)
        if p is None:
            p = _plan(key, x, q4, s)
        out_shape, args = p
        out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
        # torch.cuda.current_stream(device).cuda_stream, without building a Stream
        stream = torch._C._cuda_getCurrentRawStream(args[-1])
        rc = _kernel()(x.data_ptr(), q4.data_ptr(), s.data_ptr(), out.data_ptr(), *args, stream)
        if rc != 0:
            _check(x.reshape(-1, x.shape[-1]), q4, s)  # names a per-call fault (alignment) if any
            raise RuntimeError(f"int4 matmul kernel launch failed: cudaError_t {rc}")
        if not torch.cuda.is_current_stream_capturing():  # a graph's node runs on replay
            launches += 1
        return out
