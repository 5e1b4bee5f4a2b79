"""Weight-only int8 GEMV: a hand-written Hopper kernel and its plain version.

No counterpart in the JAX package, whose weight-only int8 matmul is
``x @ q.astype(x.dtype)`` then the scale, left to XLA, which fuses the
convert into the dot. Eager PyTorch writes a bf16 copy of the weight for
that expression on every call, so the port has its own kernel for the int8
matmuls of few rows (the decode step; ``models.quantization.matmul`` sends
them here).

Kernel: ``csrc/int8_gemv.cu``. bf16 ``x (..., K)`` with at most
``MAX_ROWS`` rows in all, times ``q (K, N)`` int8 in its stored layout, with
the per-output-channel f32 scale ``s (N,)``: one f32 accumulation of the
products on the tensor cores (``mma.sync`` m16n8k16, A and B swapped), the
weight converted to bf16 in registers, ``* s`` in the epilogue, one
rounding to bf16. The weight is read once (12.6 MB for (2048, 6144): 3.8 us
at 3.35 TB/s), straight into registers, by one wave of blocks; the K-splits
of a column tile merge in split order inside a thread block cluster
(:func:`plan`).

:func:`reference_int8_gemv` follows the same order of arithmetic: one f32
dot of x against q, then ``* s``, then the cast. The dequant route it
replaces rounds twice (the bf16 GEMM's output, then the scaled result).

Dispatch: CPU tensors take :func:`reference_int8_gemv`; CUDA tensors launch
the kernel or raise. Inputs that require grad under grad mode raise on
either device (``check_no_autograd``): the kernel has no backward.
``launches`` counts the kernel's launches, not those recorded into a CUDA
graph under capture, which run when the graph is replayed. The kernel
keeps no state between launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ...utils import profiling
from . import _build, check_no_autograd

#: number of times the CUDA kernel was launched
launches = 0

MAX_ROWS = 64  # rows of x in all (8 tiles of 8)
COLS = 128  # output columns a block
STEP_ROWS = 16  # weight rows a step (one mma k)
#: K-splits of a column tile at most: clusters of 8 blocks ran slower than
#: of 6 or fewer at every decode shape measured on an H100
MAX_SPLITS = 6


def reference_int8_gemv(x, q, s):
    """Plain PyTorch version: ``x (..., K)`` by ``q (K, N)`` int8, scale ``s (N,)``.

    One f32 dot, ``* s``, then the cast to x's dtype.
    """
    return ((x.float() @ q.float()) * s).to(x.dtype)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(k: int, n: int, sms: int, fits=None) -> Tuple[int, int]:
    """``(splits, slice)`` of the launch for K, N and ``sms`` SMs.

    A block owns 128 columns and one of ``splits`` K-splits (the blocks of
    one cluster) of ``slice`` rows, a multiple of 16. Splits are as many as
    keep the grid within one block an SM (one wave: every load can be in
    flight at once), up to ``MAX_SPLITS``, and, where ``fits(splits)`` says
    how many clusters of that size fit on the card at once (for the rows of
    x at hand), as many as let every column tile's cluster fit. One split is
    no cluster. Split i covers rows ``[i*slice,
    min(K, (i+1)*slice))``: every row once, every split non-empty.
    """
    col_tiles = _cdiv(n, COLS)
    best = (1, _cdiv(k, STEP_ROWS) * STEP_ROWS)
    for want in range(2, MAX_SPLITS + 1):
        slice_ = _cdiv(_cdiv(k, want), STEP_ROWS) * STEP_ROWS
        splits = _cdiv(k, slice_)
        if col_tiles * splits > sms or (fits is not None and fits(splits) < col_tiles):
            break
        best = (splits, slice_)
    return best


_fn = None
_sms: Dict[torch.device, int] = {}
_plans: Dict[tuple, tuple] = {}


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("int8_gemv").rho_int8_gemv
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        _fn = fn
    return _fn


def _clusters(m: int, splits: int, device: int) -> int:
    """How many clusters of ``splits`` blocks for M rows fit on the card at
    once (``cudaOccupancyMaxActiveClusters``; -1 if they cannot launch)."""
    fn = _build.load("int8_gemv").rho_int8_gemv_clusters
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    return fn(m, splits, device)


def _check(x2, q, s):
    """Raise on what the kernel does not take: dtypes, shapes and layout
    first, the device last."""
    if x2.dtype != torch.bfloat16:
        raise TypeError(f"int8_gemv: x must be bfloat16, got {x2.dtype}")
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"int8_gemv: q must be int8 and s float32, got {q.dtype}/{s.dtype}")
    if q.dim() != 2 or x2.shape[1] != q.shape[0]:
        raise ValueError(f"int8_gemv: x (..., {x2.shape[1]}) does not match q{tuple(q.shape)}")
    m = x2.shape[0]
    k, n = q.shape
    if not 1 <= m <= MAX_ROWS:
        raise ValueError(f"int8_gemv: x has {m} rows; the kernel takes 1 to {MAX_ROWS}")
    if k == 0 or n == 0 or k % 8 or n % 16:
        raise ValueError(f"int8_gemv: needs K % 8 == 0 and N % 16 == 0 (both > 0); got {k},{n}")
    if tuple(s.shape) != (n,):
        raise ValueError(f"int8_gemv: s{tuple(s.shape)} != ({n},)")
    for name, t in (("x", x2), ("q", q), ("s", s)):
        if not t.is_contiguous():
            raise ValueError(f"int8_gemv: {name} must be contiguous")
    for name, t in (("x", x2), ("q", q)):
        if t.data_ptr() % 16:
            raise ValueError(f"int8_gemv: {name} must be 16-byte aligned")
    dev = x2.device
    if not (x2.is_cuda and q.device == dev and s.device == dev):
        raise ValueError("int8_gemv: x, q and s must share one CUDA device")


def _plan(key, x, q, s):
    """Checks and launch arguments of one call signature, computed once:
    the decode step calls with the same shapes 140 times."""
    if not x.is_contiguous():
        raise ValueError("int8_gemv: x must be contiguous")
    x2 = x.reshape(-1, x.shape[-1])
    _check(x2, q, s)
    m = x2.shape[0]
    k, n = q.shape
    dev = x.device
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    p = plan(k, n, _sms[dev], lambda splits: _clusters(m, splits, dev.index))
    out = ((*x.shape[:-1], n), (m, k, n, *p, dev.index))
    _plans[key] = out
    return out


def int8_gemv(x, q, s):
    """``x (..., K) @ (q * s)`` -> ``(..., N)`` in bf16, x bf16 of at most
    ``MAX_ROWS`` rows in all.

    CPU tensors run :func:`reference_int8_gemv`; CUDA tensors launch
    ``csrc/int8_gemv.cu`` (or raise).
    """
    global launches
    check_no_autograd("int8_gemv", "reference_int8_gemv", x, s)
    if x.device.type == "cpu":
        return reference_int8_gemv(x, q, s)
    with profiling.region("kernels/int8_gemv"):
        key = (x.shape, x.stride(), x.dtype, x.device, q.shape, q.stride(), q.dtype, q.device,
               s.shape, s.stride(), s.dtype, s.device)
        p = _plans.get(key)
        if p is None:
            p = _plan(key, x, q, s)
        out_shape, args = p
        out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
        # torch.cuda.current_stream(device).cuda_stream, without building a Stream
        stream = torch._C._cuda_getCurrentRawStream(args[-1])
        rc = _kernel()(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), *args, stream)
        if rc != 0:
            _check(x.reshape(-1, x.shape[-1]), q, s)  # names a per-call fault (alignment) if any
            raise RuntimeError(f"int8 GEMV kernel launch failed: cudaError_t {rc}")
        if not torch.cuda.is_current_stream_capturing():  # a graph's node runs on replay
            launches += 1
        return out
