"""Single-token GQA decode attention: a hand-written Hopper kernel and its plain version.

Counterpart of ``rho_tts_tpu/ops/pallas/decode_attention.py``.

Kernel: ``csrc/decode_attention.cu`` replaces the Pallas kernel
``decode_gqa_attention`` (``_decode_kernel``). In the JAX package that
kernel is opt-in; in the port it is the attention of every decode step. At
the 1.7B main-path shape (q ``(5,1,16,128)`` bf16, a ``(5,384,8,128)`` bf16
cache per layer) it is bound by reading K and V (~7.9 MB, ~2.3 us at
3.35 TB/s, less where masked slots are skipped). Design: split-S
(flash-decoding). :func:`plan_splits` cuts S into slices of at most 64
keys so that the grid ``(splits, Hkv, B)`` holds at least two blocks per
SM; each block loads its whole K/V slice with 16-byte asynchronous copies,
skips masked keys of rows that have a valid key (their probability is
exactly 0), and the last block of each (row, KV head) merges the per-split
softmax states in split order, so the result is the same bits on every
launch. K/V are converted to f32 as they are used (f32, bf16 or float8
e4m3 storage) and the probabilities stay f32, as in the Pallas kernel and
:func:`reference_decode_attention` (JAX's default einsum path casts
probabilities to bf16 for f8 caches only).

Dispatch: CPU tensors take :func:`reference_decode_attention`; CUDA tensors
launch the kernel or raise. Inputs that require grad under grad mode raise on
either device (``check_no_autograd``): the kernel has no backward.
``launches`` counts the kernel's launches, not those recorded into a CUDA
graph under capture, which run when the graph is replayed. The merge's
workspace and tickets are kept per (device, stream) and the tickets reset
themselves, so launches on several streams of one device do not share them.
A graph that captured launches replays them over the workspace of the
stream it was captured on (:func:`workspace`): it keeps that workspace, and
replays on that one stream.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from ...utils import profiling
from . import _build, check_no_autograd

#: number of times the CUDA kernel was launched
launches = 0

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
_MAX_GROUP = 8
_MAX_D = 128
MAX_SLICE = 64  # keys per block: the kernel's shared-memory slice
_MIN_SLICE = 16


def reference_decode_attention(q, k, v, mask, scale=None):
    """Plain PyTorch version; same semantics as the JAX reference.

    q ``(B,1,Hq,D)``, k/v ``(B,S,Hkv,D)`` in any float storage (converted to
    f32), mask ``(B,S)`` bool, the complete key validity; ``scale``
    multiplies the scores (None: ``1 / sqrt(D)``). Returns ``(B,1,Hq,D)`` in
    q's dtype.
    """
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, t, hkv, group, d).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    scores = scores.masked_fill(~mask[:, None, None, None, :].bool(), -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, t, hq, d).to(q.dtype)


def plan_splits(s: int, units: int, sms: int) -> Tuple[int, int]:
    """``(splits, slice)`` for S keys and ``units`` = B * Hkv (row, KV head) pairs.

    The slice is the largest multiple of 8 keys, from 16 to ``MAX_SLICE``,
    that still gives ``splits * units`` two blocks for every SM; where even
    slices of 16 keys cannot, slices of 16. Split i covers keys ``[i*slice,
    min(S, (i+1)*slice))``: every key exactly once, every split non-empty.
    """
    want = _cdiv(2 * sms, units)
    slice_ = min(MAX_SLICE, max(_MIN_SLICE, s // want // 8 * 8))
    return _cdiv(s, slice_), slice_


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


_fns = None
_sms: Dict[torch.device, int] = {}
_plans: Dict[tuple, tuple] = {}
_buffers: Dict[Tuple[torch.device, int], tuple] = {}


def _kernel():
    global _fns
    if _fns is None:
        lib = _build.load("decode_attention")
        fn = lib.rho_decode_attention
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        ws = lib.rho_decode_workspace
        ws.restype = None
        ws.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)] * 2
        _fns = (fn, ws)
    return _fns


def _workspace(device: torch.device, stream: int, floats: int, tickets: int) -> Tuple[int, int]:
    """Pointers to the merge's f32 workspace and tickets for launches on
    ``stream``: launches on one stream run in order and each leaves its
    tickets zero, so they can share them; each stream has its own."""
    key = (device, stream)
    buf = _buffers.get(key)
    if buf is None or buf[0].numel() < floats or buf[1].numel() < tickets:
        work = torch.empty(max(floats, 1 << 16), dtype=torch.float32, device=device)
        ticket = torch.zeros(max(tickets, 1024), dtype=torch.int32, device=device)
        buf = (work, ticket, work.data_ptr(), ticket.data_ptr())
        _buffers[key] = buf
    return buf[2], buf[3]


def workspace(device: torch.device, stream: "torch.cuda.Stream") -> tuple:
    """The merge's workspace and tickets that launches on ``stream`` use now
    (none before the first): a CUDA graph captured on ``stream`` holds them,
    as a larger call would replace them."""
    buf = _buffers.get((device, stream.cuda_stream))
    return () if buf is None else buf[:2]


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


def _plan(key, q, k, v, mask):
    """Checks, splits, workspace sizes and the strides array of one call
    signature, computed once: the decode loop calls with the same shapes
    28 times a step."""
    _check(q, k, v, mask)
    b, _, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    dev = q.device
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, slice_ = plan_splits(s, b * hkv, _sms[dev])
    floats, tickets = ctypes.c_longlong(0), ctypes.c_longlong(0)
    _kernel()[1](b, hq, hkv, d, splits, ctypes.byref(floats), ctypes.byref(tickets))
    # out is allocated contiguous (B,1,Hq,D): its strides are (Hq*D, _, D, 1).
    strides = (ctypes.c_longlong * 11)(
        q.stride(0), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        hq * d, d,
        mask.stride(0),
    )
    plan = (
        (b, 1, hq, d), dev.index, floats.value, tickets.value,
        (_Q_DTYPES[q.dtype], _KV_DTYPES[k.dtype], b, s, hq, hkv, d, splits, slice_, strides),
    )
    _plans[key] = plan
    return plan


def decode_gqa_attention(q, k, v, mask, scale=None):
    """Decode attention; returns ``(B,1,Hq,D)`` in q's dtype. ``scale``
    multiplies the scores (None: ``1 / sqrt(D)``, which the kernel computes
    as it always has).

    CPU tensors run :func:`reference_decode_attention`; CUDA tensors launch
    ``csrc/decode_attention.cu`` (or raise).
    """
    global launches
    check_no_autograd("decode_gqa_attention", "reference_decode_attention", q, k, v)
    if q.device.type == "cpu":
        return reference_decode_attention(q, k, v, mask, scale)
    with profiling.region("kernels/decode_attention"):
        key = (q.shape, q.stride(), q.dtype, q.device, k.shape, k.stride(), k.dtype, k.device,
               v.shape, v.stride(), v.dtype, v.device, mask.shape, mask.stride(), mask.dtype,
               mask.device)
        plan = _plans.get(key)
        if plan is None:
            plan = _plan(key, q, k, v, mask)
        out_shape, dev_index, floats, n_tickets, args = plan
        out = torch.empty(out_shape, dtype=q.dtype, device=q.device)
        # torch.cuda.current_stream(device).cuda_stream, without building a Stream
        stream = torch._C._cuda_getCurrentRawStream(dev_index)
        work = tickets = None
        if floats:
            work, tickets = _workspace(q.device, stream, floats, n_tickets)
        rc = _kernel()[0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(), work,
            tickets, *args, 0.0 if scale is None else float(scale), dev_index, stream,
        )
        if rc != 0:
            raise RuntimeError(f"decode attention kernel launch failed: cudaError_t {rc}")
        if not torch.cuda.is_current_stream_capturing():  # a graph's node runs on replay
            launches += 1
        return out
