"""Single-token GQA decode attention: a hand-written Hopper kernel and its plain version.

Counterpart of ``rho_tts_tpu/ops/pallas/decode_attention.py``.

Kernel: ``csrc/decode_attention.cu`` replaces the Pallas kernel
``decode_gqa_attention`` (``_decode_kernel``). In the JAX package that
kernel is opt-in; in the port it is the attention of every decode step. At
the Qwen cells' shape (q ``(8,1,16,128)`` bf16, a ``(8,448,8,128)`` bf16
cache per layer, ~280 valid keys a row) it is bound by reading the valid
keys' K and V (~9.2 MB, ~2.7 us at 3.35 TB/s). Design: each (row, KV head)
is one thread block cluster of :func:`plan_clusters` blocks (1, 2, 4 or
8); block r reads its keys' mask bytes, then walks the valid keys of
``[r*S/C, (r+1)*S/C)`` (:func:`block_keys`) in tiles of 32 through an
asynchronous copy ring with an online softmax, and the blocks merge their
softmax states in rank order through distributed shared memory, so the
result is the same bits on every launch. K/V are converted to f32 as they are used (f32, bf16 or
float8 e4m3 storage) and the probabilities stay f32, as in the Pallas kernel
and :func:`reference_decode_attention` (JAX's default einsum path casts
probabilities to bf16 for f8 caches only).

Dispatch: CPU tensors take :func:`reference_decode_attention`; CUDA tensors
launch the kernel or raise. Inputs that require grad under grad mode raise on
either device (``check_no_autograd``): the kernel has no backward.
``launches`` counts the kernel's launches, and ``cluster_launches`` those of
them with more than one block a (row, KV head), not those recorded into a
CUDA graph under capture, which run when the graph is replayed. The kernel
keeps no state between launches.
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
#: of them, launches with more than one block a (row, KV head): a cluster each
cluster_launches = 0

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
_MAX_GROUP = 8
_MAX_D = 128
MAX_CLUSTER = 8  # blocks a (row, KV head): the portable cluster size
MIN_KEYS = 16  # keys a block at least, where S allows
MAX_BLOCK_KEYS = 65536  # keys a block at most: its mask in shared memory
MAX_S = MAX_CLUSTER * MAX_BLOCK_KEYS
#: keys a block walks at least for clusters that run in waves to beat half
#: as many blocks (H100, 64 pairs of row and KV head: at S = 2,112, clusters
#: of 8 in waves 39.3 us, of 4 all at once 46.5; at S = 448, of 8 all at
#: once 11.6, of 4 14.3, of 8 in waves, their registers uncapped, 21.8)
LONG_BLOCK = 128


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


def plan_clusters(s: int, units: int, sms: int, fits=None) -> int:
    """C, the blocks of each (row, KV head), for S keys and ``units`` = B * Hkv.

    The smallest of 1, 2, 4 and 8 that gives ``C * units`` two blocks for
    every one of ``sms`` SMs, and no more than leave every block
    ``MIN_KEYS`` keys or, where ``fits(c)`` says how many clusters of ``c``
    blocks fit on the card at once, than let all ``units`` clusters run at
    once, unless the blocks would still hold ``LONG_BLOCK`` keys; at least
    as many as keep a block within ``MAX_BLOCK_KEYS`` keys.
    """
    c = 1
    while c < MAX_CLUSTER and c * units < 2 * sms and 2 * c * MIN_KEYS <= s:
        if fits is not None:
            n = fits(2 * c)
            if n < units and not (n > 0 and s // (2 * c) >= LONG_BLOCK):
                break
        c *= 2
    while _cdiv(s, c) > MAX_BLOCK_KEYS:
        c *= 2
    return c


def block_keys(s: int, clusters: int, rank: int) -> Tuple[int, int]:
    """The keys ``[lo, hi)`` of block ``rank`` of a cluster of ``clusters``
    over S keys, as the kernel cuts them: every key in exactly one block, no
    block empty while ``clusters <= S``."""
    return rank * s // clusters, (rank + 1) * s // clusters


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


_fn = None
_sms: Dict[torch.device, int] = {}
_plans: Dict[tuple, tuple] = {}


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("decode_attention").rho_decode_attention
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        _fn = fn
    return _fn


def _clusters_fit(kv_dtype: int, s: int, hq: int, hkv: int, d: int, clusters: int,
                  device: int) -> int:
    """How many clusters of ``clusters`` blocks fit on the card at once
    (``cudaOccupancyMaxActiveClusters``; -1 if they cannot launch)."""
    fn = _build.load("decode_attention").rho_decode_clusters
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 7
    return fn(kv_dtype, s, hq, hkv, d, clusters, device)


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
    if hq // hkv > _MAX_GROUP or d > _MAX_D or not 0 < s <= MAX_S:
        raise ValueError(
            f"decode_gqa_attention: needs Hq/Hkv <= {_MAX_GROUP}, head_dim <= {_MAX_D}, "
            f"0 < S <= {MAX_S}"
        )
    if tuple(mask.shape) != (b, s):
        raise ValueError(f"decode_gqa_attention: mask {tuple(mask.shape)} != {(b, s)}")
    for name, x in (("q", q), ("k", k), ("v", v), ("mask", mask)):
        if x.stride(-1) != 1:
            raise ValueError(f"decode_gqa_attention: {name}'s last dimension must be contiguous")


def _plan(key, q, k, v, mask):
    """Checks, cluster size and the strides array of one call signature,
    computed once: the decode loop calls with the same shapes 28 times a
    step."""
    _check(q, k, v, mask)
    b, _, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    dev = q.device
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    kv_dtype = _KV_DTYPES[k.dtype]
    clusters = plan_clusters(s, b * hkv, _sms[dev], lambda c: _clusters_fit(
        kv_dtype, s, hq, hkv, d, c, dev.index))
    # out is allocated contiguous (B,1,Hq,D): its strides are (Hq*D, _, D, 1).
    strides = (ctypes.c_longlong * 11)(
        q.stride(0), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        hq * d, d,
        mask.stride(0),
    )
    plan = (
        (b, 1, hq, d), dev.index, clusters,
        (_Q_DTYPES[q.dtype], kv_dtype, b, s, hq, hkv, d, clusters, strides),
    )
    _plans[key] = plan
    return plan


def planned_clusters(q, k, v, mask) -> int:
    """C, the blocks a (row, KV head) that a launch on these CUDA tensors takes."""
    key = _key(q, k, v, mask)
    return (_plans.get(key) or _plan(key, q, k, v, mask))[2]


def _key(q, k, v, mask):
    return (q.shape, q.stride(), q.dtype, q.device, k.shape, k.stride(), k.dtype, k.device,
            v.shape, v.stride(), v.dtype, v.device, mask.shape, mask.stride(), mask.dtype,
            mask.device)


def decode_gqa_attention(q, k, v, mask, scale=None):
    """Decode attention; returns ``(B,1,Hq,D)`` in q's dtype. ``scale``
    multiplies the scores (None: ``1 / sqrt(D)``, which the kernel computes
    as it always has).

    CPU tensors run :func:`reference_decode_attention`; CUDA tensors launch
    ``csrc/decode_attention.cu`` (or raise).
    """
    global launches, cluster_launches
    check_no_autograd("decode_gqa_attention", "reference_decode_attention", q, k, v)
    if q.device.type == "cpu":
        return reference_decode_attention(q, k, v, mask, scale)
    with profiling.region("kernels/decode_attention"):
        key = _key(q, k, v, mask)
        plan = _plans.get(key)
        if plan is None:
            plan = _plan(key, q, k, v, mask)
        out_shape, dev_index, clusters, args = plan
        out = torch.empty(out_shape, dtype=q.dtype, device=q.device)
        # torch.cuda.current_stream(device).cuda_stream, without building a Stream
        stream = torch._C._cuda_getCurrentRawStream(dev_index)
        rc = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(), *args,
            0.0 if scale is None else float(scale), dev_index, stream,
        )
        if rc != 0:
            raise RuntimeError(f"decode attention kernel launch failed: cudaError_t {rc}")
        if not torch.cuda.is_current_stream_capturing():  # a graph's node runs on replay
            launches += 1
            cluster_launches += int(clusters > 1)
        return out
