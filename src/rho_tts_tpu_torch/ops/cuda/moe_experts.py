"""Routed experts of a decode step: a hand-written Hopper kernel and its plain version.

No counterpart in the JAX package, which has no expert layer.

Kernel: ``csrc/moe_experts.cu``, two launches a call: gate/up with SiLU.mul
into ``act`` ``(rows * topk, F)`` bf16, then down into ``partial``
``(rows * topk, H)`` f32, each slot times its routing weight; the wrapper sums
each row's ``topk`` slots in slot order. A block owns one expert and one
column tile, and reads nothing of its expert where no row chose it, so a
step reads only the experts its rows touched, each once for up to 8 of its
rows. Any number of rows: a block scans the choices 512 slots at a time.
The gate/up launch also writes, into an optional ``touched`` ``(E,)``
int32, 1 for each expert some row chose and 0 for the others. No host
value is read, so a decode step that calls it can be captured in a CUDA
graph.

Dispatch: CPU tensors take :func:`grouped_experts`; CUDA tensors launch the
kernel or raise. :func:`grouped_experts` is also the prefill's path on either
device: it groups the slots by expert after one host read of the counts.
Inputs that require grad under grad mode raise on either device
(``check_no_autograd``). ``launches`` counts the kernel's launches (two a
call), not those recorded into a CUDA graph under capture.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...utils import profiling
from . import _build, check_no_autograd

#: number of times the CUDA kernels were launched (two a call)
launches = 0


def grouped_experts(x, idx, weight, w_gate, w_up, w_down, touched=None):
    """Plain PyTorch version: the experts grouped by expert.

    ``x`` ``(N, H)``, ``idx`` ``(N, topk)`` integer experts, ``weight``
    ``(N, topk)`` f32, ``w_gate`` / ``w_up`` ``(E, H, F)``, ``w_down``
    ``(E, F, H)``. Each expert that some slot chose runs once over its slots
    (the counts are read on the host); returns ``(N, H)`` f32, the weighted
    sum of each row's slots in slot order. Matmuls in the weights' dtype,
    SiLU.mul in f32, the activation rounded to ``x``'s dtype. ``touched``,
    if given, ``(E,)`` int32, becomes 1 for each expert chosen, else 0.
    """
    n, topk = idx.shape
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    per_expert = torch.bincount(flat, minlength=w_gate.shape[0])
    if touched is not None:
        touched.copy_(per_expert > 0)
    counts = per_expert.tolist()  # the host read
    wflat = weight.reshape(-1).float()
    partial = torch.empty((n * topk, x.shape[1]), dtype=torch.float32, device=x.device)
    start = 0
    for e, c in enumerate(counts):
        if c == 0:
            continue
        slots = order[start:start + c]
        start += c
        xe = x.index_select(0, torch.div(slots, topk, rounding_mode="floor"))
        act = (F.silu((xe @ w_gate[e]).float()) * (xe @ w_up[e]).float()).to(x.dtype)
        y = (act @ w_down[e]).float() * wflat.index_select(0, slots)[:, None]
        partial.index_copy_(0, slots, y)
    return partial.view(n, topk, -1).sum(dim=1)


_fns = None


def _kernel():
    global _fns
    if _fns is None:
        lib = _build.load("moe_experts")
        fns = []
        for name in ("rho_moe_gate_up", "rho_moe_down"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            n_ptrs = 6 if name == "rho_moe_gate_up" else 5
            fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fns.append(fn)
        _fns = tuple(fns)
    return _fns


def _check(x, idx, weight, w_gate, w_up, w_down, touched):
    dev = x.device
    inputs = (idx, weight, w_gate, w_up, w_down) + (() if touched is None else (touched,))
    if not all(t.is_cuda and t.device == dev for t in inputs):
        raise ValueError("moe_experts: every input must be on the one CUDA device of x")
    if not all(t.dtype == torch.bfloat16 for t in (x, w_gate, w_up, w_down)):
        raise TypeError("moe_experts: x and the expert weights must be bfloat16")
    if idx.dtype != torch.int64 or weight.dtype != torch.float32:
        raise TypeError(f"moe_experts: idx must be int64 and weight float32, got "
                        f"{idx.dtype} / {weight.dtype}")
    rows, topk = idx.shape
    e, h, f = w_gate.shape
    if (x.shape != (rows, h) or weight.shape != idx.shape or w_up.shape != w_gate.shape
            or w_down.shape != (e, f, h)):
        raise ValueError(f"moe_experts: shapes x{tuple(x.shape)} idx{tuple(idx.shape)} "
                         f"w_gate{tuple(w_gate.shape)} w_down{tuple(w_down.shape)} disagree")
    if not (rows > 0 and 0 < topk <= e):
        raise ValueError(f"moe_experts: needs rows and 1-{e} experts a row, got {rows} and {topk}")
    if touched is not None and (touched.shape != (e,) or touched.dtype != torch.int32):
        raise ValueError(f"moe_experts: touched must be ({e},) int32, got "
                         f"{tuple(touched.shape)} {touched.dtype}")
    if h % 128 or f % 64:  # the blocks' column tiles and the contraction's step
        raise ValueError(f"moe_experts: hidden {h} must be a multiple of 128 and ffn {f} of 64")
    for name, t in (("x", x), ("idx", idx), ("weight", weight), ("w_gate", w_gate),
                    ("w_up", w_up), ("w_down", w_down), ("touched", touched)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"moe_experts: {name} must be contiguous")
    for name, t in (("x", x), ("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        if t.data_ptr() % 16:
            raise ValueError(f"moe_experts: {name} must be 16-byte aligned")


def moe_experts(x, idx, weight, w_gate, w_up, w_down, touched=None):
    """The routed experts of ``x`` ``(rows, H)``: ``(rows, H)`` f32.
    ``touched``, if given, ``(E,)`` int32, becomes 1 for each expert that
    some row chose, else 0.

    CPU tensors run :func:`grouped_experts`; CUDA tensors launch
    ``csrc/moe_experts.cu`` (or raise).
    """
    global launches
    check_no_autograd("moe_experts", "grouped_experts", x, w_gate, w_up, w_down)
    if x.device.type == "cpu":
        return grouped_experts(x, idx, weight, w_gate, w_up, w_down, touched)
    with profiling.region("kernels/moe_experts"):
        _check(x, idx, weight, w_gate, w_up, w_down, touched)
        rows, topk = idx.shape
        e, h, f = w_gate.shape
        act = torch.empty((rows * topk, f), dtype=torch.bfloat16, device=x.device)
        partial = torch.empty((rows, topk, h), dtype=torch.float32, device=x.device)
        dev = x.device.index
        stream = torch._C._cuda_getCurrentRawStream(dev)
        gate_up, down = _kernel()
        rc = gate_up(x.data_ptr(), idx.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                     act.data_ptr(), None if touched is None else touched.data_ptr(),
                     rows, topk, e, h, f, dev, stream)
        if rc == 0:
            rc = down(act.data_ptr(), idx.data_ptr(), weight.data_ptr(), w_down.data_ptr(),
                      partial.data_ptr(), rows, topk, e, f, h, dev, stream)
        if rc != 0:
            raise RuntimeError(f"moe experts kernel launch failed: cudaError_t {rc}")
        if not torch.cuda.is_current_stream_capturing():  # a graph's nodes run on replay
            launches += 2
        return partial.sum(dim=1)
