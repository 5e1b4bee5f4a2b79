"""The Mamba-2 mixer's decode step: a hand-written Hopper kernel and its plain version.

No counterpart in the JAX package, which has no state-space layer.

Kernel: ``csrc/ssm_step.cu``, one launch a Mamba layer a decode step, from
the layer's ``in_proj`` output ``[z | xBC | dt]`` (bf16) to ``y * silu(z)``
(bf16), which the gated norm (``add_rms_norm``) and ``out_proj`` take: the
causal depthwise convolution over its f32 state (rolled in place), SiLU,
``dt = softplus(dt + dt_bias)``, the scan's state ``S`` (f32) updated in
place, reading it once and writing it once, and ``y = S C + D x``. A block
owns one (head, row); the B and C channels' convolution state, which every
block of a row reads, is rolled by the row's last block (a ticket a row in
a buffer kept per stream, :func:`_tickets`). No host value is read, so a
decode step that calls it can be captured in a CUDA graph.

:func:`reference_ssm_step` is the plain version, the same steps in plain
PyTorch (f32 from the convolution on).

Dispatch: CPU tensors take :func:`reference_ssm_step`; CUDA tensors launch
the kernel or raise. Inputs that require grad under grad mode raise on
either device (``check_no_autograd``): the kernel has no backward.
``launches`` counts the kernel's launches, not those recorded into a CUDA
graph under capture, which run when the graph is replayed.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ...utils import profiling
from . import _build, check_no_autograd

#: number of times the CUDA kernel was launched
launches = 0

STATE = 128  # the state size the kernel takes (Mamba-2's d_state)
HEAD_DIMS = (32, 64, 128)  # head sizes the kernel takes
MAX_TAPS = 4
MAX_ROWS = 4096  # rows a launch takes at most: the tickets a stream keeps


def _split(zxbcdt: torch.Tensor, ssm_state: torch.Tensor, heads: int):
    _, _, p, n = ssm_state.shape
    di = heads * p
    return zxbcdt.split([di, di + 2 * n, heads], dim=-1), di, p, n


def reference_ssm_step(zxbcdt, conv_state, ssm_state, conv_w, conv_b, dt_bias, a_log, d):
    """Plain version of one decode step of a Mamba-2 layer.

    ``zxbcdt`` ``(B, 2 di + 2 N + heads)``, ``conv_state`` ``(B, K - 1,
    di + 2 N)`` f32 and ``ssm_state`` ``(B, heads, P, N)`` f32 (both
    advanced in place), ``conv_w`` ``(di + 2 N, K)``, ``conv_b``, ``dt_bias``,
    ``a_log`` and ``d`` ``(heads,)``. Returns ``y * silu(z)`` ``(B, di)`` in
    ``zxbcdt``'s dtype."""
    rows, heads = zxbcdt.shape[0], a_log.shape[0]
    (z, xbc, dt), di, p, n = _split(zxbcdt, ssm_state, heads)
    full = torch.cat([conv_state, xbc.float()[:, None]], dim=1)  # (B, K, C)
    conv = (full.unfold(1, conv_w.shape[-1], 1) * conv_w.float()).sum(dim=-1)[:, 0]
    conv_state.copy_(full[:, 1:])
    x, bm, cm = F.silu(conv + conv_b.float()).split([di, n, n], dim=-1)
    dt = F.softplus(dt.float() + dt_bias)  # (B, heads)
    decay = torch.exp(dt * -torch.exp(a_log.float()))
    x = x.reshape(rows, heads, p)
    ssm_state.mul_(decay[:, :, None, None]).add_((dt[:, :, None] * x)[..., None]
                                                 * bm[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", ssm_state, cm) + d.float()[:, None] * x
    return (y.reshape(rows, di) * F.silu(z.float())).to(zxbcdt.dtype)


_fn = None
_tickets_by_stream: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("ssm_step").rho_ssm_step
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 9
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        _fn = fn
    return _fn


def _tickets(device: torch.device, stream: int) -> torch.Tensor:
    """The zeroed tickets of launches on ``stream``: launches on one stream
    run in order and each leaves them zero. Made once and never replaced,
    so a CUDA graph captured on the stream keeps a live address."""
    key = (device, stream)
    buf = _tickets_by_stream.get(key)
    if buf is None:
        with torch.inference_mode(False):
            buf = _tickets_by_stream[key] = torch.zeros(MAX_ROWS, dtype=torch.int32,
                                                        device=device)
    return buf


def _check(zxbcdt, conv_state, ssm_state, conv_w, conv_b, dt_bias, a_log, d):
    """Raise on what the kernel does not take: dtypes, shapes and layout
    first, the device last."""
    for name, t in (("zxbcdt", zxbcdt), ("conv_w", conv_w), ("conv_b", conv_b)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"ssm_step: {name} must be bfloat16, got {t.dtype}")
    for name, t in (("conv_state", conv_state), ("ssm_state", ssm_state), ("dt_bias", dt_bias),
                    ("a_log", a_log), ("d", d)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssm_step: {name} must be float32, got {t.dtype}")
    if zxbcdt.dim() != 2 or ssm_state.dim() != 4 or conv_state.dim() != 3:
        raise ValueError(f"ssm_step: zxbcdt{tuple(zxbcdt.shape)} ssm_state"
                         f"{tuple(ssm_state.shape)} conv_state{tuple(conv_state.shape)}")
    rows, heads = zxbcdt.shape[0], a_log.shape[0]
    _, _, p, n = ssm_state.shape
    di, cd, taps = heads * p, heads * p + 2 * n, conv_w.shape[-1]
    if n != STATE or p not in HEAD_DIMS or not 2 <= taps <= MAX_TAPS:
        raise ValueError(f"ssm_step: a state of {n} and heads of {p} with {taps} taps; the "
                         f"kernel takes {STATE}, {HEAD_DIMS} and 2-{MAX_TAPS}")
    if not 0 < rows <= MAX_ROWS:
        raise ValueError(f"ssm_step: {rows} rows; the kernel takes 1-{MAX_ROWS}")
    want = {"zxbcdt": (rows, di + cd + heads), "ssm_state": (rows, heads, p, n),
            "conv_state": (rows, taps - 1, cd), "conv_w": (cd, taps), "conv_b": (cd,),
            "dt_bias": (heads,), "a_log": (heads,), "d": (heads,)}
    got = {"zxbcdt": zxbcdt, "ssm_state": ssm_state, "conv_state": conv_state,
           "conv_w": conv_w, "conv_b": conv_b, "dt_bias": dt_bias, "a_log": a_log, "d": d}
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"ssm_step: {name}{tuple(t.shape)} is not {want[name]}")
        if name != "zxbcdt" and not t.is_contiguous():
            raise ValueError(f"ssm_step: {name} must be contiguous")
    if zxbcdt.stride(-1) != 1:
        raise ValueError("ssm_step: the last dim of zxbcdt must be contiguous")
    if ssm_state.data_ptr() % 16:
        raise ValueError("ssm_step: ssm_state must be 16-byte aligned")
    dev = zxbcdt.device
    if not all(t.is_cuda and t.device == dev for t in got.values()):
        raise ValueError("ssm_step: every input must be on the one CUDA device of zxbcdt")


def ssm_step(zxbcdt, conv_state, ssm_state, conv_w, conv_b, dt_bias, a_log, d):
    """One decode step of a Mamba-2 layer: ``y * silu(z)`` ``(B, di)`` in
    ``zxbcdt``'s dtype, the states advanced in place
    (:func:`reference_ssm_step`'s arguments).

    CPU tensors run :func:`reference_ssm_step`; CUDA tensors launch
    ``csrc/ssm_step.cu`` (or raise).
    """
    global launches
    check_no_autograd("ssm_step", "reference_ssm_step", zxbcdt, conv_w, conv_b, dt_bias,
                      a_log, d)
    if zxbcdt.device.type == "cpu":
        return reference_ssm_step(zxbcdt, conv_state, ssm_state, conv_w, conv_b, dt_bias,
                                  a_log, d)
    with profiling.region("kernels/ssm_step"):
        _check(zxbcdt, conv_state, ssm_state, conv_w, conv_b, dt_bias, a_log, d)
        rows, heads = zxbcdt.shape[0], a_log.shape[0]
        _, _, p, n = ssm_state.shape
        out = torch.empty((rows, heads * p), dtype=zxbcdt.dtype, device=zxbcdt.device)
        dev = zxbcdt.device.index
        # torch.cuda.current_stream(device).cuda_stream, without building a Stream
        stream = torch._C._cuda_getCurrentRawStream(dev)
        tickets = _tickets(zxbcdt.device, stream)
        rc = _kernel()(zxbcdt.data_ptr(), zxbcdt.stride(0), conv_state.data_ptr(),
                       ssm_state.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(),
                       dt_bias.data_ptr(), a_log.data_ptr(), d.data_ptr(), out.data_ptr(),
                       tickets.data_ptr(), rows, heads, p, n, conv_w.shape[-1], dev, stream)
        if rc != 0:
            raise RuntimeError(f"ssm_step kernel launch failed: cudaError_t {rc}")
        if not torch.cuda.is_current_stream_capturing():  # a graph's node runs on replay
            launches += 1
        return out
