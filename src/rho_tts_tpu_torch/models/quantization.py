"""Weight quantization for the codec-LM talker (PyTorch port).

Counterpart of ``rho_tts_tpu/models/quantization.py`` and of ``pack_int4``
in ``rho_tts_tpu/ops/pallas/int4_matmul.py`` (its ``_unpack_nibbles`` is
``ops.cuda.int4_matmul.unpack_int4``, beside the plain version that uses it).

* int8: ``{"q": int8 (..., in, out), "s": f32 (..., out)}``, per output
  channel, symmetric, ``s = max(absmax, 1e-8) / 127``.
* int4: ``{"q4": int8 (..., in/2, out), "s": f32 (..., out)}``, values in
  [-7, 7], ``s = max(absmax, 1e-8) / 7``, packed half-split: byte i holds
  row i in its low nibble and row i + in/2 in its high nibble. The bytes
  and scales are bit-identical to the JAX package's, so checkpoints
  interchange.

Rounding is half to even everywhere (``torch.round``, ``np.round`` and
``jnp.round`` agree), and every division is by a tensor on the operand's
device: PyTorch turns a division by a Python scalar into a multiplication
by its reciprocal on CUDA, which may round differently.

``matmul`` dispatches on the leaf type as JAX's does:

* ``{"q4","s"}`` goes to ``ops.cuda.int4_matmul``;
* ``{"q","s"}`` with more than one token (``x.shape[-2] > 1``) and
  ``RHO_TTS_TPU_W8A8_PREFILL=1`` (read at call time) quantizes the
  activations per row to int8 and goes to ``ops.cuda.w8a8_matmul``; decode
  (one token) stays weight-only whatever the flag says;
* ``{"q","s"}`` with a CUDA bf16 ``x`` of at most ``int8_gemv.MAX_ROWS``
  rows in all (the decode step), whose ``reduce`` spans at most one rank,
  goes to ``ops.cuda.int8_gemv``: the weight read once in its stored
  layout, converted in registers, one f32 sum, the scale applied and one
  rounding, in one launch;
* other ``{"q","s"}`` leaves (the prefill's many rows, f32 activations,
  CPU tensors, row-parallel matmuls over several ranks, which sum before
  they scale) take the dequant route: ``x @ q.to(x.dtype)``, then ``* s``
  in f32, then a cast back. Eager PyTorch materialises the converted
  weight on every call (XLA fuses the convert into the dot). ``dequant_calls``
  counts its calls, beside ``int8_gemv.launches``, as the kernels count:
  not those recorded into a CUDA graph under capture;
* dense weights are a plain ``x @ w``.

Under tensor parallelism the row-parallel ``wo`` / ``w_down`` matmuls pass
``reduce``, the mesh's ``model`` axis: ``x`` holds this rank's K shard and
the partial products are sum-all-reduced. A w8a8 quantize there takes each
row's absmax over the WHOLE K, as the JAX program does (a max all-reduce
before the quantize), then kernel 3 runs on the local shard. Weight-only
int8 and int4 need no collective beyond the sum.

The kernels' gates (``RHO_TTS_TPU_W8A8_KERNEL``, ``RHO_TTS_TPU_INT4_KERNEL``
and ``shapes_ok`` in JAX) do not exist here: on CUDA tensors the hand
kernel is the only route.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..ops.cuda import int8_gemv as _gemv
from ..ops.cuda.int4_matmul import int4_matmul
from ..ops.cuda.w8a8_matmul import w8a8_matmul
from ..parallel.collectives import all_reduce_max, all_reduce_sum
from ..parallel.mesh import Axis
from ..utils import profiling

QUANT_KEYS = ("wqkv", "wo", "w_gate", "w_up", "w_down")
BITS_MAX = 7  # symmetric int4: values in [-7, 7]

#: int8 matmuls that took the dequant route (the weight converted in memory)
dequant_calls = 0


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as an IEEE division on any device (see the module docstring)."""
    return x / x.new_full((), d)


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8: w (..., in, out) -> {q, s}."""
    wf = w.float()
    absmax = wf.abs().amax(dim=-2, keepdim=True)  # (..., 1, out)
    scale = _div(absmax.clamp_min(1e-8), 127.0)
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return {"q": q, "s": scale.squeeze(-2).float()}


def pack_int4(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-output-channel symmetric int4: w (..., K, N) -> {"q4": (..., K/2, N)
    int8, "s": (..., N) f32}. K must be even. Half-split packing, as JAX."""
    wf = w.float()
    k = wf.shape[-2]
    if k % 2:
        raise ValueError(f"int4 packing needs even K, got {k}")
    absmax = wf.abs().amax(dim=-2, keepdim=True)  # (..., 1, N)
    scale = _div(absmax.clamp_min(1e-8), float(BITS_MAX))
    q = torch.round(wf / scale).clamp(-BITS_MAX, BITS_MAX).to(torch.int32)
    lo = q[..., : k // 2, :] & 0xF
    hi = q[..., k // 2 :, :] & 0xF
    b = (hi << 4) | lo  # 0..255
    packed = torch.where(b > 127, b - 256, b).to(torch.int8)
    return {"q4": packed, "s": scale.squeeze(-2).float()}


def _quantizer(mode: str):
    if mode == "int4":
        return pack_int4
    if mode == "int8":
        return quantize_weight
    raise ValueError(f"Unknown quantization mode: {mode!r}")


def quantize_host(w, mode: str = "int8") -> Dict[str, np.ndarray]:
    """Quantize a host array (JAX's ``quantize_host``): :func:`quantize_weight`
    or :func:`pack_int4` on the CPU, returned as numpy arrays."""
    out = _quantizer(mode)(torch.as_tensor(np.asarray(w, np.float32)))
    return {k: v.numpy() for k, v in out.items()}


def _w8a8_prefill_enabled() -> bool:
    """``RHO_TTS_TPU_W8A8_PREFILL=1``: int8 activations for multi-token matmuls."""
    return os.environ.get("RHO_TTS_TPU_W8A8_PREFILL", "0") == "1"


def _w8a8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                 reduce: Optional[Axis] = None) -> torch.Tensor:
    """x @ (q*s) with per-row int8 activations, as JAX's ``_w8a8_matmul``.

    The activation quantize (f32 row absmax, ``max(amax, 1e-8) / 127``,
    ``clip(round(x / sx), -127, 127)``) runs here in plain ops, outside the
    kernel; the int8 dot and the rescale run in ``w8a8_matmul``. With
    ``reduce`` (row-parallel) the absmax is the whole row's and the scaled
    partials are summed over the axis.
    """
    xf = x.float()
    amax = all_reduce_max(xf.abs().amax(dim=-1, keepdim=True), reduce)  # (..., T, 1)
    sx = _div(amax.clamp_min(1e-8), 127.0)
    xq = torch.round(xf / sx).clamp(-127, 127).to(torch.int8)
    lead = x.shape[:-1]
    k_dim, n = q.shape
    y = w8a8_matmul(xq.reshape(-1, k_dim), sx.reshape(-1, 1), q, s.float(), x.dtype)
    return all_reduce_sum(y, reduce).reshape(*lead, n)


def _takes_gemv(x: torch.Tensor, reduce: Optional[Axis]) -> bool:
    """An int8 matmul for the GEMV kernel: CUDA bf16 ``x`` of at most
    ``MAX_ROWS`` rows in all, and no sum over several ranks."""
    return (x.is_cuda and x.dtype == torch.bfloat16
            and 0 < x.numel() <= _gemv.MAX_ROWS * x.shape[-1]
            and (reduce is None or reduce.size <= 1))


def matmul(x: torch.Tensor, w, reduce: Optional[Axis] = None) -> torch.Tensor:
    """x @ w for dense or quantized ({"q","s"} int8 / {"q4","s"} int4) weights.

    ``reduce``: the axis over which ``x`` and ``w`` hold K shards (a
    row-parallel matmul); the partial products are summed over it.
    """
    global dequant_calls
    if isinstance(w, dict):
        if "q4" in w:
            return all_reduce_sum(int4_matmul(x, w["q4"], w["s"]), reduce)
        if x.dim() >= 2 and x.shape[-2] > 1 and _w8a8_prefill_enabled():
            with profiling.region("quant/w8a8_matmul"):
                return _w8a8_matmul(x, w["q"], w["s"], reduce)
        if _takes_gemv(x, reduce):
            return _gemv.int8_gemv(x.contiguous(), w["q"], w["s"])
        with profiling.region("quant/int8_matmul"):
            if not (x.is_cuda and torch.cuda.is_current_stream_capturing()):
                dequant_calls += 1
            y = all_reduce_sum(x @ w["q"].to(x.dtype), reduce)
            return (y.float() * w["s"]).to(x.dtype)
    return all_reduce_sum(x @ w, reduce)


def is_quantized(w) -> bool:
    return isinstance(w, dict) and ("q" in w or "q4" in w)


def quantize_stack(stack_params: Dict[str, Any], mode: str = "int8") -> Dict[str, Any]:
    """Quantize a transformer stack's matmul weights (norms stay f32).

    ``"int8"``: weight-only int8 (the default serving mode); ``"int4"``:
    packed int4, half of int8's weight bytes.
    """
    quant = _quantizer(mode)
    blocks = dict(stack_params["blocks"])
    for name in QUANT_KEYS:
        if name in blocks and not is_quantized(blocks[name]):
            blocks[name] = quant(blocks[name])
    return {**stack_params, "blocks": blocks}


def quantized_bytes(stack_params: Any) -> int:
    """Total parameter bytes of a (possibly quantized) tree of tensors."""
    if isinstance(stack_params, dict):
        return sum(quantized_bytes(v) for v in stack_params.values())
    if isinstance(stack_params, (list, tuple)):
        return sum(quantized_bytes(v) for v in stack_params)
    return stack_params.numel() * stack_params.element_size()
