"""Weight-only int8 quantization for the codec-LM talker (PyTorch port).

Counterpart of ``rho_tts_tpu/models/quantization.py``. A quantized linear
is stored as ``{"q": int8 (..., in, out), "s": f32 (..., out)}``, per
output channel, symmetric, with round-half-to-even (``torch.round``,
``np.round`` and ``jnp.round`` all round half to even). ``matmul``
dispatches on the leaf type so the same transformer code runs dense or
quantized weights.

``matmul`` keeps the JAX arithmetic exactly: ``x @ q.to(x.dtype)``, then
``* s`` in f32, then a cast back. Eager PyTorch materialises the converted
weight on every call (XLA fuses the convert into the dot); that copy is a
known cost of this slice. int4 packing and the w8a8 prefill path wait for
their kernels.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

QUANT_KEYS = ("wqkv", "wo", "w_gate", "w_up", "w_down")


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8: w (..., in, out) -> {q, s}."""
    wf = w.float()
    absmax = wf.abs().amax(dim=-2, keepdim=True)  # (..., 1, out)
    scale = absmax.clamp_min(1e-8) / 127.0
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return {"q": q, "s": scale.squeeze(-2).float()}


def quantize_host(w, mode: str = "int8") -> Dict[str, np.ndarray]:
    """Host-side (numpy) int8 quantization, same math as :func:`quantize_weight`."""
    if mode != "int8":
        raise NotImplementedError(f"quantization mode {mode!r} is not ported yet (int8 only)")
    wf = np.asarray(w, np.float32)
    absmax = np.max(np.abs(wf), axis=-2, keepdims=True)
    scale = np.maximum(absmax, 1e-8) / 127.0
    q = np.clip(np.round(wf / scale), -127, 127).astype(np.int8)
    return {"q": q, "s": scale.squeeze(-2).astype(np.float32)}


def is_quantized(w) -> bool:
    return isinstance(w, dict) and ("q" in w or "q4" in w)


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for dense or int8 ``{"q","s"}`` weights."""
    if isinstance(w, dict):
        if "q4" in w:
            raise NotImplementedError("int4 weights need the int4 matmul kernel, not ported yet")
        y = x @ w["q"].to(x.dtype)
        return (y.float() * w["s"]).to(x.dtype)
    return x @ w


def quantize_stack(stack_params: Dict[str, Any], mode: str = "int8") -> Dict[str, Any]:
    """Quantize a transformer stack's matmul weights (norms stay f32)."""
    if mode != "int8":
        raise NotImplementedError(f"quantization mode {mode!r} is not ported yet (int8 only)")
    blocks = dict(stack_params["blocks"])
    for name in QUANT_KEYS:
        if name in blocks and not is_quantized(blocks[name]):
            blocks[name] = quantize_weight(blocks[name])
    return {**stack_params, "blocks": blocks}

