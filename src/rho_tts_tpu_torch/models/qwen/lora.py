"""LoRA voice adaptation for the codec-LM talker (PyTorch port).

Counterpart of ``rho_tts_tpu/models/qwen/lora.py``. Low-rank adapters over
the talker's stacked projection weights: for a target weight ``W (L, in,
out)``, LoRA trains ``A (L, in, r)`` and ``B (L, r, out)`` in f32 with
``B`` zero-initialised, serving ``W + scale * A @ B``.

Merge-for-forward, as in JAX: a step merges the adapters into fresh
weights and reuses ``train._forward_loss`` unchanged, so gradients reach
only the adapters and the base stays bit for bit. Serving merges once
(:func:`apply_lora`, or ``QwenTTSModel(lora_path=...)``), before any
quantization, into an ordinary params tree.

Adapters on disk are the port's own format: ``adapter.pt`` (a ``torch.save``
of the flat ``{"wqkv.a": ..., "wqkv.b": ...}``) and ``lora_meta.json``. The
JAX package's orbax ``adapter/`` directory is not read.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from .. import checkpoint as ckpt_lib
from .config import QwenTTSConfig
from .train import AdamW, _apply_updates, _forward_loss, _value_and_grad, leaves, make_optimizer

Params = Dict[str, Any]

#: talker block weights eligible for adapters (stacked (L, in, out))
TARGETS = ("wqkv", "wo", "w_gate", "w_up", "w_down")
DEFAULT_TARGETS = ("wqkv", "wo")

_ADAPTER_FILE = "adapter.pt"
_META_FILE = "lora_meta.json"


def init_lora(cfg: QwenTTSConfig, params: Params, rank: int = 8,
              targets: Sequence[str] = DEFAULT_TARGETS, seed: int = 0) -> Params:
    """Adapters for ``targets`` against ``params``' shapes, on their device.

    ``A`` is Gaussian (1/rank scale) from a generator seeded with ``seed``,
    ``B`` is zero: the merged model equals the base bit for bit until the
    first optimizer step.
    """
    unknown = [t for t in targets if t not in TARGETS]
    if unknown:
        raise ValueError(f"unknown LoRA targets {unknown}; choose from {TARGETS}")
    blocks = params["talker"]["blocks"]
    lora: Params = {}
    gen = None
    for name in targets:
        w = blocks[name]  # (L, in, out)
        if not isinstance(w, torch.Tensor):
            raise ValueError(f"LoRA needs a dense base; talker {name!r} is quantized")
        if gen is None:
            gen = torch.Generator(device=w.device).manual_seed(int(seed))
        l, d_in, d_out = w.shape
        a = torch.randn((l, d_in, rank), generator=gen, dtype=torch.float32, device=w.device)
        lora[name] = {"a": a / rank,
                      "b": torch.zeros((l, rank, d_out), dtype=torch.float32, device=w.device)}
    return lora


def apply_lora(params: Params, lora: Params, scale: float = 1.0) -> Params:
    """Merge adapters into a fresh params tree (the base's dtypes), usable
    everywhere the base is: generation, quantization, export, serving."""
    blocks = dict(params["talker"]["blocks"])
    for name, ab in lora.items():
        w = blocks[name]
        delta = torch.einsum("lir,lro->lio", ab["a"], ab["b"]) * scale
        blocks[name] = (w.float() + delta).to(w.dtype)
    return {**params, "talker": {**params["talker"], "blocks": blocks}}


def n_lora_params(lora: Params) -> int:
    return sum(t.numel() for t in leaves(lora))


def lora_train_step(base_params: Params, lora: Params, opt_state: torch.optim.AdamW,
                    batch: Dict[str, torch.Tensor], cfg: QwenTTSConfig, optimizer: AdamW,
                    scale: float = 1.0) -> Tuple[Params, Any, torch.Tensor]:
    """One optimizer step on the adapters only; the base stays frozen.

    The same teacher-forced loss and batch layout as ``train.train_step``.
    ``lora`` is updated in place and returned with the state and the loss.
    """
    trained = leaves(lora)
    loss, grads = _value_and_grad(
        lambda: _forward_loss(apply_lora(base_params, lora, scale=scale), cfg, batch), trained)
    _apply_updates(optimizer, opt_state, trained, grads)
    return lora, opt_state, loss


def init_lora_train_state(cfg: QwenTTSConfig, params: Params, rank: int = 8,
                          targets: Sequence[str] = DEFAULT_TARGETS, seed: int = 0,
                          optimizer: Optional[AdamW] = None):
    """``(lora, opt_state, optimizer)`` ready for :func:`lora_train_step`."""
    optimizer = optimizer or make_optimizer()
    lora = init_lora(cfg, params, rank=rank, targets=targets, seed=seed)
    return lora, optimizer.init(lora), optimizer


# ---------------------------------------------------------------------------
# Persistence
# ---------------------------------------------------------------------------


def _adapter_file(path: str) -> str:
    """``adapter.pt`` under ``path``; a JAX-package (orbax) adapter raises."""
    path = os.path.abspath(os.path.expanduser(str(path)))
    f = os.path.join(path, _ADAPTER_FILE)
    if not os.path.isfile(f) and os.path.isdir(os.path.join(path, "adapter")):
        raise ValueError(
            f"{path} holds a JAX-package (orbax) adapter, which the port does not read: "
            "restore it with rho_tts_tpu.models.qwen.lora.load_lora, convert the numpy tree "
            "with rho_tts_tpu_torch.from_jax.params_from_numpy, and save it with the port's "
            "save_lora"
        )
    return f


def save_lora(path: str, lora: Params, meta: Optional[Dict[str, Any]] = None) -> None:
    """Adapters to ``adapter.pt``; meta (scale, voice id, ...) to ``lora_meta.json``."""
    f = _adapter_file(path)
    os.makedirs(os.path.dirname(f), exist_ok=True)
    torch.save(ckpt_lib.flatten(lora), f)
    with open(os.path.join(os.path.dirname(f), _META_FILE), "w") as fh:
        json.dump(meta or {}, fh)


def load_lora(path: str, device=None) -> Tuple[Params, Dict[str, Any]]:
    """``(lora, meta)`` saved by :func:`save_lora`, onto ``device`` (default ``"cuda"``)."""
    f = _adapter_file(path)
    lora = ckpt_lib.unflatten(torch.load(f, weights_only=True,
                                         map_location=torch.device(device or "cuda")))
    meta: Dict[str, Any] = {}
    meta_file = os.path.join(os.path.dirname(f), _META_FILE)
    if os.path.exists(meta_file):
        with open(meta_file) as fh:
            meta = json.load(fh)
    return lora, meta
