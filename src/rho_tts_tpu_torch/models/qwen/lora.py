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

On a mesh (``lora_train_step(mesh=...)``) the base is this rank's shards
and the adapters stay whole on every rank: the merge cuts them first, ``B``'s
columns for a column-parallel weight (``wqkv`` by heads, as
``parallel.sharding`` cuts it) and ``A``'s rows for a row-parallel one, so
the merged local shard is the cut of the merged whole; a pipeline stage
takes its layers of both. Each rank's adapter gradient then holds only its
shard's share, and the step sums the gradients over ``model`` and ``pipe``
as well as ``data``.

Adapters on disk are the port's own format: ``adapter.pt`` (a ``torch.save``
of the flat ``{"wqkv.a": ..., "wqkv.b": ...}``) and ``lora_meta.json``. The
JAX package's orbax ``adapter/`` directory is not read.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ...parallel import collectives as coll
from ...parallel.mesh import mesh_axis
from ...parallel.sharding import cut_lora
from .. import checkpoint as ckpt_lib
from .. import transformer as tfm
from .config import QwenTTSConfig
from .train import AdamW, _apply_updates, _forward_loss, _value_and_grad, leaves, make_optimizer

Params = Dict[str, Any]

#: talker block weights eligible for adapters (stacked (L, in, out))
TARGETS = ("wqkv", "wo", "w_gate", "w_up", "w_down")
DEFAULT_TARGETS = ("wqkv", "wo")

_ADAPTER_FILE = "adapter.pt"
_META_FILE = "lora_meta.json"


def _whole_shape(t, name: str) -> Tuple[int, int, int]:
    """``(L, in, out)`` of the whole talker weight ``name`` (config ``t``)."""
    qkv = (t.q_heads + 2 * t.kv_heads) * t.head_dim
    return {"wqkv": (t.layers, t.hidden, qkv), "wo": (t.layers, t.q_heads * t.head_dim, t.hidden),
            "w_gate": (t.layers, t.hidden, t.ffn), "w_up": (t.layers, t.hidden, t.ffn),
            "w_down": (t.layers, t.ffn, t.hidden)}[name]


def init_lora(cfg: QwenTTSConfig, params: Params, rank: int = 8,
              targets: Sequence[str] = DEFAULT_TARGETS, seed: int = 0) -> Params:
    """Adapters for ``targets`` at the whole weights' shapes (``cfg``'s
    widths), on ``params``' device; ``params`` may be a rank's shards.

    ``A`` is Gaussian (1/rank scale) from a generator seeded with ``seed``,
    ``B`` is zero: the merged model equals the base bit for bit until the
    first optimizer step.
    """
    tfm.require_dense(cfg.talker, "LoRA")
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
        l, d_in, d_out = _whole_shape(cfg.talker, name)
        a = torch.randn((l, d_in, rank), generator=gen, dtype=torch.float32, device=w.device)
        lora[name] = {"a": a / rank,
                      "b": torch.zeros((l, rank, d_out), dtype=torch.float32, device=w.device)}
    return lora


def apply_lora(params: Params, lora: Params, scale: float = 1.0, tp=None,
               talker_cfg=None, pipe=None) -> Params:
    """Merge adapters into a fresh params tree (the base's dtypes), usable
    everywhere the base is: generation, quantization, export, serving.
    ``tp`` / ``pipe``: ``params`` hold this rank's TP shards or pipeline
    stage and the whole adapters are cut to match (``sharding.cut_lora``;
    ``talker_cfg`` gives the heads)."""
    blocks = dict(params["talker"]["blocks"])
    for name, ab in lora.items():
        w = blocks[name]
        a, b = cut_lora(name, ab["a"], ab["b"], tp, talker_cfg, pipe=pipe)
        delta = torch.einsum("lir,lro->lio", a, b) * scale
        blocks[name] = (w.float() + delta).to(w.dtype)
    return {**params, "talker": {**params["talker"], "blocks": blocks}}


def n_lora_params(lora: Params) -> int:
    return sum(t.numel() for t in leaves(lora))


def lora_train_step(base_params: Params, lora: Params, opt_state: torch.optim.AdamW,
                    batch: Dict[str, torch.Tensor], cfg: QwenTTSConfig, optimizer: AdamW,
                    scale: float = 1.0, mesh=None,
                    n_microbatches: Optional[int] = None) -> Tuple[Params, Any, torch.Tensor]:
    """One optimizer step on the adapters only; the base stays frozen.

    The same teacher-forced loss and batch layout as ``train.train_step``.
    ``lora`` is updated in place and returned with the state and the loss.
    ``mesh``: ``base_params`` are this rank's shards or pipeline stage
    (``train.shard_train_params``), ``lora`` whole on every rank
    (:func:`init_lora` makes it whole from either) and ``batch`` the whole
    batch; every rank applies the same update and returns the global loss.
    ``n_microbatches``: the pipeline's, on a mesh with a ``pipe`` axis.
    """
    trained = leaves(lora)
    tp, pipe = mesh_axis(mesh, "model"), mesh_axis(mesh, "pipe")

    def loss_fn():
        merged = apply_lora(base_params, lora, scale=scale, tp=tp, talker_cfg=cfg.talker,
                            pipe=pipe)
        return _forward_loss(merged, cfg, batch, mesh=mesh, n_microbatches=n_microbatches)

    loss, grads = _value_and_grad(loss_fn, trained)
    # Each model rank and pipeline stage holds its cut's share of the gradient.
    grads = coll.sum_gradients(grads, [mesh_axis(mesh, "data"), tp, pipe])
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
