"""Training / fine-tuning step for the codec-LM (voice adaptation; PyTorch port).

Counterpart of ``rho_tts_tpu/models/qwen/train.py``. Teacher-forced
next-token loss over codec tokens given the text prompt: the primary
codebook through the LM head, the residual codebooks through the code
predictor, over the cache-less talker forward
(``transformer.stack_forward(kv_caches=None)``, plain attention as in JAX:
no kernel runs on a training step).

``torch.optim`` takes optax's place. :func:`make_optimizer` returns an
:class:`AdamW` factory: its ``init(params)`` builds ``torch.optim.AdamW``
over the leaves of a params tree, the optimizer state that the step
functions carry. Two choices keep it optax's ``adamw``:

* every leaf in the optimizer gets a gradient, zeros where autograd left
  none (the codec, the speaker table, text rows no batch touched), so weight
  decay reaches every leaf as optax's does; torch's AdamW would skip a leaf
  whose ``.grad`` is None;
* a schedule (``learning_rate`` a function of the step count) is evaluated
  at the count BEFORE the update, as optax's ``scale_by_schedule`` is.

The moments take the params' dtype (bf16 for a bf16 model), as optax's do.
Registered model parameters are ``requires_grad=False``; a step switches
gradients on for the leaves it trains and restores the flags after.

The train state on disk is the port's own format: ``train_state.pt``, a
``torch.save`` of the flat params (``models.checkpoint.flatten`` names, in
the tree's order), the optimizer's ``state_dict()`` and the step. The JAX
package's orbax directory is not read.

Meshes (``parallel``; one process per GPU, every rank making the same
call with the WHOLE batch). JAX's ``_constrain`` hints become the explicit
layout: on a ``(data, model)`` mesh each rank embeds, runs and scores its
own ``data`` rows, the params are this rank's shards
(:func:`shard_train_params`: Megatron's column / row cuts, the vocab-sharded
``text_embed``, the code predictor's ``w1`` / ``w2``) and the TP forward
runs the differentiable collectives (``parallel.collectives``). The loss
stays JAX's one global masked mean: the mask count is summed over
``data`` first, each rank's loss is its rows' masked sum over that global
count, and those sum over ``data`` (``reduce_from_model``: every rank
reports the global loss, each keeps its own rows' gradient). The step then
sums the gradients over ``data`` and AdamW updates the local shards (its
math is elementwise). On a ``(data, pipe)`` mesh the params hold this
stage's talker layers and :func:`_forward_loss` runs the talker through
``parallel.pipeline`` in ``n_microbatches``, so the same steps train every
mesh. :func:`gather_train_params` and :func:`save_train_state` give back
the global tree.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ...parallel import collectives as coll
from ...parallel import pipeline, sharding
from ...parallel.inference import shard_batch
from ...parallel.mesh import mesh_axis
from .. import checkpoint as ckpt_lib
from .. import transformer as tfm
from .config import QwenTTSConfig
from .model import init_params

Params = Dict[str, Any]

_STATE_FILE = "train_state.pt"
# Files an orbax checkpoint directory holds (the JAX package's train state).
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt", "_sharding")


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax ``adamw(learning_rate, weight_decay=...)`` on ``torch.optim.AdamW``.

    ``learning_rate`` is a number or a schedule ``count -> lr``. ``init``
    builds the optimizer state: a ``torch.optim.AdamW`` over the leaves of a
    params tree (betas 0.9 / 0.999, eps 1e-8, optax's defaults).
    """

    learning_rate: Union[float, Callable[[int], float]] = 1e-4
    weight_decay: float = 1e-4

    def _lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def init(self, params) -> torch.optim.AdamW:
        return torch.optim.AdamW(leaves(params), lr=self._lr(0), betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=self.weight_decay)


def make_optimizer(learning_rate: float = 1e-4, weight_decay: float = 0.01) -> AdamW:
    return AdamW(learning_rate, weight_decay)


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a params tree, in ``checkpoint.flatten``'s order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def _count(opt_state: torch.optim.Optimizer) -> int:
    """Updates the optimizer has applied (its per-leaf ``step``, a host tensor)."""
    params = opt_state.param_groups[0]["params"]
    step = opt_state.state.get(params[0], {}).get("step") if params else None
    return 0 if step is None else int(step)


def _value_and_grad(loss_fn: Callable[[], Any], trained: Sequence[torch.Tensor]):
    """``(loss, aux), grads`` of ``loss_fn()`` with respect to ``trained``.

    Gradients are switched on for ``trained`` around the call only; a leaf
    the loss does not reach gets zeros, as ``jax.value_and_grad`` gives.
    """
    flags = [t.requires_grad for t in trained]
    try:
        with torch.enable_grad():
            for t in trained:
                t.requires_grad_(True)
            out = loss_fn()
            loss = out[0] if isinstance(out, tuple) else out
            grads = torch.autograd.grad(loss, list(trained), allow_unused=True,
                                        materialize_grads=True)
    finally:
        for t, flag in zip(trained, flags):
            t.requires_grad_(flag)
    if isinstance(out, tuple):
        return tuple(o.detach() for o in out), grads
    return loss.detach(), grads


def _apply_updates(optimizer: AdamW, opt_state: torch.optim.Optimizer,
                   trained: Sequence[torch.Tensor], grads: Sequence[torch.Tensor]) -> None:
    """One AdamW update of ``trained`` (the optimizer's leaves) in place."""
    params = opt_state.param_groups[0]["params"]
    if len(params) != len(trained) or any(p is not t for p, t in zip(params, trained)):
        raise ValueError("opt_state was not built over these params (optimizer.init(params))")
    lr = optimizer._lr(_count(opt_state))  # the count before the update, as optax
    for group in opt_state.param_groups:
        group["lr"] = lr
    for p, g in zip(trained, grads):
        p.grad = g
    opt_state.step()
    for p in trained:
        p.grad = None


# ---------------------------------------------------------------------------
# Loss and step
# ---------------------------------------------------------------------------


def init_train_state(cfg: QwenTTSConfig, seed: int = 0, optimizer: Optional[AdamW] = None,
                     device=None, mesh=None):
    """``(params, opt_state)``: random weights from ``seed`` on ``device``
    (default ``"cuda"``, this rank's card under a mesh) and a fresh
    optimizer state over them; with ``mesh``, over this rank's shards."""
    tfm.require_dense(cfg.talker, "training")
    params = init_params(cfg, seed, device)
    if mesh is not None:
        params = shard_train_params(mesh, params, cfg)
    optimizer = optimizer or make_optimizer()
    return params, optimizer.init(params)


def _param_specs(mesh, params: Params) -> Params:
    """The spec tree of a train-params tree on ``mesh``: the TP layout of
    ``parallel.sharding`` on a ``(data, model)`` mesh, the talker's layers
    staged on a ``(data, pipe)`` one (the rest replicated)."""
    if "pipe" in mesh.shape:
        return {"talker": {"blocks": pipeline.stage_specs(params["talker"]["blocks"])}}
    return sharding.qwen_param_specs(params)


def shard_train_params(mesh, params: Params, cfg: QwenTTSConfig) -> Params:
    """This rank's shard of a whole train-params tree on ``mesh``: on a
    ``(data, model)`` mesh the TP layout (``sharding.qwen_param_specs``), on
    a ``(data, pipe)`` mesh the talker's layers of this stage (as
    ``pipeline.shard_stack_for_pipeline`` cuts them). Replicated leaves are
    the caller's tensors."""
    with torch.no_grad():
        return sharding.shard_params(mesh, params, _param_specs(mesh, params), cfg.talker)


def gather_train_params(mesh, params: Params, cfg: QwenTTSConfig) -> Params:
    """The whole tree from every rank's shards (a collective: every rank of
    the mesh calls it and gets the whole tree)."""
    with torch.no_grad():
        return sharding.gather_params(mesh, params, _param_specs(mesh, params), cfg.talker)


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's ``softmax_cross_entropy_with_integer_labels`` over the last axis."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                           reduction="none").reshape(labels.shape)


def _code_predictor_logits(params: Params, h: torch.Tensor, tok0: torch.Tensor,
                           tp=None) -> torch.Tensor:
    """Residual-codebook logits ``(nq-1, B, T, C)`` f32 from the hidden states
    and the primary code's embedding. Under ``tp`` ``w1`` is this rank's
    columns and ``w2`` its rows (column- then row-parallel)."""
    w1, w2 = params["code_predictor"]["w1"], params["code_predictor"]["w2"]
    e0 = params["audio_embed"][0][tok0]
    cp_in = coll.copy_to_model(torch.cat([h, e0], dim=-1).to(w1.dtype), tp)
    hidden = F.silu(torch.einsum("btd,qdc->qbtc", cp_in, w1).float())
    out = torch.einsum("qbtc,qce->qbte", hidden.to(w2.dtype), w2)
    return coll.reduce_from_model(out, tp).float()


def _forward_loss(params: Params, cfg: QwenTTSConfig, batch: Dict[str, torch.Tensor],
                  stack_fn=None, mesh=None, n_microbatches: Optional[int] = None) -> torch.Tensor:
    """Teacher-forced CE loss (a 0-d f32 tensor).

    batch:
      text_ids:   (B, Tt) integer
      codes:      (B, Tc, nq) integer target codec tokens
      codes_mask: (B, Tc) bool

    ``stack_fn`` swaps the talker forward (the contract of
    ``transformer.stack_forward`` without caches).
    ``mesh``: ``params`` are this rank's shards and ``batch`` the whole
    batch, of which this rank scores its ``data`` rows; every rank returns
    the global loss, whose gradient on each rank is that of its own rows
    (the module docstring). A mesh with a ``pipe`` axis runs the talker
    through ``pipeline`` in ``n_microbatches`` (default: one per stage).
    """
    data, tp = mesh_axis(mesh, "data"), mesh_axis(mesh, "model")
    if stack_fn is None and mesh is not None and "pipe" in mesh.shape:
        stack_fn = functools.partial(pipeline._local_stack_forward, mesh=mesh,
                                     n_microbatches=n_microbatches)
    elif stack_fn is None:
        stack_fn = functools.partial(tfm.stack_forward, tp=tp)
    if mesh is not None:  # this rank's rows
        batch = shard_batch(batch, mesh)
    text_ids = batch["text_ids"].long()
    codes = batch["codes"].long()
    mask = batch["codes_mask"].float()
    b, tt = text_ids.shape
    tc = codes.shape[1]
    nq = cfg.codec.n_codebooks

    text_emb = coll.vocab_embed(params["text_embed"], text_ids, tp, differentiable=True)
    bos = params["audio_embed"][0][cfg.audio_bos][None, None, :].expand(b, 1, text_emb.shape[-1])
    audio_in = params["audio_embed"][0][codes[:, :-1, 0]]
    for q in range(1, nq):
        audio_in = audio_in + params["audio_embed"][q][codes[:, :-1, q]]
    embeds = torch.cat([text_emb, bos, audio_in], dim=1)  # (B, Tt+Tc, H)

    t_total = tt + tc
    positions = torch.arange(t_total, device=embeds.device).expand(b, t_total)
    h, _ = stack_fn(params["talker"], cfg.talker, embeds, positions)
    h_audio = h[:, tt: tt + tc]  # hidden states predicting each code step

    logits = h_audio.float() @ params["lm_head"].float()
    primary_ce = _ce(logits, codes[..., 0])
    # The global mask count: the denominator needs no gradient.
    denom = coll.all_reduce_sum(mask.sum(), data).clamp_min(1.0)
    loss = (primary_ce * mask).sum() / denom

    if nq > 1:
        res_logits = _code_predictor_logits(params, h_audio, codes[..., 0], tp)
        for q in range(1, nq):
            ce = _ce(res_logits[q - 1], codes[..., q])
            loss = loss + (ce * mask).sum() / denom / (nq - 1)
    return coll.reduce_from_model(loss, data)


def loss_and_grads(params: Params, cfg: QwenTTSConfig, batch: Dict[str, torch.Tensor],
                   mesh=None, n_microbatches: Optional[int] = None):
    """``(loss, grads)``: the global loss and every leaf's gradient (in
    :func:`leaves` order), summed over ``data``: what :func:`train_step`
    applies. On a mesh each rank holds its shards' gradients."""
    loss, grads = _value_and_grad(
        lambda: _forward_loss(params, cfg, batch, mesh=mesh, n_microbatches=n_microbatches),
        leaves(params))
    return loss, coll.sum_gradients(grads, [mesh_axis(mesh, "data")])


def train_step(params: Params, opt_state: torch.optim.AdamW, batch: Dict[str, torch.Tensor],
               cfg: QwenTTSConfig, optimizer: AdamW, mesh=None,
               n_microbatches: Optional[int] = None) -> Tuple[Params, Any, torch.Tensor]:
    """One optimizer step over every leaf; ``params`` are updated in place
    and returned with the state and the loss (on the params' device).

    ``mesh``: ``params`` / ``opt_state`` are this rank's shards
    (:func:`init_train_state` or :func:`shard_train_params`), ``batch`` the
    whole batch on every rank; the gradients sum over ``data`` before the
    update and every rank returns the global loss. ``n_microbatches``: the
    pipeline's, on a mesh with a ``pipe`` axis.
    """
    loss, grads = loss_and_grads(params, cfg, batch, mesh, n_microbatches)
    _apply_updates(optimizer, opt_state, leaves(params), grads)
    return params, opt_state, loss


# ---------------------------------------------------------------------------
# Checkpoint / resume
# ---------------------------------------------------------------------------


def _state_file(path: str) -> str:
    """``train_state.pt`` under ``path``; a JAX (orbax) directory raises."""
    path = os.path.abspath(os.path.expanduser(str(path)))
    f = os.path.join(path, _STATE_FILE)
    if not os.path.isfile(f) and os.path.isdir(path) and any(
            os.path.exists(os.path.join(path, m)) for m in _ORBAX_MARKERS):
        raise ValueError(
            f"{path} is a JAX-package (orbax) train state, which the port does not read: "
            "restore it with rho_tts_tpu.models.qwen.train.restore_train_state, convert the "
            "numpy params with rho_tts_tpu_torch.from_jax.params_from_numpy, and start the "
            "port's optimizer over them (the optax moments do not carry over)"
        )
    return f


def _like(tree, values):
    """A tree shaped as ``tree`` holding ``values`` in :func:`leaves` order."""
    it = iter(values)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return next(it)

    return walk(tree)


_MOMENTS = ("exp_avg", "exp_avg_sq")


def _map_moments(opt_sd: Dict[str, Any], params: Params, fn) -> Dict[str, Any]:
    """``opt_sd`` (an AdamW ``state_dict()`` over ``leaves(params)``) with
    each moment's tree replaced by ``fn(tree)``."""
    state = {i: dict(v) for i, v in opt_sd["state"].items()}
    if state:
        for key in _MOMENTS:
            moved = leaves(fn(_like(params, [state[i][key] for i in range(len(state))])))
            for i, t in enumerate(moved):
                state[i][key] = t
    return {**opt_sd, "state": state}


def save_train_state(path: str, params: Params, opt_state: torch.optim.AdamW, step: int,
                     mesh=None, cfg: Optional[QwenTTSConfig] = None) -> None:
    """Save ``{params, opt_state, step}`` to ``path`` (a directory).

    ``mesh`` (with ``cfg``): every rank calls it; the params and AdamW's
    moments are gathered into the global tree (``gather_train_params``),
    which the mesh's first rank writes, so :func:`restore_train_state`
    reloads it unmeshed, or onto a mesh."""
    f = _state_file(path)
    opt_sd = opt_state.state_dict()
    if mesh is not None:
        if cfg is None:
            raise ValueError("save_train_state on a mesh needs cfg (the heads of wqkv)")
        opt_sd = _map_moments(opt_sd, params, lambda t: gather_train_params(mesh, t, cfg))
        params = gather_train_params(mesh, params, cfg)

    def write():
        os.makedirs(os.path.dirname(f), exist_ok=True)
        torch.save({"params": ckpt_lib.flatten(params), "opt_state": opt_sd,
                    "step": int(step)}, f)

    if mesh is None:
        write()
    else:
        mesh.write_on_first_rank(write)


def restore_train_state(path: str, cfg: QwenTTSConfig, optimizer: Optional[AdamW] = None,
                        device=None, mesh=None):
    """Restore ``(params, opt_state, step)`` saved by :func:`save_train_state`
    onto ``device`` (default ``"cuda"``), in a fresh process too; the params'
    shapes are checked against ``cfg``. ``mesh``: the params and moments
    come back as this rank's shards (:func:`shard_train_params`)."""
    # Read on the host: the optimizer keeps its step counts there, and
    # load_state_dict moves the moments to their leaves' device.
    state = torch.load(_state_file(path), weights_only=True, map_location="cpu", mmap=True)
    device = torch.device(device or "cuda")
    params = ckpt_lib.unflatten({k: v.to(device) for k, v in state["params"].items()})
    t = cfg.talker
    want = {"text_embed": (cfg.text_vocab, t.hidden), "lm_head": (t.hidden, cfg.audio_vocab)}
    got = {k: tuple(params[k].shape) for k in want}
    if got != want or params["talker"]["blocks"]["attn_norm"].shape != (t.layers, t.hidden):
        raise ValueError(f"train state at {path} does not match config {cfg.name!r}: {got}")
    opt_sd = state["opt_state"]
    if mesh is not None:
        opt_sd = _map_moments(opt_sd, params, lambda tree: shard_train_params(mesh, tree, cfg))
        params = shard_train_params(mesh, params, cfg)
    opt_state = (optimizer or make_optimizer()).init(params)
    opt_state.load_state_dict(opt_sd)
    return params, opt_state, int(state["step"])
