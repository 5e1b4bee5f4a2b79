"""Pipeline parallelism: the talker's layer stack staged over a ``pipe`` axis
(PyTorch port).

Counterpart of ``rho_tts_tpu/parallel/pipeline.py``. The layers split into
contiguous stages, one per rank along the ``pipe`` axis of a ``(data,
pipe)`` mesh; microbatches flow through the stages GPipe-style, each stage
handing its activation, with the microbatch's RoPE positions and its uint8
validity mask, to the next stage. Every rank makes the same call with the
whole batch and returns the whole output, as JAX's ``psum`` over ``pipe``
leaves it on every device.

Execution. JAX runs one ``shard_map`` program of ``M + P - 1`` ticks in
which every device computes every tick (bubbles on zeros) and ``ppermute``
shifts the activations; its backward is ``ppermute``'s transpose. The port
runs one process per stage (``parallel.mesh``) and the same schedule with
point-to-point sends (``collectives.exchange``): stage ``s`` runs
microbatch ``j`` at tick ``s + j``, as soon as stage ``s - 1`` has sent it,
and computes nothing at a bubble tick. The schedule is one
``torch.autograd.Function`` (:class:`_GPipe`) whose backward runs it in
reverse: microbatches last to first, each stage taking its output's
gradient from the next stage and sending its input's gradient to the
previous one. An explicit backward keeps the sends of every rank in one
order; autograd's own traversal would skip a node whose output no loss
reads (a stage-0 receive) and leave its partner waiting.

Three gradients need care:

* the stage outputs sum over ``pipe`` (only the last stage's are not zero)
  with ``reduce_from_model``, whose backward is the identity: the last
  stage gets the cotangent once, where an all-reduce backward would give it
  ``P`` times;
* the stack's input is ``copy_to_model`` over ``pipe``: its gradient, which
  only stage 0 computes, is summed to every stage, so the leaves upstream
  of the stack (``text_embed``, ``audio_embed``) get the same gradient on
  every rank. ``audio_embed`` also feeds the code predictor on every stage,
  downstream of the sum, so summing the leaf gradients instead would count
  that part ``P`` times;
* the masks keep JAX's safe form (``msk | ~any(msk)``, :179): a row with no
  valid key attends causally over all of its tokens, as it does in JAX.

Decode is not pipelined (as in JAX): the teacher-forced paths are the
target (training, LoRA, scoring).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from . import collectives as coll
from .inference import shard_batch
from .mesh import Mesh, create_mesh, mesh_axis, world_size
from .sharding import shard_params

Params = Dict[str, Any]


def create_pipeline_mesh(n_devices: Optional[int] = None,
                         n_stages: Optional[int] = None) -> Mesh:
    """A ``(data, pipe)`` mesh: stages on the minor axis, the rest data.

    ``n_devices`` defaults to the world size, ``n_stages`` to all of them
    (pure pipeline, data = 1). Adjacent ranks form a pipeline.
    """
    n = world_size() if n_devices is None else int(n_devices)
    stages = n if n_stages is None else int(n_stages)
    if stages < 1 or n % stages:
        raise ValueError(f"n_stages ({stages}) must divide n_devices ({n})")
    mesh = create_mesh(n, model_parallel=stages, axis_names=("data", "pipe"))
    pipe = mesh.axis("pipe")
    if pipe.group is not None and torch.distributed.get_backend(pipe.group) == "nccl":
        # NCCL wants a group's first operation to involve every member; the
        # schedule's first sends involve two.
        coll.all_reduce_sum(torch.zeros(1, device="cuda"), pipe)
    return mesh


def stage_specs(blocks: Params) -> Params:
    """The spec tree splitting every stacked-block leaf's layer axis over
    ``pipe`` (dense and quantized ``{"q","s"}`` leaves alike)."""
    if isinstance(blocks, dict):
        return {k: stage_specs(v) for k, v in blocks.items()}
    return ("pipe",) + (None,) * (blocks.dim() - 1)


def shard_stack_for_pipeline(mesh: Mesh, stack_params: Params) -> Params:
    """This stage's contiguous ``L / P`` layers of a transformer stack
    (``final_norm`` replicated)."""
    blocks = stack_params["blocks"]
    with torch.no_grad():
        local = shard_params(mesh, blocks, stage_specs(blocks))
    return {"blocks": local, "final_norm": stack_params["final_norm"]}


def _layer_count(blocks: Params) -> int:
    leaf = blocks
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return int(leaf.shape[0])


def _microbatches(cfg, blocks: Params, b: int, mesh, n_microbatches) -> int:
    """JAX's shape guards on the whole batch ``b``; the microbatch count."""
    n_stages = mesh.shape["pipe"]
    if cfg.layers % n_stages:
        raise ValueError(f"pipe axis ({n_stages}) must divide the layer count ({cfg.layers})")
    if _layer_count(blocks) != cfg.layers // n_stages:
        raise ValueError(f"blocks of {_layer_count(blocks)} layers are not one stage of the "
                         f"{cfg.layers}-layer stack (shard_stack_for_pipeline)")
    m = n_stages if n_microbatches is None else int(n_microbatches)
    if m < 1:
        raise ValueError(f"n_microbatches must be >= 1, got {m}")
    if b % m:
        raise ValueError(f"batch ({b}) must divide into n_microbatches ({m})")
    dp = mesh.shape.get("data", 1)
    if (b // m) % dp:
        raise ValueError(f"microbatch rows ({b // m}) must divide over the data axis ({dp})")
    return m


class _Schedule:
    """What the schedule needs besides tensors: the config, the block leaf
    names, the ``pipe`` axis and the microbatch count."""

    def __init__(self, cfg, names, pipe, m: int):
        self.cfg, self.names, self.pipe, self.m = cfg, names, pipe, m
        self.stage = 0 if pipe is None else pipe.index
        self.n_stages = 1 if pipe is None else pipe.size

    def blocks(self, weights) -> Params:
        tree: Params = {}
        for path, w in zip(self.names, weights):
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = w
        return tree

    def run(self, blocks: Params, h, pos, msk) -> torch.Tensor:
        """This stage's layers on one microbatch, under JAX's safe mask."""
        from ..models import transformer as tfm  # it imports this package

        valid = msk.bool()
        safe = valid | ~valid.any(dim=-1, keepdim=True)
        mask = tfm._causal_mask(h.shape[1], safe, h.device)
        rope = tfm._rope_tables(pos, self.cfg.head_dim, self.cfg.rope_theta)
        per_layer = {name: tfm._unbind(w) for name, w in blocks.items()}
        for layer in range(_layer_count(blocks)):
            lp = {name: w[layer] for name, w in per_layer.items()}
            h, _ = tfm.block_forward(lp, self.cfg, h, pos, rope=rope, mask=mask)
        return h


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _leaf_paths(v, prefix + (k,))
        return out
    return [(prefix, tree)]


class _GPipe(torch.autograd.Function):
    """The GPipe schedule over ``pipe`` with an explicit backward (module
    docstring). Inputs ``(sched, xm, pm, am, *weights)``: the microbatched
    activations ``(M, mb, T, H)``, positions and uint8 masks ``(M, mb, T)``
    and this stage's block leaves. Output ``(M, mb, T, H)``: the last
    stage's outputs there, zeros on the other stages."""

    @staticmethod
    def forward(ctx, sched: _Schedule, xm, pm, am, *weights):
        s, n, pipe = sched.stage, sched.n_stages, sched.pipe
        need_grad = ctx.needs_input_grad[1] or any(ctx.needs_input_grad[4:])
        outs = torch.zeros_like(xm)
        saved = []
        with torch.set_grad_enabled(need_grad):
            w = [t.detach().requires_grad_(t.requires_grad) for t in weights]
            blocks = sched.blocks(w)
            for j in range(sched.m):
                if s == 0:
                    h, pos, msk = xm[j], pm[j], am[j]
                else:
                    h, pos, msk = torch.empty_like(xm[j]), pm[j].clone(), am[j].clone()
                    coll.exchange([], None, [h, pos, msk], s - 1, pipe)
                inp = h.detach().requires_grad_(need_grad)
                out = sched.run(blocks, inp, pos, msk)
                if s < n - 1:
                    coll.exchange([out.detach(), pos, msk], s + 1, [], None, pipe)
                else:
                    outs[j] = out.detach()
                if need_grad:
                    saved.append((inp, out))
        ctx.sched, ctx.saved, ctx.w = sched, saved, w
        ctx.x_needs_grad = ctx.needs_input_grad[1]
        return outs

    @staticmethod
    def backward(ctx, g_outs):
        sched, w = ctx.sched, ctx.w
        s, n, pipe = sched.stage, sched.n_stages, sched.pipe
        trained = [i for i, t in enumerate(w) if t.requires_grad]
        g_w = [None] * len(w)
        g_xm = torch.zeros_like(g_outs) if ctx.x_needs_grad else None
        for j in reversed(range(sched.m)):
            inp, out = ctx.saved[j]
            if s == n - 1:
                g = g_outs[j]
            else:
                g = torch.empty_like(out)
                coll.exchange([], None, [g], s + 1, pipe)
            grads = torch.autograd.grad(out, [inp] + [w[i] for i in trained], g,
                                        allow_unused=True, materialize_grads=True)
            for i, gi in zip(trained, grads[1:]):
                g_w[i] = gi if g_w[i] is None else g_w[i] + gi
            if s > 0:
                coll.exchange([grads[0]], s - 1, [], None, pipe)
            elif g_xm is not None:
                g_xm[j] = grads[0]
        ctx.saved = ctx.w = None
        return (None, g_xm, None, None, *g_w)


def _schedule(params: Params, cfg, x, positions, attn_mask, mesh: Mesh, m: int) -> torch.Tensor:
    """The pipelined stack (before ``final_norm``) over this rank's rows."""
    pipe = mesh_axis(mesh, "pipe")
    pipe = pipe if pipe is not None and pipe.size > 1 else None
    b, t, hidden = x.shape
    mb = b // m
    if attn_mask is None:
        attn_mask = torch.ones((b, t), dtype=torch.bool, device=x.device)
    x = coll.copy_to_model(x, pipe)  # stage 0's input gradient, summed to every stage
    xm = x.reshape(m, mb, t, hidden)
    pm = positions.reshape(m, mb, t)
    am = attn_mask.reshape(m, mb, t).to(torch.uint8)  # travels with the activation
    names, weights = zip(*_leaf_paths(params["blocks"]))
    outs = _GPipe.apply(_Schedule(cfg, names, pipe, m), xm, pm, am, *weights)
    # Only the last stage's outputs are not zero: the sum moves them to every
    # stage, and its identity backward hands the cotangent to the last once.
    return coll.reduce_from_model(outs, pipe).reshape(b, t, hidden)


def pipeline_stack_forward(
    params: Params,
    cfg,
    x: torch.Tensor,  # (B, T, hidden), the whole batch on every rank
    positions: torch.Tensor,  # (B, T)
    attn_mask: Optional[torch.Tensor] = None,  # (B, T)
    *,
    mesh: Mesh,
    n_microbatches: Optional[int] = None,
) -> Tuple[torch.Tensor, None]:
    """GPipe-microbatched ``stack_forward`` (the cache-less path) over ``pipe``.

    The contract of ``models.transformer.stack_forward`` without caches:
    returns ``(hidden_states, None)``, the whole batch on every rank. The
    batch must divide into ``n_microbatches`` (default: one per stage) and
    each microbatch over ``data``; each ``data`` rank runs its rows and the
    output is gathered over ``data``. ``params`` is this stage's stack
    (:func:`shard_stack_for_pipeline`).
    """
    m = _microbatches(cfg, params["blocks"], x.shape[0], mesh, n_microbatches)
    rows = functools.partial(shard_batch, mesh=mesh)
    out = _schedule(params, cfg, rows(x), rows(positions),
                    None if attn_mask is None else rows(attn_mask), mesh, m)
    return _final_norm(params, cfg, coll.gather_from(out, 0, mesh_axis(mesh, "data")))


def _final_norm(params: Params, cfg, h: torch.Tensor):
    from ..models.transformer import rms_norm

    return rms_norm(h, params["final_norm"], cfg.rms_eps), None


def _local_stack_forward(params: Params, cfg, x, positions, attn_mask=None, *, mesh: Mesh,
                         n_microbatches: Optional[int] = None):
    """:func:`pipeline_stack_forward` on this rank's ``data`` rows, which
    ``train._forward_loss(mesh=...)`` has already taken: the guards read the
    whole batch, the output stays this rank's rows."""
    b = x.shape[0] * mesh.shape.get("data", 1)
    m = _microbatches(cfg, params["blocks"], b, mesh, n_microbatches)
    return _final_norm(params, cfg, _schedule(params, cfg, x, positions, attn_mask, mesh, m))


def pipeline_train_step(params: Params, opt_state, batch: Dict[str, torch.Tensor], cfg,
                        optimizer, mesh: Mesh, n_microbatches: Optional[int] = None):
    """JAX's name for ``models.qwen.train.train_step`` on a ``(data, pipe)``
    mesh, which runs the talker through this module's schedule."""
    from ..models.qwen.train import train_step  # it imports this module

    return train_step(params, opt_state, batch, cfg, optimizer, mesh=mesh,
                      n_microbatches=n_microbatches)
