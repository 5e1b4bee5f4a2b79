"""The explicit collectives of the port's meshes.

The JAX package has no counterpart: XLA inserts its collectives from the
shardings. The port keeps plain local shards and calls these where GSPMD
would insert them:

* :func:`all_reduce_sum` -- the row-parallel ``wo`` / ``w_down`` partial
  sums, the vocab-parallel embedding lookup, the code predictor's ``w2``;
* :func:`all_reduce_max` -- the whole-K row absmax of a row-parallel w8a8
  quantize, the "any row still decoding" flag over ``data``;
* :func:`all_gather` -- K/V and the mask of a sequence-parallel prefill,
  the code logs and done flags of a data-parallel decode;
* :func:`broadcast` -- the serving engines' schedule, from the mesh's
  first rank over its gloo ``control`` axis;
* :func:`exchange` -- a pipeline stage's sends and receives.

Those have no backward: inference runs them. Training runs the
differentiable operators, Megatron's pairing, where XLA would transpose
its collectives:

* :func:`copy_to_model` -- identity forward, sum all-reduce backward:
  before a column-parallel matmul (``wqkv``, ``w_gate`` / ``w_up``, the
  code predictor's ``w1``), whose replicated input feeds every rank's
  columns;
* :func:`reduce_from_model` -- sum all-reduce forward, identity backward:
  after a row-parallel matmul (``wo``, ``w_down``, ``w2``, the vocab-sharded
  lookup). Every rank then holds the same replicated activation and
  computes the same loss, so each already has the whole cotangent; an
  all-reduce backward (``torch.distributed.nn.functional.all_reduce``'s)
  would multiply the gradients by the axis size;
* :func:`gather_from` -- all-gather forward, this rank's slice backward.

They take any axis (the names say where tensor parallelism puts them):
``reduce_from_model`` over ``data`` sums the per-row loss, ``copy_to_model``
over ``pipe`` hands the stack's input gradient to every stage.

Each takes an ``Axis`` (``parallel.mesh``); over ``None`` or an axis of one
it returns its input and launches nothing, as XLA elides a collective over
a group of one. ``launches`` counts the collectives actually launched.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Axis

#: number of collectives launched (an axis of one launches none)
launches = 0


def _active(axis: Optional[Axis]) -> bool:
    return axis is not None and axis.size > 1


def _launched() -> None:
    global launches
    launches += 1


def all_reduce_sum(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Sum over ``axis``; reduces ``x`` in place (pass a tensor you own)."""
    if not _active(axis):
        return x
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=axis.group)
    _launched()
    return x


def all_reduce_max(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Elementwise max over ``axis``; reduces ``x`` in place."""
    if not _active(axis):
        return x
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=axis.group)
    _launched()
    return x


def all_gather(x: torch.Tensor, dim: int, axis: Optional[Axis]) -> torch.Tensor:
    """Concatenate every member's ``x`` along ``dim``, in axis order (JAX's
    ``all_gather(..., tiled=True)``). Bool tensors travel as bytes."""
    if not _active(axis):
        return x
    src = x.contiguous()
    as_bytes = src.dtype == torch.bool
    if as_bytes:
        src = src.view(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    _launched()
    out = torch.cat(parts, dim=dim)
    return out.view(torch.bool) if as_bytes else out


def broadcast(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """``x`` of the axis's first member, in place on every member."""
    if not _active(axis):
        return x
    dist.broadcast(x, src=dist.get_global_rank(axis.group, 0), group=axis.group)
    _launched()
    return x


def exchange(send, dst: Optional[int], recv, src: Optional[int], axis: Axis) -> None:
    """Point-to-point over ``axis``: the tensors ``send`` to member ``dst``,
    and the tensors ``recv`` filled from member ``src`` (pass ``[]`` /
    ``None`` for a side with nothing), as one batch of operations; the i-th
    tensor of a side travels with tag i. A pipeline's stage-to-stage hand-off
    (``parallel.pipeline``)."""
    rank = functools.partial(dist.get_global_rank, axis.group)
    ops = [dist.P2POp(dist.isend, t.contiguous(), rank(dst), axis.group, tag)
           for tag, t in enumerate(send)]
    ops += [dist.P2POp(dist.irecv, t, rank(src), axis.group, tag) for tag, t in enumerate(recv)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    _launched()


def vocab_embed(table: torch.Tensor, ids: torch.Tensor, axis: Optional[Axis],
                differentiable: bool = False) -> torch.Tensor:
    """``table[ids]`` with ``table`` this rank's contiguous vocab shard.

    Each rank looks up the ids of its own range and writes zero elsewhere;
    the sum over ``axis`` then holds every row exactly once, so the lookup
    is exact. ``differentiable`` sums with :func:`reduce_from_model`, so
    each rank's shard gets the gradient of its own rows.
    """
    if not _active(axis):
        return table[ids]
    rows = table.shape[0]
    local = ids - axis.index * rows
    hit = (local >= 0) & (local < rows)
    emb = torch.where(hit[..., None], table[local.clamp(0, rows - 1)], 0)
    return reduce_from_model(emb, axis) if differentiable else all_reduce_sum(emb, axis)


# ---------------------------------------------------------------------------
# Differentiable operators (training)
# ---------------------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.clone(), ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_sum(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis, ctx.n = dim, axis, x.shape[dim]
        return all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n), None, None


def copy_to_model(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Identity; its backward sums the gradient over ``axis``."""
    return _CopyTo.apply(x, axis) if _active(axis) else x


def reduce_from_model(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Sum over ``axis`` (``x`` is not modified); its backward is the identity."""
    return _ReduceFrom.apply(x, axis) if _active(axis) else x


def gather_from(x: torch.Tensor, dim: int, axis: Optional[Axis]) -> torch.Tensor:
    """:func:`all_gather` along ``dim``; its backward keeps this rank's slice."""
    return _GatherFrom.apply(x, dim, axis) if _active(axis) else x


def sum_gradients(grads, axes) -> list:
    """Sum a list of gradients over each axis in ``axes`` (``None`` and axes
    of one skipped): one all-reduce per axis and dtype, over the gradients
    laid end to end."""
    grads = list(grads)
    for axis in axes:
        if not _active(axis):
            continue
        by_dtype = {}
        for i, g in enumerate(grads):
            by_dtype.setdefault(g.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = all_reduce_sum(torch.cat([grads[i].reshape(-1) for i in idx]), axis)
            for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
                grads[i] = part.view_as(grads[i])
    return grads
