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
  first rank over its gloo ``control`` axis.

Each takes an ``Axis`` (``parallel.mesh``); over ``None`` or an axis of one
it returns its input and launches nothing, as XLA elides a collective over
a group of one. ``launches`` counts the collectives actually launched.
"""

from __future__ import annotations

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


def vocab_embed(table: torch.Tensor, ids: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """``table[ids]`` with ``table`` this rank's contiguous vocab shard.

    Each rank looks up the ids of its own range and writes zero elsewhere;
    the sum over ``axis`` then holds every row exactly once, so the lookup
    is exact.
    """
    if not _active(axis):
        return table[ids]
    rows = table.shape[0]
    local = ids - axis.index * rows
    hit = (local >= 0) & (local < rows)
    emb = torch.where(hit[..., None], table[local.clamp(0, rows - 1)], 0)
    return all_reduce_sum(emb, axis)
