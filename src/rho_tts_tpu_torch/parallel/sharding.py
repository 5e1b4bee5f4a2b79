"""Sharding specs for the codec-LM parameter trees, and the cut of each
rank's shards (PyTorch port).

Counterpart of ``rho_tts_tpu/parallel/sharding.py``. Tensor-parallel
layout (Megatron-style):

* ``wqkv``   (L, hidden, qkv_out)   -> output columns over ``model``
* ``wo``     (L, q_heads*d, hidden) -> input rows over ``model``
  (row-parallel: the partial sums are all-reduced)
* ``w_gate`` / ``w_up`` (L, hidden, ffn) -> column-parallel
* ``w_down`` (L, ffn, hidden)           -> row-parallel
* ``text_embed``: vocab-sharded over ``model``; norms, heads and the
  codec replicated.

A spec is a tuple with one entry per tensor axis, the mesh axis that
splits it or None (JAX's ``PartitionSpec`` as plain data; ``()`` is fully
replicated). :func:`shard_params` cuts each rank's LOCAL shard out of the
whole tree (``from_jax.params_from_numpy``, ``init_params`` or a
checkpoint), where JAX's ``device_put`` lays the global array out. Three
leaves cannot copy GSPMD's contiguous layout, because the port computes on
its shards directly:

* the fused ``wqkv``: its columns are ``[q | k | v]``, so a contiguous
  split would hand a rank the wrong heads. Rank r gets its q heads, its k
  heads and its v heads (their scale ``s`` with them);
* an int4 row-parallel leaf (``wo``, ``w_down``): ``pack_int4`` packs row
  i with row i + K/2 into one byte, so a split of the packed rows gives a
  rank two K ranges. Each rank's contiguous K shard is repacked in halves
  of its own;
* the vocab-sharded ``text_embed`` is a contiguous row range, looked up by
  ``collectives.vocab_embed`` (zeros outside the range, then a sum).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..ops.cuda.int4_matmul import unpack_int4
from .collectives import all_gather
from .mesh import Axis, Mesh

Params = Dict[str, Any]
Spec = Tuple[Optional[str], ...]

# Per-block parameter specs; leading axis is the stacked layer dim.
_BLOCK_SPECS = {
    "attn_norm": (None, None),
    "wqkv": (None, None, "model"),
    "wo": (None, "model", None),
    "mlp_norm": (None, None),
    "w_gate": (None, None, "model"),
    "w_up": (None, None, "model"),
    "w_down": (None, "model", None),
}


def stack_specs() -> Params:
    """Spec tree for a transformer stack (see models.transformer)."""
    return {"blocks": dict(_BLOCK_SPECS), "final_norm": (None,)}


def _quantized_block_specs(blocks: Params, bspecs: Params) -> None:
    """Swap dense block specs for quantized-leaf dict specs in place:
    ``q`` / ``q4`` keep the dense spec, the per-output-channel scale ``s``
    drops the input axis."""
    for name, leaf in blocks.items():
        if isinstance(leaf, dict) and "s" in leaf and ("q" in leaf or "q4" in leaf):
            dense = tuple(bspecs[name])
            qkey = "q" if "q" in leaf else "q4"
            bspecs[name] = {qkey: dense, "s": dense[:-2] + dense[-1:]}


def _replicated(tree):
    if isinstance(tree, dict):
        return {k: _replicated(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_replicated(v) for v in tree]
    return ()


def qwen_param_specs(params: Params) -> Params:
    """Spec tree matching models.qwen.model.init_params."""
    specs: Params = {
        # Text vocab is large and divisible; the audio vocab (codebook + 3
        # specials) is replicated, a few MB.
        "text_embed": ("model", None),
        "audio_embed": (None, None, None),
        "speaker_embed": (None, None),
        "talker": stack_specs(),
        "lm_head": (None, None),
        "code_predictor": {"w1": (None, None, "model"), "w2": (None, "model", None)},
        "codec": _replicated(params["codec"]),
    }
    _quantized_block_specs(params["talker"]["blocks"], specs["talker"]["blocks"])
    return specs


def chatterbox_param_specs(params: Params) -> Params:
    """Spec tree matching models.chatterbox.model.init_params: the Qwen
    recipe over the shared stack; ``speech_embed``, ``spk_proj``,
    ``lm_head`` and the codec replicated."""
    specs: Params = {
        "text_embed": ("model", None),
        "speech_embed": (None, None),
        "spk_proj": (None, None),
        "talker": stack_specs(),
        "lm_head": (None, None),
        "codec": _replicated(params["codec"]),
    }
    _quantized_block_specs(params["talker"]["blocks"], specs["talker"]["blocks"])
    return specs


def param_specs_for(params: Params) -> Params:
    """Spec tree for either codec-LM family, keyed on the tree's shape (the
    Chatterbox tree carries ``spk_proj``; the Qwen tree ``code_predictor``)."""
    if "spk_proj" in params:
        return chatterbox_param_specs(params)
    return qwen_param_specs(params)


def param_shardings(mesh: Mesh, params: Params, specs: Params) -> Dict[str, Spec]:
    """Every leaf's spec by its ``"a/b/c"`` path, as JAX's NamedShardings
    are keyed; a leaf missing from the (partial) spec tree is replicated."""
    spec_map = _flatten(specs)
    return {"/".join(path): spec_map.get(path, ()) for path in _flatten(params)}


def _cut(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """This rank's contiguous ``1/size`` of ``x`` along ``dim`` (a copy)."""
    n = x.shape[dim]
    if n % axis.size:
        raise ValueError(f"axis {dim} of {tuple(x.shape)} does not divide over "
                         f"{axis.name}={axis.size}")
    step = n // axis.size
    return x.narrow(dim, axis.index * step, step).clone()


def _cut_heads(x: torch.Tensor, axis: Axis, cfg) -> torch.Tensor:
    """This rank's q, k and v head columns of a fused ``[q | k | v]`` last axis."""
    d = cfg.head_dim
    parts, lo = [], 0
    for heads in (cfg.q_heads, cfg.kv_heads, cfg.kv_heads):
        if heads % axis.size:
            raise ValueError(f"{heads} heads do not divide over {axis.name}={axis.size}")
        parts.append(_cut(x.narrow(-1, lo, heads * d), x.dim() - 1, axis))
        lo += heads * d
    return torch.cat(parts, dim=-1)


def _pack_rows(vals: torch.Tensor) -> torch.Tensor:
    """Signed nibbles ``(..., K, N)`` packed as ``pack_int4`` packs them: row
    i in the low nibble of byte i, row i + K/2 in its high nibble."""
    k = vals.shape[-2]
    if k % 2:
        raise ValueError(f"an int4 row shard of {k} rows cannot be packed")
    b = ((vals[..., k // 2:, :] & 0xF) << 4) | (vals[..., : k // 2, :] & 0xF)
    return torch.where(b > 127, b - 256, b).to(torch.int8)


def _repack_int4_rows(q4: torch.Tensor, axis: Axis) -> torch.Tensor:
    """This rank's contiguous K shard of packed int4 ``(..., K/2, N)``,
    repacked in halves of its own: ``(..., K/(2*size), N)``."""
    vals = unpack_int4(q4).to(torch.int32)  # (..., K, N) signed nibbles
    return _pack_rows(_cut(vals, vals.dim() - 2, axis))


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], Any]:
    """``path -> leaf`` of a tree of dicts and lists (a spec, a tuple, is a leaf)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (str(i),)))
    else:
        out[prefix] = tree
    return out


def shard_params(mesh: Mesh, params: Params, specs: Params, talker_cfg=None) -> Params:
    """This rank's shard of every leaf under the spec tree (partial ok: a
    leaf missing from the spec tree is replicated).

    ``talker_cfg`` (the stack's ``TransformerConfig``) gives the head split
    of the fused ``wqkv``; it is needed when ``wqkv`` is split.
    """
    spec_map = _flatten(specs)

    def place(path, leaf):
        if isinstance(leaf, dict):
            return {k: place(path + (str(k),), v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return [place(path + (str(i),), v) for i, v in enumerate(leaf)]
        spec = spec_map.get(path, ())
        for dim, name in enumerate(spec):
            if name is None or mesh.shape.get(name, 1) == 1:
                continue
            axis = mesh.axis(name)
            if "wqkv" in path and dim == len(spec) - 1:
                if talker_cfg is None:
                    raise ValueError("shard_params: splitting wqkv needs talker_cfg")
                leaf = _cut_heads(leaf, axis, talker_cfg)
            elif path[-1] == "q4" and dim == len(spec) - 2:
                leaf = _repack_int4_rows(leaf, axis)
            else:
                leaf = _cut(leaf, dim, axis)
        return leaf

    return place((), params)


def gather_params(mesh: Mesh, local: Params, specs: Params, talker_cfg=None) -> Params:
    """The whole tree from every rank's shards: the inverse of
    :func:`shard_params` (a collective: every rank of the mesh calls it and
    gets the whole tree). ``wqkv``'s head columns go back to ``[q | k | v]``
    and int4 row shards are unpacked, gathered and packed whole again, so
    the result is bit for bit the tree that was cut."""
    spec_map = _flatten(specs)

    def place(path, leaf):
        if isinstance(leaf, dict):
            return {k: place(path + (str(k),), v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return [place(path + (str(i),), v) for i, v in enumerate(leaf)]
        spec = spec_map.get(path, ())
        for dim, name in enumerate(spec):
            if name is None or mesh.shape.get(name, 1) == 1:
                continue
            axis = mesh.axis(name)
            if "wqkv" in path and dim == len(spec) - 1:
                if talker_cfg is None:
                    raise ValueError("gather_params: joining wqkv needs talker_cfg")
                leaf = _gather_heads(leaf, axis, talker_cfg)
            elif path[-1] == "q4" and dim == len(spec) - 2:
                vals = unpack_int4(leaf).to(torch.int32)
                leaf = _pack_rows(all_gather(vals, vals.dim() - 2, axis))
            else:
                leaf = all_gather(leaf, dim, axis)
        return leaf

    return place((), local)


def _gather_heads(x: torch.Tensor, axis: Axis, cfg) -> torch.Tensor:
    """The whole fused ``[q | k | v]`` last axis from every rank's
    ``[q_r | k_r | v_r]`` (the inverse of :func:`_cut_heads`)."""
    d, n = cfg.head_dim, axis.size
    widths = [h // n * d for h in (cfg.q_heads, cfg.kv_heads, cfg.kv_heads)]
    ranks = all_gather(x, x.dim() - 1, axis).split(sum(widths), dim=-1)
    parts = [r.split(widths, dim=-1) for r in ranks]
    return torch.cat([p[i] for i in range(3) for p in parts], dim=-1)


def whole_params(model) -> Params:
    """A model's whole params tree: on a tensor-parallel mesh its shards
    gathered (a collective), else its own tree."""
    if model.tp_axis is None:
        return model.params
    with torch.no_grad():
        return gather_params(model.mesh, model.params, param_specs_for(model.params),
                             model.config.talker)


def cut_lora(name: str, a: torch.Tensor, b: torch.Tensor, axis: Optional[Axis], talker_cfg=None,
             pipe: Optional[Axis] = None):
    """The LoRA factors whose product is this rank's cut of ``a @ b`` for the
    block weight ``name``: ``b``'s columns of a column-parallel weight
    (``wqkv`` by heads), ``a``'s rows of a row-parallel one, and this
    pipeline stage's layers of both. Differentiable; the whole factors on
    ``None`` or axes of one."""
    if pipe is not None and pipe.size > 1:
        a, b = _cut(a, 0, pipe), _cut(b, 0, pipe)
    if axis is None or axis.size == 1:
        return a, b
    spec = _BLOCK_SPECS[name]
    if spec[-1] == "model":
        return a, (_cut_heads(b, axis, talker_cfg) if name == "wqkv" else _cut(b, 2, axis))
    return _cut(a, 1, axis), b


def batch_sharding(mesh: Mesh, ndim: int) -> Spec:
    """The spec of a batch-sharded array: leading axis over ``data``."""
    return ("data",) + (None,) * (ndim - 1)
