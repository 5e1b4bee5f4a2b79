"""Host-side checkpoint conversion utilities: HF safetensors to the port's tensors.

The port's copy of ``rho_tts_tpu/models/hf_weights.py``, on torch tensors
instead of numpy arrays (``safetensors.torch`` also reads bf16, which numpy
cannot hold). All matching is scoped: a tensor can only map into a component
when its name passes that component's scope filter, so same-suffix tensors
of different submodules (talker, codec and predictor all have
``q_proj.weight``-style names) never cross-map.
"""

from __future__ import annotations

import glob
import logging
import os
import re
from typing import Any, Callable, Dict, Optional, Sequence

import torch

logger = logging.getLogger(__name__)

Tensors = Dict[str, torch.Tensor]


def read_safetensors(model_path: str) -> Optional[Tensors]:
    """All ``*.safetensors`` under a checkpoint dir, merged (CPU tensors)."""
    files = sorted(glob.glob(os.path.join(model_path, "*.safetensors")))
    if not files:
        return None
    from safetensors.torch import load_file

    tensors: Tensors = {}
    for f in files:
        tensors.update(load_file(f, device="cpu"))
    return tensors


def scope(tensors: Tensors, include: Optional[Sequence[str]] = None,
          exclude: Sequence[str] = ()) -> Tensors:
    """Filter tensors to one component's namespace.

    ``include``: keep names containing ANY of these substrings (None keeps
    all). ``exclude``: then drop names containing any of these.
    """
    out = {}
    for name, t in tensors.items():
        if include is not None and not any(s in name for s in include):
            continue
        if any(s in name for s in exclude):
            continue
        out[name] = t
    return out


def find(tensors: Tensors, *suffixes: str) -> Optional[torch.Tensor]:
    """First tensor whose name ends with one of the suffixes."""
    for s in suffixes:
        for name, t in tensors.items():
            if name.endswith(s):
                return t
    return None


def layer_tensor(tensors: Tensors, layer: int, *suffixes: str) -> Optional[torch.Tensor]:
    """Tensor of transformer layer ``layer`` matched by suffix, under the HF
    ``...layers.{i}....`` pattern (word-bounded: layer 1 never matches 11)."""
    pat = re.compile(rf"(^|\.)layers\.{layer}\.")
    for s in suffixes:
        for name, t in tensors.items():
            if name.endswith(s) and pat.search(name):
                return t
    return None


def map_llama_blocks(tensors: Tensors, blocks: Dict[str, Any], n_layers: int,
                     count: Callable[[], None]) -> Dict[str, torch.Tensor]:
    """Map llama/qwen-family per-layer tensors into a stacked block tree.

    HF keeps separate ``{q,k,v,o}_proj`` / ``{gate,up,down}_proj`` linears
    stored (out, in); the port keeps a fused (in, q+k+v) ``wqkv`` and
    (in, out) matrices stacked over a leading layer axis. ``count`` is
    called once per tensor that lands. ``tensors`` must already be scoped to
    ONE transformer stack. A leaf every layer of which matched is built from
    the checkpoint alone; a partial match patches a copy of the existing
    leaf; an unmatched leaf is returned as it was. Matched leaves come back
    in f32 on the CPU; the caller casts them.
    """
    collected: Dict[str, Dict[int, torch.Tensor]] = {}

    def land(name: str, layer: int, value: torch.Tensor) -> None:
        want = tuple(blocks[name].shape[1:])
        if tuple(value.shape) != want:
            logger.warning("Layer %d %s shape %s != %s", layer, name, tuple(value.shape), want)
            return
        collected.setdefault(name, {})[layer] = value.float()
        count()

    for layer in range(n_layers):
        g = lambda *names: layer_tensor(tensors, layer, *names)  # noqa: E731
        q, k, v, o = (g(f"{n}_proj.weight") for n in ("q", "k", "v", "o"))
        gate, up, down = (g(f"{n}_proj.weight") for n in ("gate", "up", "down"))
        ln1 = g("input_layernorm.weight")
        ln2 = g("post_attention_layernorm.weight")
        if q is None or k is None or v is None:
            continue
        land("wqkv", layer, torch.cat([q.T, k.T, v.T], dim=1))
        if o is not None:
            land("wo", layer, o.T)
        for name, t in (("w_gate", gate), ("w_up", up), ("w_down", down)):
            if t is not None:
                land(name, layer, t.T)
        for name, t in (("attn_norm", ln1), ("mlp_norm", ln2)):
            if t is not None:
                land(name, layer, t)

    new_blocks: Dict[str, torch.Tensor] = {}
    for name, base in blocks.items():
        got = collected.get(name, {})
        if len(got) == n_layers:
            new_blocks[name] = torch.stack([got[i] for i in range(n_layers)])
        elif got:
            patched = base.detach().float().cpu().clone()  # partial match: patch the fallback
            for i, t in got.items():
                patched[i] = t
            new_blocks[name] = patched
        else:
            new_blocks[name] = base
    return new_blocks
