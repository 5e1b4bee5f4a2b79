"""Native serving checkpoints of the port: a full parameter tree, saved once, served many times.

Counterpart of ``rho_tts_tpu/models/checkpoint.py``, with the port's own
payload: the JAX package writes orbax, which the port does not read. A
checkpoint directory holds

* ``params.pt``: a flat ``name -> tensor`` dict written with ``torch.save``,
  the names those of the params tree joined by dots
  (``talker.blocks.wqkv.q4``, ``codec.decoder.ups.0``), and
* ``rho_tts_tpu_torch.json``: the manifest, with the same fields as the
  JAX package's (``format``, ``version``, ``family``, ``preset``,
  ``quantization``, extras such as ``variant``).

The manifest's name differs from the JAX package's ``rho_tts_tpu.json``, so
neither package takes the other's directory for its own. A quantized tree
saves its int8 / int4 leaves, so serving moves the quantized bytes and
skips the quantize pass. A JAX export reaches the port through
``from_jax.params_from_numpy`` (restore the orbax tree with the JAX
package, convert it, and save it here).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

MANIFEST = "rho_tts_tpu_torch.json"
JAX_MANIFEST = "rho_tts_tpu.json"
_PARAMS_FILE = "params.pt"
FORMAT = "rho-tts-tpu-torch-checkpoint"


def is_native_checkpoint(path: str) -> bool:
    """True when ``path`` holds a checkpoint written by :func:`save_params`."""
    return os.path.isfile(os.path.join(str(path), MANIFEST))


def is_jax_checkpoint(path: str) -> bool:
    """True when ``path`` holds a JAX-package (orbax) export and no port one."""
    return (os.path.isfile(os.path.join(str(path), JAX_MANIFEST))
            and not is_native_checkpoint(path))


def flatten(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dicts/lists of tensors -> ``{"a.b.0": tensor}``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree.detach()}
    out: Dict[str, torch.Tensor] = {}
    for key, value in items:
        key = str(key)
        if "." in key:
            raise ValueError(f"params key {key!r} contains a '.'")
        out.update(flatten(value, f"{prefix}.{key}" if prefix else key))
    return out


def unflatten(flat: Dict[str, torch.Tensor]) -> Any:
    """Inverse of :func:`flatten`: a node whose keys are exactly 0..n-1 is a list."""
    root: Dict[str, Any] = {}
    for name, value in flat.items():
        node = root
        *parents, leaf = name.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and sorted(node) == sorted(str(i) for i in range(len(node))):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def save_params(path: str, params: Dict[str, Any], *, family: str, preset: str,
                quantization: Optional[str] = None,
                extra: Optional[Dict[str, Any]] = None) -> None:
    """Save a parameter tree and its manifest under ``path`` (a directory)."""
    path = os.path.abspath(os.path.expanduser(str(path)))
    os.makedirs(path, exist_ok=True)
    torch.save(flatten(params), os.path.join(path, _PARAMS_FILE))
    manifest = {
        "format": FORMAT,
        "version": 1,
        "family": family,
        "preset": preset,
        "quantization": quantization,
    }
    if extra:
        manifest.update(extra)
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    logger.info("Saved %s/%s checkpoint to %s", family, preset, path)


def load_manifest(path: str) -> Dict[str, Any]:
    with open(os.path.join(str(path), MANIFEST)) as f:
        return json.load(f)


def load_params(path: str, *, family: str, device=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Restore ``(params, manifest)`` saved by :func:`save_params`, the
    tensors loaded straight onto ``device`` (default ``"cuda"``)."""
    path = os.path.abspath(os.path.expanduser(str(path)))
    if is_jax_checkpoint(path):
        raise ValueError(
            f"{path} is a JAX-package (orbax) export, which the port does not read: restore it "
            "with rho_tts_tpu.models.checkpoint.load_params, convert the numpy tree with "
            "rho_tts_tpu_torch.from_jax.params_from_numpy, and save it with the port's "
            "save_checkpoint"
        )
    manifest = load_manifest(path)
    if manifest.get("family") != family:
        raise ValueError(
            f"Checkpoint at {path} is for family {manifest.get('family')!r}, not {family!r}"
        )
    flat = torch.load(os.path.join(path, _PARAMS_FILE), weights_only=True,
                      map_location=torch.device(device or "cuda"))
    return unflatten(flat), manifest
