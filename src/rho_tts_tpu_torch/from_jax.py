"""Weights bridge: a JAX params tree, already converted to numpy, to the port.

The port never imports jax: the caller converts the tree first, e.g.
``jax.tree.map(np.asarray, model.params)``, and hands the nested
dicts/lists of numpy arrays to :func:`params_from_numpy`. bf16 and float8
arrays (numpy's ``ml_dtypes`` types) are reinterpreted bit for bit; int8
``{"q", "s"}`` leaves pass through unchanged.

Conv weights change layout: JAX keeps ``(K, Cin, Cout)``; the port keeps
torch's ``(Cout, Cin, K)`` for a convolution and ``(Cin, Cout, K)`` for a
transposed convolution (``codec.decoder.ups``), unflipped. That covers the
Qwen codec's convs and the Whisper tree's stem (``conv1.w``, ``conv2.w``).
The speaker encoder's tree crosses as it is: the port keeps the JAX layout
of its LSTM (``lstm[i].{w_ih (D, 4H), w_hh (H, 4H), bias}``).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

# numpy dtype names of the ml_dtypes extension types -> (bit-width view, torch dtype)
_BIT_VIEWS = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
}


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    view = _BIT_VIEWS.get(a.dtype.name)
    if view is not None:
        bits, dtype = view
        return torch.from_numpy(a.view(bits).copy()).view(dtype)
    return torch.from_numpy(a.copy())


def _is_conv(path: Tuple[str, ...], a: np.ndarray) -> bool:
    if a.ndim != 3 or len(path) < 2:
        return False
    if path[0] == "codec":
        return path[1] != "rvq"
    return path[0] in ("conv1", "conv2") and path[1] == "w"  # the Whisper stem


def params_from_numpy(tree: Any, device=None, dtype: Optional[torch.dtype] = None) -> Any:
    """Convert a numpy params tree to the port's tensors on ``device``.

    ``dtype`` casts every floating leaf except int8 scales ``s`` (which stay
    f32, as in the JAX package); ``None`` keeps each leaf's dtype.
    """
    device = torch.device(device or "cuda")

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, path + (str(i),)) for i, v in enumerate(node)]
        a = np.asarray(node)
        if _is_conv(path, a):
            a = a.transpose(1, 2, 0) if "ups" in path else a.transpose(2, 1, 0)
        t = _to_tensor(a)
        if dtype is not None and t.is_floating_point() and path[-1] != "s":
            t = t.to(dtype)
        return t.to(device)

    return walk(tree, ())
