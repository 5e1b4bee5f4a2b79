"""Multi-GPU inference: DP, TP and SP meshes (PyTorch port).

Counterpart of ``rho_tts_tpu/parallel/inference.py``. One process per GPU
(``parallel.mesh``); every rank calls the same entry point with the same
inputs and gets the whole result.

* Data parallelism (:func:`enable_data_parallel`): weights replicated,
  batch rows split over ``data``; each rank decodes its rows and the codes
  are all-gathered once at the end. Serving splits its slot rows the same
  way.
* Tensor parallelism (:func:`enable_tensor_parallel`): the talker's
  weights split Megatron-style over ``model`` (``sharding``), the KV cache
  over its heads, two sum all-reduces per block; rows still over ``data``.
* Sequence parallelism (:func:`enable_sequence_parallel`): weights
  replicated, the PREFILL's prompt axis split over ``model``; K/V
  all-gathered per layer for the causal attention, whose kernel runs on
  the local queries at their global offset. Decode is the DP layout.

Usage, in every rank (``torchrun --nproc-per-node N``)::

    initialize_distributed()                  # from torchrun's environment
    model = QwenTTSModel(cfg)                 # on cuda:{LOCAL_RANK}
    enable_data_parallel(model, create_mesh(model_parallel=1))
    waves, sr = model.synthesize([...])       # the whole batch, on every rank
"""

from __future__ import annotations

import logging

import torch
import torch.distributed as dist

from .mesh import Mesh, create_mesh, initialize_distributed, world_size
from .sharding import _cut, param_specs_for, shard_params

logger = logging.getLogger(__name__)


def replicate_params(params, mesh: Mesh):
    """Make every rank of the mesh hold the first rank's weights, in place.

    Each process already holds a whole tree; replication is the contract
    that they are the same, so every leaf is broadcast from the mesh's
    first rank (over ``data``, then over ``model``). An axis of one sends
    nothing.
    """
    for name in mesh.axis_names:
        axis = mesh.axis(name)
        if axis.group is None:
            continue
        src = dist.get_global_rank(axis.group, 0)
        with torch.no_grad():
            for t in _leaves(params):
                dist.broadcast(t.data, src=src, group=axis.group)
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def shard_batch(tree, mesh: Mesh):
    """This rank's rows of each tensor: the leading axis split over ``data``."""
    data = mesh.axis("data")
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [shard_batch(v, mesh) for v in tree]
    return tree if data.size == 1 else _cut(tree, 0, data)


def enable_parallelism(model, mode: str, n_devices=None) -> None:
    """Provider-level mesh setup from a ``parallelism`` mode string.

    ``mode`` is "data" or "tensor". The process group starts from the
    environment if it has not (``initialize_distributed``); the device
    count is the world size. With "tensor", the TP degree is the largest of
    (4, 2) dividing both the count and the model's KV heads; leftover ranks
    form a ``data`` axis. A world of one logs and leaves the model unmeshed.
    """
    if mode not in ("data", "tensor"):
        raise ValueError(f"Unknown parallelism mode: {mode!r}")
    initialize_distributed(device=model.device)
    n = n_devices or world_size()
    if n <= 1:
        logger.warning("parallelism=%r requested but only %d device(s) visible", mode, n)
        return
    if mode == "data":
        enable_data_parallel(model, create_mesh(n, model_parallel=1))
    else:
        kv_heads = model.config.talker.kv_heads
        mp = 1
        for cand in (4, 2):
            if n % cand == 0 and kv_heads % cand == 0:
                mp = cand
                break
        enable_tensor_parallel(model, create_mesh(n, model_parallel=mp))


def _require_dense(model, what: str) -> None:
    """A Qwen-class model with a hybrid talker raises ``NotImplementedError``."""
    from ..models.transformer import require_dense

    talker = getattr(getattr(model, "config", None), "talker", None)
    if talker is not None:
        require_dense(talker, what)


def enable_data_parallel(model, mesh: Mesh) -> None:
    """Switch a model to mesh execution in place: weights replicated, batch
    rows over ``data`` (the model pads a batch to a multiple of it)."""
    _require_dense(model, "a data-parallel mesh")
    replicate_params(model.params, mesh)
    model.mesh = mesh
    logger.info("Data-parallel inference enabled: mesh=%s", mesh.shape)


def enable_sequence_parallel(model, mesh: Mesh) -> None:
    """Split the PREFILL's prompt axis over the mesh ``model`` axis.

    Weights replicated (DP-style), rows over ``data``, and each prefill
    layer's per-token work on 1/mp of the prompt: RoPE, the projections and
    the MLP run on the local tokens, K/V are all-gathered for the causal
    attention (``ops.cuda.attention.sp_fused_gqa_attention``: the prefill
    kernel on the local queries at their global offset) and written whole
    into the cache, which is then the decode layout. Decode is DP. A model
    without a sequence-parallel prefill (Chatterbox's CFG prefill) raises.
    """
    _require_dense(model, "a sequence-parallel mesh")
    if not hasattr(model, "seq_parallel"):
        raise ValueError(
            f"{type(model).__name__} has no sequence-parallel prefill; use "
            "enable_data_parallel or enable_tensor_parallel")
    if mesh.shape.get("model", 1) < 2:
        raise ValueError(
            "sequence-parallel prefill needs a mesh 'model' axis >= 2 "
            f"(got mesh {mesh.shape}); create_mesh(n, model_parallel=mp)")
    replicate_params(model.params, mesh)
    model.mesh = mesh
    model.seq_parallel = True
    logger.info("Sequence-parallel prefill enabled: mesh=%s", mesh.shape)


def enable_tensor_parallel(model, mesh: Mesh) -> None:
    """Shard a model's weights over the mesh ``model`` axis, in place.

    wqkv / w_gate / w_up columns and wo / w_down rows split over ``model``
    (two sum all-reduces per block), the text embedding by vocab rows, and
    the KV caches over the KV heads. Batch rows still spread over ``data``.
    Works for both codec-LM families (the spec tree follows the tree's
    shape, ``sharding.param_specs_for``).
    """
    from ..models.qwen.model import _register

    _require_dense(model, "a tensor-parallel mesh")
    mp = mesh.shape.get("model", 1)
    talker = model.config.talker
    if talker.kv_heads % mp != 0:
        raise ValueError(
            f"model axis ({mp}) must divide kv_heads ({talker.kv_heads}) so the "
            "KV cache shards evenly over heads")
    with torch.no_grad():
        local = shard_params(mesh, model.params, param_specs_for(model.params), talker)
    # Re-register: the module's parameters become this rank's shards.
    model.params = {key: _register(model, key, value) for key, value in local.items()}
    model.mesh = mesh
    model.tp_axis = mesh.axis("model") if mp > 1 else None
    logger.info("Tensor-parallel inference enabled: mesh=%s", mesh.shape)
