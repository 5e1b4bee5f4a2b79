"""Mesh construction on ``torch.distributed`` (PyTorch port).

Counterpart of ``rho_tts_tpu/parallel/mesh.py``. Axis convention as JAX's:

* ``data``  -- batch/data parallelism (segments, texts, serving slots);
* ``model`` -- tensor parallelism (attention heads, FFN columns), or the
  prompt axis under sequence-parallel prefill;
* ``pipe``  -- pipeline stages of the talker's layers (``parallel.pipeline``,
  a ``(data, pipe)`` mesh from ``create_mesh(axis_names=...)``).

Execution model. JAX runs one controller per host that drives every
device. The port runs ONE PROCESS PER GPU, SPMD, on ``torch.distributed``:
NCCL for CUDA tensors, gloo where the caller asks for the CPU (as the
tests do). Every rank makes the same call with the same inputs; each rank
computes its own rows (``data``) or heads (``model``) and every rank
returns the WHOLE result, as a JAX caller gets it. This is the discipline
the JAX package certifies for its multi-host runs (``serving._np_fetch``,
``parallel.multihost_dryrun``): the scheduler is deterministic, so every
rank reaches the same collectives in the same order. In JAX the device
count is ``len(jax.devices())``; here it is the world size. Under a mesh,
``device=None`` means ``cuda:{LOCAL_RANK}`` (:func:`initialize_distributed`
sets that device current).

Each rank keeps its shards as plain local tensors and calls the
collectives explicitly (``parallel.collectives``); there is no DTensor. The
hand kernels take plain tensors, and an explicit step stays open to CUDA
graph capture. A collective over an axis whose group has one member
returns its input and launches nothing, as XLA elides it.

The ``data`` axis is the major one: rank ``r`` sits at ``(r // mp, r %
mp)``, so a ``model`` (TP) group is a run of adjacent ranks, which
``torchrun`` places on one node.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its size, this rank's index on it
    and the process group of the ranks that share every other coordinate
    (``None`` for an axis of one, whose collectives launch nothing)."""

    name: str
    size: int
    index: int
    group: Optional[dist.ProcessGroup] = None


class Mesh:
    """A ``(data, model)`` mesh over the first ``dp * mp`` ranks.

    Holds the ``torch.distributed`` ``DeviceMesh`` (one process group per
    axis), ``shape`` as JAX's ``{"data": dp, "model": mp}``, this rank's
    ``coords`` and the :class:`Axis` of each name (:meth:`axis`).
    ``control`` spans every rank of the mesh over gloo: host decisions that
    every rank must share (the serving engines' schedule) travel on it as
    CPU tensors, without a device sync.
    """

    def __init__(self, device_mesh, shape: Dict[str, int], axis_names: Sequence[str],
                 control: Optional[dist.ProcessGroup] = None):
        self.device_mesh = device_mesh
        self.shape = dict(shape)
        self.axis_names = tuple(axis_names)
        coord = device_mesh.get_coordinate()
        self.coords = dict(zip(self.axis_names, coord))
        self._axes = {}
        for name in self.axis_names:
            size = self.shape[name]
            group = device_mesh.get_group(name) if size > 1 else None
            if group is not None and dist.get_rank(group) != self.coords[name]:
                raise RuntimeError(f"mesh axis {name!r}: group rank != coordinate")
            self._axes[name] = Axis(name, size, self.coords[name], group)
        n = math.prod(self.shape.values())
        self.control = Axis("mesh", n, dist.get_rank() if n > 1 else 0, control)

    def axis(self, name: str) -> Axis:
        return self._axes[name]

    def write_on_first_rank(self, write) -> None:
        """``write()`` on the mesh's first rank while the others wait at a
        barrier (over ``control``; none on a mesh of one): one writer of a
        file every rank asks for."""
        if self.control.index == 0:
            write()
        if self.control.group is not None:
            dist.barrier(group=self.control.group)


def mesh_axis(mesh: Optional[Mesh], name: str) -> Optional[Axis]:
    """``mesh``'s ``name`` axis, or None (no mesh, or no such axis)."""
    return mesh.axis(name) if mesh is not None and name in mesh.shape else None


def default_mesh_shape(n_devices: int, model_parallel: Optional[int] = None) -> Tuple[int, int]:
    """Pick (data, model) sizes for ``n_devices``.

    Model parallelism defaults to the largest power of two <= 4 that divides
    the device count (a 1.7B-class model rarely benefits from TP > 4; the
    rest goes to batch parallelism).
    """
    if model_parallel is None:
        model_parallel = 1
        for cand in (4, 2):
            if n_devices % cand == 0:
                model_parallel = cand
                break
    return n_devices // model_parallel, model_parallel


def world_size() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def create_mesh(n_devices: Optional[int] = None, model_parallel: Optional[int] = None,
                axis_names: Sequence[str] = ("data", "model")) -> Mesh:
    """Create a 2-D (data, model) mesh over the first ``n_devices`` ranks.

    Every rank of the world must call it (process groups are made
    collectively); a rank outside the mesh then gets ``ValueError``. The
    process group comes first (:func:`initialize_distributed`).
    """
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call initialize_distributed() "
                           "(a world of one is enough for a mesh of one)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks needs a world of at least {n} (got {world})")
    dp, mp = default_mesh_shape(n, model_parallel)
    if dp * mp != n:
        raise ValueError(f"model_parallel={mp} does not divide {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = DeviceMesh(device_type, torch.arange(n).reshape(dp, mp),
                    mesh_dim_names=tuple(axis_names))
    control = dist.new_group(list(range(n)), backend="gloo") if n > 1 else None
    if dm.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is outside the {dp}x{mp} mesh of ranks "
                         f"0..{n - 1}")
    return Mesh(dm, dict(zip(axis_names, (dp, mp))), axis_names, control)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device=None,
                           local_rank: Optional[int] = None, timeout_s: float = 600.0) -> bool:
    """Start the process group from arguments or the environment; idempotent.

    Arguments default to ``RHO_TTS_TPU_COORDINATOR`` (``host:port``, or an
    ``init_method`` URL such as ``file:///path``) / ``_NUM_PROCESSES`` /
    ``_PROCESS_ID``, else torchrun's ``MASTER_ADDR``:``MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK``. ``device`` ``"cpu"`` selects
    gloo; otherwise NCCL on ``cuda:{local_rank}``, which becomes the current
    device. Without any of these it stays a plain single process and
    returns False, as JAX's stays single-process off a pod. A collective
    that waits longer than ``timeout_s`` raises.
    """
    if dist.is_initialized():
        return True
    addr = coordinator_address or os.environ.get("RHO_TTS_TPU_COORDINATOR")
    n = num_processes if num_processes is not None else _env_int("RHO_TTS_TPU_NUM_PROCESSES")
    rank = process_id if process_id is not None else _env_int("RHO_TTS_TPU_PROCESS_ID")
    if addr is None and n is None and os.environ.get("MASTER_ADDR"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        n, rank = _env_int("WORLD_SIZE"), _env_int("RANK")
    if addr is None and n is None:
        return False
    if addr is None:
        raise ValueError(f"{n} processes need a coordinator address (RHO_TTS_TPU_COORDINATOR)")
    n = 1 if n is None else n
    rank = 0 if rank is None else rank
    init_method = addr if "://" in addr else f"tcp://{addr}"
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if on_cpu:
        backend = "gloo"
    else:
        if local_rank is None:
            local_rank = _env_int("LOCAL_RANK")
        if local_rank is None:
            local_rank = rank % max(torch.cuda.device_count(), 1)
        torch.cuda.set_device(local_rank)
        backend = "nccl"
    from datetime import timedelta

    dist.init_process_group(backend, init_method=init_method, world_size=n, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    logger.info("process group: rank %d of %d (%s, %s)", rank, n, backend, init_method)
    return True


def shutdown_distributed() -> None:
    """Destroy the process group (and with it every mesh's groups)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A free TCP port on the loopback interface (for a local coordinator)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def create_multihost_mesh(model_parallel: Optional[int] = None,
                          axis_names: Sequence[str] = ("data", "model")) -> Mesh:
    """Mesh over the whole world with ``model`` kept within one node.

    The node size is ``LOCAL_WORLD_SIZE`` (torchrun's; the world size when
    unset). ``data`` runs over the nodes and the ranks of a node, major
    axis first, so TP collectives ride a node's NVLink and only ``data``
    crosses nodes. ``model_parallel`` must divide the node size.
    """
    world = world_size()
    local = _env_int("LOCAL_WORLD_SIZE") or world
    _dp_local, mp = default_mesh_shape(local, model_parallel)
    if mp > local or local % mp:
        raise ValueError(
            f"model_parallel ({mp}) must fit within one node's {local} ranks "
            "(TP collectives must stay on the node)")
    return create_mesh(world, model_parallel=mp, axis_names=axis_names)
