"""Device-mesh helpers on ``torch.distributed``.

Counterpart of `mlx_audio_primitives_tpu/parallel/mesh.py`, with its names,
signatures and checks. A ``jax.sharding.Mesh`` becomes a
``torch.distributed.device_mesh.DeviceMesh`` with the same axis names
(``mesh_dim_names``): ``data``, ``time``, ``model``, ``stage``, ``expert``.
Its entries are ranks of the default process group, one rank per device;
``devices=`` names them (a list of ranks), in the mesh's row-major order.

The device type follows ``_config.DEFAULT_DEVICE``: ``cuda`` meshes talk
over NCCL, ``cpu`` meshes over gloo. When no process group exists, a
constructor starts one: from the launcher's ``RANK`` / ``WORLD_SIZE``
(``env://``) where they are set, else a world of one, as a single JAX process
sees its own devices. A card never falls back to gloo.

A ``NamedSharding(mesh, PartitionSpec(...))`` becomes :class:`NamedSharding`,
the mesh and its DTensor placements (one per mesh dimension):
:func:`batch_sharding` is ``Shard(0)`` on ``data``, :func:`batch_time_sharding`
adds ``Shard(1)`` on ``time``, :func:`replicated` is ``Replicate()``
everywhere. :class:`PartitionSpec` keeps the JAX spec trees of ``models/``
readable; :func:`placements` turns one into placements.

JAX's topology-aware layout (``mesh_utils.create_device_mesh``) has no
counterpart: the cards of one host are joined all to all by NVLink, so
ranks are taken in order.
"""

from __future__ import annotations

import datetime
import os
import warnings
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Placement, Replicate, Shard

from ..utils import dispatch

DATA_AXIS = "data"
TIME_AXIS = "time"
MODEL_AXIS = "model"
STAGE_AXIS = "stage"
EXPERT_AXIS = "expert"

#: How long a collective may wait for its peers before it raises.
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)


class PartitionSpec:
    """``PartitionSpec("model")``, ``PartitionSpec(None, "model")``: which
    mesh axis (or tuple of axes) shards each tensor dimension, as in JAX.
    Not a tuple, so the port's tree functions take it as one leaf."""

    def __init__(self, *parts):
        self.parts = parts

    def __iter__(self):
        return iter(self.parts)

    def __len__(self) -> int:
        return len(self.parts)

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and self.parts == other.parts

    def __hash__(self) -> int:
        return hash(self.parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.parts!r}"


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and one DTensor placement per mesh dimension."""

    mesh: DeviceMesh
    placements: tuple[Placement, ...]


def placements(mesh: DeviceMesh, spec: PartitionSpec) -> tuple[Placement, ...]:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each mesh
    axis that ``spec`` names for tensor dimension ``i``, ``Replicate()`` on
    the others. An axis named twice, or absent from the mesh, raises."""
    where: dict[str, int] = {}
    for dim, part in enumerate(spec):
        for name in part if isinstance(part, tuple) else (part,):
            if name is None:
                continue
            if name not in mesh.mesh_dim_names:
                raise ValueError(f"{spec} names axis '{name}', not in mesh axes "
                                 f"{mesh.mesh_dim_names}")
            if name in where:
                raise ValueError(f"{spec} names axis '{name}' twice")
            where[name] = dim
    return tuple(Shard(where[n]) if n in where else Replicate() for n in mesh.mesh_dim_names)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """Size of the mesh axis ``name`` (``mesh.shape[name]`` in JAX)."""
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_index(mesh: DeviceMesh, name: str) -> int:
    """This rank's coordinate on axis ``name`` (``lax.axis_index``)."""
    return mesh.get_local_rank(name)


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _device_type() -> str:
    # raises for ``cuda`` without a CUDA device: no fallback to the CPU
    return dispatch.default_device().type


def _ensure_world(device_type: str) -> None:
    """Start the default process group if none exists: from the launcher's
    environment where ``RANK`` and ``WORLD_SIZE`` are set, else a world of
    one in this process."""
    if dist.is_initialized():
        return
    backend = _backend(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, timeout=COLLECTIVE_TIMEOUT)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=COLLECTIVE_TIMEOUT)


def _ranks(devices: list | None) -> list[int]:
    """The ranks a mesh may take: ``devices`` (ranks), or the whole world."""
    _ensure_world(_device_type())
    if devices is None:
        return list(range(dist.get_world_size()))
    return [int(d) for d in devices]


def _infer_leading(lead_name: str, other: int, other_name: str, devices: list) -> int:
    """Fill an omitted leading dim so the mesh covers every device."""
    if len(devices) % other != 0:
        raise ValueError(
            f"{len(devices)} devices do not divide evenly over "
            f"{other_name}={other}; pass {lead_name} explicitly"
        )
    return len(devices) // other


def _grid_mesh(axis_names: tuple[str, ...], dims: tuple[int, ...],
               devices: list | None) -> DeviceMesh:
    """Shared constructor body: validation, then the first ranks in order."""
    ranks = _ranks(devices)
    for name, v in zip(axis_names, dims):
        if v < 1:
            raise ValueError(f"n_{name} must be >= 1, got {v}")
    n = int(np.prod(dims))
    shape_str = "x".join(str(d) for d in dims)
    if n > len(ranks):
        raise ValueError(f"mesh {shape_str} needs {n} devices, have {len(ranks)}")
    if n < len(ranks):
        warnings.warn(
            f"mesh {shape_str} uses {n} of {len(ranks)} devices; the rest stay idle",
            stacklevel=3,
        )
    return DeviceMesh(_device_type(), torch.tensor(ranks[:n]).reshape(dims),
                      mesh_dim_names=axis_names)


def make_mesh(
    n_data: int | None = None,
    n_time: int = 1,
    devices: list | None = None,
) -> DeviceMesh:
    """Build a ``(data, time)`` mesh over the available ranks.

    ``data`` is the embarrassingly-parallel batch axis (every op in the API
    is independent per batch element, so no collectives cross it). ``time``
    shards long signals along the sample axis; STFT-family ops on that axis
    exchange ``n_fft - hop`` halos between neighbours (see `time_shard.py`).
    """
    rank_list = _ranks(devices)
    if n_time < 1:
        raise ValueError(f"n_time must be >= 1, got {n_time}")
    if n_data is None:
        n_data = _infer_leading("n_data", n_time, "n_time", rank_list)
    return _grid_mesh((DATA_AXIS, TIME_AXIS), (n_data, n_time), rank_list)


def make_tp_mesh(
    n_data: int | None = None,
    n_model: int = 1,
    devices: list | None = None,
) -> DeviceMesh:
    """Build a ``(data, model)`` mesh for tensor-parallel training.

    ``data`` is the batch axis as in :func:`make_mesh`; ``model`` shards
    parameter tensors (conv channels, classifier columns) Megatron-style:
    activations cross it by ``all_reduce`` / ``all_gather`` (see
    `models/tensor_parallel.py`).
    """
    rank_list = _ranks(devices)
    if n_model < 1:
        raise ValueError(f"n_model must be >= 1, got {n_model}")
    if n_data is None:
        n_data = _infer_leading("n_data", n_model, "n_model", rank_list)
    return _grid_mesh((DATA_AXIS, MODEL_AXIS), (n_data, n_model), rank_list)


def make_ep_mesh(
    n_data: int | None = None,
    n_expert: int = 1,
    devices: list | None = None,
) -> DeviceMesh:
    """Build a ``(data, expert)`` mesh for expert-parallel (MoE) training:
    ``expert`` shards a mixture-of-experts layer's expert stack, each rank
    of an expert group holding ``n_experts / n_expert`` experts."""
    rank_list = _ranks(devices)
    if n_expert < 1:
        raise ValueError(f"n_expert must be >= 1, got {n_expert}")
    if n_data is None:
        n_data = _infer_leading("n_data", n_expert, "n_expert", rank_list)
    return _grid_mesh((DATA_AXIS, EXPERT_AXIS), (n_data, n_expert), rank_list)


def make_moe_mesh(
    n_data: int,
    n_expert: int,
    n_model: int,
    devices: list | None = None,
) -> DeviceMesh:
    """Build a 3-axis ``(data, expert, model)`` mesh: batch over 'data',
    expert stacks over 'expert', each expert's FFN sharded over 'model'."""
    return _grid_mesh(
        (DATA_AXIS, EXPERT_AXIS, MODEL_AXIS), (n_data, n_expert, n_model), devices
    )


def make_pp_mesh(n_stage: int, devices: list | None = None) -> DeviceMesh:
    """Build a 1-D ``(stage,)`` mesh for pipeline-parallel training, ranks
    in order, so stage ``i`` hands activations to stage ``i+1`` (see
    `models/pipeline_parallel.py`)."""
    rank_list = _ranks(devices)
    if n_stage < 1:
        raise ValueError(f"n_stage must be >= 1, got {n_stage}")
    if n_stage > len(rank_list):
        raise ValueError(
            f"pipeline of {n_stage} stages needs {n_stage} devices, have {len(rank_list)}"
        )
    return DeviceMesh(_device_type(), torch.tensor(rank_list[:n_stage]),
                      mesh_dim_names=(STAGE_AXIS,))


def batch_sharding(mesh: DeviceMesh) -> NamedSharding:
    """Sharding for ``(batch, ...)`` arrays: batch split over 'data'."""
    return NamedSharding(mesh, placements(mesh, P(DATA_AXIS)))


def batch_time_sharding(mesh: DeviceMesh) -> NamedSharding:
    """Sharding for ``(batch, samples)``: batch over 'data', samples over 'time'."""
    return NamedSharding(mesh, placements(mesh, P(DATA_AXIS, TIME_AXIS)))


def replicated(mesh: DeviceMesh) -> NamedSharding:
    return NamedSharding(mesh, placements(mesh, P()))


__all__ = [
    "DATA_AXIS", "TIME_AXIS", "MODEL_AXIS", "STAGE_AXIS", "EXPERT_AXIS",
    "make_mesh", "make_tp_mesh", "make_ep_mesh", "make_moe_mesh", "make_pp_mesh",
    "batch_sharding", "batch_time_sharding", "replicated",
]
