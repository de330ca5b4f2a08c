"""Data-parallel batch sharding helpers.

Counterpart of `mlx_audio_primitives_tpu/parallel/sharding.py`. Every op in
the public API is independent per batch element, so batch parallelism
needs no collectives: place the batch axis over the 'data' mesh axis and
run the op on each rank's shard.

Placement follows PyTorch's DTensor: ``jax.device_put(x, sharding)`` is
:func:`distribute`, which takes a plain tensor (or NumPy array) as the
global array, the same on every rank, and keeps this rank's slice of it
without communication; a DTensor is redistributed to the placements. A
``shard_map`` body is a function on ``DTensor.to_local()`` tensors, and its
result comes back as a DTensor through :func:`from_local`.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Shard

from ..utils import dispatch
from ..utils.tree import tree_map
from .mesh import DATA_AXIS, NamedSharding, PartitionSpec, batch_sharding, placements


def sharding_tree(mesh: DeviceMesh, specs: Any) -> Any:
    """Map a :class:`~.mesh.PartitionSpec` tree to the matching
    :class:`~.mesh.NamedSharding` tree (the one place the spec -> sharding
    conversion lives; every ``*_param_sharding`` helper delegates here)."""
    return tree_map(lambda spec: NamedSharding(mesh, placements(mesh, spec)), specs)


def _check_member(mesh: DeviceMesh) -> None:
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the mesh")


def local_shard(x: Any, mesh: DeviceMesh, place: tuple[Placement, ...]) -> torch.Tensor:
    """This rank's local tensor of ``x`` placed by ``place`` on ``mesh``.

    A DTensor of ``mesh`` is redistributed (communication where its
    placements differ) and its local tensor returned; anything else (a
    DTensor of another mesh gathered first) is the global array, and
    its slice is taken here, each ``Shard(d)`` splitting dimension ``d``
    evenly, mesh dimensions in order (so ``Shard(0)`` twice splits the
    batch data-major, as JAX's ``P(('data', 'time'))`` does)."""
    _check_member(mesh)
    if isinstance(x, DTensor) and x.device_mesh == mesh:
        if tuple(x.placements) != tuple(place):
            x = x.redistribute(mesh, place)
        return x.to_local()
    # a DTensor of another mesh is gathered to its global array first
    t = x.full_tensor() if isinstance(x, DTensor) else dispatch.to_tensor(x)
    coord = mesh.get_coordinate()
    for i, p in enumerate(place):
        if isinstance(p, Shard):
            n, size = mesh.size(i), t.shape[p.dim]
            if size % n != 0:
                raise ValueError(
                    f"dimension {p.dim} of size {size} does not divide over the "
                    f"{n} ranks of mesh axis '{mesh.mesh_dim_names[i]}'"
                )
            t = t.narrow(p.dim, coord[i] * (size // n), size // n)
    return t


def from_local(local: torch.Tensor, mesh: DeviceMesh,
               place: tuple[Placement, ...]) -> DTensor:
    """The DTensor whose even shards are every rank's ``local`` (no
    communication)."""
    return DTensor.from_local(local, mesh, place, run_check=False)


def distribute(x: Any, sharding: NamedSharding) -> DTensor:
    """``jax.device_put(x, sharding)``: ``x`` (the global array, or a
    DTensor) as a DTensor placed by ``sharding``."""
    local = local_shard(x, sharding.mesh, sharding.placements)
    return from_local(local, sharding.mesh, sharding.placements)


def shard_batch(arr: Any, mesh: DeviceMesh) -> DTensor:
    """Place a ``(batch, ...)`` array with the batch axis over 'data'."""
    return distribute(arr, batch_sharding(mesh))


def data_parallel(fn: Callable, mesh: DeviceMesh) -> Callable:
    """Wrap a batched op so it runs once per 'data' shard on ``mesh``.

    Contract: every POSITIONAL array argument is batched (leading batch
    axis, batch size a multiple of the 'data' axis size) and is sharded
    over it. Auxiliary non-batched arrays (windows, filterbanks, params)
    and scalars go through KEYWORD arguments, which every rank passes whole.
    ``fn`` must return tensors (or a tree of them) with a leading batch
    axis; they come back as DTensors sharded over 'data'.

    Each rank calls ``fn`` on its local batch: batch elements are
    independent, so no collectives appear, and a kernel stays a
    single-device launch on each rank's card.
    """
    place = placements(mesh, PartitionSpec(DATA_AXIS))

    def wrapper(*args, **kwargs):
        arr_idx = [
            i for i, a in enumerate(args)
            if hasattr(a, "ndim") and getattr(a, "ndim", 0) >= 1
        ]
        if not arr_idx:
            return fn(*args, **kwargs)
        batch = args[arr_idx[0]].shape[0]
        # every positional array is sharded over 'data' by contract; an aux
        # array (window, filterbank) passed positionally would be silently
        # SLICED per shard whenever its length divides the mesh: reject the
        # mismatch instead of corrupting it
        for i in arr_idx:
            if args[i].shape[0] != batch:
                raise TypeError(
                    f"data_parallel: positional array argument {i} has "
                    f"leading dim {args[i].shape[0]} != batch {batch}; every "
                    "positional array is batch-sharded: pass auxiliary "
                    "non-batched arrays (windows/filterbanks/params) as "
                    "keyword arguments, which are replicated."
                )
        # a batched array passed as a kwarg would reach every shard whole:
        # each shard would compute over the full batch. Reject the ambiguity.
        for k, v in kwargs.items():
            if (
                hasattr(v, "ndim") and getattr(v, "ndim", 0) >= 1
                and v.shape[0] == batch
            ):
                raise TypeError(
                    f"data_parallel: keyword argument '{k}' looks batched "
                    f"(leading dim {v.shape[0]} == batch); batched arrays "
                    "must be positional so they are sharded. Keyword arrays "
                    "are replicated (windows/filterbanks/params)."
                )
        full = list(args)
        for i in arr_idx:
            full[i] = local_shard(args[i], mesh, place)
        out = fn(*full, **kwargs)
        return tree_map(lambda t: from_local(t, mesh, place), out)

    return wrapper
