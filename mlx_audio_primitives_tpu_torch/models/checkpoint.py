"""Checkpoint / resume for training state.

Counterpart of `mlx_audio_primitives_tpu/models/checkpoint.py`, in its
``.npz`` format: the leaves as ``leaf0``, ``leaf1``, ... in ``jax.tree``
order (dict keys sorted), and the tree's structure as the string
``str(jax.tree.structure(state))`` prints, stored as ``__treedef__`` bytes.
A checkpoint the JAX package writes in that format restores here, and one
written here restores there. State is a tree of dicts, lists, tuples and
``None`` whose leaves are tensors, DTensors, arrays or scalars::

    state = {"params": params, "step": 120}
    save_checkpoint("/ckpts/run1/120", state)
    state = restore_checkpoint("/ckpts/run1/120", target=state)

A PyTorch install has no Orbax, so :data:`HAS_ORBAX` is False: the JAX
package's Orbax directories cannot be read here, and restoring one raises.

Across ranks: a DTensor leaf is gathered (every rank must call
:func:`save_checkpoint`), rank 0 writes the file, and every rank returns
once it is written; :func:`restore_checkpoint` places each leaf as the
target's leaf is placed (a DTensor target gets this rank's shard).
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..parallel.sharding import from_local, local_shard
from ..utils.tree import leaves

#: Orbax is a JAX library; the port reads and writes the npz format only.
HAS_ORBAX = False

__all__ = ["save_checkpoint", "restore_checkpoint", "HAS_ORBAX"]


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _treedef(tree: Any) -> str:
    """The body of ``str(jax.tree.structure(tree))`` for a tree of dicts,
    lists, tuples (named tuples included) and ``None``."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        kids = ", ".join(_treedef(c) for c in tree)
        return f"CustomNode(namedtuple[{type(tree).__name__}], [{kids}])"
    if isinstance(tree, tuple):
        kids = [_treedef(c) for c in tree]
        return "(" + ", ".join(kids) + ("," if len(kids) == 1 else "") + ")"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(c) for c in tree) + "]"
    return "*"


def _structure(tree: Any) -> str:
    return f"PyTreeDef({_treedef(tree)})"


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _multi_rank() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def save_checkpoint(path: str, state: Any, overwrite: bool = True) -> str:
    """Persist the tree ``state`` as ``path`` + ``.npz`` (unless ``path``
    ends so). Synchronous: returns the path written once it is on disk."""
    out = _npz_path(os.path.abspath(path))
    flat = [_host(leaf) for leaf in leaves(state)]
    if not _multi_rank() or dist.get_rank() == 0:
        if not overwrite and os.path.exists(out):
            raise FileExistsError(out)
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        np.savez(
            out,
            __treedef__=np.frombuffer(_structure(state).encode(), dtype=np.uint8),
            **{f"leaf{i}": leaf for i, leaf in enumerate(flat)},
        )
    if _multi_rank():
        dist.barrier()
    return out


def _placed(arr: np.ndarray, like: Any) -> Any:
    """``arr`` as a tensor placed like the target leaf ``like``."""
    t = torch.from_numpy(np.array(arr))
    if isinstance(like, DTensor):
        mesh, place = like.device_mesh, like.placements
        return from_local(local_shard(t.to(like.device), mesh, place).contiguous(), mesh, place)
    if isinstance(like, torch.Tensor):
        return t.to(like.device)
    return t


def _rebuild(target: Any, it) -> Any:
    """A tree shaped like ``target`` with the stored leaves, in ``jax.tree``
    order (sorted dict keys), each placed like the target's leaf."""
    if target is None:
        return None
    if isinstance(target, dict):
        built = {k: _rebuild(target[k], it) for k in sorted(target)}
        return {k: built[k] for k in target}
    if isinstance(target, (list, tuple)):
        items = [_rebuild(c, it) for c in target]
        if isinstance(target, list):
            return items
        return type(target)(*items) if hasattr(target, "_fields") else type(target)(items)
    return _placed(next(it), target)


def restore_checkpoint(path: str, target: Any | None = None) -> Any:
    """Load a checkpoint written by :func:`save_checkpoint` (or by the JAX
    package in its npz format). ``target``, a tree of the stored structure,
    gives the containers and the placement of each leaf; a target of
    another structure raises, as it would misassign leaves. Leaves come
    back as tensors of their stored dtype."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: an Orbax checkpoint of the JAX package. "
            "The PyTorch port has no Orbax (HAS_ORBAX is False) and reads the "
            "npz format only; save it there with HAS_ORBAX off to get one"
        )
    with np.load(_npz_path(path)) as data:
        n = sum(1 for k in data.files if k.startswith("leaf"))
        stored_leaves = [data[f"leaf{i}"] for i in range(n)]
        stored = bytes(data["__treedef__"]).decode()
    if target is None:
        raise ValueError("npz-fallback checkpoints need `target` to rebuild the pytree")
    # the stored structure string guards against a same-leaf-count target
    # with a DIFFERENT structure, which would otherwise silently misassign
    # leaves by position
    if stored != _structure(target):
        raise ValueError(
            f"checkpoint pytree structure {stored} does not match the "
            f"target structure {_structure(target)}"
        )
    return _rebuild(target, iter(stored_leaves))
