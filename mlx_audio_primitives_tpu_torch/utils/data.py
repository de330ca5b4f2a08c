"""Input-pipeline helpers: host batching and device prefetch.

Counterpart of `mlx_audio_primitives_tpu/utils/data.py`. The classic stall
of a training or feature-extraction loop is the host->device copy of batch
``k+1`` waiting for batch ``k``'s work to finish. :func:`prefetch_to_device`
keeps ``size`` batches in flight: each NumPy leaf is staged in pinned host
memory and copied with ``non_blocking=True`` on a side CUDA stream, so the
copy of the next batch overlaps the work on the current one.
:func:`batch_iterator` is the deterministic epoch batcher the JAX package
has, over the same pytrees (`utils/tree.py`), with the same permutations.
"""

from __future__ import annotations

import collections
from collections.abc import Callable, Iterable, Iterator
from typing import Any

import numpy as np
import torch

from . import dispatch
from .tree import is_node, leaves, same_structure, tree_map

__all__ = ["prefetch_to_device", "batch_iterator"]


def _device(spec: torch.device | str | None) -> torch.device:
    """``spec`` (None: the default device) with a CUDA index filled in;
    raises for ``cuda`` without a CUDA device."""
    dev = dispatch.default_device(spec)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _devices(batch: Any, sharding: Any) -> Any:
    """The target device of each leaf of ``batch``, as a tree of the same
    structure."""
    if sharding is None or isinstance(sharding, (torch.device, str)):
        dev = _device(sharding)
        return tree_map(lambda _: dev, batch)
    if is_node(sharding) and same_structure(batch, sharding):
        return tree_map(lambda _, d: _device(d), batch, sharding)
    raise ValueError(
        "sharding must be None, a torch.device or a pytree of them matching the batch; "
        "sharded placement across devices has no counterpart until the port has parallel/"
    )


#: the side stream of the copies to each CUDA device, made when first needed
_SIDE_STREAMS: dict[torch.device, torch.cuda.Stream] = {}


class _InFlight:
    """One batch whose copies were issued on the side streams: the device
    tensors, the event each device's copies end at, and the pinned buffers
    they read, held until that event has passed."""

    def __init__(self, batch: Any, devices: Any):
        self.events: dict[torch.device, torch.cuda.Event] = {}
        self.pinned: list[torch.Tensor] = []
        self.tree = tree_map(self._put, batch, devices)
        for dev, event in self.events.items():
            event.record(_SIDE_STREAMS[dev])

    def _put(self, leaf: Any, dev: torch.device) -> torch.Tensor:
        if isinstance(leaf, torch.Tensor):
            if leaf.device == dev:
                return leaf
            if leaf.device.type != "cpu" or dev.type != "cuda":
                return leaf.to(dev, copy=True)
            pinned = leaf.pin_memory()
        else:
            arr = np.asarray(leaf)
            if dev.type != "cuda":
                return torch.from_numpy(arr.copy())  # never aliases the batch
            dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
            pinned = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
            pinned.numpy()[...] = arr  # the one host copy, into pinned memory
        self.pinned.append(pinned)
        stream = _SIDE_STREAMS.setdefault(dev, torch.cuda.Stream(dev))
        with torch.cuda.stream(stream):
            out = pinned.to(dev, non_blocking=True)
        self.events.setdefault(dev, torch.cuda.Event())
        return out

    def hand_over(self) -> Any:
        """The batch, safe to use on each device's current stream: that
        stream waits for the copies, and each tensor is marked as used by
        it, so the allocator keeps its memory until the consumer's work on
        it is done."""
        for dev, event in self.events.items():
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(event)
            for t in leaves(self.tree):
                if t.device == dev:
                    t.record_stream(consumer)
        return self.tree

    def copies_done(self) -> bool:
        return all(event.query() for event in self.events.values())


def prefetch_to_device(
    iterator: Iterable[Any],
    size: int = 2,
    sharding: Any | None = None,
) -> Iterator[Any]:
    """Wrap a host-batch iterator with ``size``-deep device prefetch.

    Each item is a pytree (dicts, lists, tuples) of NumPy arrays, scalars
    or tensors. ``sharding`` places it: None puts every leaf on the default
    device (``_config.DEFAULT_DEVICE``, ``cuda`` unless the caller set
    another), a ``torch.device`` (or device string) puts every leaf there,
    and a pytree of devices matching the batch puts each leaf on its own.
    The JAX package's ``NamedSharding`` spreads one array over a mesh; the
    port has no counterpart until ``parallel/`` is ported, so anything else
    raises ``ValueError``. A CUDA target without a CUDA device raises: the
    batches never go to the CPU unasked.

    On a CUDA device each leaf is copied into pinned host memory and from
    there with ``non_blocking=True`` on a side stream, as soon as a slot of
    the ``size`` in flight frees up; a yielded batch is safe on the
    consumer's current stream (it waits for the copy's event, and each
    tensor is recorded as used by it), and each pinned buffer is held until
    its copy has ended. On the CPU the leaves are copied into CPU tensors,
    in order. ``size=2`` is double buffering; deeper only helps when
    batches arrive in bursts.
    """
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")

    def put(batch: Any) -> _InFlight:
        return _InFlight(batch, _devices(batch, sharding))

    queue: collections.deque[_InFlight] = collections.deque()
    retired: collections.deque[_InFlight] = collections.deque()
    it = iter(iterator)
    try:
        while len(queue) < size:
            queue.append(put(next(it)))
    except StopIteration:
        pass
    try:
        while queue:
            item = queue.popleft()
            try:
                queue.append(put(next(it)))
            except StopIteration:
                pass
            out = item.hand_over()
            retired.append(item)
            while retired and retired[0].copies_done():
                retired.popleft()  # its pinned buffers may go now
            yield out
    finally:
        for item in (*retired, *queue):
            for event in item.events.values():
                event.synchronize()


def batch_iterator(
    data: Any,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
    epochs: int = 1,
    transform: Callable[[Any], Any] | None = None,
) -> Iterator[Any]:
    """Deterministic epoch batcher over a pytree of equal-length arrays.

    ``data`` is a pytree whose leaves share a leading example axis. Each
    yield is the same pytree sliced to ``batch_size`` examples; ``shuffle``
    reshuffles every epoch from ``seed`` (reproducible: the JAX package's
    permutations, so the same batches), ``transform`` maps each host batch
    before it is yielded (e.g. decode or augment on host).
    """
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    arrays = leaves(data)
    if not arrays:
        raise ValueError("data has no array leaves")
    n = arrays[0].shape[0]
    for leaf in arrays:
        if leaf.shape[0] != n:
            raise ValueError(
                f"all leaves must share the example axis: {leaf.shape[0]} != {n}"
            )
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = rng.permutation(n) if shuffle else np.arange(n)
        stop = n - (n % batch_size) if drop_remainder else n
        for start in range(0, stop, batch_size):
            idx = order[start:start + batch_size]
            batch = tree_map(lambda leaf: leaf[idx], data)
            yield transform(batch) if transform is not None else batch
