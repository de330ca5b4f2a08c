"""Device-resident table caches.

Counterpart of `mlx_audio_primitives_tpu/utils/cache.py`, with the same two
tiers around every host-built table (windows, mel filterbank, DFT bases,
ISTFT envelopes, FFT twiddles):

* tier 1 -- ``functools.lru_cache`` around a pure-NumPy float64 builder, so
  the table math happens once on the host in double precision;
* tier 2 -- a dict keyed by ``(builder args, device)`` holding the table
  cast to the cache's ``dtype`` (float32 by default) as a tensor on that
  device, so a hit costs no host-to-device copy.

The tensors handed out are shared: callers must not modify them in place.
Each one remembers the cache and the arguments it came from
(:func:`table_origin`), so that a kernel wrapper can keep what it derives
from a table (K1's contraction plan) beside the table.
As in the JAX package, every cache registers itself, so that
:func:`clear_all_caches` empties them all (cold-cache benchmarks) and
:func:`cache_stats` reports their hits, misses and entries; the profiler
(`utils/profiler.py`) reads its cache accesses from them. While the port
records, a miss is the span ``tables.build.<name>``: the host build, the
cast and the copy to the device.
"""

from __future__ import annotations

import functools
import threading
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from . import profiler

# Registry of every live TableCache, for clear_all_caches() / cache_stats().
_CACHE_REGISTRY: list["TableCache"] = []
_REGISTRY_LOCK = threading.Lock()


class TableCache:
    """Two-tier (host lru / device dict) cache around a float64 table builder."""

    def __init__(
        self,
        name: str,
        builder: Callable[..., np.ndarray],
        maxsize: int = 128,
        dtype: Any = np.float32,
    ):
        self.name = name
        self.dtype = dtype
        self._host_builder = functools.lru_cache(maxsize=maxsize)(builder)
        self._span = f"tables.build.{name}"
        self._device_cache: dict[tuple, torch.Tensor] = {}
        self._maxsize = maxsize
        self._order: list[tuple] = []
        # guards _device_cache/_order/counters against concurrent callers
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        with _REGISTRY_LOCK:
            _CACHE_REGISTRY.append(self)

    def __call__(self, *args, device: torch.device | str | None = None) -> torch.Tensor:
        """The table for ``args`` as a tensor of ``self.dtype`` on ``device``
        (CPU when None). A dtype that ``torch.from_numpy`` cannot hold
        raises its TypeError, which names the dtype."""
        dev = torch.device("cpu" if device is None else device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        key = (args, str(dev))
        with self._lock:
            hit = self._device_cache.get(key)
            if hit is not None:
                self.hits += 1
                # true LRU: a hit refreshes recency
                self._order.remove(key)
                self._order.append(key)
            else:
                self.misses += 1
        if hit is not None:
            return hit
        with profiler.span(self._span):
            host = np.asarray(self._host_builder(*args)).astype(self.dtype)
            table = torch.from_numpy(np.ascontiguousarray(host)).to(dev)
        table._table_origin = (self, args)
        with self._lock:
            if key in self._device_cache:
                return self._device_cache[key]  # a concurrent builder won
            if len(self._device_cache) >= self._maxsize and self._order:
                self._device_cache.pop(self._order.pop(0), None)
            self._device_cache[key] = table
            self._order.append(key)
        return table

    def host(self, *args) -> np.ndarray:
        """Return the host float64 table (tier 1 only)."""
        return self._host_builder(*args)

    def clear(self) -> None:
        """Empty both tiers and zero the counts."""
        with self._lock:
            profiler._cache_cleared(self.name, self.hits, self.misses)
            self._host_builder.cache_clear()
            self._device_cache.clear()
            self._order.clear()
            self.hits = 0
            self.misses = 0

    @property
    def stats(self) -> dict[str, int]:
        return {"hits": self.hits, "misses": self.misses, "entries": len(self._device_cache)}


def table_origin(t: torch.Tensor) -> tuple[TableCache, tuple] | None:
    """``(cache, args)`` where ``t`` is the very tensor a :class:`TableCache`
    handed out for ``args``, else None (a copy or a view of it is not)."""
    return getattr(t, "_table_origin", None)


def table_cache(name: str, maxsize: int = 128, dtype: Any = np.float32):
    """Decorator: wrap a float64 NumPy builder into a TableCache."""

    def deco(builder: Callable[..., np.ndarray]) -> TableCache:
        return TableCache(name, builder, maxsize=maxsize, dtype=dtype)

    return deco


def clear_all_caches() -> None:
    """Clear every registered table cache (cold-cache benchmarking hook)."""
    with _REGISTRY_LOCK:
        caches = list(_CACHE_REGISTRY)
    for c in caches:
        c.clear()


def cache_stats() -> dict[str, dict[str, int]]:
    """Hit/miss/entry counts for every registered cache."""
    with _REGISTRY_LOCK:
        caches = list(_CACHE_REGISTRY)
    return {c.name: c.stats for c in caches}
