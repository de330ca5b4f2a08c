"""Device-resident table caches.

Counterpart of `mlx_audio_primitives_tpu/utils/cache.py`, with the same two
tiers around every host-built table (windows, mel filterbank, DFT bases,
ISTFT envelopes, FFT twiddles):

* tier 1 -- ``functools.lru_cache`` around a pure-NumPy float64 builder, so
  the table math happens once on the host in double precision;
* tier 2 -- a dict keyed by ``(builder args, device)`` holding the float32
  tensor on that device, so a hit costs no host-to-device copy.

The tensors handed out are shared: callers must not modify them in place.
As in the JAX package, every cache registers itself, so that
:func:`clear_all_caches` empties them all (cold-cache benchmarks) and
:func:`cache_stats` reports their hits, misses and entries, and every hit
and miss is reported to the profiler (`utils/profiler.py`).
"""

from __future__ import annotations

import functools
import threading
from collections.abc import Callable

import numpy as np
import torch

from .._config import REAL_DTYPE

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
    ):
        self.name = name
        self._host_builder = functools.lru_cache(maxsize=maxsize)(builder)
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
        """The table for ``args`` as a float32 tensor on ``device`` (CPU
        when None)."""
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
        self._note_profiler(hit is not None)
        if hit is not None:
            return hit
        host = np.asarray(self._host_builder(*args))
        table = torch.from_numpy(np.ascontiguousarray(host)).to(REAL_DTYPE).to(dev)
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

    def _note_profiler(self, hit: bool) -> None:
        # lazy import: the profiler imports nothing of this module
        from . import profiler

        profiler.log_cache_access(self.name, hit)

    def clear(self) -> None:
        """Empty both tiers and zero the counts."""
        with self._lock:
            self._host_builder.cache_clear()
            self._device_cache.clear()
            self._order.clear()
            self.hits = 0
            self.misses = 0

    @property
    def stats(self) -> dict[str, int]:
        return {"hits": self.hits, "misses": self.misses, "entries": len(self._device_cache)}


def table_cache(name: str, maxsize: int = 128):
    """Decorator: wrap a float64 NumPy builder into a TableCache."""

    def deco(builder: Callable[..., np.ndarray]) -> TableCache:
        return TableCache(name, builder, maxsize=maxsize)

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
