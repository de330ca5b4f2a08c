"""Lightweight profiling subsystem.

Counterpart of `mlx_audio_primitives_tpu/utils/profiler.py`, with the same
state and hooks: enable/disable/clear, a ``profile_section`` context
manager and a ``@profile`` decorator that synchronise the device before and
after a region (``torch.cuda.synchronize()`` where the JAX package blocks
on its arrays), explicit hooks for sync points, host<->device transfers and
table-cache accesses, and text/JSON reports.

Zero overhead when disabled: every hook checks one boolean first.

For kernel-level traces, :func:`start_device_trace` /
:func:`stop_device_trace` wrap a ``torch.profiler`` run with CPU and CUDA
activities and write it to a directory in TensorBoard's format.
"""

from __future__ import annotations

import contextlib
import functools
import json
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from . import dispatch


@dataclass
class ProfilerState:
    enabled: bool = False
    timings: dict[str, list[float]] = field(default_factory=lambda: defaultdict(list))
    sync_points: list[str] = field(default_factory=list)
    transfers: list[tuple[str, str, int]] = field(default_factory=list)
    cache_accesses: dict[str, dict[str, int]] = field(
        default_factory=lambda: defaultdict(lambda: {"hits": 0, "misses": 0})
    )


_STATE = ProfilerState()
_TRACE: list = []  # the torch.profiler run between start/stop_device_trace


def enable_profiling() -> None:
    _STATE.enabled = True


def disable_profiling() -> None:
    _STATE.enabled = False


def clear_profiling() -> None:
    _STATE.timings = defaultdict(list)
    _STATE.sync_points = []
    _STATE.transfers = []
    _STATE.cache_accesses = defaultdict(lambda: {"hits": 0, "misses": 0})


def is_profiling() -> bool:
    return _STATE.enabled


def _sync() -> None:
    """Wait for all pending device work (honest timing): a CUDA
    synchronise once CUDA is initialised, nothing on the CPU, where every
    op has finished when it returns."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def profile_section(name: str):
    """Time a region, with the device synchronised before and after."""
    if not _STATE.enabled:
        yield
        return
    _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        _STATE.timings[name].append(time.perf_counter() - t0)


def profile(fn=None, *, name: str | None = None):
    """Decorator: time a function, with the device synchronised before the
    call and after it returns."""

    def deco(f):
        label = name or f.__qualname__

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            if not _STATE.enabled:
                return f(*args, **kwargs)
            _sync()
            t0 = time.perf_counter()
            out = f(*args, **kwargs)
            _sync()
            _STATE.timings[label].append(time.perf_counter() - t0)
            return out

        return wrapper

    return deco(fn) if fn is not None else deco


def log_sync_point(context: str) -> None:
    if _STATE.enabled:
        _STATE.sync_points.append(context)


def log_transfer(direction: str, context: str, num_bytes: int) -> None:
    """Record a host<->device transfer (direction: 'h2d' or 'd2h')."""
    if _STATE.enabled:
        _STATE.transfers.append((direction, context, int(num_bytes)))


def log_cache_access(name: str, hit: bool) -> None:
    if _STATE.enabled:
        entry = _STATE.cache_accesses[name]
        entry["hits" if hit else "misses"] += 1


def tracked_to_device(x, context: str = "to_device") -> torch.Tensor:
    """``x`` as a tensor on the default device (``_config.DEFAULT_DEVICE``;
    a tensor keeps its dtype, an array its NumPy dtype), logging the
    host->device transfer's bytes when profiling. Raises for ``cuda``
    without a CUDA device."""
    out = torch.as_tensor(x, device=dispatch.default_device())
    if _STATE.enabled:
        log_transfer("h2d", context, out.element_size() * out.numel())
    return out


def tracked_to_host(x, context: str = "to_host") -> np.ndarray:
    """``x`` as a NumPy array on the host, logging the device->host
    transfer's bytes when profiling."""
    out = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if _STATE.enabled:
        log_transfer("d2h", context, out.nbytes)
    return out


def start_device_trace(log_dir: str) -> None:
    """Start a ``torch.profiler`` trace of CPU and CUDA activity (CUDA only
    where a device is present), written to ``log_dir`` in TensorBoard's
    format when :func:`stop_device_trace` ends it. One trace at a time."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    if _TRACE:
        raise RuntimeError("a device trace is already running")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir))
    prof.start()
    _TRACE.append(prof)


def stop_device_trace() -> None:
    """End the trace :func:`start_device_trace` began and write it."""
    if not _TRACE:
        raise RuntimeError("no device trace is running")
    _sync()
    _TRACE.pop().stop()


def get_profiling_data() -> dict[str, Any]:
    return {
        "timings": {k: list(v) for k, v in _STATE.timings.items()},
        "sync_points": list(_STATE.sync_points),
        "transfers": [
            {"direction": d, "context": c, "bytes": b} for d, c, b in _STATE.transfers
        ],
        "cache_accesses": {k: dict(v) for k, v in _STATE.cache_accesses.items()},
    }


def generate_text_report() -> str:
    """Aggregate timings / syncs / transfer MB / cache hit-rates as text."""
    lines = ["=== mlx-audio-primitives-tpu profile ==="]
    if _STATE.timings:
        lines.append("\n-- section timings --")
        for name, ts in sorted(_STATE.timings.items()):
            total = sum(ts)
            lines.append(
                f"{name}: calls={len(ts)} total={total * 1e3:.3f}ms "
                f"mean={total / len(ts) * 1e3:.3f}ms"
            )
    if _STATE.transfers:
        lines.append("\n-- host<->device transfers --")
        by_ctx: dict[tuple[str, str], int] = defaultdict(int)
        for d, c, b in _STATE.transfers:
            by_ctx[(d, c)] += b
        for (d, c), b in sorted(by_ctx.items()):
            lines.append(f"{d} [{c}]: {b / 1e6:.3f} MB")
    if _STATE.sync_points:
        lines.append(f"\n-- sync points: {len(_STATE.sync_points)} --")
    if _STATE.cache_accesses:
        lines.append("\n-- cache hit rates --")
        for name, e in sorted(_STATE.cache_accesses.items()):
            n = e["hits"] + e["misses"]
            rate = e["hits"] / n if n else 0.0
            lines.append(f"{name}: {e['hits']}/{n} ({rate:.1%})")
    return "\n".join(lines)


def export_json(path: str) -> None:
    with open(path, "w") as f:
        json.dump(get_profiling_data(), f, indent=2)
