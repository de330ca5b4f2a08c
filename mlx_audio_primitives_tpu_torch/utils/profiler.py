"""Lightweight profiling subsystem.

Counterpart of `mlx_audio_primitives_tpu/utils/profiler.py`, with the same
state and hooks: enable/disable/clear, a ``profile_section`` context
manager and a ``@profile`` decorator that time a region, explicit hooks for
sync points, host<->device transfers and table-cache accesses, and
text/JSON reports. Where the JAX package blocks on its arrays around a
region, a region here is timed by two CUDA events recorded on the current
stream at its entry and exit (the host clock before CUDA is initialised),
read when the data is read: nothing waits for the device inside it.

Spans and counters inside the port. The port records while
:func:`enable_profiling` is on or while a ``torch.profiler`` session
records; a session that starts with profiling off begins a fresh
recording, which stays readable after it ends. Each layer boundary is a
span (:func:`traced`, :func:`span`):

* ``ops.<op>`` around each public op of ``ops/`` (``ops.__all__`` and
  ``filterbank_spectrogram``);
* ``kernels.<wrapper>`` around each kernel wrapper (``*_fused``);
* ``launch.<kernel>`` around each launch (``kernels/_build.py``);
* ``tables.build.<cache>`` around a table cache's miss: host build, cast,
  copy to the device (``utils/cache.py``);

and each routing decision a counter (:func:`count`, from
`utils/dispatch.py::route`): ``dispatch.kernel.<op>`` or
``dispatch.plain.<op>.<reason>``. A span keeps its name, start and end,
its parent (a per-thread stack) and the id of its outermost ``ops.*`` span,
which all spans of one call share; its name's totals keep the count, the
time, the self time (less the part its children cover) and the time of
the instances outermost in their layer (the part before the first dot).
Times are ``time.perf_counter_ns()``; one offset taken when the recording
starts puts exported spans on the profiler's clock (Unix-epoch ns). Under
``torch.profiler`` each span is also a FUNCTION-scope range of the same
name (``_RecordFunctionFast``, not ``record_function``: a user annotation
would be mirrored onto the GPU timeline as a device event).

Near-zero overhead when disabled: while both flags are off, a hook reads
them, notes that it saw them off, and reads no clock and opens no range.

For kernel-level traces, :func:`start_device_trace` /
:func:`stop_device_trace` wrap a ``torch.profiler`` run with CPU and CUDA
activities and write it to a directory in TensorBoard's format.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
import torch.autograd.profiler as _torch_profiler

#: Closed spans kept one by one (for :func:`export_json`); past it a
#: recording keeps only each name's totals.
MAX_SPAN_RECORDS = 200_000


@dataclass
class ProfilerState:
    enabled: bool = False
    # seconds, or a (start, end) pair of CUDA events until the data is read
    timings: dict[str, list] = field(default_factory=lambda: defaultdict(list))
    sync_points: list[str] = field(default_factory=list)
    transfers: list[tuple[str, str, int]] = field(default_factory=list)
    # explicit log_cache_access calls, and the cache_stats() deltas of
    # periods that disable_profiling() closed
    cache_accesses: dict[str, dict[str, int]] = field(
        default_factory=lambda: defaultdict(lambda: {"hits": 0, "misses": 0})
    )


class _Recording:
    """The spans and counters of one recording. A span is a list (a frame;
    the indices below) kept in ``records`` once it closes; past
    ``MAX_SPAN_RECORDS`` its name's totals take it instead."""

    def __init__(self):
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.records: list[list] = []
        self.totals: dict[str, list[int]] = {}  # count, total, self, outer ns
        self.counters: dict[str, int] = {}
        self.ids = itertools.count()
        self.lock = threading.Lock()


# a frame's fields; ``_CHILD``: the time its children took
_NAME, _LAYER, _ID, _T0, _T1, _PARENT, _CHILD, _RF, _REC_OF = range(9)


_STATE = ProfilerState()
# cache_stats() when the current enabled period began (None: disabled)
_CACHE_BASE: dict[str, list[int]] | None = None
_REC = _Recording()
_TLS = threading.local()
# the next hook that sees a torch.profiler session begins a fresh recording
_ARMED = True
_TRACE: list = []  # the torch.profiler run between start/stop_device_trace


def _cache_stats() -> dict[str, list[int]]:
    from .cache import cache_stats  # the cache module imports this one

    return {k: [s["hits"], s["misses"]] for k, s in cache_stats().items()}


def _close_cache_period() -> None:
    """Fold the cache_stats() deltas since the period began into
    ``cache_accesses``."""
    global _CACHE_BASE
    if _CACHE_BASE is None:
        return
    for name, (h, m) in _cache_stats().items():
        h0, m0 = _CACHE_BASE.get(name, (0, 0))
        if h != h0 or m != m0:
            e = _STATE.cache_accesses[name]
            e["hits"] += h - h0
            e["misses"] += m - m0
    _CACHE_BASE = None


def enable_profiling() -> None:
    global _ARMED, _CACHE_BASE
    if not _STATE.enabled:
        _CACHE_BASE = _cache_stats()
    _STATE.enabled = True
    _ARMED = False


def disable_profiling() -> None:
    _close_cache_period()
    _STATE.enabled = False


def clear_profiling() -> None:
    global _REC, _CACHE_BASE
    _STATE.timings = defaultdict(list)
    _STATE.sync_points = []
    _STATE.transfers = []
    _STATE.cache_accesses = defaultdict(lambda: {"hits": 0, "misses": 0})
    _CACHE_BASE = _cache_stats() if _STATE.enabled else None
    _REC = _Recording()


def is_profiling() -> bool:
    return _STATE.enabled


def _cache_cleared(name: str, hits: int, misses: int) -> None:
    """A table cache is about to zero its counts: keep the period's delta."""
    base = _CACHE_BASE
    if base is not None:
        h0, m0 = base.get(name, (0, 0))
        base[name] = [h0 - hits, m0 - misses]


def recording() -> bool:
    """True while the port records spans and counters: profiling enabled,
    or a ``torch.profiler`` session running. The first call that sees a
    session after one that saw none starts a fresh recording, unless
    profiling is enabled."""
    global _ARMED, _REC
    if _STATE.enabled:
        return True
    if _torch_profiler._is_profiler_enabled:
        if _ARMED:
            _ARMED = False
            _REC = _Recording()
        return True
    _ARMED = True
    return False


def _open(name: str, layer: str) -> list:
    """Open a span on this thread's stack; ``layer`` is the part of
    ``name`` before its first dot."""
    rec = _REC
    try:
        stack = _TLS.stack
    except AttributeError:
        stack = _TLS.stack = []
    parent = stack[-1] if stack else None
    if parent is not None and parent[_REC_OF] is not rec:
        parent = None
    # the range lies inside the span's interval: a span pays for its own
    f = [name, layer, next(rec.ids), time.perf_counter_ns(), 0, parent, 0, None, rec]
    stack.append(f)
    if _torch_profiler._is_profiler_enabled:
        rf = f[_RF] = torch._C._profiler._RecordFunctionFast(name)
        rf.__enter__()
    return f


def _close(f: list) -> None:
    rf = f[_RF]
    if rf is not None:
        rf.__exit__(None, None, None)
        f[_RF] = None
    t1 = f[_T1] = time.perf_counter_ns()
    stack = _TLS.stack
    if stack[-1] is f:
        stack.pop()
    elif f in stack:
        stack.remove(f)
    rec = f[_REC_OF]
    if rec is not _REC:
        return  # opened before the recording it would land in began
    if f[_PARENT] is not None:
        f[_PARENT][_CHILD] += t1 - f[_T0]
    if len(rec.records) < MAX_SPAN_RECORDS:
        rec.records.append(f)
    else:
        with rec.lock:
            _add(rec.totals, f)


def _outer(f: list) -> bool:
    """No span of the frame's layer encloses it."""
    layer, p = f[_LAYER], f[_PARENT]
    while p is not None:
        if p[_LAYER] == layer:
            return False
        p = p[_PARENT]
    return True


def _call(f: list) -> int | None:
    """The id of the outermost ``ops.*`` span that holds the frame (itself
    included), which every span of one call shares."""
    call = None
    while f is not None:
        if f[_LAYER] == "ops":
            call = f[_ID]
        f = f[_PARENT]
    return call


def _add(totals: dict, f: list) -> None:
    dur = f[_T1] - f[_T0]
    t = totals.get(f[_NAME])
    if t is None:
        t = totals[f[_NAME]] = [0, 0, 0, 0]
    t[0] += 1
    t[1] += dur
    t[2] += dur - f[_CHILD]
    if _outer(f):
        t[3] += dur


class span:
    """Context manager: a span named ``name`` while the port records
    (:func:`recording`), nothing otherwise."""

    __slots__ = ("name", "_layer", "_frame")

    def __init__(self, name: str):
        self.name = name
        self._layer = name.partition(".")[0]
        self._frame = None

    def __enter__(self):
        self._frame = _open(self.name, self._layer) if recording() else None
        return self

    def __exit__(self, *exc):
        if self._frame is not None:
            _close(self._frame)
            self._frame = None
        return False


def traced(name: str):
    """Decorator: each call of the function is a span named ``name`` while
    the port records; otherwise the call costs the flag reads and one
    frame. ``functools.wraps`` keeps the signature."""
    layer = name.partition(".")[0]

    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            # recording()'s test, inline: the call is the decorated ops' cost
            if not (_STATE.enabled or _torch_profiler._is_profiler_enabled):
                global _ARMED
                _ARMED = True
                return f(*args, **kwargs)
            recording()  # begins a session's recording
            frame = _open(name, layer)
            try:
                return f(*args, **kwargs)
            finally:
                _close(frame)

        return wrapper

    return deco


def count(name: str) -> None:
    """Add one to the counter ``name`` while the port records."""
    if recording():
        rec = _REC
        with rec.lock:
            rec.counters[name] = rec.counters.get(name, 0) + 1


def _sync() -> None:
    """Wait for all pending device work (honest timing): a CUDA
    synchronise once CUDA is initialised, nothing on the CPU, where every
    op has finished when it returns."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _mark():
    """A region's start or end: a CUDA event recorded on the current stream
    once CUDA is initialised, else the host clock."""
    if torch.cuda.is_initialized():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _timed(start, end) -> float | tuple:
    return end - start if isinstance(start, float) else (start, end)


def _resolve_timings() -> dict[str, list[float]]:
    """The timings in seconds; pending CUDA-event pairs are waited for and
    replaced by their elapsed time."""
    for ts in _STATE.timings.values():
        for i, t in enumerate(ts):
            if isinstance(t, tuple):
                t[1].synchronize()
                ts[i] = t[0].elapsed_time(t[1]) / 1e3
    return _STATE.timings


@contextlib.contextmanager
def profile_section(name: str):
    """Time a region: CUDA events on the current stream at its entry and
    exit once CUDA is initialised, else the host clock. Nothing waits for
    the device; the time is read with the data."""
    if not _STATE.enabled:
        yield
        return
    t0 = _mark()
    try:
        yield
    finally:
        _STATE.timings[name].append(_timed(t0, _mark()))


def profile(fn=None, *, name: str | None = None):
    """Decorator: time a function as :func:`profile_section` times a
    region."""

    def deco(f):
        label = name or f.__qualname__

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            if not _STATE.enabled:
                return f(*args, **kwargs)
            t0 = _mark()
            out = f(*args, **kwargs)
            _STATE.timings[label].append(_timed(t0, _mark()))
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
    """Record one access of a cache outside the table caches, whose own
    accesses are read from ``cache_stats()``."""
    if _STATE.enabled:
        entry = _STATE.cache_accesses[name]
        entry["hits" if hit else "misses"] += 1


def tracked_to_device(x, context: str = "to_device") -> torch.Tensor:
    """``x`` as a tensor on the default device (``_config.DEFAULT_DEVICE``;
    a tensor keeps its dtype, an array its NumPy dtype), logging the
    host->device transfer's bytes when profiling. Raises for ``cuda``
    without a CUDA device."""
    from . import dispatch  # the dispatch module imports this one

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


def _cache_accesses() -> dict[str, dict[str, int]]:
    out = {k: dict(v) for k, v in _STATE.cache_accesses.items()}
    if _CACHE_BASE is not None:
        for name, (h, m) in _cache_stats().items():
            h0, m0 = _CACHE_BASE.get(name, (0, 0))
            if h != h0 or m != m0:
                e = out.setdefault(name, {"hits": 0, "misses": 0})
                e["hits"] += h - h0
                e["misses"] += m - m0
    return out


def get_profiling_data() -> dict[str, Any]:
    """Everything recorded: the timed regions (seconds), sync points,
    transfers, cache accesses, and the port's span totals (``count``, and
    ``total_ms``, ``self_ms``, ``outer_ms`` in ms) and counters."""
    rec = _REC
    with rec.lock:
        totals = {k: list(v) for k, v in rec.totals.items()}
        counters = dict(rec.counters)
    for f in rec.records[:]:
        _add(totals, f)
    spans = {k: {"count": c, "total_ms": t / 1e6, "self_ms": s / 1e6, "outer_ms": o / 1e6}
             for k, (c, t, s, o) in totals.items()}
    return {
        "timings": {k: list(v) for k, v in _resolve_timings().items()},
        "sync_points": list(_STATE.sync_points),
        "transfers": [
            {"direction": d, "context": c, "bytes": b} for d, c, b in _STATE.transfers
        ],
        "cache_accesses": _cache_accesses(),
        "spans": spans,
        "counters": counters,
    }


def generate_text_report() -> str:
    """Aggregate timings / syncs / transfer MB / cache hit-rates / spans /
    counters as text."""
    data = get_profiling_data()
    lines = ["=== mlx-audio-primitives-tpu profile ==="]
    if data["timings"]:
        lines.append("\n-- section timings --")
        for name, ts in sorted(data["timings"].items()):
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
    if data["cache_accesses"]:
        lines.append("\n-- cache hit rates --")
        for name, e in sorted(data["cache_accesses"].items()):
            n = e["hits"] + e["misses"]
            rate = e["hits"] / n if n else 0.0
            lines.append(f"{name}: {e['hits']}/{n} ({rate:.1%})")
    if data["spans"]:
        lines.append("\n-- spans --")
        for name, s in sorted(data["spans"].items()):
            lines.append(f"{name}: calls={s['count']} total={s['total_ms']:.3f}ms "
                         f"self={s['self_ms']:.3f}ms")
    if data["counters"]:
        lines.append("\n-- counters --")
        for name, n in sorted(data["counters"].items()):
            lines.append(f"{name}: {n}")
    return "\n".join(lines)


def export_json(path: str) -> None:
    """Write :func:`get_profiling_data` and the raw spans, each with its
    start and end on the profiler's clock (Unix-epoch ns), its parent and
    its call (the id of its outermost ``ops.*`` span)."""
    data = get_profiling_data()
    rec = _REC
    data["span_records"] = [
        {"id": f[_ID], "name": f[_NAME], "start_ns": f[_T0] + rec.offset_ns,
         "end_ns": f[_T1] + rec.offset_ns,
         "parent": None if f[_PARENT] is None else f[_PARENT][_ID], "call": _call(f)}
        for f in rec.records[:]]
    with rec.lock:
        data["span_records_dropped"] = sum(t[0] for t in rec.totals.values())
    with open(path, "w") as f:
        json.dump(data, f, indent=2)
