"""Device-memory profiling.

Counterpart of `mlx_audio_primitives_tpu/utils/memory_profiler.py`, built
on the CUDA caching allocator's counters (``torch.cuda.memory_allocated``,
``max_memory_allocated``) of device 0 where the JAX
package reads PJRT's ``memory_stats()``: a :func:`track_memory` context
manager, :func:`profile_memory` returning a :class:`MemoryProfile` with the
same ``efficiency = output_bytes / peak-above-baseline`` metric, and the
same analytical per-stage estimates of the stft/mel/mfcc pipelines. Without
a CUDA device every reading is 0, as the JAX package's are where its
backend reports no statistics.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from .profiler import _sync
from .tree import leaves


def memory_available() -> bool:
    """Whether device-memory statistics exist (a CUDA device is present)."""
    return torch.cuda.is_available()


def get_active_memory() -> int:
    """Bytes currently allocated on device 0 (0 without CUDA)."""
    return int(torch.cuda.memory_allocated(0)) if memory_available() else 0


def get_peak_memory() -> int:
    """Peak bytes allocated on device 0 since the last reset of CUDA's peak
    counter (0 without CUDA)."""
    return int(torch.cuda.max_memory_allocated(0)) if memory_available() else 0


@dataclass
class MemoryProfile:
    active_before: int
    active_after: int
    peak: int
    output_bytes: int = 0
    extra: dict[str, Any] = field(default_factory=dict)

    @property
    def delta_mb(self) -> float:
        return (self.active_after - self.active_before) / 1e6

    @property
    def peak_mb(self) -> float:
        return self.peak / 1e6

    @property
    def efficiency(self) -> float:
        """output bytes / peak-above-baseline (1.0 = no transient overhead)."""
        denom = max(self.peak - self.active_before, 1)
        return self.output_bytes / denom


_depth = 0  # how many track_memory regions are open, in every thread
_depth_lock = threading.Lock()


@contextlib.contextmanager
def track_memory():
    """Context manager yielding a MemoryProfile filled on exit.

    CUDA can reset its peak counter where PJRT cannot: the outermost open
    region resets it (``torch.cuda.reset_peak_memory_stats``) on entry, so
    its ``peak`` is its own high-water mark, and
    ``extra["peak_is_process_lifetime"]`` is False. A region nested inside
    another does not reset, so that the outer region's peak stays honest:
    its ``peak`` is the high-water mark since the outermost region began,
    which may predate it, and then ``peak_is_process_lifetime`` is True and
    ``efficiency`` is a lower bound, as in the JAX package. A caller's own
    readings of ``torch.cuda.max_memory_allocated`` across an outermost
    region see the reset.
    """
    global _depth
    with _depth_lock:
        outermost = _depth == 0
        _depth += 1
    try:
        if outermost and memory_available():
            torch.cuda.reset_peak_memory_stats(0)
        prof = MemoryProfile(active_before=get_active_memory(), active_after=0, peak=0)
        peak_before = get_peak_memory()
        try:
            yield prof
        finally:
            prof.active_after = get_active_memory()
            prof.peak = get_peak_memory()
            prof.extra["peak_is_process_lifetime"] = (
                not outermost and prof.peak <= peak_before
            )
    finally:
        with _depth_lock:
            _depth -= 1


def _nbytes(tree: Any) -> int:
    """The bytes of the tensors and arrays among ``tree``'s leaves."""
    total = 0
    for leaf in leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.element_size() * leaf.numel()
        elif isinstance(leaf, np.ndarray):
            total += leaf.nbytes
    return total


def profile_memory(fn: Callable, *args, **kwargs) -> tuple[Any, MemoryProfile]:
    """Run ``fn`` and measure device memory around it; the device is
    synchronised before the region closes, and ``output_bytes`` sums the
    bytes of the tensors the call returned (over a pytree)."""
    with track_memory() as prof:
        out = fn(*args, **kwargs)
        _sync()
    prof.output_bytes = _nbytes(out)
    return out, prof


def estimate_operation_memory(
    op: str,
    signal_length: int,
    batch: int = 1,
    n_fft: int = 2048,
    hop_length: int = 512,
    n_mels: int = 128,
    n_mfcc: int = 20,
) -> dict[str, float]:
    """Analytical per-stage MB estimates (the JAX package's arithmetic).

    Useful for predicting whether a workload fits device memory before
    running it.
    """
    f32 = 4
    n_frames = 1 + signal_length // hop_length  # center=True
    n_bins = n_fft // 2 + 1
    est: dict[str, float] = {
        "input_mb": batch * signal_length * f32 / 1e6,
        "frames_mb": batch * n_frames * n_fft * f32 / 1e6,
        "spectrum_mb": batch * n_frames * n_bins * 2 * f32 / 1e6,
    }
    if op in ("mel", "mfcc"):
        est["mel_mb"] = batch * n_mels * n_frames * f32 / 1e6
    if op == "mfcc":
        est["mfcc_mb"] = batch * n_mfcc * n_frames * f32 / 1e6
    if op == "istft":
        est["output_mb"] = batch * signal_length * f32 / 1e6
    est["total_mb"] = float(np.sum(list(est.values())))
    return est
