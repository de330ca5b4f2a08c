"""Startup warmup: pay every first-call cost before traffic arrives.

Counterpart of `mlx_audio_primitives_tpu/utils/warmup.py`. There a first
call of a new shape compiles an XLA executable; here the first call that
launches a kernel builds the kernel library with nvcc
(`kernels/_build.py::library`, seconds), and the first call of a shape
builds its host tables, copies them to the device and makes cuFFT's plans.
A serving or training process wants those costs at startup.

* :func:`warmup` runs each requested op once per (batch, length) on random
  data on the default device, synchronising after each, and returns the
  wall seconds per op (build-dominated on the first call, small after: a
  warm-state smoke signal).
* :func:`enable_persistent_compilation_cache` points the kernel build at a
  directory of the caller's, so that one nvcc build serves every process.
"""

from __future__ import annotations

import time
from collections.abc import Iterable, Sequence
from pathlib import Path

import numpy as np
import torch

from . import dispatch

_DEFAULT_OPS = ("stft", "istft", "melspectrogram", "mfcc")
# opt-in extras a serving config may add to ``ops``
_EXTRA_OPS = ("chroma_stft", "pcen")


def warmup(
    signal_lengths: Sequence[int] = (22050,),
    batch_sizes: Sequence[int] = (1,),
    *,
    sr: int = 22050,
    n_fft: int = 2048,
    hop_length: int | None = None,
    n_mels: int = 128,
    ops: Iterable[str] = _DEFAULT_OPS,
) -> dict[str, float]:
    """Run every (op, batch, length) combination once on the default device.

    Returns ``{"<op> b=<B> len=<L>": seconds}``, the wall time of the op's
    calls, the device synchronised after each: on the first call of a
    process that launches a kernel it includes the kernel build, and on a
    shape's first call its tables and FFT plans. Batch 1 runs both layouts
    a server may feed, ``(1, L)`` and ``(L,)``. Unknown op names raise
    ValueError up front (a typo must not silently skip a warmup).
    """
    from .. import chroma_stft, istft, melspectrogram, mfcc, pcen, stft

    if hop_length is None:
        hop_length = n_fft // 4
    ops = tuple(ops)
    known = set(_DEFAULT_OPS) | set(_EXTRA_OPS)
    unknown = [o for o in ops if o not in known]
    if unknown:
        raise ValueError(f"unknown warmup ops {unknown}; available: {sorted(known)}")

    dev = dispatch.default_device()

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    calls = {
        "stft": lambda y, L: stft(y, n_fft=n_fft, hop_length=hop_length),
        "istft": lambda y, L: istft(stft(y, n_fft=n_fft, hop_length=hop_length),
                                    hop_length=hop_length, length=L),
        "melspectrogram": lambda y, L: melspectrogram(y, sr=sr, n_fft=n_fft,
                                                      hop_length=hop_length, n_mels=n_mels),
        "mfcc": lambda y, L: mfcc(y, sr=sr, n_fft=n_fft, hop_length=hop_length, n_mels=n_mels),
        "chroma_stft": lambda y, L: chroma_stft(y, sr=sr, n_fft=n_fft, hop_length=hop_length),
        "pcen": lambda y, L: pcen(melspectrogram(y, sr=sr, n_fft=n_fft, hop_length=hop_length,
                                                 n_mels=n_mels), sr=sr, hop_length=hop_length),
    }
    rng = np.random.default_rng(0)
    times: dict[str, float] = {}
    for B in batch_sizes:
        for L in signal_lengths:
            y2d = torch.as_tensor(rng.standard_normal((B, L)).astype(np.float32), device=dev)
            sync()
            variants = [y2d] if B > 1 else [y2d, y2d[0]]
            for op in ops:
                t0 = time.perf_counter()
                for y in variants:
                    calls[op](y, L)
                    sync()
                times[f"{op} b={B} len={L}"] = time.perf_counter() - t0
    return times


def enable_persistent_compilation_cache(cache_dir: str) -> None:
    """Build the kernel library under ``cache_dir`` (instead of ``build/``
    beside the package) from now on, so that every process given the same
    directory reuses one nvcc build: a library is kept under the hash of its
    sources and flags, and a file lock lets one process build while the
    others wait. Safe to call more than once.

    It sets where the library is looked for when it is first loaded. A
    process whose kernel library is already loaded keeps using it (the
    call moves no library and builds none); the directory serves its later
    processes.
    """
    from ..kernels import _build

    _build.BUILD_ROOT = Path(cache_dir)


__all__ = ["warmup", "enable_persistent_compilation_cache"]
