"""Duration-capped bucketing, as speech loaders batch (Lhotse's
``DynamicBucketingSampler``): the bucket edges split the configuration's
length law (``clip_seconds``) into ``buckets`` of equal audio, so that the
same number of batches in each bucket gives each bucket the share of the
corpus's audio that it holds. A batch takes clips of one bucket, drawn from
the law with the mix's ``sizes_seed``, until the next would pass
``batch_audio_seconds``."""

from __future__ import annotations

import numpy as np


def edges(law: dict, n_buckets: int, grid: int = 200_001) -> np.ndarray:
    """Lengths (s) that split the law's audio into ``n_buckets`` equal parts:
    quantiles of the density of a length times the length, the law being a
    Beta(a, b) scaled to ``[min, max]``."""
    lo, hi = law["min"], law["max"]
    a, b = law["beta"]
    x = np.linspace(0.0, 1.0, grid)
    s = lo + (hi - lo) * x
    audio = x ** (a - 1) * (1 - x) ** (b - 1) * s
    cum = np.concatenate([[0.0], np.cumsum((audio[1:] + audio[:-1]) / 2)])
    out = np.interp(np.linspace(0.0, 1.0, n_buckets + 1), cum / cum[-1], s)
    out[0], out[-1] = lo, hi
    return out


def lengths(clips: dict, cfg: dict, pool: int) -> list[list[int]]:
    law, n_buckets, per = cfg["clip_seconds"], clips["buckets"], clips["batches_per_bucket"]
    if pool != n_buckets * per:
        raise ValueError("pool must be buckets x batches_per_bucket")
    rng = np.random.default_rng(clips["sizes_seed"])
    e = edges(law, n_buckets)
    return [_fill(rng, law, e[j], e[j + 1], clips["batch_audio_seconds"], cfg["sr"])
            for j in range(n_buckets) for _ in range(per)]


def _fill(rng, law: dict, e0: float, e1: float, cap: float, sr: int) -> list[int]:
    lo, hi = law["min"], law["max"]
    a, b = law["beta"]
    lengths, total = [], 0.0
    while True:
        draw = lo + (hi - lo) * rng.beta(a, b, size=4096)
        for s in draw[(draw >= e0) & (draw <= e1)]:
            if total + s > cap:
                return lengths
            lengths.append(int(round(s * sr)))
            total += s
