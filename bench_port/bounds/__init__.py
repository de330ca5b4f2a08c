"""The least work each public op needs, for the rooflines: ``bounds/<op>.py``
gives ``cost(cfg, lengths) -> (flops, bytes)`` for one batch of clips of
``lengths`` samples, padded to the longest.

The count is the algorithm's, whatever kernel runs it: a real FFT at
``2.5 n log2 n`` operations a frame (split radix), the filterbank's nonzero
entries taken from the reference's own filterbank, the elementwise work,
all in FP32; each op's inputs read once and its outputs written once.
Peaks are NVIDIA's published H100 SXM figures: 67 TFLOP/s FP32 outside the
tensor cores and 3.35 TB/s of HBM3, at the 700 W limit.
"""

from __future__ import annotations

import math

import numpy as np

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
F32 = 4
C64 = 8


def seconds(flops: float, nbytes: float) -> float:
    """The least time: the larger of the compute and the memory bound."""
    return max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)


def n_frames(cfg: dict, L: int, n: int | None = None) -> int:
    n = n or cfg["n_fft"]
    return 1 + (L + (n if cfg["center"] else 0) - n) // cfg["hop_length"]


def rfft_flops(n: int) -> float:
    return 2.5 * n * math.log2(n)


def spectrum_flops(cfg: dict, power: float) -> float:
    """One frame: the window, the real FFT and ``|X|`` or ``|X|^2``."""
    n, bins = cfg["n_fft"], cfg["n_fft"] // 2 + 1
    return n + rfft_flops(n) + bins * (3 if power == 2.0 else 4)


def filterbank_nnz(cfg: dict) -> int:
    from ..reference.dsp import config_filterbank

    return int(np.count_nonzero(config_filterbank(cfg)))
