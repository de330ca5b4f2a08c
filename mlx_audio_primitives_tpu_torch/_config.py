"""Numerical and policy constants of the PyTorch port.

Counterpart of `mlx_audio_primitives_tpu/_config.py`, carrying only the
constants the STFT / ISTFT / mel slice uses. One small module of constants,
no flag registry.
"""

from __future__ import annotations

import torch

# Epsilon that clamps the squared-window envelope in overlap-add
# normalization (same value as the JAX package).
WINDOW_SUM_EPSILON: float = 1e-8

# Table-cache sizes (same as the JAX package).
WINDOW_CACHE_SIZE: int = 128
FILTERBANK_CACHE_SIZE: int = 64

# Working dtypes. Tables are built in float64 on the host and cast to
# REAL_DTYPE when they are placed on a device.
REAL_DTYPE = torch.float32
COMPLEX_DTYPE = torch.complex64
