"""Numerical and policy constants of the PyTorch port.

Counterpart of `mlx_audio_primitives_tpu/_config.py`, carrying only the
constants the ported slices use, plus the one placement setting the JAX
package takes from ``jax.default_device``: where a non-tensor input (a NumPy
array, a list) goes. One small module of constants, no flag registry.
"""

from __future__ import annotations

import torch

# Epsilon that clamps the squared-window envelope in overlap-add
# normalization (same value as the JAX package).
WINDOW_SUM_EPSILON: float = 1e-8

# Table-cache sizes (same as the JAX package).
WINDOW_CACHE_SIZE: int = 128
FILTERBANK_CACHE_SIZE: int = 64
DCT_CACHE_SIZE: int = 32

# Working dtypes. Tables are built in float64 on the host and cast to
# REAL_DTYPE when they are placed on a device.
REAL_DTYPE = torch.float32
COMPLEX_DTYPE = torch.complex64

#: Device that every entry point places a non-tensor input on (the
#: counterpart of ``jnp.asarray`` placing data on the TPU). A tensor input
#: keeps its own device: passing a CPU tensor is how a caller asks for the
#: CPU. Change it with :func:`set_default_device`; the port never reads
#: ``torch.set_default_device``, so other libraries' tensors are unaffected.
DEFAULT_DEVICE = torch.device("cuda")


def set_default_device(device: torch.device | str) -> None:
    """Place non-tensor inputs of every entry point on ``device`` from now
    on (``"cuda"`` by default; ``"cpu"`` runs NumPy inputs on the CPU)."""
    global DEFAULT_DEVICE
    DEFAULT_DEVICE = torch.device(device)
