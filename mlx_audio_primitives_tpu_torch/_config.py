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

# K1's filterbank contraction (kernels/mel_fused.py) as 3-pass bf16 splits:
# each FP32 operand split into hi = bf16(x) and lo = bf16(x - hi), and
# hi@hi + hi@lo + lo@hi in FP32 on the tensor cores (mma.sync m16n8k16),
# within ~1e-5 of max of an exact product; False takes the 3xTF32 entry,
# within ~1e-6. Same default as the JAX package. The STFT, magnitude and
# ISTFT kernels compute by FP32 FFT and have no GEMM for it to change; the
# pitch ACF runs K1's ACF entry, which has no contraction. Read at call
# time, so setting it pins every call site that takes the default.
ANALYSIS_FAST_GEMM: bool = True

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
