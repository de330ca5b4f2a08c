"""Shared helpers of the PyTorch-port parity tests (`test_torch_port_*.py`).

The same NumPy inputs go through the JAX package and the port; results come
back as NumPy arrays and are compared against the contract rows of
`NUMERICAL_ACCURACY.md`.
"""

from __future__ import annotations

import numpy as np
import torch

# Keep each xdist worker on one CPU thread: the suite runs six workers.
torch.set_num_threads(1)


def signals(seed: int, shape: tuple[int, ...]) -> np.ndarray:
    """Standard-normal float32 test signal from ``np.random.default_rng(seed)``."""
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def to_np(x) -> np.ndarray:
    """JAX array or torch tensor -> NumPy (detached, on the host)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def max_rel(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    got, ref = to_np(got).astype(np.complex128), to_np(ref).astype(np.complex128)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def max_abs(got, ref) -> float:
    got, ref = to_np(got).astype(np.complex128), to_np(ref).astype(np.complex128)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max())


def same_bits(a, b) -> bool:
    """float32 arrays equal bit for bit (so -0.0 != 0.0)."""
    a, b = to_np(a), to_np(b)
    return (a.dtype == b.dtype == np.float32 and a.shape == b.shape
            and np.array_equal(a.view(np.uint32), b.view(np.uint32)))


def launch_counts() -> dict[str, int]:
    from mlx_audio_primitives_tpu_torch.kernels import _build

    return {k.name: k.launches for k in _build.KERNELS}
