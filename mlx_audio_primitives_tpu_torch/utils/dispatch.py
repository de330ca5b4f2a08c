"""Per-call routing between the hand-written CUDA kernels and the plain
PyTorch compositions.

Counterpart of `mlx_audio_primitives_tpu/utils/dispatch.py`. There the
Pallas kernels are the fast path and the XLA compositions the
always-available one; here the CUDA kernels under `kernels/` are the fast
path and plain torch ops the other. A call is routed by the device of its
input tensor, never by a global device choice:

* ``use_pallas=None`` takes the kernel for a CUDA tensor wherever the
  kernel's shape gate admits the shape, and the plain composition for a
  CPU tensor;
* ``use_pallas=True`` takes the kernel wrapper on every device; on a CPU
  tensor the wrapper runs the kernel's plain twin, the counterpart of
  Pallas interpret mode;
* ``use_pallas=False`` always takes the plain composition.

``MLX_AUDIO_TPU_DISABLE_PALLAS=1`` turns every kernel off, as it does in the
JAX package (read once, at import, like the JAX package's ``HAS_PALLAS``).

The JAX module's ``is_batch_traced`` and ``try_pallas`` guard against
``jax.vmap`` batching traces and forward-mode autodiff traces reaching a
``pallas_call``. PyTorch runs eagerly and has no such traces, so they have
no counterpart here.
"""

from __future__ import annotations

import os

import torch

#: False when ``MLX_AUDIO_TPU_DISABLE_PALLAS=1``: no kernel is ever selected.
KERNELS_ENABLED: bool = os.environ.get("MLX_AUDIO_TPU_DISABLE_PALLAS", "0") != "1"


def resolve_use_pallas(flag: bool | None, device: torch.device) -> bool:
    """Resolve a per-op ``use_pallas`` kwarg for a tensor on ``device``."""
    if not KERNELS_ENABLED:
        return False
    if flag is True:
        return True
    if flag is None:
        return torch.device(device).type == "cuda"
    return False


def radix_shape_ok(n_fft: int, hop_length: int) -> bool:
    """The JAX package's shape gate for its radix kernels (fused mel, STFT,
    ISTFT; `kernels/block_policy.py::radix_shape_ok`): power-of-two
    ``n_fft = C*hop``, ``hop = R2*128``, ``C, R2 <= 8``. The JAX kernels add
    VMEM budgets on top; those are TPU-only and have no counterpart here.
    The port's kernels (K1-K3) take every shape this gate admits."""
    return (
        n_fft >= 128
        and n_fft & (n_fft - 1) == 0
        and hop_length >= 128
        and hop_length % 128 == 0
        and n_fft % hop_length == 0
        and n_fft // hop_length <= 8
        and hop_length // 128 <= 8
    )


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device (the wrapper launches
    its kernel), False when all lie on the CPU (the wrapper runs the plain
    twin). Raises for any other placement: a kernel wrapper never moves
    data between devices."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs must share one device, got {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain twin for device type '{dev.type}'")
