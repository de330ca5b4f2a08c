"""Per-call routing between the hand-written CUDA kernels and the plain
PyTorch compositions, and where a non-tensor input is placed.

Counterpart of `mlx_audio_primitives_tpu/utils/dispatch.py`. There the
Pallas kernels are the fast path and the XLA compositions the
always-available one; here the CUDA kernels under `kernels/` are the fast
path and plain torch ops the other. :func:`to_tensor` places a non-tensor
input on ``_config.DEFAULT_DEVICE``; after that the ops route a call by the
device of its input tensor (:func:`kernel_route`), never by a global device
choice:

* ``use_pallas=None`` takes the kernel for a CUDA tensor wherever the
  kernel's shape gate admits the shape, and the plain composition for a
  CPU tensor;
* ``use_pallas=True`` takes the kernel wrapper on every device; on a CPU
  tensor the wrapper runs the kernel's plain twin, the counterpart of
  Pallas interpret mode;
* ``use_pallas=False`` always takes the plain composition.

``MLX_AUDIO_TPU_DISABLE_PALLAS=1`` turns every kernel off, as it does in the
JAX package (read once, at import, like the JAX package's ``HAS_PALLAS``).

The JAX module's public names keep their signatures here, each with its
CUDA meaning: :data:`HAS_PALLAS`, :func:`has_pallas_tpu` (and the lazy
``HAS_PALLAS_TPU``), :func:`is_tpu`, :func:`default_backend`,
:func:`pallas_interpret_mode` and :func:`resolve_use_pallas` with its
``default_on_tpu`` argument. The JAX module's ``is_batch_traced``,
``try_pallas`` and ``vma_struct`` guard against ``jax.vmap`` batching
traces, forward-mode autodiff traces and ``shard_map`` types reaching a
``pallas_call``. PyTorch runs eagerly and has no such traces, so they have
no counterpart here.
"""

from __future__ import annotations

import os

import torch

from .. import _config

#: False when ``MLX_AUDIO_TPU_DISABLE_PALLAS=1``: no kernel is ever selected.
KERNELS_ENABLED: bool = os.environ.get("MLX_AUDIO_TPU_DISABLE_PALLAS", "0") != "1"


def to_tensor(x, dtype: torch.dtype | None = None) -> torch.Tensor:
    """An entry point's input as a tensor. A tensor keeps its device (only
    ``dtype`` changes); anything else goes to ``_config.DEFAULT_DEVICE``,
    ``cuda`` unless the caller set another. With the default at ``cuda`` and
    no CUDA device this raises: an op never falls back to the CPU unasked."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None or x.dtype == dtype else x.to(dtype)
    return torch.as_tensor(x, dtype=dtype, device=default_device())


def default_device(device: torch.device | str | None = None) -> torch.device:
    """``device``, or when None ``_config.DEFAULT_DEVICE``: where a
    non-tensor input, or a table asked for without a device, is placed.
    Raises for ``cuda`` without a CUDA device."""
    dev = _config.DEFAULT_DEVICE if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device for a non-tensor input: pass a CPU tensor, or call "
            "set_default_device('cpu') to run NumPy inputs on the CPU"
        )
    return dev


def kernel_route(flag: bool | None, device: torch.device) -> bool:
    """Whether an op takes its kernel wrapper for a tensor on ``device``,
    given its ``use_pallas`` kwarg (the routing in the module docstring)."""
    if not KERNELS_ENABLED:
        return False
    if flag is True:
        return True
    if flag is None:
        return torch.device(device).type == "cuda"
    return False


#: True unless ``MLX_AUDIO_TPU_DISABLE_PALLAS=1``: the kernels can run at
#: all (compiled on a CUDA tensor, as their plain twins on a CPU tensor, the
#: counterpart of Pallas interpret mode). The JAX package's ``HAS_PALLAS``.
HAS_PALLAS: bool = KERNELS_ENABLED


def default_backend() -> str:
    """``"gpu"`` when a CUDA device is present, else ``"cpu"``: the
    platform names ``jax.default_backend()`` gives on such a machine."""
    return "gpu" if torch.cuda.is_available() else "cpu"


def is_tpu() -> bool:
    """Always False: the port runs on CUDA devices and the CPU."""
    return False


def has_pallas_tpu() -> bool:
    """True when the compiled kernels are the default: kernels enabled and
    a CUDA device present, so ``use_pallas=None`` launches them on CUDA
    tensors. Read on each call; ``torch.cuda.is_available()`` does not
    create a CUDA context."""
    return KERNELS_ENABLED and torch.cuda.is_available()


def pallas_interpret_mode() -> bool:
    """True without a CUDA device: a kernel wrapper can then only run its
    plain twin on CPU tensors (the counterpart of Pallas interpret mode)."""
    return not torch.cuda.is_available()


def __getattr__(name: str):
    # the JAX package's lazy ``HAS_PALLAS_TPU``: read when asked for
    if name == "HAS_PALLAS_TPU":
        return has_pallas_tpu()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def resolve_use_pallas(flag: bool | None, default_on_tpu: bool = False) -> bool:
    """Resolve a ``use_pallas`` kwarg against availability, with the JAX
    package's signature and policy: ``True`` selects the kernels whenever
    they are enabled (their plain twins on a CPU tensor); ``None`` selects
    them when ``default_on_tpu`` is set and a CUDA device is present
    (:func:`has_pallas_tpu`); ``False`` never. Honors
    ``MLX_AUDIO_TPU_DISABLE_PALLAS``. The port's own ops route by their
    input's device instead (:func:`kernel_route`)."""
    if flag is True:
        return KERNELS_ENABLED
    if flag is None and default_on_tpu:
        return has_pallas_tpu()
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
