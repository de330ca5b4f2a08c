"""Window functions (scipy/librosa-compatible).

Counterpart of `mlx_audio_primitives_tpu/ops/windows.py`. Windows are tiny
tables whose exactness matters far more than their construction speed:
every window is built on the host in float64 NumPy with the same formulas
as the JAX package's NumPy builder, so the float32 result is bit-equal to
scipy's. Periodic ("fftbins") windows are ``n+1``-point symmetric windows
with the last sample dropped (scipy's DFT-even convention).

As in the JAX package, the native C++ builder (`_native.py`, the same
float64 math) is tried first, and the NumPy builder stands in without it.
"""

from __future__ import annotations

import numpy as np
import torch

from .._config import REAL_DTYPE, WINDOW_CACHE_SIZE
from ..utils import dispatch
from ..utils.cache import table_cache

# Generalized-cosine coefficients (Harris 1978), as in scipy.signal.windows.
_COSINE_COEFFS: dict[str, tuple[float, ...]] = {
    "hann": (0.5, 0.5),
    "hamming": (0.54, 0.46),
    "blackman": (0.42, 0.5, 0.08),
}

_ALIASES: dict[str, str] = {
    "hanning": "hann",
    "triangular": "bartlett",
    "boxcar": "rectangular",
    "ones": "rectangular",
}

_SUPPORTED = sorted(
    set(_COSINE_COEFFS) | {"bartlett", "rectangular", "kaiser"} | set(_ALIASES)
)


def _general_cosine_np(n: int, coeffs: tuple[float, ...]) -> np.ndarray:
    """Symmetric generalized-cosine window in float64, scipy's
    ``fac = linspace(-pi, pi, n)`` formulation (Blackman endpoints stay at
    scipy's ~-1.4e-17; no clamping)."""
    if n == 1:
        return np.ones(1, dtype=np.float64)
    fac = np.linspace(-np.pi, np.pi, n)
    w = np.zeros(n, dtype=np.float64)
    for k, a in enumerate(coeffs):
        w += a * np.cos(k * fac)
    return w


def _symmetric_window_np(name: str, n: int, beta: float | None) -> np.ndarray:
    if n <= 0:
        raise ValueError(f"window length must be positive, got {n}")
    if n == 1:
        return np.ones(1, dtype=np.float64)
    if name in _COSINE_COEFFS:
        return _general_cosine_np(n, _COSINE_COEFFS[name])
    if name == "bartlett":
        k = np.arange(n, dtype=np.float64)
        return 1.0 - np.abs(2.0 * k / (n - 1) - 1.0)
    if name == "rectangular":
        return np.ones(n, dtype=np.float64)
    if name == "kaiser":
        b = 8.6 if beta is None else float(beta)
        k = np.arange(n, dtype=np.float64)
        alpha = (n - 1) / 2.0
        return np.i0(b * np.sqrt(1.0 - ((k - alpha) / alpha) ** 2)) / np.i0(b)
    raise ValueError(
        f"Unknown window type: '{name}'. Supported: {', '.join(_SUPPORTED)}"
    )


@table_cache("window", maxsize=WINDOW_CACHE_SIZE)
def _window_table(name: str, n: int, fftbins: bool, beta: float | None) -> np.ndarray:
    """Host float64 window table (tier-1 cache): the native C++ builder
    first (`csrc/tables.cpp::mapt_window`), the NumPy builder without it."""
    from .._native import native_window

    w = native_window(name, n, fftbins, beta)
    if w is not None:
        return w
    if fftbins and n > 1:
        return _symmetric_window_np(name, n + 1, beta)[:n]
    return _symmetric_window_np(name, n, beta)


def get_window(
    window: str | tuple | torch.Tensor | np.ndarray,
    n_fft: int,
    fftbins: bool = True,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """A window function as a float32 tensor of shape ``(n_fft,)``.

    Same parameters as the JAX package's ``get_window``:

    - ``window``: one of 'hann'/'hanning', 'hamming', 'blackman',
      'bartlett'/'triangular', 'rectangular'/'boxcar'/'ones', a
      ``('kaiser', beta)`` tuple, or an array of length ``n_fft`` used as-is.
    - ``fftbins=True`` gives a periodic (DFT-even) window, ``False`` a
      symmetric one.

    ``device`` places the result. When None, a named window is a table on
    the default device and an array window keeps its own device (a NumPy
    array goes to the default device, as every entry point's input does).
    Named windows are cached per device.
    """
    if isinstance(window, (torch.Tensor, np.ndarray)):
        if window.shape[0] != n_fft:
            raise ValueError(
                f"Window array length ({window.shape[0]}) must match n_fft ({n_fft})"
            )
        if device is None:
            return dispatch.to_tensor(window, REAL_DTYPE)
        return torch.as_tensor(window, dtype=REAL_DTYPE, device=device)

    beta: float | None = None
    if isinstance(window, tuple):
        if len(window) != 2 or window[0] != "kaiser":
            raise ValueError(
                "tuple windows must be ('kaiser', beta); got " f"{window!r}"
            )
        name, beta = "kaiser", float(window[1])
    elif isinstance(window, str):
        name = window.lower()
        name = _ALIASES.get(name, name)
        if name not in set(_SUPPORTED):
            raise ValueError(
                f"Unknown window type: '{window}'. Supported: {', '.join(_SUPPORTED)}"
            )
    else:
        raise TypeError(
            f"window must be str, tuple, or array, got {type(window).__name__}"
        )

    if n_fft <= 0:
        raise ValueError(f"n_fft must be positive, got {n_fft}")
    return _window_table(name, n_fft, fftbins, beta, device=dispatch.default_device(device))


def window_host(
    window: str | tuple, n_fft: int, fftbins: bool = True
) -> np.ndarray:
    """Host-side float64 window (used by table builders that stay in f64)."""
    beta = None
    if isinstance(window, tuple):
        name, beta = "kaiser", float(window[1])
    else:
        name = _ALIASES.get(window.lower(), window.lower())
    return _window_table.host(name, n_fft, fftbins, beta)
