"""Short-Time Fourier Transform and inverse (librosa-compatible).

Counterpart of `mlx_audio_primitives_tpu/ops/stft.py`, with the same
signatures, defaults, errors and output conventions (complex64
``(B, n_bins, F)``). Every op runs on the device of its input tensor; a
non-tensor input goes to the default device (`utils/dispatch.py::to_tensor`).

Paths, chosen per call as in the JAX package:

* ``stft``: the fused STFT kernel (K2, `kernels/stft_radix.py`) where the
  radix shape gate admits and no explicit ``fft_mode`` pins a plain path;
  otherwise the plain composition (pad, frame, window, then
  ``torch.fft.rfft`` or, for ``fft_mode='matmul'``, an FP32 DFT GEMM).
* ``magnitude_spectrogram``: ``|stft|`` without the complex intermediate,
  through the STFT kernel's magnitude emit (K2m) under the radix gate, else
  the plain composition ``|rfft(window * frames)|``
  (`kernels/stft_radix.py::stft_magnitude_plain`, the JAX package's
  ``_magnitude_core``).
* ``istft``: three tiers. The fused ISTFT kernel (K3,
  `kernels/istft_fused.py`) under the radix gate; the inverse transform
  plus the overlap-add kernel (K4, `kernels/overlap_add.py`) for other hops
  within its gate (e.g. hop 441); else the plain composition.

``fft_mode``: 'auto' and 'fft' use ``torch.fft``; 'sixstep' (an XLA GEMM
FFT in the JAX package) also maps to ``torch.fft``; 'matmul' uses the
stacked DFT bases of `kernels/dft.py`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._config import COMPLEX_DTYPE, REAL_DTYPE, WINDOW_SUM_EPSILON
from ..kernels.dft import forward_basis, inverse_basis, irfft_frames
from ..kernels.istft_fused import istft_fused, istft_plain
from ..kernels.overlap_add import ola_supported, overlap_add_fused
from ..kernels.stft_radix import (
    stft_fused,
    stft_magnitude_fused,
    stft_magnitude_plain,
    stft_plain,
)
from ..utils import dispatch
from ..utils.cache import table_cache
from ._frames import num_frames, window_envelope
from .windows import _ALIASES, get_window, window_host

ArrayLike = Any

_PAD_MODES = ("constant", "reflect", "edge")


def _resolve_fft_mode(fft_mode: str, n_fft: int) -> str:
    """Resolve the transform path: 'fft' (``torch.fft``) or 'matmul'. An
    unknown mode raises the JAX package's ValueError on every device."""
    if fft_mode in ("auto", "fft", "sixstep"):
        return "fft"
    if fft_mode == "matmul":
        return "matmul"
    raise ValueError(
        f"fft_mode must be 'auto', 'fft', 'matmul' or 'sixstep', got {fft_mode}"
    )


@table_cache("istft_envelope", maxsize=32)
def _istft_envelope_table(
    window_key: tuple, win_length: int, n_fft: int,
    n_frames: int, hop_length: int, padded_length: int,
) -> np.ndarray:
    """Squared-window overlap-add envelope, built once per config in f64 on
    the host and clamped to ``WINDOW_SUM_EPSILON``."""
    name, beta = window_key
    win = window_host(name if beta is None else (name, beta), win_length)
    if win_length < n_fft:
        lp = (n_fft - win_length) // 2
        win = np.pad(win, (lp, n_fft - win_length - lp))
    sq = win * win
    env = np.zeros(padded_length, np.float64)
    for f in range(n_frames):
        s = f * hop_length
        e = min(s + n_fft, padded_length)
        if s >= padded_length:
            break
        env[s:e] += sq[: e - s]
    return np.maximum(env, WINDOW_SUM_EPSILON)


def _window_key(window) -> tuple | None:
    """Hashable cache key for string/tuple window specs (None for arrays);
    aliases normalize so identical envelopes share one cache slot."""
    if isinstance(window, str):
        name = window.lower()
        return (_ALIASES.get(name, name), None)
    if isinstance(window, tuple) and len(window) == 2:
        name = str(window[0]).lower()
        return (_ALIASES.get(name, name), float(window[1]))
    return None


def _validate_stft_params(
    n_fft: int, hop_length: int, win_length: int, pad_mode: str
) -> None:
    """Shared argument validation for the STFT-family entry points."""
    if hop_length <= 0:
        raise ValueError(f"hop_length must be positive, got {hop_length}")
    if win_length <= 0:
        raise ValueError(f"win_length must be positive, got {win_length}")
    if win_length > n_fft:
        raise ValueError(f"win_length ({win_length}) must be <= n_fft ({n_fft})")
    if hop_length > n_fft:
        raise ValueError(
            f"hop_length ({hop_length}) should typically be <= n_fft ({n_fft})"
        )
    if pad_mode not in _PAD_MODES:
        raise ValueError(
            f"Unknown pad_mode: '{pad_mode}'. Supported: {', '.join(_PAD_MODES)}"
        )


def _as_batched(y: ArrayLike, n_fft: int, center: bool) -> tuple[torch.Tensor, bool]:
    """Promote to a contiguous (B, L) float32 tensor (a tensor keeps its
    device, anything else goes to the default device, see
    :func:`..utils.dispatch.to_tensor`) and check the center=False length
    bound. Returns ``(y_2d, input_is_1d)``."""
    y = dispatch.to_tensor(y, REAL_DTYPE)
    if y.dim() not in (1, 2):
        raise ValueError(f"y must be 1D or 2D, got {y.dim()}D")
    input_is_1d = y.dim() == 1
    if input_is_1d:
        y = y[None, :]
    if not center and y.shape[1] < n_fft:
        raise ValueError(
            f"signal length ({y.shape[1]}) must be >= n_fft ({n_fft}) "
            "when center=False"
        )
    return y.contiguous(), input_is_1d


def _get_padded_window(
    window: str | tuple | ArrayLike, win_length: int, n_fft: int,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Window of length ``win_length`` center-padded to ``n_fft``, on
    ``device``."""
    win = get_window(window, win_length, fftbins=True, device=device)
    if win_length < n_fft:
        pad_left = (n_fft - win_length) // 2
        win = torch.nn.functional.pad(win, (pad_left, n_fft - win_length - pad_left))
    return win.contiguous()


def stft(
    y: ArrayLike,
    n_fft: int = 2048,
    hop_length: int | None = None,
    win_length: int | None = None,
    window: str | ArrayLike = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    fft_mode: str = "auto",
    use_pallas: bool | None = None,
) -> torch.Tensor:
    """Short-Time Fourier Transform.

    Input ``(samples,)`` or ``(batch, samples)``; output
    ``(n_fft//2+1, n_frames)`` or ``(batch, n_fft//2+1, n_frames)``
    complex64, on the input's device. ``use_pallas`` selects the fused STFT
    kernel (see :mod:`..utils.dispatch`); an explicit ``fft_mode`` pins the
    plain path unless ``use_pallas=True``.
    """
    if hop_length is None:
        hop_length = n_fft // 4
    if win_length is None:
        win_length = n_fft
    _validate_stft_params(n_fft, hop_length, win_length, pad_mode)
    y, input_is_1d = _as_batched(y, n_fft, center)
    win = _get_padded_window(window, win_length, n_fft, y.device)
    fft_mode_r = _resolve_fft_mode(fft_mode, n_fft)
    kw = dict(n_fft=n_fft, hop_length=hop_length, center=center, pad_mode=pad_mode)

    if (
        dispatch.kernel_route(use_pallas, y.device)
        and (fft_mode == "auto" or use_pallas is True)
        and dispatch.radix_shape_ok(n_fft, hop_length)
    ):
        out = stft_fused(y, win, **kw)
    else:
        basis = forward_basis(n_fft, device=y.device) if fft_mode_r == "matmul" else None
        out = stft_plain(y, win, basis=basis, **kw)
    return out[0] if input_is_1d else out


def magnitude_spectrogram(
    y: ArrayLike,
    n_fft: int = 2048,
    hop_length: int | None = None,
    win_length: int | None = None,
    window: str | ArrayLike = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    use_pallas: bool | None = None,
    fast_gemm: bool | None = None,
) -> torch.Tensor:
    """``|stft(y)|`` as float32 ``(n_bins, F)`` / ``(B, n_bins, F)``, without
    the complex intermediate: the spectral features' magnitude path.

    ``use_pallas`` selects the magnitude kernel (see :mod:`..utils.dispatch`).
    The port's kernels are FP32-exact, so ``fast_gemm`` (the JAX kernel's
    bf16-split GEMM mode) is accepted and changes nothing."""
    del fast_gemm
    if hop_length is None:
        hop_length = n_fft // 4
    if win_length is None:
        win_length = n_fft
    _validate_stft_params(n_fft, hop_length, win_length, pad_mode)
    y, input_is_1d = _as_batched(y, n_fft, center)
    win = _get_padded_window(window, win_length, n_fft, y.device)
    kw = dict(n_fft=n_fft, hop_length=hop_length, center=center, pad_mode=pad_mode)
    if dispatch.kernel_route(use_pallas, y.device) and dispatch.radix_shape_ok(n_fft, hop_length):
        out = stft_magnitude_fused(y, win, **kw)
    else:
        out = stft_magnitude_plain(y, win, **kw)
    return out[0] if input_is_1d else out


def istft(
    stft_matrix: ArrayLike,
    hop_length: int | None = None,
    win_length: int | None = None,
    n_fft: int | None = None,
    window: str | ArrayLike = "hann",
    center: bool = True,
    length: int | None = None,
    fft_mode: str = "auto",
    use_pallas: bool | None = None,
) -> torch.Tensor:
    """Inverse Short-Time Fourier Transform.

    librosa-compatible semantics including ``length`` crop/pad and
    center-pad trimming. ``use_pallas`` selects the kernel tiers: the fused
    ISTFT kernel under the radix gate, else the overlap-add kernel within
    its gate, else the plain composition.
    """
    S = dispatch.to_tensor(stft_matrix, COMPLEX_DTYPE).resolve_conj()
    if S.dim() not in (2, 3):
        raise ValueError(f"stft_matrix must be 2D or 3D, got {S.dim()}D")
    input_is_2d = S.dim() == 2
    if input_is_2d:
        S = S[None]

    _, freq_bins, n_frames = S.shape
    if n_fft is None:
        n_fft = 2 * (freq_bins - 1)
    if hop_length is None:
        hop_length = n_fft // 4
    if win_length is None:
        win_length = n_fft
    if hop_length <= 0:
        raise ValueError(f"hop_length must be positive, got {hop_length}")
    if win_length > n_fft:
        raise ValueError(f"win_length ({win_length}) must be <= n_fft ({n_fft})")

    win = _get_padded_window(window, win_length, n_fft, S.device)
    S = S.transpose(1, 2)  # (B, F, n_bins) view

    if length is not None:
        padded_length = length + n_fft if center else length
    else:
        padded_length = n_fft + (n_frames - 1) * hop_length

    fft_mode_r = _resolve_fft_mode(fft_mode, n_fft)
    env = _istft_envelope(window, win, win_length, n_fft, n_frames, hop_length, padded_length)
    tier = _istft_tier(use_pallas, S.device, fft_mode, n_fft, hop_length, freq_bins)
    basis = inverse_basis(n_fft, device=S.device) if fft_mode_r == "matmul" else None
    y = _istft_core(S, win, env, basis, n_fft=n_fft, hop_length=hop_length,
                    padded_length=padded_length, tier=tier)

    if center:
        pad = n_fft // 2
        if length is not None:
            y = y[:, pad : pad + length]
        else:
            end = y.shape[1] - pad
            y = y[:, pad:end] if end > pad else y[:, :0]
    elif length is not None:
        cur = y.shape[1]
        if length < cur:
            y = y[:, :length]
        elif length > cur:
            y = torch.nn.functional.pad(y, (0, length - cur))

    return y[0] if input_is_2d else y


def _istft_envelope(window, win: torch.Tensor, win_length: int, n_fft: int, n_frames: int,
                    hop_length: int, padded_length: int) -> torch.Tensor:
    """The clamped squared-window envelope on ``win``'s device: the cached
    host table for a named window, else built from ``win``."""
    wkey = _window_key(window)
    if wkey is not None:
        return _istft_envelope_table(wkey, win_length, n_fft, n_frames, hop_length,
                                     padded_length, device=win.device)
    return torch.clamp(window_envelope(win, n_frames, hop_length, padded_length),
                       min=WINDOW_SUM_EPSILON)


def _istft_tier(use_pallas: bool | None, device: torch.device, fft_mode: str, n_fft: int,
                hop_length: int, freq_bins: int) -> str:
    """The inverse's tier, as the JAX package picks it: 'fused' (K3) under
    the radix gate unless an explicit ``fft_mode`` pins the plain
    transforms, else 'ola' (inverse transform, then K4) within K4's gate,
    else 'none' (the plain composition)."""
    want = dispatch.kernel_route(use_pallas, device)
    if (
        want
        and (fft_mode == "auto" or use_pallas is True)
        and dispatch.radix_shape_ok(n_fft, hop_length)
        and freq_bins == n_fft // 2 + 1
    ):
        return "fused"
    if want and ola_supported(n_fft, hop_length):
        return "ola"
    return "none"


def _istft_core(S: torch.Tensor, win: torch.Tensor, env: torch.Tensor,
                basis: torch.Tensor | None, *, n_fft: int, hop_length: int,
                padded_length: int, tier: str, owned: bool = False) -> torch.Tensor:
    """``(B, F, n_bins)`` spectrum (any strides) -> ``(B, padded_length)``
    through ``tier`` (see :func:`_istft_tier`); shared by :func:`istft` and
    Griffin-Lim, which passes ``owned`` for the spectra it builds itself
    (see :func:`..kernels.dft.irfft_len`)."""
    kw = dict(n_fft=n_fft, hop_length=hop_length)
    if tier == "fused":
        return istft_fused(S, win, env, padded_length=padded_length, **kw)
    if tier == "ola":
        frames = irfft_frames(S, n_fft, basis, owned=owned) * win
        return overlap_add_fused(frames, env, hop_length=hop_length,
                                 output_length=padded_length)
    return istft_plain(S, win, env, padded_length=padded_length, basis=basis, owned=owned, **kw)


def magnitude(stft_matrix: ArrayLike) -> torch.Tensor:
    """Magnitude of a complex STFT."""
    return dispatch.to_tensor(stft_matrix).abs()


def phase(stft_matrix: ArrayLike) -> torch.Tensor:
    """Phase (radians) of a complex STFT via arctan2(imag, real)."""
    S = dispatch.to_tensor(stft_matrix)
    return torch.atan2(S.imag, S.real)


def check_nola(
    window: str | ArrayLike,
    hop_length: int,
    n_fft: int,
    tol: float = 1e-10,
) -> bool:
    """Nonzero-overlap-add constraint check (scipy ``check_NOLA``
    algorithm), on the host."""
    if hop_length <= 0:
        raise ValueError(f"hop_length must be positive, got {hop_length}")
    if hop_length > n_fft:
        # hops larger than the window leave uncovered gaps: NOLA fails
        return False
    win = get_window(window, n_fft, fftbins=True, device="cpu").numpy().astype(np.float64)
    step = hop_length
    n_bins = n_fft // step
    binsums = sum(win[ii * step : (ii + 1) * step] ** 2 for ii in range(n_bins))
    if n_fft % step != 0:
        binsums[: n_fft % step] += win[-(n_fft % step):] ** 2
    return bool(np.min(binsums) > tol)


def reconstruction_length(
    n_frames: int, hop_length: int, n_fft: int, center: bool
) -> int:
    """Natural ISTFT output length for a given frame count (helper)."""
    full = n_fft + (n_frames - 1) * hop_length
    return full - 2 * (n_fft // 2) if center else full


def magphase(D: ArrayLike, power: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Split a complex spectrogram into ``(|D|**power, unit phasors)`` with
    ``mag * phase == D`` when ``power=1`` (librosa `magphase` semantics).
    Zero-magnitude cells get phase ``1+0j`` rather than NaN."""
    D = dispatch.to_tensor(D)
    mag = D.abs()
    tiny = float(np.finfo(np.float32).tiny)
    ph = torch.where(
        mag > tiny, D / torch.clamp(mag, min=tiny).to(D.dtype),
        torch.ones((), dtype=D.dtype, device=D.device),
    )
    if power != 1.0:
        mag = mag**power
    return mag.to(REAL_DTYPE), ph


__all__ = [
    "stft",
    "istft",
    "magnitude_spectrogram",
    "magnitude",
    "phase",
    "check_nola",
    "num_frames",
    "reconstruction_length",
    "magphase",
]
