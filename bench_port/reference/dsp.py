"""The plain reference's building blocks, written from the published
definitions (librosa's and scipy's documented semantics): the periodic Hann
window, Slaney's mel filterbank, centred framing, the real DFT and its
inverse, overlap-add, the DCT-II and Savitzky-Golay derivatives.

Everything is built here from the configuration's arguments: nothing is
imported from the port or the JAX package, and no table the port made is
read. Each function takes a :class:`Prec`:

* ``Prec("float64")``: the reference, float64, transforms by FFT;
* ``Prec("tf32")``: the control, float32 with every sum of products taken as
  a matrix product of operands rounded to TF32 (10 mantissa bits), the DFT
  as a product with its basis: what a tensor-core DFT or filterbank in TF32
  computes, the nearest precision below the port's float32 with TF32 off.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits (to nearest, ties
    away from zero), exactly as a tensor core reads it; finite inputs only."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Prec:
    def __init__(self, name: str):
        if name not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    @property
    def tf32(self) -> bool:
        return self.name == "tf32"

    def cast(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.dtype)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b``: in float64, or on TF32-rounded float32 operands."""
        if not self.tf32:
            return a.double() @ b.double()
        a, b = round_tf32(a.float()), round_tf32(b.float())
        if a.is_cuda:
            saved = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                return a @ b
            finally:
                torch.backends.cuda.matmul.allow_tf32 = saved
        return a @ b


def hann(n: int) -> np.ndarray:
    """The periodic Hann window (``scipy.signal.get_window('hann', n)``)."""
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)


def padded_window(cfg: dict) -> np.ndarray:
    """The window of ``win_length`` centred in ``n_fft`` zeros."""
    if cfg["window"] != "hann":
        raise ValueError("the reference knows only the Hann window")
    n_fft, wl = cfg["n_fft"], cfg.get("win_length") or cfg["n_fft"]
    w = np.zeros(n_fft)
    left = (n_fft - wl) // 2
    w[left:left + wl] = hann(wl)
    return w


def hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    lin = f / f_sp
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
                    lin)


def mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Slaney's mel filterbank ``(n_mels, n_fft//2 + 1)`` with Slaney's area
    normalisation (librosa ``filters.mel(htk=False, norm='slaney')``)."""
    fft_f = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_f = mel_to_hz_slaney(np.linspace(hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax),
                                         n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_f[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    return weights * (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]


def config_filterbank(cfg: dict) -> np.ndarray:
    if cfg.get("htk") or cfg.get("norm") != "slaney":
        raise ValueError("the reference knows only Slaney's mel scale and norm")
    fmax = cfg["fmax"] if cfg.get("fmax") is not None else cfg["sr"] / 2.0
    return mel_filterbank(cfg["sr"], cfg["n_fft"], cfg["n_mels"], cfg["fmin"], fmax)


def frames(y: torch.Tensor, n: int, hop: int, center: bool, pad_mode: str) -> torch.Tensor:
    """``(B, L) -> (B, F, n)``: the frames of ``y``, centred by a pad of
    ``n // 2`` each side ('constant' zeros or 'edge' copies)."""
    if center:
        if pad_mode == "constant":
            y = torch.nn.functional.pad(y, (n // 2, n // 2))
        elif pad_mode == "edge":
            y = torch.cat([y[:, :1].expand(-1, n // 2), y, y[:, -1:].expand(-1, n // 2)], dim=1)
        else:
            raise ValueError(f"the reference knows no pad mode {pad_mode!r}")
    return y.unfold(-1, n, hop)


def _dft_basis(n: int, device) -> torch.Tensor:
    """``(n, 2 * (n//2 + 1))``: the real DFT's cosine and minus-sine columns."""
    k = np.arange(n // 2 + 1)
    ang = 2 * np.pi * np.outer(np.arange(n), k) / n
    return torch.from_numpy(np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)).to(device)


def _idft_basis(n: int, device) -> torch.Tensor:
    """``(2 * (n//2 + 1), n)``: NumPy's ``irfft`` as a product with
    ``[Re, Im]``; the imaginary parts of the DC and Nyquist bins drop out."""
    k = np.arange(n // 2 + 1)
    c = np.full(k.shape, 2.0)
    c[0] = c[-1] = 1.0
    ang = 2 * np.pi * np.outer(k, np.arange(n)) / n
    cos = c[:, None] * np.cos(ang) / n
    sin = -c[:, None] * np.sin(ang) / n
    sin[0] = sin[-1] = 0.0
    return torch.from_numpy(np.concatenate([cos, sin], axis=0)).to(device)


def rdft(x: torch.Tensor, prec: Prec) -> torch.Tensor:
    """Real DFT along the last axis: complex ``(..., n//2 + 1)``."""
    n = x.shape[-1]
    if not prec.tf32:
        return torch.fft.rfft(x.double())
    out = prec.mm(x.reshape(-1, n), _dft_basis(n, x.device).float())
    re, im = out.chunk(2, dim=-1)
    return torch.complex(re, im).reshape(*x.shape[:-1], n // 2 + 1)


def irdft(X: torch.Tensor, n: int, prec: Prec) -> torch.Tensor:
    """Inverse real DFT of ``(..., n//2 + 1)`` bins: real ``(..., n)``."""
    if not prec.tf32:
        return torch.fft.irfft(X.to(torch.complex128), n=n)
    XR = torch.cat([X.real, X.imag], dim=-1).reshape(-1, 2 * (n // 2 + 1))
    return prec.mm(XR, _idft_basis(n, X.device).float()).reshape(*X.shape[:-1], n)


def stft(y: torch.Tensor, cfg: dict, prec: Prec) -> torch.Tensor:
    """``(B, L) -> (B, n_bins, F)`` complex."""
    win = prec.cast(padded_window(cfg)).to(y.device)
    fr = frames(prec.cast(y), cfg["n_fft"], cfg["hop_length"], cfg["center"], cfg["pad_mode"])
    return rdft(fr * win, prec).transpose(1, 2)


def istft(S: torch.Tensor, cfg: dict, length: int, prec: Prec) -> torch.Tensor:
    """librosa's ``istft`` with ``length``: inverse DFT of each frame, the
    window, overlap-add, the division by the summed squared window where it
    is above the smallest normal float, the centre trim."""
    n, hop = cfg["n_fft"], cfg["hop_length"]
    B, _, F = S.shape
    win = prec.cast(padded_window(cfg)).to(S.device)
    fr = irdft(S.transpose(1, 2), n, prec) * win                       # (B, F, n)
    total = n + hop * (F - 1)
    fold = dict(output_size=(1, total), kernel_size=(1, n), stride=(1, hop))
    y = torch.nn.functional.fold(fr.transpose(1, 2), **fold)[:, 0, 0]  # (B, total)
    env = torch.nn.functional.fold((win * win)[None, :, None].expand(1, n, F).contiguous(),
                                   **fold)[0, 0, 0]
    tiny = torch.finfo(env.dtype).tiny
    y = torch.where(env > tiny, y / torch.where(env > tiny, env, 1.0), y)
    start = n // 2 if cfg["center"] else 0
    y = y[:, start:start + length]
    if y.shape[1] < length:
        y = torch.nn.functional.pad(y, (0, length - y.shape[1]))
    return y


def to_db(S: torch.Tensor, coefficient: float, ref: float, amin: float, top_db) -> torch.Tensor:
    """``coefficient * log10(max(S, amin) / max(ref, amin))``, floored at
    ``top_db`` below the maximum of the whole array (librosa)."""
    db = coefficient * torch.log10(torch.clamp(S, min=amin) / max(ref, amin))
    if top_db is not None:
        db = torch.maximum(db, db.max() - top_db)
    return db


def dct_ortho(n_out: int, n_in: int) -> np.ndarray:
    """The orthonormal DCT-II matrix ``(n_out, n_in)`` (scipy ``norm='ortho'``)."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    basis = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in))
    basis[0] *= 1.0 / np.sqrt(n_in)
    basis[1:] *= np.sqrt(2.0 / n_in)
    return basis


def savgol_rows(width: int, polyorder: int, deriv: int) -> np.ndarray:
    """``(width, width)``: row i maps a window of ``width`` samples to the
    ``deriv``-th derivative, at its i-th sample, of the least-squares
    polynomial of degree ``polyorder`` through the window (sample spacing
    1). The middle row is the interior filter; the others are
    ``scipy.signal.savgol_filter``'s 'interp' edges."""
    x = np.arange(width, dtype=np.float64) - width // 2
    fit = np.linalg.pinv(np.vander(x, polyorder + 1, increasing=True))   # coefs from samples
    powers = np.arange(polyorder + 1)
    scale = np.array([math.perm(int(p), deriv) if p >= deriv else 0 for p in powers], float)
    at = np.where(powers >= deriv, x[:, None] ** np.maximum(powers - deriv, 0), 0.0) * scale
    return at @ fit


def delta(x: torch.Tensor, width: int, order: int, prec: Prec) -> torch.Tensor:
    """librosa ``delta(x, width, order)`` along the last axis: a
    Savitzky-Golay derivative of polynomial order ``order``, 'interp' edges."""
    rows = prec.cast(savgol_rows(width, order, order)).to(x.device)
    half, T = width // 2, x.shape[-1]
    lead = x.shape[:-1]
    win = x.reshape(-1, T).unfold(-1, width, 1)                          # (N, T-w+1, w)
    inner = prec.mm(win.reshape(-1, width), rows[half][:, None]).reshape(-1, T - width + 1)
    left = prec.mm(x.reshape(-1, T)[:, :width], rows[:half].T)
    right = prec.mm(x.reshape(-1, T)[:, T - width:], rows[width - half:].T)
    return torch.cat([left, inner, right], dim=-1).reshape(*lead, T)
