"""The plain reference against hand-worked cases and NumPy/SciPy."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from bench_port.reference import dsp, features

F64 = dsp.Prec("float64")
CFG = dict(n_fft=2048, hop_length=512, win_length=2048, window="hann", center=True,
           pad_mode="constant")


def test_float64_round_trip():
    y = torch.randn(3, 30000, dtype=torch.float64, generator=torch.Generator().manual_seed(5))
    out = dsp.istft(dsp.stft(y, CFG, F64), CFG, 30000, F64)
    assert float((out - y).abs().max()) <= 1e-12


def test_stft_against_numpy():
    y = torch.randn(2, 9000, dtype=torch.float64, generator=torch.Generator().manual_seed(6))
    S = dsp.stft(y, CFG, F64)
    yp = np.pad(y.numpy(), ((0, 0), (1024, 1024)))
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(2048) / 2048)
    for t in (0, 7, S.shape[-1] - 1):
        ref = np.fft.rfft(yp[:, t * 512:t * 512 + 2048] * w)
        assert np.abs(S[:, :, t].numpy() - ref).max() <= 1e-9


def test_slaney_filter_row_by_hand():
    """sr 8000, n_fft 16, 2 mels over 0-4000 Hz. Slaney's scale: linear
    (200/3 Hz a mel) to 15 mels at 1 kHz, then log with step ln(6.4)/27.
    4 kHz is 15 + ln 4 / step = 35.1636 mels, so the mel points lie at 0,
    11.7212, 23.4424 and 35.1636 mels: 0, 781.42, 1786.82 and 4000 Hz. The
    first filter rises over 0-781.42 Hz, falls over 781.42-1786.82 Hz and
    is scaled by 2 / (1786.82 - 0); the bins lie every 500 Hz."""
    step = math.log(6.4) / 27
    top = 15 + math.log(4.0) / step
    m1, m2 = top / 3, 2 * top / 3
    f1 = m1 * 200 / 3
    f2 = 1000 * math.exp(step * (m2 - 15))
    assert f1 == pytest.approx(781.42, abs=0.01) and f2 == pytest.approx(1786.82, abs=0.01)
    norm = 2 / f2
    expect = [0.0, 500 / f1 * norm, (f2 - 1000) / (f2 - f1) * norm,
              (f2 - 1500) / (f2 - f1) * norm, 0.0, 0.0, 0.0, 0.0, 0.0]
    row = dsp.mel_filterbank(8000, 16, 2, 0.0, 4000.0)[0]
    assert row == pytest.approx(expect, rel=1e-12, abs=1e-15)


def test_hann_is_periodic():
    w = dsp.hann(8)
    assert w == pytest.approx([0, 0.14644661, 0.5, 0.85355339, 1, 0.85355339, 0.5, 0.14644661])


def test_savgol_against_scipy():
    from scipy.signal import savgol_filter

    x = np.random.default_rng(0).standard_normal((3, 40))
    for order in (1, 2):
        got = dsp.delta(torch.from_numpy(x), 9, order, F64).numpy()
        ref = savgol_filter(x, 9, order, deriv=order, axis=-1, mode="interp")
        assert np.abs(got - ref).max() <= 1e-12


def test_dct_ortho_is_orthonormal():
    D = dsp.dct_ortho(128, 128)
    assert np.abs(D @ D.T - np.eye(128)).max() <= 1e-12


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-12, -3.0 - 2**-9, 1e-20], dtype=torch.float32)
    got = dsp.round_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2**-10, 1.0, -3.0 - 2**-9, got[4].item()]
    assert abs(got[4].item() - 1e-20) <= 1e-20 * 2**-11


def test_tf32_control_is_coarser_than_float32():
    y = torch.randn(2, 12000, generator=torch.Generator().manual_seed(7))
    exact = dsp.stft(y.double(), CFG, F64)
    ctrl = dsp.stft(y, CFG, dsp.Prec("tf32"))
    f32 = torch.stft(y, 2048, 512, window=torch.hann_window(2048), pad_mode="constant",
                     return_complex=True)
    scale = exact.abs().max()
    e_ctrl = float((ctrl.to(torch.complex128) - exact).abs().max() / scale)
    e_f32 = float((f32.to(torch.complex128) - exact).abs().max() / scale)
    assert e_ctrl > 30 * e_f32 and e_ctrl > 1e-4


def test_contrast_bands_gtzan():
    bands = features.contrast_bands(1025, 22050, 200.0, 6, 0.02)
    assert len(bands) == 7
    assert bands[0] == (0, 18, 1)  # bins 0-18 lie at or under 200 Hz; the top one drops
    assert bands[-1][1] == 1025
    for (a0, b0, _), (a1, _, _) in zip(bands, bands[1:]):
        assert a1 == b0 - 1 or a1 == b0 or a1 < b0
