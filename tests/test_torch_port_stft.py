"""PyTorch port: ``stft`` / ``istft`` against the JAX package.

The JAX side runs with ``use_pallas=True`` (its Pallas kernels in interpret
mode on the CPU) and with ``use_pallas=False`` (its XLA path); the port runs
on the CPU, where ``use_pallas=True`` takes each kernel's plain twin.
Contracts (`NUMERICAL_ACCURACY.md`): STFT within 1e-5 of max |S|; ISTFT and
the round trip within 1e-5 absolute.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch
from torch_port_util import max_abs, max_rel, signals, to_np

import mlx_audio_primitives_tpu as jap
import mlx_audio_primitives_tpu_torch as tap

# by path: the JAX package's `ops` re-exports a function named `stft`
jax_stft = importlib.import_module("mlx_audio_primitives_tpu.ops.stft")
tap_stft = importlib.import_module("mlx_audio_primitives_tpu_torch.ops.stft")

torch.set_num_threads(1)

STFT_TOL = 1e-5  # relative to max |S|
ISTFT_TOL = 1e-5  # absolute


def _stft_both(y, use_pallas, **kw):
    ref = jap.stft(y, use_pallas=use_pallas, **kw)
    for up in (None, True):
        got = tap.stft(y, use_pallas=up, **kw)
        assert got.dtype == torch.complex64 and got.device.type == "cpu"
        assert max_rel(got, ref) <= STFT_TOL
    return ref


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("case", [
    dict(shape=(2, 8192), n_fft=1024, hop_length=256),
    dict(shape=(4096,), n_fft=512, hop_length=128),
    dict(shape=(2, 4096), n_fft=512, hop_length=128, pad_mode="reflect"),
    dict(shape=(2, 4096), n_fft=512, hop_length=128, pad_mode="edge"),
    dict(shape=(2, 4096), n_fft=512, hop_length=128, win_length=400, window="hamming"),
    # reflect pad longer than the clip: numpy-style repeated reflection
    dict(shape=(1000,), n_fft=2048, hop_length=512, pad_mode="reflect"),
], ids=["2d-1024", "1d-512", "reflect", "edge", "win_length", "reflect-short-clip"])
def test_stft_matches_jax(case, use_pallas):
    case = dict(case)
    y = signals(0, case.pop("shape"))
    _stft_both(y, use_pallas, **case)


def test_stft_array_window():
    y = signals(1, (2, 4096))
    win = np.hamming(512).astype(np.float32)
    _stft_both(y, True, n_fft=512, hop_length=128, window=win)


def test_stft_center_false():
    y = signals(2, (2, 4096))
    _stft_both(y, False, n_fft=512, hop_length=128, center=False)


@pytest.mark.parametrize("which", ["stft", "istft"])
def test_fft_mode_matmul(which):
    y = signals(3, (2, 4096))
    kw = dict(n_fft=512, hop_length=128, fft_mode="matmul")
    if which == "stft":
        assert max_rel(tap.stft(y, **kw), jap.stft(y, **kw)) <= STFT_TOL
    else:
        S = to_np(tap.stft(y, n_fft=512, hop_length=128))
        got = tap.istft(S, hop_length=128, length=4096, fft_mode="matmul")
        assert max_abs(got, jap.istft(S, hop_length=128, length=4096, fft_mode="matmul")) <= ISTFT_TOL
        assert max_abs(got, y) <= ISTFT_TOL


@pytest.mark.parametrize("kw", [
    dict(fft_mode="bogus"), dict(hop_length=0), dict(window="bogus"),
    dict(pad_mode="wrap"), dict(win_length=4096), dict(hop_length=1024),
], ids=["fft_mode", "hop0", "window", "pad_mode", "win_length", "hop_gt_nfft"])
def test_stft_errors_match(kw):
    y = signals(4, (2048,))
    args = dict(n_fft=512, **kw)
    with pytest.raises(ValueError) as jerr:
        jap.stft(y, **args)
    for up in (None, True, False):
        with pytest.raises(ValueError) as terr:
            tap.stft(y, use_pallas=up, **args)
        assert str(terr.value) == str(jerr.value)


def test_istft_bad_fft_mode_raises_everywhere():
    S = to_np(tap.stft(signals(5, (2048,)), n_fft=512))
    for up in (None, True, False):
        with pytest.raises(ValueError, match="fft_mode"):
            tap.istft(S, fft_mode="bogus", use_pallas=up)


@pytest.fixture(scope="module")
def spectrum_1024():
    y = signals(6, (2, 8192))
    return y, to_np(tap.stft(y, n_fft=1024, hop_length=256))


def test_istft_radix_tier_matches_jax(spectrum_1024):
    # hop 256: the JAX fused ISTFT kernel; the port's K3 twin
    y, S = spectrum_1024
    ref = jap.istft(S, hop_length=256, length=8192, use_pallas=True)
    for up in (None, True, False):
        got = tap.istft(S, hop_length=256, length=8192, use_pallas=up)
        assert max_abs(got, ref) <= ISTFT_TOL
        assert max_abs(got, y) <= ISTFT_TOL  # round trip


@pytest.mark.parametrize("n_fft,hop", [(256, 128), (4096, 512)])
def test_istft_radix_tier_other_shapes_match_jax(n_fft, hop):
    # two more shapes of the radix gate (C = 2 and C = 8), a batch of 3
    y = signals(16, (3, 6 * n_fft + 77))
    S = to_np(tap.stft(y, n_fft=n_fft, hop_length=hop))
    ref = jap.istft(S, hop_length=hop, length=y.shape[1], use_pallas=True)
    for up in (None, True, False):
        got = tap.istft(S, hop_length=hop, length=y.shape[1], use_pallas=up)
        assert max_abs(got, ref) <= ISTFT_TOL
        assert max_abs(got, y) <= ISTFT_TOL  # round trip


def test_istft_ola_tier_matches_jax():
    # hop 441 is outside the radix gate: XLA/torch inverse + the OLA kernel
    y = signals(7, (2, 8192))
    S = to_np(tap.stft(y, n_fft=1024, hop_length=441))
    ref = jap.istft(S, hop_length=441, length=8192, use_pallas=True)
    for up in (None, True, False):
        got = tap.istft(S, hop_length=441, length=8192, use_pallas=up)
        assert max_abs(got, ref) <= ISTFT_TOL
        assert max_abs(got, y) <= ISTFT_TOL


def _well_conditioned(n_frames, length, center, n_fft=1024, hop=256):
    """Output samples whose squared-window envelope is >= 1e-3. Elsewhere
    (window edges, a pad past the last frame) both packages divide rounding
    noise by the 1e-8 envelope clamp, which no tolerance bounds."""
    from mlx_audio_primitives_tpu_torch.ops.stft import _istft_envelope_table

    if length is not None:
        T = length + n_fft if center else length
    else:
        T = n_fft + (n_frames - 1) * hop
    env = _istft_envelope_table.host(("hann", None), n_fft, n_fft, n_frames, hop, T)
    if center:
        pad = n_fft // 2
        env = env[pad : pad + length] if length is not None else env[pad : T - pad]
    elif length is not None:
        env = np.pad(env[:length], (0, max(0, length - T)))
    return env >= 1e-3


@pytest.mark.parametrize("length", [None, 0, 5000, 8192, 9000], ids=str)
@pytest.mark.parametrize("center", [True, False])
def test_istft_length_crop_and_pad(spectrum_1024, length, center):
    _, S = spectrum_1024
    ref = to_np(jap.istft(S, hop_length=256, length=length, center=center, use_pallas=False))
    keep = _well_conditioned(S.shape[-1], length, center)
    assert keep.shape == ref.shape[-1:]
    for up in (None, True):
        got = tap.istft(S, hop_length=256, length=length, center=center, use_pallas=up)
        assert got.shape == ref.shape
        if ref.size:
            assert max_abs(to_np(got)[:, keep], ref[:, keep]) <= ISTFT_TOL


def test_istft_ignores_dc_and_nyquist_imaginary(spectrum_1024):
    # irfft semantics: the imaginary parts of DC and Nyquist are dropped
    y, S = spectrum_1024
    S2 = S.copy()
    S2[:, 0, :] += 0.5j
    S2[:, -1, :] -= 0.25j
    ref = jap.istft(S2, hop_length=256, length=8192, use_pallas=True)
    assert max_abs(ref, jap.istft(S2, hop_length=256, length=8192, use_pallas=False)) <= ISTFT_TOL
    for up in (None, True):
        got = tap.istft(S2, hop_length=256, length=8192, use_pallas=up)
        assert max_abs(got, ref) <= ISTFT_TOL
        assert max_abs(got, y) <= ISTFT_TOL


def test_istft_2d_input_and_array_window():
    y = signals(8, (4096,))
    win = np.hanning(514)[1:-1].astype(np.float32)  # any array window
    S = to_np(tap.stft(y, n_fft=512, hop_length=128, window=win))
    got = tap.istft(S, hop_length=128, window=win, length=4096)
    ref = jap.istft(S, hop_length=128, window=win, length=4096, use_pallas=False)
    assert got.shape == (4096,) and max_abs(got, ref) <= ISTFT_TOL


def test_helpers_match_jax():
    S = to_np(tap.stft(signals(9, (2, 2048)), n_fft=512, hop_length=128))
    assert max_rel(tap.magnitude(S), jap.magnitude(S)) <= 1e-6
    assert max_abs(tap.phase(S), jap.phase(S)) <= 1e-5
    for power in (1.0, 2.0):
        m, p = tap.magphase(S, power=power)
        jm, jp = jap.magphase(S, power=power)
        assert max_rel(m, jm) <= 1e-6 and max_abs(p, jp) <= 1e-6
    for win, hop in (("hann", 128), ("hann", 512), ("rectangular", 300), ("hann", 600)):
        assert tap.check_nola(win, hop, 512) == jap.check_nola(win, hop, 512)
    for args in ((20, 128, 512, True), (20, 128, 512, False), (1, 441, 2048, True)):
        assert tap_stft.reconstruction_length(*args) == jax_stft.reconstruction_length(*args)
    assert tap_stft.num_frames(8192, 1024, 256) == jax_stft.num_frames(8192, 1024, 256)
