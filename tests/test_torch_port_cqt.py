"""PyTorch port: the CQT / VQT family against the JAX package.

Both packages take one rectangular-window STFT at the bank's power-of-two
``n_fft`` and one complex product with the same float64 basis table. At
the defaults (fmin C1, 84 bins) ``n_fft`` is 16384 at hop 512, outside
the radix gate: neither package runs a kernel there. Contract
(`NUMERICAL_ACCURACY.md`: CQT / VQT family): ``|got - ref| <= 3e-5 +
2e-4 |ref|`` elementwise. The clips are short, and all but one case take a
higher ``fmin`` (a shorter ``n_fft``); one case runs the default size.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch_port_util import signals, to_np

import mlx_audio_primitives_tpu as jap
import mlx_audio_primitives_tpu_torch as tap
from mlx_audio_primitives_tpu_torch.ops import cqt as tap_cqt

torch.set_num_threads(1)

SR = 22050
Y = signals(90, (2, 2 * SR))


def assert_cqt_close(got, ref) -> None:
    g, r = to_np(got), to_np(ref)
    assert g.shape == r.shape and g.dtype == r.dtype
    assert np.all(np.abs(g - r) <= 3e-5 + 2e-4 * np.abs(r))


@pytest.mark.parametrize("name", ["cqt", "vqt", "pseudo_cqt"])
@pytest.mark.parametrize("kw", [
    dict(fmin=110.0, n_bins=48),
    dict(fmin=220.0, n_bins=60, bins_per_octave=24, filter_scale=0.8, tuning=0.2),
    dict(fmin=65.0, n_bins=36, hop_length=256, pad_mode="reflect"),
], ids=["a2", "a3-24", "c2-hop256"])
@pytest.mark.parametrize("batched", [True, False])
def test_cq_family_matches_jax(name, kw, batched):
    y = Y if batched else Y[1]
    got = getattr(tap, name)(y, sr=SR, **kw)
    ref = getattr(jap, name)(y, sr=SR, **kw)
    assert_cqt_close(got, ref)


@pytest.mark.parametrize("gamma", [0.0, 5.0, 40.0])
def test_vqt_gamma_matches_jax(gamma):
    kw = dict(fmin=98.0, n_bins=36, gamma=gamma)
    assert_cqt_close(tap.vqt(Y[0], sr=SR, **kw), jap.vqt(Y[0], sr=SR, **kw))


def test_cqt_default_size_matches_jax():
    # fmin C1, 84 bins, 12 an octave: n_fft 16384, hop 512
    y = signals(91, (SR,))
    got, ref = tap.cqt(y, sr=SR), jap.cqt(y, sr=SR)
    assert got.shape == (84, 1 + SR // 512)
    assert_cqt_close(got, ref)


def test_cqt_product_reads_the_spectrum_in_place(monkeypatch):
    """The basis product runs on the spectrum as stft returns it (its
    ``(B, F, n_freq)`` storage): no ``.real``/``.imag`` or contiguous copy
    of the spectrum is made before it."""
    seen = []
    real = torch.matmul

    def spy(a, b):
        seen.append((a.is_contiguous(), tuple(a.shape), a.dtype))
        return real(a, b)

    monkeypatch.setattr(tap_cqt.torch, "matmul", spy)
    C = tap.cqt(Y, sr=SR, fmin=110.0, n_bins=48)
    assert seen == [(True, (2, C.shape[-1], 4096 // 2 + 1), torch.complex64)]


def test_cqt_tone_amplitude():
    # a tone of amplitude A at a bin's center frequency gives |C| ~ A/2
    f = tap.cqt_frequencies(48, fmin=110.0)[20]
    y = 0.8 * tap.tone(f, sr=SR, duration=1.0)
    C = tap.cqt(y, sr=SR, fmin=110.0, n_bins=48).abs()
    mid = C[:, 10:-10].mean(dim=1)
    assert int(mid.argmax()) == 20 and abs(float(mid[20]) - 0.4) < 0.02


@pytest.mark.parametrize("args", [(84,), (84, 55.0, 24, 0.5), (12, 440.0, 36)])
def test_frequencies_and_lengths_equal(args):
    np.testing.assert_array_equal(tap.cqt_frequencies(*args), jap.cqt_frequencies(*args))
    fmin = args[1] if len(args) > 1 else 32.70319566257483
    for fs in (1.0, 0.5):
        assert tap.ops.cqt.cqt_filter_length(SR, fmin, 12, fs) == \
            jap.ops.cqt.cqt_filter_length(SR, fmin, 12, fs)


@pytest.mark.parametrize("call", [
    lambda m: m.cqt(Y[0], sr=SR, fmin=1000.0, n_bins=84),
    lambda m: m.vqt(Y[0], sr=SR, fmin=1000.0, n_bins=84),
    lambda m: m.vqt(Y[0], sr=SR, gamma=-1.0),
    lambda m: m.cqt(Y[0], sr=SR, hop_length=0),
    lambda m: m.pseudo_cqt(Y[0], sr=SR, filter_scale=0.0),
    lambda m: m.cqt_frequencies(0),
], ids=["cqt-nyquist", "vqt-nyquist", "gamma", "hop", "filter-scale", "n-bins"])
def test_cq_errors_match(call):
    with pytest.raises(ValueError) as jerr:
        np.asarray(call(jap))
    with pytest.raises(ValueError) as terr:
        call(tap)
    assert str(terr.value) == str(jerr.value)
