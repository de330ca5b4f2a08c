"""PyTorch port: the bark and linear filterbanks and the Bark conversions.

The port builds its tables with the JAX package's NumPy algorithm; the JAX
package tries its native builder first. Either way the float32 tables are
held bit-equal here (so +0.0 and -0.0 count as different), and the host
float64 conversions equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch_port_util import same_bits

import mlx_audio_primitives_tpu as jap
import mlx_audio_primitives_tpu_torch as tap

torch.set_num_threads(1)

FORMULAS = ["zwicker", "traunmuller"]


@pytest.mark.parametrize("norm", ["slaney", None])
@pytest.mark.parametrize("formula", FORMULAS)
@pytest.mark.parametrize("sr,n_fft,n_bands,fmin,fmax", [
    (22050, 2048, 24, 0.0, None),
    (16000, 512, 18, 50.0, 7000.0),
    (44100, 1024, 32, 20.0, 20000.0),
])
def test_bark_table_bit_equal(sr, n_fft, n_bands, fmin, fmax, formula, norm):
    kw = dict(n_bands=n_bands, fmin=fmin, fmax=fmax, formula=formula, norm=norm)
    ref = np.asarray(jap.bark_filterbank(sr, n_fft, **kw))
    got = tap.bark_filterbank(sr, n_fft, **kw)
    assert got.device.type == "cpu" and got.shape == (n_bands, n_fft // 2 + 1)
    assert same_bits(got, ref)


@pytest.mark.parametrize("norm", ["slaney", None])
@pytest.mark.parametrize("sr,n_fft,n_bands,fmin,fmax", [
    (22050, 2048, 64, 0.0, None),
    (16000, 512, 40, 100.0, 6000.0),
    (44100, 4096, 128, 30.0, 22050.0),
])
def test_linear_table_bit_equal(sr, n_fft, n_bands, fmin, fmax, norm):
    kw = dict(n_bands=n_bands, fmin=fmin, fmax=fmax, norm=norm)
    ref = np.asarray(jap.linear_filterbank(sr, n_fft, **kw))
    got = tap.linear_filterbank(sr, n_fft, **kw)
    assert got.shape == ref.shape and same_bits(got, ref)


@pytest.mark.parametrize("formula", FORMULAS)
def test_bark_conversions_equal(formula):
    hz = np.array([0.0, 20.0, 100.0, 440.0, 1000.0, 4000.0, 11025.0, 20000.0])
    bark = np.asarray(jap.hz_to_bark(hz, formula=formula))
    assert np.array_equal(tap.hz_to_bark(hz, formula=formula), bark)
    assert np.array_equal(tap.bark_to_hz(bark, formula=formula),
                          np.asarray(jap.bark_to_hz(bark, formula=formula)))
    np.testing.assert_allclose(tap.bark_to_hz(bark, formula=formula), hz, atol=1e-6)


def test_table_on_a_device_and_cached():
    a = tap.bark_filterbank(22050, 1024, device="cpu")
    b = tap.bark_filterbank(22050, 1024, device=torch.device("cpu"))
    assert a is b and a.dtype == torch.float32


@pytest.mark.parametrize("call,match", [
    (lambda m: m.bark_filterbank(22050, 1024, formula="mel"), "formula"),
    (lambda m: m.bark_filterbank(22050, 1024, n_bands=0), "n_bands"),
    (lambda m: m.linear_filterbank(22050, 1024, fmin=5000.0, fmax=4000.0), "fmin"),
    (lambda m: m.linear_filterbank(22050, 1024, fmax=20000.0), "Nyquist"),
    (lambda m: m.linear_filterbank(22050, 1024, norm="l2"), "norm"),
    (lambda m: m.hz_to_bark(100.0, formula="x"), "formula"),
    (lambda m: m.bark_to_hz(1.0, formula="x"), "formula"),
], ids=["formula", "n_bands", "fmin", "nyquist", "norm", "hz_to_bark", "bark_to_hz"])
def test_errors_match_jax(call, match):
    with pytest.raises(ValueError, match=match) as ref:
        call(jap)
    with pytest.raises(ValueError, match=match) as got:
        call(tap)
    assert str(got.value) == str(ref.value)
