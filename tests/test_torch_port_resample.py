"""PyTorch port: resampling against the JAX package and scipy.

The same seeded NumPy input goes through the JAX package, the port (CPU
tensors) and scipy in float64. Contract (`NUMERICAL_ACCURACY.md`): the FFT
and polyphase paths within 2e-4 absolute, the kaiser designs within 2e-5,
on unit-scale signals. The polyphase product is one FP32 GEMM in both
packages.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import scipy.signal
import torch
from torch_port_util import max_abs, signals, to_np

import mlx_audio_primitives_tpu as jap
import mlx_audio_primitives_tpu_torch as tap
from mlx_audio_primitives_tpu_torch.ops.resample import _FIR_DESIGNS, _fir_half_len

torch.set_num_threads(1)

TOL = {"fft": 2e-4, "linear": 2e-4, "polyphase": 2e-4, "kaiser_best": 2e-5, "kaiser_fast": 2e-5}
RATES = [(22050, 16000), (44100, 16000), (16000, 22050), (44100, 22050)]


@pytest.mark.parametrize("res_type", list(TOL))
@pytest.mark.parametrize("orig,target", RATES)
def test_resample_matches_jax(orig, target, res_type):
    y = signals(60, (2, 6000))
    ref = to_np(jap.resample(y, orig, target, res_type=res_type))
    got = tap.resample(y, orig, target, res_type=res_type)
    assert got.device.type == "cpu" and got.shape == ref.shape
    assert max_abs(got, ref) <= TOL[res_type]


@pytest.mark.parametrize("design", ["kaiser_best", "kaiser_fast", "scipy"])
@pytest.mark.parametrize("orig,target", [(44100, 16000), (22050, 16000)])
def test_polyphase_matches_scipy_with_the_same_fir(orig, target, design):
    y = signals(61, (4410,))
    res_type = "polyphase" if design == "scipy" else design
    got = to_np(tap.resample(y, orig, target, res_type=res_type))
    g = math.gcd(orig, target)
    up, down = target // g, orig // g
    _, rolloff, beta = _FIR_DESIGNS[design]
    h = scipy.signal.firwin(2 * _fir_half_len(up, down, design) + 1, rolloff / max(up, down),
                            window=("kaiser", beta))
    ref = scipy.signal.resample_poly(y.astype(np.float64), up, down, window=h)[: got.shape[0]]
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= (2e-4 if design == "scipy" else 2e-5)


@pytest.mark.parametrize("orig,target", [(44100, 22050), (22050, 44100), (44100, 16000)])
def test_fft_matches_scipy(orig, target):
    y = signals(62, (8000,))
    got = to_np(tap.resample(y, orig, target))
    ref = scipy.signal.resample(y.astype(np.float64), int(round(len(y) * target / orig)))
    assert got.shape == ref.shape and np.abs(got - ref).max() <= 2e-4


PADTYPES = ["constant", "edge", "wrap", "symmetric", "reflect", "smooth", "antisymmetric",
            "antireflect", "line", "mean", "median", "maximum", "minimum"]


@pytest.mark.parametrize("padtype", PADTYPES)
@pytest.mark.parametrize("up,down", [(3, 2), (2, 5)])
def test_resample_poly_padtypes(padtype, up, down):
    # an offset and a ramp, so every extension mode changes the edges
    y = signals(63, (2, 1501)) + np.linspace(2.0, -1.0, 1501, dtype=np.float32)
    ref = to_np(jap.resample_poly(y, up, down, padtype=padtype))
    got = tap.resample_poly(y, up, down, padtype=padtype)
    assert got.shape == ref.shape and max_abs(got, ref) <= 2e-4
    sp = scipy.signal.resample_poly(y.astype(np.float64), up, down, axis=-1, padtype=padtype)
    assert np.abs(to_np(got) - sp).max() <= 2e-4


def test_resample_poly_cval_and_one_sample():
    y = signals(64, (1001,))
    ref = to_np(jap.resample_poly(y, 4, 3, cval=0.5))
    assert max_abs(tap.resample_poly(y, 4, 3, cval=0.5), ref) <= 2e-4
    for padtype in PADTYPES:
        if padtype.startswith("anti"):
            continue
        one = np.array([0.7], np.float32)
        assert max_abs(tap.resample_poly(one, 3, 2, padtype=padtype),
                       jap.resample_poly(one, 3, 2, padtype=padtype)) <= 2e-4


@pytest.mark.parametrize("kw", [dict(fix=False), dict(scale=True), dict(axis=0)],
                         ids=["ceil", "scale", "axis0"])
def test_fix_scale_axis(kw):
    y = signals(65, (3001, 2)) if kw.get("axis") == 0 else signals(65, (2, 3001))
    for res_type in ("fft", "kaiser_fast"):
        ref = to_np(jap.resample(y, 44100, 16000, res_type=res_type, **kw))
        got = tap.resample(y, 44100, 16000, res_type=res_type, **kw)
        assert got.shape == ref.shape and max_abs(got, ref) <= TOL[res_type]


def test_identity_and_errors():
    y = signals(66, (500,))
    assert np.array_equal(to_np(tap.resample(y, 16000, 16000)), y)
    assert np.array_equal(to_np(tap.resample_poly(y, 3, 3)), y)
    for call in (lambda m: m.resample(y, 22050, 16000, res_type="soxr_hq"),
                 lambda m: m.resample(y, 22050.5, 16000, res_type="kaiser_best"),
                 lambda m: m.resample(y, 0, 16000),
                 lambda m: m.resample_poly(y, 3, 2, padtype="nope"),
                 lambda m: m.resample_poly(y, 3, 2, padtype="edge", cval=1.0),
                 lambda m: m.resample_poly(y[:10], 3, 2, padtype="antisymmetric")):
        with pytest.raises(ValueError) as ref:
            call(jap)
        with pytest.raises(ValueError) as got:
            call(tap)
        assert str(got.value) == str(ref.value)
