"""PyTorch port: PCEN against the JAX package and a float64 scipy oracle.

The port's smoother is a blocked scan: a lower-triangular product inside
blocks of 32 frames, the block-end states scanned the same way. Contract
(`NUMERICAL_ACCURACY.md`: PCEN): ``|got - ref| <= 3e-5 + 2e-4 |ref|``
elementwise, against the JAX package and against the oracle (scipy's
``lfilter`` with ``lfilter_zi``, NumPy's compression law, float64),
including 3,000 frames, past the ~2,600 of a 60 s clip at hop 512 where
the closed form ``(1-b)^t`` underflows float32. Chunks chained through
``zi``/``zf`` equal the whole within 1e-6 of max.
"""

from __future__ import annotations

import numpy as np
import pytest
import scipy.ndimage
import scipy.signal
import torch
from torch_port_util import max_rel, signals, to_np

import mlx_audio_primitives_tpu as jap
import mlx_audio_primitives_tpu_torch as tap
from mlx_audio_primitives_tpu.ops.pcen import pcen_smoother as jax_smoother
from mlx_audio_primitives_tpu_torch.ops.pcen import pcen_smoother

torch.set_num_threads(1)

SR = 22050
HOP = 512


def assert_pcen_close(got, ref) -> None:
    g, r = to_np(got).astype(np.float64), to_np(ref).astype(np.float64)
    assert g.shape == r.shape
    assert np.all(np.abs(g - r) <= 3e-5 + 2e-4 * np.abs(r))


def _b(time_constant=0.4, sr=SR, hop_length=HOP):
    t = time_constant * sr / float(hop_length)
    return (np.sqrt(1 + 4 * t * t) - 1) / (2 * t * t)


def oracle(S, gain=0.98, bias=2.0, power=0.5, eps=1e-6, b=None, max_size=1, zi=None):
    """PCEN in float64 from scipy's pieces (librosa's definition)."""
    S = np.asarray(S, dtype=np.float64)
    b = _b() if b is None else b
    ref = S
    if max_size > 1:
        ref = scipy.ndimage.maximum_filter1d(S, max_size, axis=-2, mode="nearest")
    if zi is None:
        zi_full = scipy.signal.lfilter_zi([b], [1, b - 1])[..., 0] * ref[..., 0:1]
    else:
        zi_full = np.asarray(zi, np.float64)[..., None]
    M, zf = scipy.signal.lfilter([b], [1, b - 1], ref, axis=-1, zi=zi_full)
    smooth = (eps + M) ** (-gain)
    if power == 0:
        out = np.log1p(S * smooth)
    elif bias == 0:
        out = np.exp(power * (np.log(S) + np.log(smooth)))
    else:
        out = (bias**power) * np.expm1(power * np.log1p(S * smooth / bias))
    return out, zf[..., 0]


MEL = np.asarray(jap.melspectrogram(signals(120, (2, 3 * SR)), sr=SR, n_mels=40))
LONG = np.abs(signals(121, (6, 3000))) ** 2 * np.linspace(0.01, 3.0, 3000, dtype=np.float32)

VARIANTS = [
    {}, dict(gain=0.6, bias=10.0, power=0.25), dict(power=0.0), dict(bias=0.0, power=0.5),
    dict(b=0.3), dict(b=1.0), dict(max_size=3), dict(max_size=4, time_constant=0.1),
    dict(hop_length=256, sr=16000, eps=1e-3),
]
IDS = ["default", "agc", "log", "nobias", "b0.3", "b1", "max3", "max4-fast", "16k"]


@pytest.mark.parametrize("kw", VARIANTS, ids=IDS)
@pytest.mark.parametrize("batched", [True, False])
def test_pcen_matches_jax(kw, batched):
    S = MEL if batched else MEL[0]
    assert_pcen_close(tap.pcen(S, **kw), jap.pcen(S, **kw))


@pytest.mark.parametrize("kw", [{}, dict(power=0.0), dict(max_size=4), dict(b=0.9)],
                         ids=["default", "log", "max4", "b0.9"])
def test_pcen_long_against_lfilter(kw):
    # 3,000 frames: (1 - b)^t of the closed form is ~1e-33 at 1,292 frames
    # and 0.0 in float32 well before 3,000
    assert np.float32((1.0 - _b()) ** 3000) == 0.0
    ref, _ = oracle(LONG, **kw)
    assert_pcen_close(tap.pcen(LONG, **kw), ref)


def test_pcen_chained_halves_equal_whole():
    whole, zf = tap.pcen(LONG, return_zf=True)
    a, za = tap.pcen(LONG[:, :1700], return_zf=True)
    b, zb = tap.pcen(LONG[:, 1700:], zi=za, return_zf=True)
    assert max_rel(torch.cat([a, b], dim=-1), whole) <= 1e-6
    assert max_rel(zb, zf) <= 1e-6
    # the chain's state is scipy's
    ref, ref_zf = oracle(LONG)
    assert_pcen_close(zf, ref_zf)
    _, jzf = jap.pcen(LONG, return_zf=True)
    assert_pcen_close(zf, jzf)


def test_pcen_explicit_zi_matches_jax_and_oracle():
    zi = np.linspace(0.0, 0.5, MEL.shape[1], dtype=np.float32)
    got, gzf = tap.pcen(MEL[0], zi=zi, return_zf=True)
    ref, rzf = jap.pcen(MEL[0], zi=zi, return_zf=True)
    assert_pcen_close(got, ref)
    assert_pcen_close(gzf, rzf)
    assert_pcen_close(got, oracle(MEL[0], zi=zi)[0])


@pytest.mark.parametrize("b_shape", ["scalar", "per-channel"])
@pytest.mark.parametrize("with_zi", [False, True])
def test_smoother_matches_jax_and_lfilter(b_shape, with_zi):
    ref = LONG[:4, :2600]
    b = np.float32(0.05) if b_shape == "scalar" else np.linspace(0.01, 0.9, 4, dtype=np.float32)
    zi = np.full(4, 0.25, np.float32) if with_zi else None
    got = pcen_smoother(torch.from_numpy(ref), b, zi=zi)
    assert_pcen_close(got, jax_smoother(ref, b, zi=zi))
    bb = np.broadcast_to(np.asarray(b, np.float64), (4,))
    for c in range(4):
        z = [0.25] if with_zi else scipy.signal.lfilter_zi([bb[c]], [1, bb[c] - 1]) * ref[c, 0]
        M, _ = scipy.signal.lfilter([bb[c]], [1, bb[c] - 1], ref[c].astype(np.float64), zi=z)
        assert_pcen_close(got[c], M)


def test_smoother_is_differentiable():
    ref = torch.from_numpy(LONG[:3, :200]).requires_grad_(True)
    b = torch.tensor([0.1, 0.2, 0.3], requires_grad=True)
    pcen_smoother(ref, b).sum().backward()
    assert torch.isfinite(ref.grad).all() and torch.isfinite(b.grad).all()
    assert float(b.grad.abs().min()) > 0.0


@pytest.mark.parametrize("kw", [dict(gain=-1.0), dict(bias=-1.0), dict(power=-0.5),
                                dict(eps=0.0), dict(max_size=0), dict(b=1.5),
                                dict(max_size=100), dict(hop_length=0)],
                         ids=["gain", "bias", "power", "eps", "max0", "b", "max-big", "hop"])
def test_pcen_errors_match(kw):
    with pytest.raises(ValueError) as jerr:
        jap.pcen(MEL, **kw)
    with pytest.raises(ValueError) as terr:
        tap.pcen(MEL, **kw)
    assert str(terr.value) == str(jerr.value)


def test_pcen_rejects_1d_as_jax_does():
    with pytest.raises(ValueError) as jerr:
        jap.pcen(MEL[0, 0])
    with pytest.raises(ValueError) as terr:
        tap.pcen(MEL[0, 0])
    assert str(terr.value) == str(jerr.value)
