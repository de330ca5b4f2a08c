"""PyTorch port: MFCC, DCT, deltas and the time-domain primitives against the
JAX package.

The same NumPy inputs go through both packages; the JAX side runs its fused
mel kernel in interpret mode where it has one (``has_pallas_tpu`` patched)
and its XLA path otherwise. Contracts: MFCC and deltas within 1e-4 of max
(`NUMERICAL_ACCURACY.md`), the DCT basis bit-equal to the JAX package's
NumPy builder, the time-domain ops within 1e-5 absolute on unit-variance
signals (de-emphasis, an IIR filter, included).
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch
from torch_port_util import max_abs, max_rel, same_bits, signals, to_np

import mlx_audio_primitives_tpu as jap
import mlx_audio_primitives_tpu_torch as tap
from mlx_audio_primitives_tpu.utils import dispatch as jax_dispatch

jax_mfcc = importlib.import_module("mlx_audio_primitives_tpu.ops.mfcc")
tap_mfcc = importlib.import_module("mlx_audio_primitives_tpu_torch.ops.mfcc")

torch.set_num_threads(1)

FEAT_TOL = 1e-4  # relative to max
TIME_TOL = 1e-5  # absolute
KW = dict(n_fft=1024, hop_length=256, n_mels=32)


@pytest.fixture(scope="module")
def clips():
    return signals(70, (2, 16384))


@pytest.mark.parametrize("lifter", [0, 22])
@pytest.mark.parametrize("norm", ["ortho", None])
@pytest.mark.parametrize("jax_route", ["kernels", "xla"])
def test_mfcc_matches_jax(clips, jax_route, norm, lifter):
    with pytest.MonkeyPatch.context() as mp:
        if jax_route == "kernels":
            mp.setattr(jax_dispatch, "has_pallas_tpu", lambda: True)
        ref = to_np(jap.mfcc(clips, n_mfcc=13, norm=norm, lifter=lifter, **KW))
    for y in (clips, torch.from_numpy(clips)):
        got = tap.mfcc(y, n_mfcc=13, norm=norm, lifter=lifter, **KW)
        assert got.shape == ref.shape == (2, 13, 65)
        assert max_rel(got, ref) <= FEAT_TOL
    one = tap.mfcc(clips[0], n_mfcc=13, norm=norm, lifter=lifter, **KW)
    assert one.shape == (13, 65)


def test_mfcc_from_log_mel_s_matches_jax(clips):
    S = np.asarray(jap.power_to_db(jap.melspectrogram(clips, **KW)))
    for lifter in (0, 22):
        ref = jap.mfcc(S=S, n_mfcc=20, lifter=lifter)
        assert max_rel(tap.mfcc(S=S, n_mfcc=20, lifter=lifter), ref) <= FEAT_TOL
        assert max_rel(tap.mfcc(S=S[0], n_mfcc=20, lifter=lifter), ref[0]) <= FEAT_TOL


@pytest.mark.parametrize("norm", ["ortho", None])
@pytest.mark.parametrize("n_out,n_in", [(13, 32), (20, 128), (40, 40), (1, 7)])
def test_dct_basis_is_bit_equal_to_the_jax_numpy_builder(n_out, n_in, norm, monkeypatch):
    import mlx_audio_primitives_tpu._native as native

    # the JAX builder's NumPy fallback (its native C++ builder switched off)
    monkeypatch.setattr(native, "native_dct_basis_t", lambda *a: None)
    ref = jax_mfcc._dct_basis_t._host_builder.__wrapped__(n_out, n_in, norm)
    host = tap_mfcc._dct_basis_t.host(n_out, n_in, norm)
    assert host.dtype == np.float64 and np.array_equal(host.view(np.uint64), ref.view(np.uint64))
    assert same_bits(tap_mfcc._dct_basis_t(n_out, n_in, norm), ref.astype(np.float32))


@pytest.mark.parametrize("axis", [-1, 0, 1])
def test_dct_matches_jax(axis):
    x = signals(71, (6, 32, 10))
    for n in (None, 5):
        ref = jap.dct(x, n=n, axis=axis)
        assert max_rel(tap.dct(x, n=n, axis=axis), ref) <= 1e-5
    for bad in (dict(type=3), dict(norm="forward")):
        with pytest.raises(ValueError) as jerr:
            jap.dct(x, **bad)
        with pytest.raises(ValueError) as terr:
            tap.dct(x, **bad)
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("lifter", [0, 1, 22])
def test_lifter_coeffs_match_jax(lifter):
    assert same_bits(tap_mfcc.lifter_coeffs(20, lifter), jax_mfcc.lifter_coeffs(20, lifter))


@pytest.mark.parametrize("mode", ["interp", "nearest", "mirror", "constant", "wrap"])
@pytest.mark.parametrize("order", [1, 2])
def test_delta_matches_jax(order, mode):
    m = np.asarray(jap.mfcc(signals(72, (2, 16384)), **KW))
    ref = jap.delta(m, order=order, mode=mode)
    if mode != "interp":  # fewer frames than the half width: NumPy padding semantics
        short = m[..., :3]
        assert max_rel(tap.delta(short, order=order, mode=mode),
                       jap.delta(short, order=order, mode=mode)) <= FEAT_TOL
    got = tap.delta(m, order=order, mode=mode)
    assert got.shape == ref.shape and max_rel(got, ref) <= FEAT_TOL
    for kw in (dict(width=5, axis=1), dict(width=7, axis=-2)):
        assert max_rel(tap.delta(m, order=order, mode=mode, **kw),
                       jap.delta(m, order=order, mode=mode, **kw)) <= FEAT_TOL
    assert max_rel(tap.delta(m[0, 0], order=order, mode=mode),
                   jap.delta(m[0, 0], order=order, mode=mode)) <= FEAT_TOL


def test_savgol_tables_match_jax():
    for args in ((9, 1, 1, 1.0), (9, 2, 2, 1.0), (5, 3, 1, 0.5)):
        assert same_bits(tap_mfcc._savgol_tables(*args), jax_mfcc._savgol_tables(*args))


@pytest.mark.parametrize("kw", [
    dict(width=4), dict(width=1), dict(order=0), dict(order=3, polyorder=2),
    dict(width=9, polyorder=9),
    dict(mode="bogus"), dict(width=99),
], ids=lambda v: str(v))
def test_delta_errors_match(kw):
    m = signals(73, (4, 40))
    with pytest.raises(ValueError) as jerr:
        jap.delta(m, **kw)
    with pytest.raises(ValueError) as terr:
        tap.delta(m, **kw)
    assert str(terr.value) == str(jerr.value)


# --- framing ------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 5000), (5000,)], ids=["2d", "1d"])
def test_frame_matches_jax(shape):
    y = signals(74, shape)
    for fl, hop in ((512, 128), (400, 160), (5000, 1)):
        ref = np.asarray(jap.frame(y, fl, hop))
        got = to_np(tap.frame(y, fl, hop))
        assert np.array_equal(got, ref)


@pytest.mark.parametrize("kw", [dict(), dict(pad_mode="edge"), dict(center=False),
                                dict(frame_length=1024, hop_length=256)],
                         ids=["constant", "edge", "no-center", "1024"])
@pytest.mark.parametrize("shape", [(2, 8192), (8192,)], ids=["2d", "1d"])
def test_rms_matches_jax(shape, kw):
    y = signals(75, shape)
    ref = jap.rms(y, **kw)
    got = tap.rms(y, **kw)
    assert got.shape == ref.shape and max_abs(got, ref) <= TIME_TOL


@pytest.mark.parametrize("coef", [0.97, 0.5, 0.0, 1.0])
@pytest.mark.parametrize("zi", [None, 0.3, "per-row"])
def test_preemphasis_matches_jax(coef, zi):
    y = signals(76, (3, 4000))
    z = np.array([0.1, -0.2, 0.3], np.float32) if zi == "per-row" else zi
    for data in (y, y[0]):
        zz = z[0] if (zi == "per-row" and data.ndim == 1) else z
        out, zf = tap.preemphasis(data, coef=coef, zi=zz, return_zf=True)
        rout, rzf = jap.preemphasis(data, coef=coef, zi=zz, return_zf=True)
        assert max_abs(out, rout) <= TIME_TOL and max_abs(zf, rzf) <= TIME_TOL


@pytest.mark.parametrize("length", [1000, 4096, 70000], ids=str)  # 70000: two levels of blocks
@pytest.mark.parametrize("coef", [0.97, 0.5, 0.0])
@pytest.mark.parametrize("zi", [None, 0.25, "per-row"])
def test_deemphasis_matches_jax(length, coef, zi):
    y = signals(77, (2, length))
    z = np.array([0.1, -0.2], np.float32) if zi == "per-row" else zi
    out, zf = tap.deemphasis(y, coef=coef, zi=z, return_zf=True)
    rout, rzf = jap.deemphasis(y, coef=coef, zi=z, return_zf=True)
    assert out.shape == rout.shape
    assert max_abs(out, rout) <= TIME_TOL and max_abs(zf, rzf) <= TIME_TOL
    one = tap.deemphasis(y[0], coef=coef, zi=None if zi == "per-row" else z)
    assert one.shape == (length,)


def test_deemphasis_inverts_preemphasis_and_streams():
    y = signals(78, (2, 6000))
    rec = tap.deemphasis(tap.preemphasis(y))
    assert max_abs(rec, y) <= TIME_TOL
    # chunked: each chunk's final state starts the next
    a, zf = tap.deemphasis(y[:, :2500], zi=0.0, return_zf=True)
    b = tap.deemphasis(y[:, 2500:], zi=to_np(zf)[:, 0])
    whole = tap.deemphasis(y, zi=0.0)
    assert max_abs(torch.cat([a, b], dim=-1), whole) <= TIME_TOL


def test_framing_errors_match():
    y = signals(79, (2048,))
    for fn, kw in (("frame", dict(frame_length=0, hop_length=1)),
                   ("frame", dict(frame_length=4, hop_length=2, axis=0)),
                   ("rms", dict(hop_length=0)), ("rms", dict(pad_mode="reflect")),
                   ("preemphasis", dict(coef=1.5)), ("deemphasis", dict(coef=-0.1))):
        with pytest.raises(ValueError) as jerr:
            getattr(jap, fn)(y, **kw)
        with pytest.raises(ValueError) as terr:
            getattr(tap, fn)(y, **kw)
        assert str(terr.value) == str(jerr.value)
