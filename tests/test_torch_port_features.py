"""PyTorch port: spectral features against the JAX package.

The same NumPy inputs go through both packages. The JAX side runs either
its kernel paths (``has_pallas_tpu`` patched to True, so its Pallas kernels
run in interpret mode on the CPU: the fused moments, the magnitude STFT and
the extreme-selection kernel) or its XLA paths. The port runs on CPU
tensors either as it routes there (plain compositions) or with its kernel
routes forced on (``resolve_use_pallas`` patched), where each kernel
wrapper runs its plain twin. Contract: every feature within 1e-4 of its
maximum (`NUMERICAL_ACCURACY.md:19`), with the rules stated below for
rolloff, flatness on a tone and the zero-crossing rate.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch
from torch_port_util import max_rel, same_bits, signals, to_np

import mlx_audio_primitives_tpu as jap
import mlx_audio_primitives_tpu_torch as tap
from mlx_audio_primitives_tpu.utils import dispatch as jax_dispatch
from mlx_audio_primitives_tpu_torch.utils import dispatch as tap_dispatch

jax_features = importlib.import_module("mlx_audio_primitives_tpu.ops.features")
tap_features = importlib.import_module("mlx_audio_primitives_tpu_torch.ops.features")

torch.set_num_threads(1)

FEAT_TOL = 1e-4  # relative to max
SR = 22050
KW = dict(n_fft=1024, hop_length=256)
KW_2048 = dict(n_fft=2048, hop_length=512)


def _port_kernel_routes(mp: pytest.MonkeyPatch) -> None:
    """Take every kernel route on the CPU (the wrappers run their twins)."""
    mp.setattr(tap_dispatch, "resolve_use_pallas", lambda flag, device: flag is not False)


@pytest.fixture(params=["plain", "kernels"])
def port_route(request, monkeypatch):
    if request.param == "kernels":
        _port_kernel_routes(monkeypatch)
    return request.param


_INPUTS = {
    "y-2d": lambda: dict(y=signals(50, (2, 16384))),  # 65 frames
    "y-1d": lambda: dict(y=signals(51, (8192,))),  # 33 frames
    "S": lambda: dict(S=np.abs(np.asarray(jap.stft(signals(52, (2, 8192)), **KW)))),
}
_JAX_CACHE: dict = {}


def _jax(name: str, case: str, route: str, **kw):
    """The JAX package's result, computed once per (feature, input, route)."""
    key = (name, case, route, tuple(sorted(kw.items())))
    if key not in _JAX_CACHE:
        with pytest.MonkeyPatch.context() as mp:
            if route == "kernels":
                mp.setattr(jax_dispatch, "has_pallas_tpu", lambda: True)
            _JAX_CACHE[key] = to_np(getattr(jap, name)(**_INPUTS[case](), **KW, **kw))
    return _JAX_CACHE[key]


@pytest.mark.parametrize("jax_route", ["kernels", "xla"])
@pytest.mark.parametrize("case", list(_INPUTS))
@pytest.mark.parametrize("name,kw", [
    ("spectral_centroid", {}),
    ("spectral_bandwidth", {}),
    ("spectral_bandwidth", dict(p=1.0, norm=False)),
    ("spectral_flatness", {}),  # noise: no bin sits near the amin clamp
    ("poly_features", dict(order=2)),
], ids=["centroid", "bandwidth", "bandwidth-p1", "flatness", "poly2"])
def test_feature_matches_jax(name, kw, case, jax_route, port_route):
    if name == "spectral_flatness":
        kw = dict(kw)  # flatness has no sr
    else:
        kw = dict(kw, sr=SR)
    ref = _jax(name, case, jax_route, **kw)
    got = getattr(tap, name)(**_INPUTS[case](), **KW, **kw)
    assert got.device.type == "cpu" and got.shape == ref.shape
    assert max_rel(got, ref) <= FEAT_TOL


@pytest.mark.parametrize("case", list(_INPUTS))
def test_centroid_route(case, port_route, monkeypatch):
    """On the kernel routes the centroid of a signal takes both moments out
    of the fused filterbank kernel (K1) with the ``[1, f]`` weight at power
    1, as the JAX package does; an ``S`` input and the plain route take the
    magnitude and two reductions. Either way it matches the JAX package's
    kernel path."""
    calls = []
    real = tap_features.melspectrogram_fused

    def spy(y, win, w, **kw):
        calls.append((tuple(w.shape), kw["power"]))
        return real(y, win, w, **kw)

    monkeypatch.setattr(tap_features, "melspectrogram_fused", spy)
    got = tap.spectral_centroid(**_INPUTS[case](), sr=SR, **KW)
    assert max_rel(got, _jax("spectral_centroid", case, "kernels", sr=SR)) <= FEAT_TOL
    takes_k1 = port_route == "kernels" and case != "S"
    assert calls == ([((KW["n_fft"] // 2 + 1, 2), 1.0)] if takes_k1 else [])


def _bins(hz: np.ndarray, n_fft: int) -> np.ndarray:
    return np.rint(np.asarray(hz, np.float64) / (SR / n_fft)).astype(np.int64)


def _assert_rolloff_agrees(got, ref, n_fft: int) -> None:
    # rolloff is a discrete bin: rounding in the cumulative sum can move the
    # roll_percent threshold across one bin, so a frame may differ by
    # exactly one bin, in at most 0.5% of frames
    d = _bins(to_np(got), n_fft) - _bins(ref, n_fft)
    assert np.abs(d).max(initial=0) <= 1
    assert np.count_nonzero(d) <= 0.005 * d.size


@pytest.mark.parametrize("jax_route", ["kernels", "xla"])
@pytest.mark.parametrize("case", list(_INPUTS))
@pytest.mark.parametrize("roll_percent", [0.85, 0.5])
def test_rolloff_matches_jax_within_one_bin(roll_percent, case, jax_route, port_route):
    kw = dict(sr=SR, roll_percent=roll_percent)
    ref = _jax("spectral_rolloff", case, jax_route, **kw)
    got = tap.spectral_rolloff(**_INPUTS[case](), **KW, **kw)
    assert got.shape == ref.shape
    _assert_rolloff_agrees(got, ref, KW["n_fft"])


@pytest.mark.parametrize("shape", [(2, 22050), (22050,)], ids=["2d", "1d"])
@pytest.mark.parametrize("linear", [False, True])
@pytest.mark.parametrize("jax_route", ["kernels", "xla"])
def test_contrast_matches_jax(jax_route, linear, shape, port_route, monkeypatch):
    # n_fft 2048: the default band table, bands of 74, 149, 297 and 431
    # bins with k = 2, 3, 6, 9 take the extraction kernel
    y = signals(53, shape)
    with pytest.MonkeyPatch.context() as mp:
        if jax_route == "kernels":
            mp.setattr(jax_dispatch, "has_pallas_tpu", lambda: True)
        ref = to_np(jap.spectral_contrast(y, sr=SR, linear=linear, **KW_2048))
    calls = []
    real = tap_features.quantile_extreme_means_fused

    def spy(x, k_lo, k_hi):
        calls.append((x.shape[-1], k_lo))
        return real(x, k_lo, k_hi)

    monkeypatch.setattr(tap_features, "quantile_extreme_means_fused", spy)
    got = tap.spectral_contrast(y, sr=SR, linear=linear, **KW_2048)
    assert got.shape == ref.shape == shape[:-1] + (7, 44)
    assert max_rel(got, ref) <= FEAT_TOL
    assert calls == ([(74, 2), (149, 3), (297, 6), (431, 9)] if port_route == "kernels" else [])


def test_contrast_options_and_s_input_match_jax():
    S = np.abs(np.asarray(jap.stft(signals(54, (2, 8192)), **KW)))
    freq = np.linspace(0, SR / 2, KW["n_fft"] // 2 + 1)
    for kw in (dict(), dict(fmin=100.0, n_bands=4, quantile=0.05), dict(quantile=0.3),
               dict(freq=freq), dict(n_bands=9)):
        ref = jap.spectral_contrast(S=S, sr=SR, **KW, **kw)
        got = tap.spectral_contrast(S=S, sr=SR, **KW, **kw)
        assert max_rel(got, ref) <= FEAT_TOL, kw


@pytest.mark.parametrize("linear", [False, True])
@pytest.mark.parametrize("jax_route", ["kernels", "xla"])
def test_contrast_nan_frames_match_jax(jax_route, linear, port_route):
    # NaN in a few frames of every band (the last band, all NaN in one
    # frame, has fewer non-NaN values than k): contrast is NaN at the same
    # (band, frame) positions in both packages, on every route (the
    # extraction kernel's twin ranks a NaN above +inf, as jnp.sort puts it
    # last), and agrees elsewhere within the contrast tolerance
    S = np.abs(np.asarray(jap.stft(signals(55, (2, 8192)), **KW_2048)))
    freq = np.linspace(0, SR / 2, KW_2048["n_fft"] // 2 + 1)
    bands = [b for b in tap_features.contrast_bands(freq, 200.0, 6, 0.02) if b is not None]
    for n, (start, stop, _) in enumerate(bands):
        S[n % 2, start + (7 * n) % (stop - start), 2 + n] = np.nan
        S[(n + 1) % 2, start + (3 * n + 1) % (stop - start), 9 + n] = np.nan
    start, stop, _ = bands[-1]
    S[0, start:stop, 14] = np.nan
    with pytest.MonkeyPatch.context() as mp:
        if jax_route == "kernels":
            mp.setattr(jax_dispatch, "has_pallas_tpu", lambda: True)
        ref = to_np(jap.spectral_contrast(S=S, sr=SR, linear=linear, **KW_2048))
    got = to_np(tap.spectral_contrast(S=S, sr=SR, linear=linear, **KW_2048))
    nan = np.isnan(ref)
    assert got.shape == ref.shape and np.array_equal(np.isnan(got), nan)
    assert nan.sum() >= 2 * len(bands) and not nan.all(axis=(1, 2)).any()
    assert max_rel(got[~nan], ref[~nan]) <= FEAT_TOL


def test_flatness_on_a_tone():
    # a pure tone: away from the edge frames nearly every bin sits at the
    # spectrum's rounding floor, so flatness there (~3e-11) is ruled by
    # rounding noise that two float32 FFTs produce differently. Against the
    # JAX package's f32-exact XLA path it holds the 1e-4-of-max rule, and
    # each frame is within 10% of its own value (measured: up to 7%)
    t = np.arange(16384) / SR
    y = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    ref = to_np(jap.spectral_flatness(y, **KW))
    got = to_np(tap.spectral_flatness(y, **KW))
    assert got.shape == ref.shape
    assert max_rel(got, ref) <= FEAT_TOL
    np.testing.assert_allclose(got, ref, rtol=0.1, atol=0)
    noise = to_np(tap.spectral_flatness(signals(55, (16384,)), **KW))
    assert ref.max() < 1e-2 * noise.min()  # the tone really is far from flat


@pytest.mark.parametrize("kw", [
    dict(), dict(pad_mode="constant"), dict(center=False), dict(frame_length=1024, hop_length=128),
], ids=["edge", "constant", "no-center", "1024"])
@pytest.mark.parametrize("shape", [(2, 8192), (8192,)], ids=["2d", "1d"])
def test_zero_crossing_rate_is_exact(shape, kw):
    y = signals(56, shape)
    y[..., 100:200] = 0.0  # signbit: +0.0 counts as positive
    y[..., 300:310] = -0.0
    got = to_np(tap.zero_crossing_rate(y, **kw))
    ref = np.asarray(jap.zero_crossing_rate(y, **kw))
    assert got.shape == ref.shape and np.array_equal(got, ref)


@pytest.mark.parametrize("order", [0, 1, 3])
def test_poly_table_is_bit_equal(order):
    from mlx_audio_primitives_tpu.ops.features import _poly_pinv_table as jax_table

    got = tap_features._poly_pinv_table(SR, 1024, order)
    assert same_bits(got, jax_table.host(SR, 1024, order))


def test_poly_features_custom_grid_matches_jax():
    S = np.abs(np.asarray(jap.stft(signals(57, (2, 4096)), **KW)))
    freq = np.geomspace(20.0, SR / 2, S.shape[-2])
    ref = jap.poly_features(S=S, freq=freq, order=2, **KW)
    assert max_rel(tap.poly_features(S=S, freq=freq, order=2, **KW), ref) <= FEAT_TOL


@pytest.mark.parametrize("n_steps,delay", [(1, 1), (2, 1), (3, 2), (3, -1)])
def test_stack_memory_matches_jax(n_steps, delay):
    x = signals(58, (2, 5, 17))
    for data in (x, x[0], x[0, 0]):
        ref = np.asarray(jap.stack_memory(data, n_steps=n_steps, delay=delay))
        got = to_np(tap.stack_memory(data, n_steps=n_steps, delay=delay))
        assert np.array_equal(got, ref)


@pytest.mark.parametrize("aggregate", ["mean", "median", "max", "min"])
def test_sync_matches_jax(aggregate):
    x = signals(59, (3, 40))
    for idx, pad in (([5, 12, 30], True), ([5, 5, 12], True), ([0, 12, 40], False)):
        ref = np.asarray(jap.sync(x, idx, aggregate=aggregate, pad=pad))
        got = tap.sync(torch.from_numpy(x), idx, aggregate=aggregate, pad=pad)
        assert got.device.type == "cpu" and np.array_equal(to_np(got), ref)
    assert np.array_equal(to_np(tap.sync(x.T, [4, 9], axis=0)), np.asarray(jap.sync(x.T, [4, 9], axis=0)))


@pytest.mark.parametrize("fn,kw", [
    ("spectral_centroid", dict()),
    ("spectral_rolloff", dict(y=np.zeros(4096, np.float32), roll_percent=1.5)),
    ("spectral_contrast", dict(y=np.zeros(4096, np.float32), n_bands=0)),
    ("spectral_contrast", dict(y=np.zeros(4096, np.float32), quantile=-0.1)),
    ("zero_crossing_rate", dict(y=np.zeros(4096, np.float32), pad_mode="reflect")),
    ("zero_crossing_rate", dict(y=np.zeros(4096, np.float32), frame_length=0)),
    ("poly_features", dict(S=np.ones((513, 4), np.float32), order=-1)),
    ("poly_features", dict(S=np.ones((513, 4), np.float32), freq=np.ones(10))),
    ("stack_memory", dict(data=np.ones((2, 4), np.float32), n_steps=0)),
    ("stack_memory", dict(data=np.ones((2, 4), np.float32), delay=0)),
    ("sync", dict(data=np.ones((2, 4), np.float32), idx=[3, 1])),
    ("sync", dict(data=np.ones((2, 4), np.float32), idx=[1, 9])),
    ("sync", dict(data=np.ones((2, 4), np.float32), idx=[1], aggregate="mode")),
], ids=lambda v: v if isinstance(v, str) else "")
def test_feature_errors_match(fn, kw):
    with pytest.raises(ValueError) as jerr:
        getattr(jap, fn)(**kw)
    with pytest.raises(ValueError) as terr:
        getattr(tap, fn)(**kw)
    assert str(terr.value) == str(jerr.value)


# --- the slice as a whole -----------------------------------------------------


@pytest.fixture(scope="module")
def feature_path_jax():
    """The smoke path's feature set at n_fft 2048 / hop 512 on one batch,
    through the JAX package's kernel paths."""
    y = signals(60, (2, 22050))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_dispatch, "has_pallas_tpu", lambda: True)
        out = _feature_set(jap, y)
    return y, {k: to_np(v) for k, v in out.items()}


def _feature_set(pkg, y):
    kw = dict(sr=SR, **KW_2048)
    m = pkg.mfcc(y, n_mfcc=20, **kw)
    return {
        "mfcc": m, "delta1": pkg.delta(m), "delta2": pkg.delta(m, order=2),
        "centroid": pkg.spectral_centroid(y, **kw),
        "bandwidth": pkg.spectral_bandwidth(y, **kw),
        "rolloff": pkg.spectral_rolloff(y, **kw),
        "flatness": pkg.spectral_flatness(y, **KW_2048),
        "contrast": pkg.spectral_contrast(y, **kw),
        "zcr": pkg.zero_crossing_rate(y),
        "rms": pkg.rms(y),
    }


def test_feature_path_matches_jax(feature_path_jax, port_route):
    y, ref = feature_path_jax
    got = _feature_set(tap, y)
    assert got.keys() == ref.keys()
    for name, g in got.items():
        assert g.shape == ref[name].shape, name
        if name == "rolloff":
            _assert_rolloff_agrees(g, ref[name], KW_2048["n_fft"])
        elif name == "zcr":
            assert np.array_equal(to_np(g), ref[name])
        else:
            assert max_rel(g, ref[name]) <= FEAT_TOL, name
