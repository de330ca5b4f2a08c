"""PyTorch port: Griffin-Lim, its single step, and the mel/MFCC inversion.

The same seeded NumPy magnitude goes through the JAX package and the port.
The port runs on CPU tensors either on its plain route or with its kernel
routes forced on (``resolve_use_pallas`` patched), where K2's and K3's
wrappers run their plain twins; the JAX package runs its XLA route, and in
one case its kernel route in interpret mode with the exact GEMMs
(``ANALYSIS_FAST_GEMM`` off, in this test only). Momentum 0.99 over 32
iterations magnifies rounding differences between the two FFT libraries:
at 32 iterations on this input the JAX package's own XLA and kernel
routes differ by 2.2e-4 (5.3e-5 of the signal's maximum), the port and
the XLA route by 1.8e-4. The limit is therefore 1e-4 of the maximum, the
JAX package's batch-against-single limit (1e-4 absolute,
`tests/test_griffinlim.py`) taken relative to these signals' scale
(peaks ~4). No comparison is bitwise.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import scipy.optimize
import torch
from torch_port_util import launch_counts, max_abs, signals, to_np

import mlx_audio_primitives_tpu as jap
import mlx_audio_primitives_tpu_torch as tap
from mlx_audio_primitives_tpu import _config as jax_config
from mlx_audio_primitives_tpu.utils import dispatch as jax_dispatch
from mlx_audio_primitives_tpu_torch.utils import dispatch as tap_dispatch

# the JAX package's ops/__init__ binds its functions over these module names
jax_gl = importlib.import_module("mlx_audio_primitives_tpu.ops.griffinlim")
jax_inv = importlib.import_module("mlx_audio_primitives_tpu.ops.inverse")
tap_gl = importlib.import_module("mlx_audio_primitives_tpu_torch.ops.griffinlim")
tap_inv = importlib.import_module("mlx_audio_primitives_tpu_torch.ops.inverse")
tap_stft = importlib.import_module("mlx_audio_primitives_tpu_torch.ops.stft")
tap_dft = importlib.import_module("mlx_audio_primitives_tpu_torch.kernels.dft")

torch.set_num_threads(1)

GL_TOL = 1e-4  # of max |reference|
N_FFT, HOP = 512, 128
Y = signals(70, (2, 6000))
S_MAG = np.abs(np.asarray(jap.stft(Y, n_fft=N_FFT, hop_length=HOP)))


@pytest.fixture(params=["plain", "kernels"])
def port_route(request, monkeypatch):
    if request.param == "kernels":
        monkeypatch.setattr(tap_dispatch, "resolve_use_pallas",
                            lambda flag, device: flag is not False)
    return request.param


_JAX: dict = {}


def _jax_gl(key, S, **kw):
    """The JAX package's XLA-route result, computed once per case."""
    if key not in _JAX:
        _JAX[key] = to_np(jap.griffinlim(S, use_pallas=False, **kw))
    return _JAX[key]


CASES = {
    "defaults-32": dict(n_iter=32, hop_length=HOP, random_state=0),
    "length": dict(n_iter=16, hop_length=HOP, random_state=1, length=6000),
    "no-momentum": dict(n_iter=8, hop_length=HOP, momentum=0.0, random_state=2),
    "zeros-init": dict(n_iter=8, hop_length=HOP, init="zeros"),
    "not-centered": dict(n_iter=8, hop_length=HOP, center=False, random_state=3),
    "hop-100": dict(n_iter=8, hop_length=100, random_state=4),
    "matmul": dict(n_iter=8, hop_length=HOP, random_state=5, fft_mode="matmul"),
    "reflect-win400": dict(n_iter=8, hop_length=HOP, random_state=6, win_length=400,
                           pad_mode="reflect"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_griffinlim_matches_jax(case, port_route):
    kw = CASES[case]
    ref = _jax_gl(case, S_MAG, **kw)
    got = tap.griffinlim(S_MAG, **kw)
    assert got.device.type == "cpu" and got.shape == ref.shape
    assert max_abs(got, ref) <= GL_TOL * np.abs(ref).max()


def test_griffinlim_single_clip():
    kw = dict(n_iter=8, hop_length=HOP, random_state=7)
    got = tap.griffinlim(S_MAG[1], **kw)
    ref = _jax_gl("single", S_MAG[1], **kw)
    assert got.dim() == 1 and max_abs(got, ref) <= GL_TOL * np.abs(ref).max()


def test_griffinlim_matches_jax_kernel_route(monkeypatch):
    """Against the JAX kernel route (its group-layout loop on the Pallas
    kernels in interpret mode), with its GEMMs exact."""
    kw = dict(n_iter=6, hop_length=HOP, random_state=8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_dispatch, "has_pallas_tpu", lambda: True)
        mp.setattr(jax_config, "ANALYSIS_FAST_GEMM", False)
        ref = to_np(jap.griffinlim(S_MAG, **kw))
    monkeypatch.setattr(tap_dispatch, "resolve_use_pallas", lambda flag, device: flag is not False)
    assert max_abs(tap.griffinlim(S_MAG, **kw), ref) <= GL_TOL * np.abs(ref).max()


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("hop,tier", [(HOP, "fused"), (100, "ola"), (HOP, "none")])
def test_tiers_and_launch_counts(hop, tier, monkeypatch):
    """n_iter iterations call K2's wrapper n_iter times and K3's n_iter + 1
    times under the radix gate; K4's n_iter + 1 times at hop 100; none of
    them with the kernels off. The spectrum reaches K3 as the transposed
    view of K2's natural layout, not a copy."""
    calls: list[str] = []
    seen_strides = []
    real_k3 = tap_stft.istft_fused

    def k3(S, *a, **k):
        calls.append("istft_fused")
        seen_strides.append(S.stride())
        return real_k3(S, *a, **k)

    monkeypatch.setattr(tap_stft, "istft_fused", k3)
    _spy(monkeypatch, tap_gl, "stft_fused", calls)
    _spy(monkeypatch, tap_stft, "overlap_add_fused", calls)
    if tier != "none":
        monkeypatch.setattr(tap_dispatch, "resolve_use_pallas",
                            lambda flag, device: flag is not False)
    n_iter = 5
    tap.griffinlim(S_MAG, n_iter=n_iter, hop_length=hop, random_state=0)
    want = {"fused": {"stft_fused": n_iter, "istft_fused": n_iter + 1},
            "ola": {"overlap_add_fused": n_iter + 1}, "none": {}}[tier]
    assert {n: calls.count(n) for n in set(calls)} == want
    n_bins, F = S_MAG.shape[1:]
    assert all(s == (n_bins * F, 1, F) for s in seen_strides)


def test_wrappers_count_no_launch_on_the_cpu(monkeypatch):
    monkeypatch.setattr(tap_dispatch, "resolve_use_pallas", lambda flag, device: flag is not False)
    before = launch_counts()
    tap.griffinlim(S_MAG, n_iter=2, hop_length=HOP, random_state=0)
    assert launch_counts() == before


@pytest.mark.parametrize("route", ["plain", "kernels"])
def test_istft_drops_dc_and_nyquist_imaginary_parts(route, monkeypatch):
    """irfft's semantics, which Griffin-Lim's random initial phases reach:
    the imaginary parts of the DC and Nyquist bins are dropped, as NumPy,
    XLA and K3 drop them. (cuFFT's inverse does not; the plain path zeroes
    them on CUDA, and ``chip_smoke.py`` phase 3 holds the card's plain
    inverse to the CPU's on such a spectrum.)"""
    if route == "kernels":
        monkeypatch.setattr(tap_dispatch, "resolve_use_pallas", lambda flag, device: flag is not False)
    rng = np.random.default_rng(14)
    X = (S_MAG * np.exp(1j * rng.uniform(-np.pi, np.pi, S_MAG.shape))).astype(np.complex64)
    real_edges = X.copy()
    real_edges[:, [0, -1]] = real_edges[:, [0, -1]].real
    ref = to_np(jap.istft(real_edges, hop_length=HOP))
    assert max_abs(jap.istft(X, hop_length=HOP), ref) <= 1e-6 * np.abs(ref).max()
    for x in (X, real_edges):
        assert max_abs(tap.istft(x, hop_length=HOP), ref) <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("owned", [False, True])
@pytest.mark.parametrize("layout", ["contiguous", "transposed", "conj"])
@pytest.mark.parametrize("n", [16, 17])
def test_the_cuda_repair_of_irfft_input(n, layout, owned):
    """The zeroing `irfft_len` applies before cuFFT's inverse, run here on
    CPU tensors: only the DC (and, for even n, the Nyquist) imaginary parts
    change, the caller's tensor only when it is ``owned``, and the inverse
    of the result is NumPy's irfft of the original spectrum."""
    rng = np.random.default_rng(15)
    Z = (rng.standard_normal((2, 5, 9)) + 1j * rng.standard_normal((2, 5, 9))).astype(np.complex64)
    X = torch.from_numpy(Z.copy())
    if layout == "transposed":
        X = torch.from_numpy(np.ascontiguousarray(Z.transpose(0, 2, 1))).transpose(1, 2)
    if layout == "conj":
        X = torch.from_numpy(np.conj(Z)).conj()
    if owned and layout == "conj":
        X = X.resolve_conj()
    before = X.resolve_conj().clone()
    Y = tap_dft._drop_edge_imag(X, n, owned)
    want = Z.copy()
    want[..., 0] = want[..., 0].real
    if n % 2 == 0:
        want[..., n // 2] = want[..., n // 2].real
    assert np.array_equal(to_np(Y.resolve_conj()), want)
    assert torch.equal(X.resolve_conj(), Y.resolve_conj() if owned else before)
    ref = np.fft.irfft(Z.astype(np.complex128), n=n, axis=-1)
    assert max_abs(torch.fft.irfft(Y, n=n, dim=-1), ref) <= 1e-5 * np.abs(ref).max()


def test_griffinlim_iter_matches_jax(port_route):
    rng = np.random.default_rng(9)
    angles = rng.uniform(-np.pi, np.pi, S_MAG.shape).astype(np.float32)
    tprev = (S_MAG * np.exp(1j * rng.uniform(-np.pi, np.pi, S_MAG.shape))).astype(np.complex64)
    kw = dict(hop_length=HOP, win_length=N_FFT, n_fft=N_FFT)
    ref = jax_gl.griffinlim_iter(S_MAG, angles, tprev=tprev, **kw)
    got = tap_gl.griffinlim_iter(S_MAG, angles, tprev=tprev, **kw)
    # angles are compared as unit phasors: at |X| ~ 0 the angle is ill-posed
    phasor = lambda a: np.exp(1j * to_np(a).astype(np.float64))  # noqa: E731
    mag = np.abs(to_np(ref[1]))
    strong = mag > 1e-3 * mag.max()
    assert np.abs(phasor(got[0]) - phasor(ref[0]))[strong].max() <= 1e-4
    assert max_abs(got[1], ref[1]) <= 1e-5 * mag.max()
    assert abs(float(got[2]) - float(ref[2])) <= 1e-5 * float(ref[2])


def test_griffinlim_errors_match_jax():
    for call in (lambda m: m.griffinlim(S_MAG, n_iter=0),
                 lambda m: m.griffinlim(S_MAG, momentum=1.0),
                 lambda m: m.griffinlim(S_MAG, init="ones"),
                 lambda m: m.griffinlim(S_MAG, win_length=600, n_fft=N_FFT)):
        with pytest.raises(ValueError) as ref:
            call(jap)
        with pytest.raises(ValueError) as got:
            call(tap)
        assert str(got.value) == str(ref.value)


# ---- mel / MFCC inversion ---------------------------------------------------

SR = 22050
MEL = np.asarray(jap.melspectrogram(Y, sr=SR, n_fft=N_FFT, hop_length=HOP, n_mels=32))


def test_nnls_matches_scipy_optimum():
    rng = np.random.default_rng(10)
    A = np.abs(rng.standard_normal((40, 24))).astype(np.float32)
    X_true = np.maximum(rng.standard_normal((24, 6)), 0).astype(np.float32)
    B = (A @ X_true + 0.05 * rng.standard_normal((40, 6))).astype(np.float32)
    X = to_np(tap_inv.nnls(A, B, n_iter=800))
    assert X.min() >= 0.0
    ours = np.linalg.norm(A @ X - B, axis=0)
    exact = np.asarray([scipy.optimize.nnls(A.astype(np.float64), B[:, j].astype(np.float64))[1]
                        for j in range(6)])
    np.testing.assert_allclose(ours, exact, rtol=1e-3)
    assert max_abs(X, jax_inv.nnls(A, B, n_iter=800)) <= 1e-4 * np.abs(X).max()


def test_nnls_batched_and_errors():
    rng = np.random.default_rng(11)
    A = np.abs(rng.standard_normal((8, 12))).astype(np.float32)
    B = np.abs(rng.standard_normal((3, 8, 5))).astype(np.float32)
    assert tuple(tap_inv.nnls(A, B, n_iter=50).shape) == (3, 12, 5)
    for args, match in (((A[0], B), "2-D"), ((A, np.zeros((9, 5), np.float32)), "match")):
        with pytest.raises(ValueError, match=match):
            tap_inv.nnls(*args)


@pytest.mark.parametrize("power", [1.0, 2.0])
def test_mel_to_stft_matches_jax(power):
    M = MEL if power == 2.0 else np.sqrt(MEL)
    ref = to_np(jap.mel_to_stft(M, sr=SR, n_fft=N_FFT, power=power))
    got = tap.mel_to_stft(M, sr=SR, n_fft=N_FFT, power=power)
    assert got.shape == ref.shape
    # FISTA's 300 steps carry the two libraries' GEMM rounding along; both
    # reach the same residual class (`tests/test_inverse.py` holds 2e-2)
    assert max_abs(got, ref) <= 1e-3 * np.abs(ref).max()
    fb = np.asarray(jap.mel_filterbank(SR, N_FFT, n_mels=32), np.float64)
    res = lambda S: (np.linalg.norm(np.einsum("mk,bkf->bmf", fb, to_np(S) ** power) - M)  # noqa: E731
                     / np.linalg.norm(M))
    assert res(got) <= max(2.0 * res(ref), 1e-4)


@pytest.mark.parametrize("norm,lifter", [("ortho", 0), ("ortho", 22), (None, 0), (None, 10)])
def test_mfcc_to_mel_matches_jax(norm, lifter):
    mf = np.asarray(jap.mfcc(Y, sr=SR, n_fft=N_FFT, hop_length=HOP, n_mels=32, n_mfcc=13,
                             norm=norm, lifter=lifter))
    ref = to_np(jap.mfcc_to_mel(mf, n_mels=32, norm=norm, lifter=lifter))
    got = to_np(tap.mfcc_to_mel(mf, n_mels=32, norm=norm, lifter=lifter))
    # norm=None overflows float32 at dB to power (as in the JAX package):
    # the same cells are inf, the rest agree elementwise
    assert got.shape == ref.shape
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin)
    assert (np.abs(got[fin] - ref[fin]) <= 1e-4 * np.abs(ref[fin])).all()


def test_mel_to_audio_matches_jax(port_route):
    kw = dict(sr=SR, n_fft=N_FFT, hop_length=HOP, n_iter=8, random_state=12, length=6000)
    ref = to_np(jap.mel_to_audio(MEL, **kw))
    got = tap.mel_to_audio(MEL, **kw)
    assert got.shape == ref.shape and max_abs(got, ref) <= 1e-3 * np.abs(ref).max()


def test_mfcc_to_audio_matches_jax():
    mf = np.asarray(jap.mfcc(Y, sr=SR, n_fft=N_FFT, hop_length=HOP, n_mels=32, n_mfcc=20))
    kw = dict(n_mels=32, sr=SR, n_fft=N_FFT, hop_length=HOP, n_iter=4, random_state=13)
    ref = to_np(jap.mfcc_to_audio(mf, **kw))
    got = tap.mfcc_to_audio(mf, **kw)
    assert got.shape == ref.shape and max_abs(got, ref) <= 1e-3 * np.abs(ref).max()


def test_inversion_errors_match_jax():
    for call in (lambda m: m.mfcc_to_mel(MEL[0, :13], n_mels=32, dct_type=3),
                 lambda m: m.mfcc_to_mel(MEL[0, :13], n_mels=8),
                 lambda m: m.mfcc_to_mel(MEL[0, :13], n_mels=32, lifter=-1),
                 lambda m: m.mel_to_stft(MEL[0, 0], n_fft=N_FFT)):
        with pytest.raises(ValueError) as ref:
            call(jap)
        with pytest.raises(ValueError) as got:
            call(tap)
        assert str(got.value).split(",")[0] == str(ref.value).split(",")[0]
