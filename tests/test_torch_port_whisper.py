"""PyTorch port: Whisper large-v3's log-mel front end on the CPU.

K1's mixed-radix entry (K1m, `csrc/mel_fused_mixed.cu`) runs only on the
card; here its plain twin, which runs the kernel's decomposition in torch
(``mixed_fft``'s radix-5 and radix-8 passes, the real split, the fast
entry's bf16x3 contraction), is held against ``torch.fft.rfft`` and the
exact plain composition at each shape of its class (n_fft 400 at hops 50 to
400, centred or not, power 1 or 2), within 3e-5 of the maximum: the fast
entry's class (its bf16 hi + lo keeps ~16 bits of a power, so a product is
within ~1.5e-5 of itself). The front end, ``whisper_v3_logmel()``, runs its
twins with ``use_pallas=True`` and the plain routes without, against the plain
float64 reference of `torch_port_whisper_reference.py`, within 2e-4 in
Whisper's units (a quarter of a decade of mel power): a float32 spectrum is
exact to ~1e-7 of its frame's energy, so the bins 60-80 dB under a clip's
peak, which the floor keeps, carry relative errors of up to ~1e-4 (7e-5
measured here). K6's per-item form, the gates and the routes are held here
too; the JAX package checks the mel at the same arguments.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_port_util import max_rel, same_bits, signals, to_np

import mlx_audio_primitives_tpu as jap
import mlx_audio_primitives_tpu_torch as tap
from mlx_audio_primitives_tpu_torch import _config
from mlx_audio_primitives_tpu_torch.kernels import mel_fused as k1
from mlx_audio_primitives_tpu_torch.kernels.db_fused import to_db_fused, to_db_plain
from mlx_audio_primitives_tpu_torch.models import presets
from mlx_audio_primitives_tpu_torch.ops.convert import _to_db
from mlx_audio_primitives_tpu_torch.ops.mel import filterbank_spectrogram, mel_filterbank
from mlx_audio_primitives_tpu_torch.utils import dispatch, profiler

sys.path.insert(0, str(Path(__file__).parent))
import torch_port_whisper_reference as whisper_ref  # noqa: E402

TWIN_TOL = 3e-5  # of the maximum: the fast entry's class
FEATURE_TOL = 2e-4  # Whisper's units, against the float64 reference
MEL = dict(sr=16000, n_fft=400, hop_length=160, window="hann", center=True, pad_mode="reflect",
           n_mels=128, fmin=0.0, fmax=8000.0, htk=False, norm="slaney", power=2.0)


def whisper_audio(seed: int, n: int, clips: int = 2) -> np.ndarray:
    """Seeded speech-band audio: a tone of 100-2,000 Hz a clip and noise at
    -30 dB, float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    f = rng.uniform(100.0, 2000.0, (clips, 1))
    y = 0.3 * np.sin(2 * np.pi * f * t) + 0.01 * rng.standard_normal((clips, n))
    return y.astype(np.float32)


# -- K1m's twin -----------------------------------------------------------------


@pytest.mark.parametrize("m", [200, 16, 25, 40, 400, 1000])
def test_mixed_fft_is_the_dft(m):
    z = torch.from_numpy(signals(m, (3, m)) + 1j * signals(m + 1, (3, m))).to(torch.complex64)
    assert max_rel(k1.mixed_fft(z), np.fft.fft(z.numpy().astype(np.complex128))) <= 2e-6


@pytest.mark.parametrize("m,radices", [(200, [5, 5, 8]), (16, [2, 8]), (25, [5, 5]),
                                       (400, [5, 5, 2, 8]), (40, [5, 8]), (20, [5, 4])])
def test_mixed_radices_and_positions(m, radices):
    """The passes as `fft_common.cuh::mixed_radix` orders them, and bin k at
    its digits' positions: a permutation of the points."""
    assert k1.mixed_radices(m) == radices
    assert sorted(k1.mixed_positions(m).tolist()) == list(range(m))


@pytest.mark.parametrize("hop,center,pad_mode,power", [
    (160, True, "reflect", 2.0), (100, False, "constant", 1.0), (400, True, "edge", 2.0),
    (50, False, "reflect", 1.0), (160, True, "constant", 1.0)])
def test_k1m_twin_matches_the_rfft_composition(hop, center, pad_mode, power):
    fb = mel_filterbank(16000, 400, 128, 0.0, 8000.0, device="cpu")
    y = torch.from_numpy(whisper_audio(hop, 7000))
    win = torch.hann_window(400, periodic=True)
    kw = dict(n_fft=400, hop_length=hop, center=center, pad_mode=pad_mode, power=power)
    got = k1.melspectrogram_mixed_plain(y, win, fb.t(), **kw)
    assert max_rel(got, k1.melspectrogram_plain(y, win, fb.t(), **kw)) <= TWIN_TOL
    assert max_rel(got, k1.melspectrogram_plain(y, win, fb.t(), fast_gemm=True, **kw)) <= TWIN_TOL
    fused = k1.melspectrogram_fused(y, win, fb.t(), **kw)  # the wrapper on a CPU tensor
    assert torch.equal(fused, got)


def test_k1m_backward_is_the_exact_composition():
    fb = mel_filterbank(16000, 400, 128, 0.0, 8000.0, device="cpu")
    y = torch.from_numpy(whisper_audio(3, 4000)).requires_grad_(True)
    win = torch.hann_window(400, periodic=True)
    kw = dict(n_fft=400, hop_length=160, center=True, pad_mode="reflect", power=2.0)
    k1.melspectrogram_fused(y, win, fb.t(), **kw).sum().backward()
    y2 = y.detach().clone().requires_grad_(True)
    k1.melspectrogram_plain(y2, win, fb.t(), **kw).sum().backward()
    assert torch.equal(y.grad, y2.grad)


# -- the gate and the route -----------------------------------------------------


@pytest.mark.parametrize("n_fft,hop,fast,want", [
    (400, 160, True, True), (400, 50, True, True), (400, 400, True, True),
    (400, 49, True, False), (400, 401, True, False), (400, 160, False, False),
    (320, 160, True, False), (512, 160, True, False), (2048, 512, True, True),
    (2048, 512, False, True), (1024, 256, True, True), (128, 128, False, True)])
def test_mel_gate(monkeypatch, n_fft, hop, fast, want):
    """K1's gate in the mode ``_config.ANALYSIS_FAST_GEMM`` holds when it is
    called, and in the mode it is given over the config's."""
    monkeypatch.setattr(_config, "ANALYSIS_FAST_GEMM", fast)
    assert k1.mel_shape_ok(n_fft, hop) is want
    monkeypatch.setattr(_config, "ANALYSIS_FAST_GEMM", not fast)
    assert k1.mel_shape_ok(n_fft, hop, fast) is want


@pytest.mark.parametrize("fast", [True, False])
def test_mel_gate_holds_every_radix_shape(monkeypatch, fast):
    monkeypatch.setattr(_config, "ANALYSIS_FAST_GEMM", fast)
    for n_fft in (128, 256, 512, 1024, 2048, 4096, 8192):
        for hop in range(128, 1025, 128):
            if dispatch.radix_shape_ok(n_fft, hop):
                assert k1.mel_shape_ok(n_fft, hop)
    assert not dispatch.radix_shape_ok(400, 160)


@pytest.mark.parametrize("fast", [True, False])
def test_filterbank_spectrogram_routes_400_160(monkeypatch, fast):
    """With ``use_pallas=True`` a 400/160 call takes K1's wrapper (K1m's twin
    on the CPU) in the fast mode, and the plain route for the gate in the
    exact mode, where the wrapper itself refuses the shape."""
    monkeypatch.setattr(_config, "ANALYSIS_FAST_GEMM", fast)
    y = whisper_audio(4, 8000)
    fb = mel_filterbank(16000, 400, 128, 0.0, 8000.0, device="cpu")
    win = torch.hann_window(400, periodic=True)
    kw = dict(n_fft=400, hop_length=160, center=True, pad_mode="reflect", power=2.0)
    profiler.clear_profiling()
    profiler.enable_profiling()
    try:
        got = filterbank_spectrogram(y, win, fb, use_pallas=True, **kw)
        data = profiler.get_profiling_data()
    finally:
        profiler.disable_profiling()
        profiler.clear_profiling()
    key = ("dispatch.kernel.filterbank_spectrogram" if fast
           else "dispatch.plain.filterbank_spectrogram.gate")
    assert data["counters"].get(key) == 1
    assert ("kernels.melspectrogram_fused" in data["spans"]) is fast
    plain = k1.melspectrogram_plain(torch.from_numpy(y), win, fb.t(), **kw)
    assert max_rel(got, plain) <= (TWIN_TOL if fast else 1e-6)
    if not fast:
        with pytest.raises(ValueError, match="fast mode"):
            k1.melspectrogram_fused(torch.from_numpy(y), win, fb.t(), **kw)


# -- K6's per-item form -----------------------------------------------------------


def mel_like(shape, seed=0, special=False) -> torch.Tensor:
    """Powers over 14 decades; a NaN and a +inf in clip 1 when ``special``."""
    rng = np.random.default_rng(seed)
    S = torch.from_numpy((10.0 ** rng.uniform(-12, 2, size=shape)).astype(np.float32))
    if special:
        S[1, 3, 5], S[1, 7, 2] = float("nan"), float("inf")
    return S


def per_item_composition(S, top_db, scale, offset):
    """Whisper's normalisation in dB, written out: ``10 log10(clamp(S,
    1e-10))``, floored at each clip's maximum less ``top_db``, then ``*
    scale + offset``."""
    d = 10.0 * torch.log10(torch.clamp(S, min=1e-10) / 1.0)
    if top_db is not None:
        d = torch.maximum(d, d.amax(dim=(1, 2), keepdim=True) - top_db)
    return d * scale + offset


@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("top_db", [80.0, None])
def test_k6_twin_per_item_on_a_strided_view(special, top_db):
    S = mel_like((3, 16, 41), seed=7, special=special)[..., :-1]
    assert not S.is_contiguous()
    want = per_item_composition(S, top_db, 1.0 / 40.0, 1.0)
    got = to_db_plain(S, 10.0, 1.0, 1e-10, top_db, per_item=True, scale=1.0 / 40.0, offset=1.0)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert same_bits(torch.nan_to_num(got), torch.nan_to_num(want))
    fused = to_db_fused(S, 10.0, 1.0, 1e-10, top_db, per_item=True, scale=1.0 / 40.0, offset=1.0)
    assert torch.equal(torch.isnan(fused), torch.isnan(want))
    if special:
        # a NaN in clip 1 leaves the floors of clips 0 and 2 alone
        assert not torch.isnan(got[0]).any() and not torch.isnan(got[2]).any()


@pytest.mark.parametrize("top_db", [80.0, None])
def test_k6_twin_whole_input_is_unchanged_at_the_identity(top_db):
    S = mel_like((2, 16, 21), seed=8)
    base = to_db_plain(S, 10.0, 1.0, 1e-10, top_db)
    assert same_bits(to_db_plain(S, 10.0, 1.0, 1e-10, top_db, scale=1.0, offset=0.0), base)
    assert same_bits(to_db_fused(S, 10.0, 1.0, 1e-10, top_db), base)


def test_to_db_route_counts_the_per_item_form():
    S = mel_like((2, 8, 10), seed=9)
    profiler.clear_profiling()
    profiler.enable_profiling()
    try:
        got = _to_db("power_to_db", S, 1.0, 10.0, 1e-10, 80.0, per_item=True, scale=0.025,
                     offset=1.0, use_pallas=True)
        counters = profiler.get_profiling_data()["counters"]
    finally:
        profiler.disable_profiling()
        profiler.clear_profiling()
    assert counters.get("dispatch.kernel.power_to_db") == 1
    assert same_bits(got, per_item_composition(S, 80.0, 0.025, 1.0))


# -- the front end ------------------------------------------------------------------


@pytest.mark.parametrize("use_pallas", [True, None])
@pytest.mark.parametrize("n", [16_000, 48_000, 480_000, 496_000])
def test_front_end_matches_the_reference(use_pallas, n):
    """Clips of 1 s and 3 s (padded to 30 s), of 30 s, and of 31 s
    (trimmed)."""
    y = whisper_audio(n % 997, n)
    got = presets.whisper_v3_logmel(use_pallas=use_pallas)(y)
    assert got.shape == (2, 128, 3000) and got.dtype == torch.float32
    want = whisper_ref.log_mel_spectrogram(torch.from_numpy(y))
    assert float((got.double() - want).abs().max()) <= FEATURE_TOL


def test_front_end_of_one_clip():
    y = whisper_audio(12, 20_000, clips=1)
    got = presets.whisper_v3_logmel(use_pallas=True)(y[0])
    assert got.shape == (128, 3000)
    assert float((got.double() - whisper_ref.log_mel_spectrogram(torch.from_numpy(y[0])))
                 .abs().max()) <= FEATURE_TOL
    with pytest.raises(ValueError):
        presets.whisper_v3_logmel()(np.zeros((2, 2, 400), np.float32))


@pytest.mark.parametrize("use_pallas", [True, None])
def test_a_clip_does_not_depend_on_its_batch_mates(use_pallas):
    """Clip 0 beside a loud clip and beside a quiet one: the same features
    (the floor is its own maximum's), where a floor against the batch's
    maximum would move them."""
    quiet = whisper_audio(13, 32_000, clips=1) * 1e-3
    loud = whisper_audio(14, 32_000, clips=1) * 30.0
    other = whisper_audio(15, 32_000, clips=1) * 1e-4
    front = presets.whisper_v3_logmel(use_pallas=use_pallas)
    a = front(np.concatenate([quiet, loud]))[0]
    b = front(np.concatenate([quiet, other]))[0]
    assert torch.equal(a, b)
    padded = np.pad(np.concatenate([quiet, loud]), ((0, 0), (0, 480_000 - 32_000)))
    mel = tap.melspectrogram(padded, **MEL)[..., :-1]
    batch_floor = to_db_plain(mel, 10.0, 1.0, 1e-10, 80.0, scale=0.025, offset=1.0)[0]
    assert float((batch_floor - a).abs().max()) > 0.1


def test_front_end_span():
    y = whisper_audio(16, 16_000)
    profiler.clear_profiling()
    profiler.enable_profiling()
    try:
        presets.whisper_v3_logmel(use_pallas=True)(y)
        spans = profiler.get_profiling_data()["spans"]
    finally:
        profiler.disable_profiling()
        profiler.clear_profiling()
    for name in ("models.whisper_v3_logmel", "ops.melspectrogram", "kernels.melspectrogram_fused",
                 "kernels.db_fused"):
        assert name in spans, name


@pytest.mark.parametrize("use_pallas", [True, None])
def test_mel_matches_jax(use_pallas):
    """The front end's mel (its arguments, on its padded input) against the
    JAX package's ``melspectrogram`` at the same arguments."""
    y = np.pad(whisper_audio(17, 24_000), ((0, 0), (0, 8_000)))
    got = tap.melspectrogram(y, use_pallas=use_pallas, **MEL)
    ref = np.asarray(jap.melspectrogram(y, **MEL))
    assert got.shape == ref.shape == (2, 128, 201)
    assert max_rel(to_np(got), ref) <= 1e-4


# -- the plain references -----------------------------------------------------------


def test_the_two_references_agree():
    """The tests' reference and the benchmark's (`bench_port/reference/
    whisper_logmel.py`, built on its own DFT and filterbank) at float64 on a
    short input, padded, and on one of 31 s, trimmed."""
    from bench_port import registry
    from bench_port.reference import whisper_logmel
    from bench_port.reference.dsp import Prec

    cfg = registry.config("whisper_v3")
    for n in (5_000, 496_000):
        y = torch.from_numpy(whisper_audio(n % 89, n).astype(np.float64))
        bench = whisper_logmel.reference(y, cfg, Prec("float64"))["features"]
        assert float((whisper_ref.log_mel_spectrogram(y) - bench).abs().max()) <= 1e-9


def test_the_reference_imports_no_jax_and_nothing_of_the_port():
    import subprocess

    probe = ("import sys; sys.path.insert(0, 'tests'); import torch_port_whisper_reference; "
             "bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'mlx_audio_primitives_tpu', 'mlx_audio_primitives_tpu_torch')]; "
             "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", probe], cwd=Path(__file__).parent.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
