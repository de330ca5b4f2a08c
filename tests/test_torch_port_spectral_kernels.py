"""PyTorch port: the spectral-feature slice's kernels against the JAX package.

K5 (quantile extremes), K2m (magnitude STFT) and the K3 intakes of the
natural spectrum (``istft_fused_t`` / ``istft_fused_nat``). The JAX side runs
its Pallas kernels in interpret mode on the CPU; the port runs on CPU
tensors, where every kernel wrapper takes its plain twin. Contracts: K5
within 1e-6 absolute (its sums run in the kernel's order), the magnitude
within 1e-4 of max (`NUMERICAL_ACCURACY.md`), the ISTFT within 1e-5
absolute where the squared-window envelope is at least 1e-3.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import launch_counts, max_abs, max_rel, signals, to_np

import mlx_audio_primitives_tpu as jap
from mlx_audio_primitives_tpu.kernels.istft_fused import istft_pallas_nat, istft_pallas_t
from mlx_audio_primitives_tpu.kernels.select_extremes import (
    quantile_extreme_means_pallas,
)
from mlx_audio_primitives_tpu.kernels.select_extremes import (
    select_supported as jax_select_supported,
)
from mlx_audio_primitives_tpu.kernels.overlap_add import envelope_for_ola
from mlx_audio_primitives_tpu_torch.kernels import select_extremes as k5
from mlx_audio_primitives_tpu_torch.kernels.istft_fused import (
    istft_fused_nat,
    istft_fused_t,
    istft_plain,
)
from mlx_audio_primitives_tpu_torch.kernels.stft_radix import (
    stft_magnitude_fused,
    stft_magnitude_plain,
    stft_plain,
)

# by path: the JAX package's `ops` re-exports a function named `stft`
jax_stft = importlib.import_module("mlx_audio_primitives_tpu.ops.stft")
tap_stft = importlib.import_module("mlx_audio_primitives_tpu_torch.ops.stft")

torch.set_num_threads(1)

K5_TOL = 1e-6  # absolute
MAG_TOL = 1e-4  # relative to max
ISTFT_TOL = 1e-5  # absolute, where the envelope is >= 1e-3


# --- K5 -----------------------------------------------------------------------


def _tied_rows(seed: int, shape: tuple[int, int]) -> np.ndarray:
    """Rows of small integers: every extreme is tied many times over."""
    return np.random.default_rng(seed).integers(-3, 4, shape).astype(np.float32)


@pytest.mark.parametrize("R,W,k_lo,k_hi", [
    (100, 440, 9, 9), (7, 19, 1, 1), (64, 75, 2, 2), (33, 298, 6, 6),
    (40, 300, 16, 16), (50, 100, 3, 7), (12, 16, 16, 16),
], ids=lambda v: str(v))
def test_k5_matches_jax_kernel(R, W, k_lo, k_hi):
    x = signals(30 + W, (R, W))
    ref_lo, ref_hi = quantile_extreme_means_pallas(jnp.asarray(x), k_lo=k_lo, k_hi=k_hi)
    before = launch_counts()
    lo, hi = k5.quantile_extreme_means_fused(torch.from_numpy(x), k_lo, k_hi)
    assert lo.shape == hi.shape == (R,)
    assert max_abs(lo, ref_lo) <= K5_TOL and max_abs(hi, ref_hi) <= K5_TOL
    # the twin is the sorted reference: the k smallest / largest of np.sort
    srt = np.sort(x.astype(np.float64), axis=-1)
    assert max_abs(lo, srt[:, :k_lo].mean(-1)) <= K5_TOL
    assert max_abs(hi, srt[:, W - k_hi:].mean(-1)) <= K5_TOL
    assert launch_counts() == before


def test_k5_ties_match_jax_kernel():
    x = _tied_rows(40, (64, 75))
    for k in (2, 9, 16):
        ref_lo, ref_hi = quantile_extreme_means_pallas(jnp.asarray(x), k_lo=k, k_hi=k)
        lo, hi = k5.quantile_extreme_means_fused(torch.from_numpy(x), k, k)
        assert max_abs(lo, ref_lo) <= K5_TOL and max_abs(hi, ref_hi) <= K5_TOL


def test_k5_gradient_routes_to_first_occurrences():
    # ties everywhere: the forward cannot tell the tied instances apart, the
    # gradient must pick the same positions as the JAX custom_vjp
    x = _tied_rows(41, (24, 30))
    a = signals(42, (24,))
    b = signals(43, (24,))
    k_lo, k_hi = 5, 3

    def jax_loss(v):
        lo, hi = quantile_extreme_means_pallas(v, k_lo=k_lo, k_hi=k_hi)
        return jnp.sum(lo * a) + jnp.sum(hi * b)

    ref = np.asarray(jax.grad(jax_loss)(jnp.asarray(x)))
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    lo, hi = k5.quantile_extreme_means_fused(xt, k_lo, k_hi)
    (torch.sum(lo * torch.from_numpy(a)) + torch.sum(hi * torch.from_numpy(b))).backward()
    got = to_np(xt.grad)
    assert np.array_equal(got != 0, ref != 0)  # the same positions
    assert max_abs(got, ref) <= 1e-7


def test_k5_reads_a_strided_band_in_place():
    # a band of the natural (B, n_bins, F) layout, rows = frames: the 3-D
    # strided view gives what the contiguous (B*F, W) copy gives
    mag = np.abs(signals(44, (2, 60, 37)))
    band = torch.from_numpy(mag)[:, 10:41, :].transpose(1, 2)  # (B, F, W), strided
    assert not band.is_contiguous()
    lo, hi = k5.quantile_extreme_means_fused(band, 3, 3)
    flat = band.reshape(-1, band.shape[-1]).contiguous()
    lo2, hi2 = k5.quantile_extreme_means_fused(flat, 3, 3)
    assert lo.shape == (2, 37)
    assert torch.equal(lo.reshape(-1), lo2) and torch.equal(hi.reshape(-1), hi2)


def test_k5_gate_matches_jax():
    for W in (1, 2, 9, 16, 17, 75, 440, 2000):
        for k_lo, k_hi in ((0, 1), (1, 1), (2, 9), (9, 9), (16, 16), (17, 3), (3, 17)):
            assert k5.select_supported(W, k_lo, k_hi) == jax_select_supported(W, k_lo, k_hi)
    with pytest.raises(ValueError):
        k5.quantile_extreme_means_fused(torch.zeros(4, 8), 9, 9)
    with pytest.raises(ValueError):
        k5.quantile_extreme_means_fused(torch.zeros(4), 1, 1)


# --- K2m ----------------------------------------------------------------------


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("case", [
    dict(shape=(2, 16384), n_fft=1024, hop_length=256),  # 65 frames: JAX's transposed emit
    dict(shape=(8192,), n_fft=1024, hop_length=256),  # 33 frames: JAX's grouped emit
    dict(shape=(2, 5000), n_fft=512, hop_length=100, pad_mode="reflect"),  # outside the gate
], ids=["2d-t", "1d-grouped", "off-gate"])
def test_magnitude_spectrogram_matches_jax(case, use_pallas):
    case = dict(case)
    y = signals(45, case.pop("shape"))
    ref = jax_stft.magnitude_spectrogram(y, use_pallas=use_pallas, **case)
    for up in (None, True, False):
        got = tap_stft.magnitude_spectrogram(y, use_pallas=up, fast_gemm=True, **case)
        assert got.dtype == torch.float32 and got.shape == ref.shape
        assert max_rel(got, ref) <= MAG_TOL


def test_magnitude_twin_is_abs_of_the_stft_twin():
    y = torch.from_numpy(signals(46, (2, 6000)))
    win = torch.from_numpy(np.array(jap.get_window("hann", 512)))
    for pad_mode, center in (("constant", True), ("reflect", True), ("edge", False)):
        kw = dict(n_fft=512, hop_length=128, center=center, pad_mode=pad_mode)
        before = launch_counts()
        ref = stft_plain(y, win, **kw).abs()
        assert torch.equal(stft_magnitude_fused(y, win, **kw), ref)
        assert torch.equal(stft_magnitude_plain(y, win, **kw), ref)
        assert launch_counts() == before
    with pytest.raises(ValueError):
        stft_magnitude_fused(y, win, n_fft=512, hop_length=100, center=True, pad_mode="constant")


# --- K3 through the natural intakes -------------------------------------------


def _natural_case(n_frames_out: int | None):
    """A natural (B, n_bins, F) spectrum at n_fft 1024 / hop 256, an output
    length, and the samples to compare: those a centred ``istft`` returns
    (the half frame at each end is its padding) whose envelope is >= 1e-3.
    Elsewhere both packages divide rounding noise by a tiny envelope, which
    no tolerance bounds. ``n_frames_out`` < F makes S hold more frames than
    the output covers."""
    n_fft, hop = 1024, 256
    y = signals(47, (2, 12000))
    S = to_np(tap_stft.stft(y, n_fft=n_fft, hop_length=hop))
    F = S.shape[-1]
    T = n_fft + (F - 1) * hop if n_frames_out is None else n_frames_out * hop
    win = np.asarray(jap.get_window("hann", n_fft))
    env = np.asarray(envelope_for_ola(jnp.asarray(win), F, hop, T))
    keep = env >= 1e-3
    keep[: n_fft // 2] = keep[T - n_fft // 2 :] = False
    return n_fft, hop, S, win, env, T, keep


@pytest.mark.parametrize("n_frames_out", [None, 20, 7], ids=["all", "trim-20", "trim-7"])
@pytest.mark.parametrize("entry", ["t", "nat"])
def test_istft_natural_intakes_match_jax(entry, n_frames_out):
    n_fft, hop, S, win, env, T, keep = _natural_case(n_frames_out)
    assert n_frames_out is None or S.shape[-1] > n_frames_out + n_fft // hop
    jfn, tfn = (istft_pallas_t, istft_fused_t) if entry == "t" else (istft_pallas_nat, istft_fused_nat)
    kw = dict(n_fft=n_fft, hop_length=hop, padded_length=T)
    ref = to_np(jfn(jnp.asarray(S), jnp.asarray(win), jnp.asarray(env), **kw))
    before = launch_counts()
    t = [torch.from_numpy(np.array(a)) for a in (S, win, env)]
    got = tfn(*t, **kw)
    assert got.shape == ref.shape == (2, T)
    assert max_abs(to_np(got)[:, keep], ref[:, keep]) <= ISTFT_TOL
    # the same function as K3 on the (B, F, n_bins) transpose
    assert torch.equal(got, istft_plain(t[0].transpose(1, 2), t[1], t[2], **kw))
    assert launch_counts() == before


def test_istft_natural_intakes_accept_the_tpu_flags():
    n_fft, hop, S, win, env, T, _ = _natural_case(None)
    t = [torch.from_numpy(np.array(a)) for a in (S, win, env)]
    kw = dict(n_fft=n_fft, hop_length=hop, padded_length=T)
    base = istft_fused_t(*t, **kw)
    assert torch.equal(istft_fused_t(*t, fast_gemm=True, kara=True, **kw), base)
    assert torch.equal(istft_fused_nat(*t, kara=False, **kw), base)
    assert istft_fused_nat(*t, n_fft=n_fft, hop_length=hop, padded_length=0).shape == (2, 0)
