"""PyTorch port: pYIN against the JAX package.

Contract (`NUMERICAL_ACCURACY.md`, pYIN row, held here tighter): voicing
equal on at least 99% of the frames, f0 bin-equal wherever both voice a
frame, ``voiced_prob`` within 1e-6 (the CMND, the trough probabilities and
the bins agree to a few float32 ulps).

The Viterbi picks each state's best predecessor with ``argmax``'s first
index, as the JAX scan does, in the scan body's order of operations. Given
the same log-observations it gives the JAX package's backpointers bit for
bit, near-ties included. The one difference that reaches the decoded path
is the log itself: XLA's float32 ``log`` is not correctly rounded (51 of
104,922 observation logs of a 2 s clip differ from torch's, which are),
and at a near-tie, as at the onset after digital silence, that can move
the path for a few frames; so can the CMND's last bits at such an onset.
The end-to-end cases hold the 99% on a batch of clips with and without
such gaps; one case swaps the JAX log in and gets the JAX package's
result exactly.

The observation scatter (``scatter_add_``) sums in no fixed order on CUDA,
which changes bits only where three or more troughs share a pitch bin; a
test holds that at the defaults no bin receives more than two.
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_util  # noqa: F401  (the CPU as the default device)

import mlx_audio_primitives_tpu as jap
import mlx_audio_primitives_tpu_torch as tap

jp = importlib.import_module("mlx_audio_primitives_tpu.ops.pyin")
jpi = importlib.import_module("mlx_audio_primitives_tpu.ops.pitch")
tp = importlib.import_module("mlx_audio_primitives_tpu_torch.ops.pyin")
tpi = importlib.import_module("mlx_audio_primitives_tpu_torch.ops.pitch")

torch.set_num_threads(1)

SR = 22050


def glide(seed: int, dur: float = 3.0, f: float = 220.0, noise: float = 0.05,
          gap: bool = False) -> np.ndarray:
    """A vibrato glide with its second partial and white noise; ``gap``
    silences 0.7-1.0 s exactly."""
    r = np.random.default_rng(seed)
    t = np.arange(int(dur * SR)) / SR
    f0 = f * 2.0 ** (0.5 * np.sin(2 * np.pi * r.uniform(0.2, 0.7) * t + r.uniform(0, 6)))
    ph = 2 * np.pi * np.cumsum(f0) / SR
    y = np.sin(ph) + 0.3 * np.sin(2 * ph) + noise * r.standard_normal(t.size)
    if gap:
        y[int(0.7 * SR) : int(1.0 * SR)] = 0.0
    return y.astype(np.float32)


CLIPS = {
    "noisy": np.stack([glide(1), glide(2, f=150.0), glide(3, noise=0.2, f=400.0)]),
    "gaps": np.stack([glide(4, gap=True), glide(5, gap=True, noise=0.0)]),
}
BANDS = {
    "default": dict(fmin=65.0, fmax=2093.0),
    "narrow": dict(fmin=100.0, fmax=800.0, n_thresholds=20),
    "coarse-1024": dict(fmin=80.0, fmax=800.0, frame_length=1024, resolution=0.2, center=False),
}


def assert_pyin_close(got, ref, voicing=0.99):
    f0, voiced, vp = got
    rf0, rv, rvp = (np.asarray(a) for a in ref)
    assert f0.shape == rf0.shape and voiced.dtype == bool and vp.shape == rvp.shape
    assert (voiced == rv).mean() >= voicing
    both = voiced & rv
    np.testing.assert_array_equal(f0[both], rf0[both])
    assert np.isnan(f0[~voiced]).all()
    assert np.abs(vp - rvp).max() <= 1e-6


#: one batch of five 3 s clips, two of them with a gap of digital silence
BATCH = np.concatenate([CLIPS["noisy"], CLIPS["gaps"]])


@pytest.mark.parametrize("band", list(BANDS))
@pytest.mark.parametrize("layout", ["batch", "one-clip"])
def test_pyin_matches_jax(layout, band):
    # the frames that differ sit at the onsets after the gaps (4 frames an
    # onset at hop 256 in the coarse band: 8 of 1,275 frames)
    Y, kw = (BATCH if layout == "batch" else CLIPS["noisy"][2]), BANDS[band]
    assert_pyin_close(tap.pyin(Y, sr=SR, **kw), jap.pyin(Y, sr=SR, **kw))


def test_pyin_one_clip_and_options():
    y = CLIPS["gaps"][1, : 2 * SR]
    kw = dict(fmin=100.0, fmax=500.0, n_thresholds=30, switch_prob=0.05, no_trough_prob=0.05,
              boltzmann_parameter=1.0, beta_parameters=(1.5, 10.0), max_transition_rate=20.0,
              fill_na=0.0, pad_mode="reflect")
    got = tap.pyin(y, sr=SR, **kw)
    ref = jap.pyin(y, sr=SR, **kw)
    assert got[0].ndim == 1
    assert (got[1] == np.asarray(ref[1])).mean() >= 0.99
    np.testing.assert_array_equal(got[0][~got[1]], 0.0)


def _jax_log_observations(obs, voiced_prob, n_bins):
    """The JAX package's observation logs (`ops/pyin.py:191-195` there)."""
    o, v = jnp.asarray(obs.numpy()), jnp.asarray(voiced_prob.numpy())
    tiny = np.finfo(np.float32).tiny
    o_v = jnp.log(jnp.maximum(o, tiny))
    o_u = jnp.log(jnp.maximum((1.0 - v)[..., None] / n_bins, tiny))
    return torch.from_numpy(np.asarray(jnp.concatenate([o_v, jnp.broadcast_to(o_u, o_v.shape)], -1)))


def test_pyin_equals_jax_with_the_xla_log(monkeypatch):
    monkeypatch.setattr(tp, "_log_observations", _jax_log_observations)
    Y, kw = CLIPS["gaps"], BANDS["narrow"]
    got, ref = tap.pyin(Y, sr=SR, **kw), jap.pyin(Y, sr=SR, **kw)
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))


def _jax_observations(Y, fmin, fmax, n_thresholds=100, frame_length=2048):
    win, hop = frame_length // 2, frame_length // 4
    min_p = max(int(np.floor(SR / fmax)), 1)
    max_p = min(int(np.ceil(SR / fmin)), frame_length - win - 1)
    yp = np.pad(Y, ((0, 0), (frame_length // 2, frame_length // 2)))
    band = jpi._yin_cmnd(jnp.asarray(yp), frame_length=frame_length, win_length=win, hop_length=hop,
                         min_period=min_p, max_period=max_p)
    n_bins = int(np.ceil(120 * np.log2(fmax / fmin))) + 1
    beta = jnp.asarray(jp._beta_threshold_prior(n_thresholds, 2.0, 18.0), jnp.float32)
    obs, vp = jp._pyin_observations(band, beta, n_thresholds=n_thresholds, boltzmann_parameter=2.0,
                                    no_trough_prob=0.01, n_bins=n_bins, bins_per_semitone=10,
                                    min_period=min_p, sr=SR, fmin=fmin)
    width = 2 * max(int(round(35.92 * 120 / (SR / hop))), 1) + 1
    tables = jp._transition_tables(n_bins, min(width, 2 * n_bins - 1), 0.01)
    return band, beta, obs, vp, tables, n_bins, min_p


@pytest.mark.parametrize("clips", list(CLIPS))
def test_viterbi_equals_jax_bit_for_bit_given_its_logs(clips, monkeypatch):
    monkeypatch.setattr(tp, "_log_observations", _jax_log_observations)
    _, _, obs, vp, (ll, ls), n_bins, _ = _jax_observations(CLIPS[clips], 65.0, 2093.0)
    last_j, bps_j = jp._pyin_viterbi(obs, vp, jnp.asarray(ll), jnp.asarray(ls), n_bins=n_bins)
    last_t, bps_t = tp._pyin_viterbi(torch.from_numpy(np.asarray(obs)), torch.from_numpy(np.asarray(vp)),
                                     torch.from_numpy(ll), torch.from_numpy(ls), n_bins=n_bins)
    assert bps_t.dtype == torch.int32
    np.testing.assert_array_equal(bps_t.numpy(), np.asarray(bps_j))
    np.testing.assert_array_equal(last_t.numpy(), np.asarray(last_j))


@pytest.mark.parametrize("k", [30, 55, 91])
def test_viterbi_near_tie_tone_between_two_bins(k):
    # a pure tone half-way between pitch bins k and k + 1: its trough mass
    # splits between two bins of nearly equal score
    fmin = 100.0
    f = fmin * 2.0 ** ((k + 0.5) / 120.0)
    y = np.sin(2 * np.pi * f * np.arange(SR) / SR).astype(np.float32)
    kw = dict(fmin=fmin, fmax=400.0, n_thresholds=20)
    got, ref = tap.pyin(y, sr=SR, **kw), jap.pyin(y, sr=SR, **kw)
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    mid = got[0][5:-5]
    assert np.all(np.abs(np.log2(mid / f)) * 120 <= 1.0)  # within one bin of the tone


def test_observations_match_jax_and_bins_hold_at_most_two_troughs():
    Y = CLIPS["noisy"][:, : 2 * SR]
    band, beta, obs, vp, _, n_bins, min_p = _jax_observations(Y, 65.0, 2093.0)
    kw = dict(boltzmann_parameter=2.0, no_trough_prob=0.01, min_period=min_p)
    o, v = tp._pyin_observations(torch.from_numpy(np.asarray(band)), torch.from_numpy(np.asarray(beta)),
                                 n_bins=n_bins, bins_per_semitone=10, sr=SR, fmin=65.0, **kw)
    assert np.abs(o.numpy() - np.asarray(obs)).max() <= 1e-6
    assert np.abs(v.numpy() - np.asarray(vp)).max() <= 1e-6
    B, F, P = band.shape
    prob, period = tp._trough_probs(torch.from_numpy(np.asarray(band)).reshape(B * F, P),
                                    torch.from_numpy(np.asarray(beta)), **kw)
    bins = torch.round(120 * torch.log2(SR / period / 65.0)).long().clamp(0, n_bins - 1)
    counts = torch.zeros((B * F, n_bins)).scatter_add_(1, bins, (prob > 0).float())
    assert int(counts.max()) <= 2


def test_observation_chunks_equal_one_pass(monkeypatch):
    band, beta, *_rest, min_p = _jax_observations(CLIPS["noisy"][:1, :SR], 100.0, 800.0, 20)
    args = (torch.from_numpy(np.asarray(band)).reshape(-1, band.shape[-1]),
            torch.from_numpy(np.asarray(beta)))
    kw = dict(boltzmann_parameter=2.0, no_trough_prob=0.01, min_period=min_p)
    whole = tp._trough_probs(*args, **kw)[0]
    monkeypatch.setattr(tp, "_OBS_CHUNK_CELLS", band.shape[-1] * 20 * 3)  # 3 frames a chunk
    np.testing.assert_array_equal(tp._trough_probs(*args, **kw)[0].numpy(), whole.numpy())


def test_tables_match_jax():
    for args in ((100, 2.0, 18.0), (20, 1.5, 10.0)):
        np.testing.assert_array_equal(tp._beta_threshold_prior(*args), jp._beta_threshold_prior(*args))
    for args in ((603, 201, 0.01), (40, 79, 0.2)):
        for a, b in zip(tp._transition_tables(*args), jp._transition_tables(*args)):
            np.testing.assert_array_equal(a, b)


def test_silence_is_unvoiced():
    f0, voiced, vp = tap.pyin(np.zeros(SR, np.float32), fmin=100.0, fmax=400.0, sr=SR, n_thresholds=10)
    assert not voiced.any() and np.isnan(f0).all() and np.all(vp == 0.0)


def test_errors_match_jax():
    y = CLIPS["noisy"][0, :SR]
    for kw in (dict(fmin=0.0, fmax=400.0), dict(fmin=400.0, fmax=100.0),
               dict(fmin=100.0, fmax=400.0, win_length=4096), dict(fmin=100.0, fmax=400.0, switch_prob=2.0),
               dict(fmin=100.0, fmax=400.0, resolution=0.0), dict(fmin=20.0, fmax=25.0, frame_length=256)):
        with pytest.raises(ValueError) as e_port:
            tap.pyin(y, **kw)
        with pytest.raises(ValueError) as e_jax:
            jap.pyin(y, **kw)
        assert str(e_port.value) == str(e_jax.value)
