"""PyTorch port: mel spectrogram, dB conversions, the kernels' plain twins
and the whole slice, against the JAX package.

The JAX side reaches its Pallas kernels with ``use_pallas=True`` (interpret
mode on the CPU); the port runs on the CPU, where each kernel wrapper runs
its plain twin. Contracts (`NUMERICAL_ACCURACY.md`): mel ~1e-4 relative to
max (the JAX kernel's default 3-pass bf16-split GEMMs sit at ~2.7e-5), dB
~2e-6 relative, ISTFT 1e-5 absolute.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import launch_counts, max_abs, max_rel, signals, to_np

import mlx_audio_primitives_tpu as jap
import mlx_audio_primitives_tpu_torch as tap
from mlx_audio_primitives_tpu.kernels.istft_fused import istft_pallas
from mlx_audio_primitives_tpu.kernels.mel_fused import melspectrogram_pallas
from mlx_audio_primitives_tpu.kernels.overlap_add import envelope_for_ola, overlap_add_pallas
from mlx_audio_primitives_tpu.kernels.stft_radix import stft_pallas
from mlx_audio_primitives_tpu_torch.kernels.istft_fused import istft_fused, istft_plain
from mlx_audio_primitives_tpu_torch.kernels.mel_fused import (
    melspectrogram_fused,
    melspectrogram_plain,
)
from mlx_audio_primitives_tpu_torch.kernels.overlap_add import (
    overlap_add_fused,
    overlap_add_plain,
)
from mlx_audio_primitives_tpu_torch.kernels.stft_radix import stft_fused, stft_plain

torch.set_num_threads(1)

MEL_TOL = 1e-4  # relative to max
DB_TOL = 2e-6  # relative to max |dB|
ISTFT_TOL = 1e-5  # absolute
KW = dict(n_fft=1024, hop_length=256, n_mels=32)


@pytest.fixture(scope="module")
def clips():
    return signals(20, (2, 8192))


@pytest.fixture(scope="module")
def jax_mel_power2(clips):
    return np.asarray(jap.melspectrogram(clips, use_pallas=True, **KW))


@pytest.mark.parametrize("power", [1.0, 2.0])
def test_melspectrogram_matches_jax_kernel(clips, jax_mel_power2, power):
    ref = jax_mel_power2 if power == 2.0 else jap.melspectrogram(
        clips, power=power, use_pallas=True, **KW)
    for up in (None, True):
        got = tap.melspectrogram(clips, power=power, use_pallas=up, **KW)
        assert got.shape == (2, 32, 33)
        assert max_rel(got, ref) <= MEL_TOL


def test_melspectrogram_matches_jax_xla_path(clips):
    ref = jap.melspectrogram(clips, use_pallas=False, **KW)
    assert max_rel(tap.melspectrogram(clips, use_pallas=False, **KW), ref) <= MEL_TOL
    y1 = clips[0]
    got = tap.melspectrogram(y1, use_pallas=True, window="hamming", win_length=800, **KW)
    ref = jap.melspectrogram(y1, use_pallas=False, window="hamming", win_length=800, **KW)
    assert got.shape == (32, 33) and max_rel(got, ref) <= MEL_TOL


def test_odd_power_takes_the_plain_composition(clips):
    # power not in {1, 2}: the JAX package routes to XLA even with
    # use_pallas=True; the port routes to its plain composition
    before = launch_counts()
    got = tap.melspectrogram(clips, power=1.5, use_pallas=True, **KW)
    ref = jap.melspectrogram(clips, power=1.5, use_pallas=True, **KW)
    assert max_rel(got, ref) <= MEL_TOL
    assert launch_counts() == before


def test_mel_fft_mode_matmul_and_errors(clips):
    got = tap.melspectrogram(clips, fft_mode="matmul", **KW)
    assert max_rel(got, jap.melspectrogram(clips, fft_mode="matmul", **KW)) <= MEL_TOL
    for up in (None, True, False):
        with pytest.raises(ValueError, match="fft_mode"):
            tap.melspectrogram(clips, fft_mode="bogus", use_pallas=up, **KW)


@pytest.mark.parametrize("fn,kw", [
    ("power_to_db", {}), ("power_to_db", dict(top_db=None)),
    ("power_to_db", dict(ref=lambda S: S.max(), top_db=40.0)),
    ("power_to_db", dict(ref=3.0, amin=1e-6)),
    ("amplitude_to_db", {}), ("amplitude_to_db", dict(ref=lambda S: S.max(), top_db=None)),
], ids=["p2db", "p2db-nodb", "p2db-refmax", "p2db-ref", "a2db", "a2db-refmax"])
def test_to_db_matches_jax(jax_mel_power2, fn, kw):
    S = jax_mel_power2 if fn == "power_to_db" else np.sqrt(jax_mel_power2)
    got = getattr(tap, fn)(S, **kw)
    ref = getattr(jap, fn)(S, **kw)
    assert max_rel(got, ref) <= DB_TOL


@pytest.mark.parametrize("fn", ["db_to_power", "db_to_amplitude"])
def test_from_db_matches_jax(fn):
    S_db = np.linspace(-80.0, 20.0, 1001, dtype=np.float32)
    for ref_level in (1.0, 2.5):
        got = getattr(tap, fn)(S_db, ref=ref_level)
        assert max_rel(got, getattr(jap, fn)(S_db, ref=ref_level)) <= DB_TOL


def test_db_errors_match():
    for fn, kw in (("power_to_db", dict(amin=0.0)), ("power_to_db", dict(top_db=-1.0)),
                   ("amplitude_to_db", dict(amin=-1.0))):
        with pytest.raises(ValueError) as jerr:
            getattr(jap, fn)(np.ones(4, np.float32), **kw)
        with pytest.raises(ValueError) as terr:
            getattr(tap, fn)(np.ones(4, np.float32), **kw)
        assert str(terr.value) == str(jerr.value)


def test_slice_log_mel_matches_jax(clips, jax_mel_power2):
    # the headline transform, end to end, at (1024, 256), B=2
    got = tap.power_to_db(tap.melspectrogram(clips, **KW))
    ref = jap.power_to_db(jax_mel_power2)
    assert got.shape == ref.shape == (2, 32, 33)
    assert max_rel(got, ref) <= MEL_TOL


def test_slice_round_trip_matches_jax(clips):
    S = tap.stft(clips, n_fft=1024, hop_length=256)
    got = tap.istft(S, hop_length=256, length=8192)
    ref = jap.istft(to_np(S), hop_length=256, length=8192, use_pallas=False)
    assert max_abs(got, ref) <= ISTFT_TOL and max_abs(got, clips) <= ISTFT_TOL


def test_melspectrogram_gradient_matches_jax(clips):
    y = torch.from_numpy(clips.copy()).requires_grad_(True)
    tap.melspectrogram(y, use_pallas=True, **KW).sum().backward()
    ref = jax.grad(lambda x: jap.melspectrogram(x, use_pallas=True, **KW).sum())(jnp.asarray(clips))
    assert max_rel(y.grad, ref) <= 1e-4


def test_gradient_flows_through_every_twin():
    # the CPU twins are the kernels' backward on the card: they must carry
    # a gradient to every float input
    y = torch.from_numpy(signals(21, (1, 2048))).requires_grad_(True)
    S = tap.stft(y, n_fft=512, hop_length=128, use_pallas=True)
    rec = tap.istft(S, hop_length=128, length=2048, use_pallas=True)
    rec441 = tap.istft(tap.stft(y, n_fft=512, hop_length=100), hop_length=100, length=2048,
                       use_pallas=True)
    (rec.sum() + rec441.sum()).backward()
    # istft(stft(y)) is the identity, so d(sum)/dy is ones
    np.testing.assert_allclose(to_np(y.grad), 2.0, atol=1e-4)


# --- the four kernels' plain twins against the JAX kernel functions ----------


@pytest.fixture(scope="module")
def kernel_inputs():
    n_fft, hop = 1024, 256
    y = signals(22, (2, 8192))
    win = np.asarray(jap.get_window("hann", n_fft))
    fb_t = np.ascontiguousarray(np.asarray(jap.mel_filterbank(22050, n_fft, n_mels=32)).T)
    return n_fft, hop, y, win, fb_t


def test_mel_twin_matches_jax_kernel(kernel_inputs):
    n_fft, hop, y, win, fb_t = kernel_inputs
    kw = dict(n_fft=n_fft, hop_length=hop, center=True, pad_mode="constant")
    before = launch_counts()
    ref = melspectrogram_pallas(jnp.asarray(y), jnp.asarray(win), jnp.asarray(fb_t), **kw)
    t = [torch.from_numpy(a) for a in (y, win, fb_t)]
    assert max_rel(melspectrogram_plain(*t, **kw), ref) <= MEL_TOL
    assert max_rel(melspectrogram_fused(*t, **kw), ref) <= MEL_TOL
    assert launch_counts() == before


def test_stft_twin_matches_jax_kernel(kernel_inputs):
    n_fft, hop, y, win, _ = kernel_inputs
    kw = dict(n_fft=n_fft, hop_length=hop, center=True, pad_mode="reflect")
    before = launch_counts()
    ref = stft_pallas(jnp.asarray(y), jnp.asarray(win), **kw)
    t = [torch.from_numpy(a) for a in (y, win)]
    assert max_rel(stft_plain(*t, **kw), ref) <= 1e-5
    assert max_rel(stft_fused(*t, **kw), ref) <= 1e-5
    assert launch_counts() == before


def test_istft_twin_matches_jax_kernel(kernel_inputs):
    n_fft, hop, y, win, _ = kernel_inputs
    S = to_np(tap.stft(y, n_fft=n_fft, hop_length=hop)).transpose(0, 2, 1)  # (B, F, n_bins)
    T = n_fft + (S.shape[1] - 1) * hop
    env = np.asarray(envelope_for_ola(jnp.asarray(win), S.shape[1], hop, T))
    kw = dict(n_fft=n_fft, hop_length=hop, padded_length=T)
    before = launch_counts()
    ref = to_np(istft_pallas(jnp.asarray(S), jnp.asarray(win), jnp.asarray(env), **kw))
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (S, win, env)]
    keep = slice(n_fft // 2, T - n_fft // 2)  # the samples istft returns
    assert max_abs(istft_plain(*t, **kw)[:, keep], ref[:, keep]) <= ISTFT_TOL
    assert max_abs(istft_fused(*t, **kw)[:, keep], ref[:, keep]) <= ISTFT_TOL
    assert istft_fused(*t, n_fft=n_fft, hop_length=hop, padded_length=0).shape == (2, 0)
    assert launch_counts() == before


def test_overlap_add_twin_matches_jax_kernel(kernel_inputs):
    n_fft, _, y, win, _ = kernel_inputs
    hop, F = 441, 16
    fw = signals(23, (2, F, n_fft)) * win
    T = n_fft + (F - 1) * hop
    env = np.asarray(envelope_for_ola(jnp.asarray(win), F, hop, T))
    before = launch_counts()
    ref = to_np(overlap_add_pallas(jnp.asarray(fw), jnp.asarray(env), hop_length=hop,
                                   output_length=T))
    t = [torch.from_numpy(a) for a in (fw, env)]
    kw = dict(hop_length=hop, output_length=T)
    # random frames divided by the 1e-8 envelope edges reach ~1e4: relative
    assert max_rel(overlap_add_plain(*t, **kw), ref) <= 1e-6
    assert max_rel(overlap_add_fused(*t, **kw), ref) <= 1e-6
    # a shorter envelope counts as 1.0 past its end, as in the JAX kernel
    longer = dict(hop_length=hop, output_length=T + 100)
    ref_l = to_np(overlap_add_pallas(jnp.asarray(fw), jnp.asarray(env), **longer))
    assert max_rel(overlap_add_fused(*t, **longer), ref_l) <= 1e-6
    assert overlap_add_fused(*t, hop_length=hop, output_length=0).shape == (2, 0)
    assert launch_counts() == before


def test_twins_reject_shapes_outside_their_gates(kernel_inputs):
    n_fft, hop, y, win, fb_t = kernel_inputs
    t = [torch.from_numpy(a) for a in (y, win, fb_t)]
    kw = dict(hop_length=300, center=True, pad_mode="constant")
    with pytest.raises(ValueError):
        melspectrogram_fused(*t, n_fft=n_fft, **kw)
    with pytest.raises(ValueError):
        melspectrogram_fused(*t, n_fft=n_fft, hop_length=hop, center=True,
                             pad_mode="constant", power=1.5)
    with pytest.raises(ValueError):
        stft_fused(*t[:2], n_fft=n_fft, **kw)
    with pytest.raises(ValueError):
        overlap_add_fused(torch.zeros(1, 4, 2048), torch.ones(100), hop_length=2,
                          output_length=100)
