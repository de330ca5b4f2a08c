"""PyTorch port: the streaming front ends against their offline
counterparts and against the JAX package's streams.

Each class holds its JAX docstring's contract, streamed == offline:

* ``StreamingSTFT`` == ``stft(center=False)`` of the signal primed with
  ``n_fft - hop`` zeros, within 1e-5 of max, ``hop == n_fft`` included;
* ``StreamingISTFT``'s pushes plus ``flush()`` == ``istft(center=False)``
  within 1e-5 of max where the window envelope is at least 1e-3 (below it
  the division amplifies rounding), and within 2e-3 everywhere (the JAX
  package's own bound);
* ``StreamingLogMel`` / ``StreamingMFCC`` / ``StreamingPCEN`` == the
  offline mel front end at ``center=False`` (dB without a floor, its DCT,
  PCEN) within 1e-5 of max; ``StreamingChroma`` == ``chroma_stft(center=
  False)`` within 2e-7;
* ``StreamingPitch`` == ``pitch_detect_acf(center=False)`` frame for frame
  (and the JAX stream's f0 within 2e-7, its ``sr / period`` rounding);
* ``StreamingResample`` == ``resample_poly(padtype='constant')`` within
  2e-6 + 1e-5 |ref|.

The streams run on the plain route and on the kernel route (on the CPU
the wrappers run the kernels' twins); each also equals the JAX package's
stream on the same chunks. A chunk that is not a whole number of hops
raises, as in the JAX package.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch
from torch_port_util import max_abs, max_rel, signals, to_np

import mlx_audio_primitives_tpu_torch as tap
from mlx_audio_primitives_tpu_torch.utils import dispatch as tap_dispatch

js = importlib.import_module("mlx_audio_primitives_tpu.ops.streaming")
st = importlib.import_module("mlx_audio_primitives_tpu_torch.ops.streaming")

torch.set_num_threads(1)

SR, N_FFT, HOP = 22050, 512, 128
PAD = N_FFT - HOP
X = signals(130, (2, 48 * HOP))
T = np.arange(X.shape[1]) / SR
TONAL = (np.sin(2 * np.pi * 220.0 * T) + 0.5 * np.sin(2 * np.pi * 330.0 * T)
         + 0.05 * signals(131, (2, X.shape[1]))).astype(np.float32)


@pytest.fixture(params=["plain", "kernels"])
def port_route(request, monkeypatch):
    if request.param == "kernels":
        monkeypatch.setattr(tap_dispatch, "kernel_route", lambda flag, device: flag is not False)
    return request.param


def stream(obj, x, chunk, dim=1):
    return torch.cat([obj.push(x[..., i : i + chunk]) for i in range(0, x.shape[-1], chunk)], dim=dim)


def jax_stream(obj, x, chunk, axis=1):
    return np.concatenate([np.asarray(obj.push(x[..., i : i + chunk]))
                           for i in range(0, x.shape[-1], chunk)], axis=axis)


def primed(x, pad=PAD):
    return np.pad(x, ((0, 0), (pad, 0)))


@pytest.mark.parametrize("chunk_hops", [1, 4, 16])
def test_streaming_stft_matches_offline_and_jax(chunk_hops, port_route):
    got = stream(tap.streaming.StreamingSTFT(N_FFT, HOP, batch=2), X, chunk_hops * HOP)
    off = tap.stft(primed(X), n_fft=N_FFT, hop_length=HOP, center=False).transpose(1, 2)
    assert got.shape == off.shape == (2, 48, N_FFT // 2 + 1)
    assert max_rel(got, off) <= 1e-5
    ref = jax_stream(js.StreamingSTFT(N_FFT, HOP, batch=2), X, chunk_hops * HOP)
    assert max_rel(got, ref) <= 1e-5


def test_streaming_stft_hop_equals_nfft_and_functional_core():
    # tail == 0: the carry is empty, each chunk of k*n_fft gives k frames
    s = tap.streaming.StreamingSTFT(256, 256, window="hann", batch=2)
    got = stream(s, X, 2 * 256)
    off = tap.stft(X, n_fft=256, hop_length=256, center=False).transpose(1, 2)
    assert s.carry.shape == (2, 0) and max_rel(got, off) <= 1e-5
    win = tap.get_window("hann", N_FFT)
    carry = st.streaming_stft_init(2, N_FFT, HOP)
    parts = []
    for i in range(0, X.shape[1], 8 * HOP):
        carry, spec = st.streaming_stft_push(carry, torch.from_numpy(X[:, i : i + 8 * HOP]), win,
                                             n_fft=N_FFT, hop_length=HOP)
        parts.append(spec)
    ref = tap.stft(primed(X), n_fft=N_FFT, hop_length=HOP, center=False).transpose(1, 2)
    assert max_rel(torch.cat(parts, 1), ref) <= 1e-5


def test_streaming_stft_reset_and_one_d_chunks():
    s = tap.streaming.StreamingSTFT(N_FFT, HOP)
    a = s.push(X[0, : 4 * HOP])
    s.reset()
    b = s.push(X[0, : 4 * HOP])
    np.testing.assert_array_equal(to_np(a), to_np(b))
    assert a.shape == (1, 4, N_FFT // 2 + 1)


def test_chunk_not_a_whole_number_of_hops_raises_as_in_jax():
    for port, ref in (
        (tap.streaming.StreamingSTFT(N_FFT, HOP), js.StreamingSTFT(N_FFT, HOP)),
        (tap.streaming.StreamingLogMel(n_fft=N_FFT, hop_length=HOP),
         js.StreamingLogMel(n_fft=N_FFT, hop_length=HOP)),
        (tap.streaming.StreamingPitch(hop_length=HOP), js.StreamingPitch(hop_length=HOP)),
        (tap.streaming.StreamingResample(160, 441), js.StreamingResample(160, 441)),
    ):
        with pytest.raises(ValueError) as e_port:
            port.push(X[:1, :100])
        with pytest.raises(ValueError) as e_jax:
            ref.push(X[:1, :100])
        assert str(e_port.value) == str(e_jax.value)
    for cls in (tap.streaming.StreamingSTFT, js.StreamingSTFT):
        with pytest.raises(ValueError, match="hop_length must be in"):
            cls(256, 512)


def _envelope(n_frames, n_fft=N_FFT, hop=HOP):
    w = tap.get_window("hann", n_fft).numpy().astype(np.float64) ** 2
    env = np.zeros(n_fft + (n_frames - 1) * hop)
    for f in range(n_frames):
        env[f * hop : f * hop + n_fft] += w
    return env


@pytest.mark.parametrize("frames_per_push", [1, 3, 8])
def test_streaming_istft_matches_offline_and_jax(frames_per_push):
    S = tap.stft(X, n_fft=N_FFT, hop_length=HOP, center=False)
    inv = tap.streaming.StreamingISTFT(N_FFT, HOP, batch=2)
    parts = [inv.push(S[:, :, i : i + frames_per_push].transpose(1, 2))
             for i in range(0, S.shape[-1], frames_per_push)]
    got = torch.cat(parts + [inv.flush()], dim=1)
    off = tap.istft(S, hop_length=HOP, center=False)
    assert got.shape == off.shape
    ok = _envelope(S.shape[-1]) >= 1e-3
    assert max_rel(got[:, ok], off[:, ok]) <= 1e-5
    assert max_abs(got, off) <= 2e-3
    Sn = to_np(S)
    jinv = js.StreamingISTFT(N_FFT, HOP, batch=2)
    jparts = [np.asarray(jinv.push(Sn[:, :, i : i + frames_per_push].transpose(0, 2, 1)))
              for i in range(0, Sn.shape[-1], frames_per_push)] + [np.asarray(jinv.flush())]
    ref = np.concatenate(jparts, axis=1)
    assert max_rel(got[:, ok], ref[:, ok]) <= 1e-5


def test_streaming_istft_flush_resets_and_hop_equals_nfft():
    inv = tap.streaming.StreamingISTFT(256, 256, window="boxcar", batch=1)
    y = X[:1, : 256 * 6]
    S = tap.stft(y, n_fft=256, hop_length=256, window="boxcar", center=False).transpose(1, 2)
    out = inv.push(S)
    assert inv.flush().shape == (1, 0)
    assert max_abs(out, y) <= 1e-5
    assert inv.carry is None


def _offline_mel(x, center=False, **kw):
    return tap.melspectrogram(x, sr=SR, n_fft=N_FFT, hop_length=HOP, center=center, **kw)


@pytest.mark.parametrize("chunk_hops", [2, 8])
def test_streaming_logmel_and_mfcc_match_offline_and_jax(chunk_hops, port_route):
    c = chunk_hops * HOP
    got = stream(tap.streaming.StreamingLogMel(SR, N_FFT, HOP, n_mels=40, batch=2), X, c)
    off = tap.power_to_db(_offline_mel(primed(X), n_mels=40), top_db=None).transpose(1, 2)
    assert got.shape == (2, 48, 40) and max_rel(got, off) <= 1e-5
    ref = jax_stream(js.StreamingLogMel(SR, N_FFT, HOP, n_mels=40, batch=2), X, c)
    assert max_rel(got, ref) <= 1e-5
    got = stream(tap.streaming.StreamingMFCC(SR, N_FFT, HOP, n_mfcc=13, n_mels=40, lifter=22,
                                             batch=2), X, c)
    mel_db = tap.power_to_db(_offline_mel(primed(X), n_mels=40), top_db=None)
    off = tap.mfcc(S=mel_db, n_mfcc=13, lifter=22).transpose(1, 2)
    assert got.shape == (2, 48, 13) and max_rel(got, off) <= 1e-5
    ref = jax_stream(js.StreamingMFCC(SR, N_FFT, HOP, n_mfcc=13, n_mels=40, lifter=22, batch=2), X, c)
    assert max_rel(got, ref) <= 1e-5


@pytest.mark.parametrize("tuning", [0.0, 0.3])
def test_streaming_chroma_matches_offline_and_jax(tuning, port_route):
    got = stream(tap.streaming.StreamingChroma(SR, N_FFT, HOP, tuning=tuning, batch=2), TONAL, 4 * HOP)
    off = tap.chroma_stft(y=primed(TONAL), sr=SR, n_fft=N_FFT, hop_length=HOP, center=False,
                          tuning=tuning).transpose(1, 2)
    assert got.shape == (2, 48, 12) and max_abs(got, off) <= 2e-7
    ref = jax_stream(js.StreamingChroma(SR, N_FFT, HOP, tuning=tuning, batch=2), TONAL, 4 * HOP)
    assert max_abs(got, ref) <= 2e-6


@pytest.mark.parametrize("kw", [{}, dict(gain=0.8, bias=10.0, power=0.25, time_constant=0.1)],
                         ids=["default", "agc"])
def test_streaming_pcen_matches_offline_and_jax(kw, port_route):
    got = stream(tap.streaming.StreamingPCEN(SR, N_FFT, HOP, n_mels=40, batch=2, **kw), X, 4 * HOP)
    M = _offline_mel(primed(X), n_mels=40)
    off = tap.pcen(M, sr=SR, hop_length=HOP, **kw).transpose(1, 2)
    assert got.shape == (2, 48, 40) and max_rel(got, off) <= 1e-5
    ref = jax_stream(js.StreamingPCEN(SR, N_FFT, HOP, n_mels=40, batch=2, **kw), X, 4 * HOP)
    assert max_rel(got, ref) <= 1e-5


def test_filterbank_streams_reset():
    for cls in (tap.streaming.StreamingLogMel, tap.streaming.StreamingPCEN):
        s = cls(SR, N_FFT, HOP, n_mels=20)
        a = s.push(X[0, : 4 * HOP])
        s.push(X[0, 4 * HOP : 8 * HOP])
        s.reset()
        np.testing.assert_array_equal(to_np(s.push(X[0, : 4 * HOP])), to_np(a))


@pytest.mark.parametrize("kw", [dict(frame_length=2048, hop_length=512),
                                dict(frame_length=1024, hop_length=256, fmin=80.0, fmax=1000.0)],
                         ids=["2048-512", "1024-256"])
def test_streaming_pitch_matches_offline_and_jax(kw):
    hop = kw["hop_length"]
    y = np.tile(TONAL, (1, 4))[:, : 24 * hop * 2]
    p = tap.streaming.StreamingPitch(sr=SR, batch=2, **kw)
    outs = [p.push(y[:, i : i + 4 * hop]) for i in range(0, y.shape[1], 4 * hop)]
    f0, voiced = torch.cat([o[0] for o in outs], 1), torch.cat([o[1] for o in outs], 1)
    f0_off, v_off = tap.pitch_detect_acf(primed(y, kw["frame_length"] - hop), sr=SR, center=False, **kw)
    np.testing.assert_array_equal(to_np(voiced), to_np(v_off))
    np.testing.assert_array_equal(to_np(f0), to_np(f0_off))
    assert voiced.float().mean() > 0.9
    jp = js.StreamingPitch(sr=SR, batch=2, **kw)
    jouts = [jp.push(y[:, i : i + 4 * hop]) for i in range(0, y.shape[1], 4 * hop)]
    np.testing.assert_array_equal(to_np(voiced), np.concatenate([np.asarray(o[1]) for o in jouts], 1))
    # the JAX package's sr / period rounds differently in the last bit
    np.testing.assert_allclose(to_np(f0), np.concatenate([np.asarray(o[0]) for o in jouts], 1),
                               rtol=2e-7)


@pytest.mark.parametrize("up,down,chunk", [(160, 441, 441 * 8), (2, 1, 64), (1, 3, 3 * 50), (3, 3, 99)])
def test_streaming_resample_matches_resample_poly(up, down, chunk):
    x = signals(132, (2, 441 * 40))
    r = tap.streaming.StreamingResample(up, down, batch=2)
    got = torch.cat([r.push(x[:, i : i + chunk]) for i in range(0, x.shape[1], chunk)] + [r.flush()], 1)
    ref = to_np(tap.resample_poly(x, up, down, padtype="constant"))
    assert got.shape == ref.shape
    np.testing.assert_array_less(np.abs(to_np(got) - ref), 2e-6 + 1e-5 * np.abs(ref) + 1e-12)
    rj = js.StreamingResample(up, down, batch=2)
    jref = np.concatenate([np.asarray(rj.push(x[:, i : i + chunk])) for i in range(0, x.shape[1], chunk)]
                          + [np.asarray(rj.flush())], 1)
    assert max_abs(got, jref) <= 2e-6


def test_streaming_resample_first_chunk_too_short_raises_as_in_jax():
    with pytest.raises(ValueError) as e_port:
        tap.streaming.StreamingResample(1, 441).push(X[:1, :441])
    with pytest.raises(ValueError) as e_jax:
        js.StreamingResample(1, 441).push(X[:1, :441])
    assert str(e_port.value) == str(e_jax.value)


def test_streaming_names_match_jax():
    assert st.__all__ == [n for n in st.__all__ if hasattr(js, n)]
    for name in st.__all__:
        assert callable(getattr(tap.streaming, name))
