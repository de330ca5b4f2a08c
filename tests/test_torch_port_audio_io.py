"""PyTorch port: WAV I/O and ``load`` (`utils/audio_io.py`).

The port's codecs against the JAX package's on the same files: the bytes
``write_wav`` writes (native and NumPy, 16/24/32-bit, mono and stereo)
equal the JAX package's NumPy codec's; ``read_wav`` / ``wav_info`` equal
the JAX package's; ``load`` equals the JAX ``load`` bit for bit without
resampling and within the resampling contract (kaiser 2e-5) with it. The
NumPy RIFF codec is the oracle of the native one, as in the JAX package's
`tests/test_audio_io.py`, whose cases are mirrored here.
"""

from __future__ import annotations

import io
import struct
import wave

import numpy as np
import pytest
import torch
import torch_port_util  # noqa: F401  (CPU placement, one thread)

import mlx_audio_primitives_tpu.utils.audio_io as jio
import mlx_audio_primitives_tpu_torch as tap
from mlx_audio_primitives_tpu_torch import _native as tnat
from mlx_audio_primitives_tpu_torch.utils import audio_io as tio


def _sig(frames=1000, channels=1, seed=0):
    rng = np.random.default_rng(seed)
    x = 0.7 * np.sin(2 * np.pi * 440 * np.arange(frames) / 16000)
    x = x[None] + 0.1 * rng.standard_normal((channels, frames))
    return np.clip(x, -1, 1).astype(np.float32)


def _no_native(monkeypatch) -> None:
    monkeypatch.setattr(tnat, "_loaded", True)
    monkeypatch.setattr(tnat, "_lib", None)


def test_native_codec_is_present():
    assert tnat.has_native_wav()


@pytest.mark.parametrize("bits", [16, 24, 32])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("use_native", [True, False])
def test_written_bytes_equal_jax(tmp_path, bits, channels, use_native):
    x = _sig(frames=1001, channels=channels, seed=bits)  # odd payloads pad
    x = x if channels > 1 else x[0]
    tio.write_wav(tmp_path / "port.wav", x, 16000, bits=bits, use_native=use_native)
    jio.write_wav(tmp_path / "jax.wav", x, 16000, bits=bits, use_native=False)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()


@pytest.mark.parametrize("bits", [16, 24, 32])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("use_native", [True, False])
def test_read_equals_jax(tmp_path, bits, channels, use_native):
    p = tmp_path / "a.wav"
    jio.write_wav(p, _sig(channels=channels, seed=7), 22050, bits=bits, use_native=False)
    got, sr = tio.read_wav(p, use_native=use_native)
    ref, sr_ref = jio.read_wav(p, use_native=False)
    assert sr == sr_ref == 22050 and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert tio.wav_info(p) == jio.wav_info(p)


# quantization bound: |round(x*(S-1))/S - x| <= 1.5/S for |x| <= 1
@pytest.mark.parametrize("bits,tol", [(16, 2 ** -14), (24, 2 ** -22), (32, 0.0)])
@pytest.mark.parametrize("channels", [1, 2])
def test_roundtrip(tmp_path, bits, tol, channels):
    x = _sig(channels=channels)
    p = tmp_path / f"t{bits}_{channels}.wav"
    tio.write_wav(p, x if channels > 1 else x[0], 16000, bits=bits)
    y, sr = tio.read_wav(p)
    assert sr == 16000
    assert y.shape == ((1000,) if channels == 1 else (channels, 1000))
    np.testing.assert_allclose(y if channels > 1 else y[None], x, atol=tol)
    assert tio.wav_info(p) == {"sr": 16000, "channels": channels, "frames": 1000, "bits": bits,
                               "format": "float" if bits == 32 else "pcm"}


def test_always_2d(tmp_path):
    p = tmp_path / "m.wav"
    tio.write_wav(p, _sig()[0], 8000)
    y, _ = tio.read_wav(p, always_2d=True)
    assert y.shape == (1, 1000)


def test_stdlib_wave_interop(tmp_path):
    x = _sig()[0]
    p = tmp_path / "w.wav"
    tio.write_wav(p, x, 22050, bits=16)
    with wave.open(str(p)) as w:
        assert (w.getframerate(), w.getnchannels(), w.getsampwidth()) == (22050, 1, 2)
        raw = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    np.testing.assert_array_equal(raw, np.round(x.astype(np.float64) * 32767.0).astype(np.int16))
    p2 = tmp_path / "w2.wav"
    with wave.open(str(p2), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(22050)
        w.writeframes(raw.tobytes())
    y, sr = tio.read_wav(p2)
    assert sr == 22050
    np.testing.assert_array_equal(y, raw.astype(np.float32) / 32768.0)


@pytest.mark.parametrize("bits", [16, 24, 32])
def test_native_matches_numpy(tmp_path, bits):
    x = _sig(channels=2, seed=3)
    pn, pf = tmp_path / "native.wav", tmp_path / "numpy.wav"
    tio.write_wav(pn, x, 44100, bits=bits, use_native=True)
    tio.write_wav(pf, x, 44100, bits=bits, use_native=False)
    assert pn.read_bytes() == pf.read_bytes()
    yn, srn = tio.read_wav(pn, use_native=True)
    yf, srf = tio.read_wav(pn, use_native=False)
    assert srn == srf == 44100
    np.testing.assert_array_equal(yn, yf)


def test_clipping_on_write(tmp_path):
    p = tmp_path / "c.wav"
    tio.write_wav(p, np.asarray([2.0, -2.0, 0.0], np.float32), 8000, bits=16)
    y, _ = tio.read_wav(p)
    np.testing.assert_allclose(y, [32767 / 32768, -32767 / 32768, 0.0])


@pytest.mark.parametrize("use_native", [True, False])
def test_extensible_format_reads(tmp_path, use_native):
    x = np.round(_sig()[0].astype(np.float64) * 32767).astype("<i2")
    payload = x.tobytes()
    fmt = (struct.pack("<HHIIHH", 0xFFFE, 1, 16000, 32000, 2, 16) + struct.pack("<HHI", 22, 16, 0)
           + struct.pack("<H", 1) + b"\x00" * 14)
    buf = io.BytesIO()
    buf.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(payload)) + b"WAVE")
    buf.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
    buf.write(b"data" + struct.pack("<I", len(payload)) + payload)
    p = tmp_path / "ext.wav"
    p.write_bytes(buf.getvalue())
    y, sr = tio.read_wav(p, use_native=use_native)
    assert sr == 16000
    np.testing.assert_array_equal(y, x.astype(np.float32) / 32768.0)


def test_skips_extra_chunks(tmp_path):
    p = tmp_path / "x.wav"
    tio.write_wav(p, np.asarray([0.25, -0.25], np.float32), 8000, bits=16)
    raw = p.read_bytes()
    fmt_end = 12 + 8 + 16
    extra = b"LIST" + struct.pack("<I", 5) + b"INFOx" + b"\x00"
    patched = raw[:fmt_end] + extra + raw[fmt_end:]
    patched = patched[:4] + struct.pack("<I", len(patched) - 8) + patched[8:]
    p2 = tmp_path / "x2.wav"
    p2.write_bytes(patched)
    y, _ = tio.read_wav(p2, use_native=False)
    np.testing.assert_allclose(y, [0.25, -0.25], atol=2 ** -15)
    np.testing.assert_array_equal(tio.read_wav(p2, use_native=True)[0], y)


@pytest.mark.parametrize("blob,err", [
    (b"RIFX" + b"\x00" * 20, "RIFF"),
    (b"RIFF" + struct.pack("<I", 4) + b"AIFF", "RIFF"),
    (b"RIFF" + struct.pack("<I", 40) + b"WAVE" + b"fmt " + struct.pack("<I", 16)
     + struct.pack("<HHIIHH", 1, 1, 8000, 8000, 1, 8) + b"data" + struct.pack("<I", 0), "bit depth"),
])
@pytest.mark.parametrize("use_native", [True, False])
def test_malformed_raises(tmp_path, blob, err, use_native):
    # a format the native codec rejects surfaces the NumPy parser's error
    p = tmp_path / "bad.wav"
    p.write_bytes(blob)
    with pytest.raises(ValueError, match=err):
        tio.read_wav(p, use_native=use_native)


def test_truncated_final_data_chunk_tolerated(tmp_path):
    p = tmp_path / "t.wav"
    tio.write_wav(p, np.zeros(100, np.float32), 8000, bits=16)
    p.write_bytes(p.read_bytes()[:-50])
    y, _ = tio.read_wav(p, use_native=False)
    assert y.shape == (75,)
    np.testing.assert_array_equal(tio.read_wav(p, use_native=True)[0], y)
    np.testing.assert_array_equal(jio.read_wav(p, use_native=False)[0], y)


def test_write_validation(tmp_path):
    with pytest.raises(ValueError, match="bits"):
        tio.write_wav(tmp_path / "a.wav", np.zeros(4), 8000, bits=8)
    with pytest.raises(ValueError, match="sample rate"):
        tio.write_wav(tmp_path / "a.wav", np.zeros(4), 0)
    with pytest.raises(ValueError, match="1-D or 2-D"):
        tio.write_wav(tmp_path / "a.wav", np.zeros((1, 2, 3)), 8000)
    with pytest.raises(OSError):
        tio.read_wav(tmp_path / "nope.wav")


@pytest.mark.parametrize("use_native", [True, False])
def test_riff_size_counts_pad_byte(tmp_path, use_native):
    p = tmp_path / "odd.wav"
    tio.write_wav(p, np.zeros(3, np.float32), 8000, bits=24, use_native=use_native)
    raw = p.read_bytes()
    assert len(raw) == 8 + struct.unpack_from("<I", raw, 4)[0]


def test_nan_inf_encode_deterministically(tmp_path):
    x = np.asarray([np.nan, np.inf, -np.inf, 0.5], np.float32)
    pf, pn = tmp_path / "nan_numpy.wav", tmp_path / "nan_native.wav"
    tio.write_wav(pf, x, 8000, bits=16, use_native=False)
    tio.write_wav(pn, x, 8000, bits=16, use_native=True)
    y, _ = tio.read_wav(pf, use_native=False)
    np.testing.assert_allclose(y, [0.0, 32767 / 32768, -32767 / 32768, 0.5], atol=2 ** -14)
    assert pn.read_bytes() == pf.read_bytes()


def test_first_data_chunk_and_missing_data(tmp_path):
    p = tmp_path / "a.wav"
    tio.write_wav(p, np.zeros(10, np.float32), 8000, bits=16)
    raw = p.read_bytes() + b"data" + struct.pack("<I", 4) + b"\x00" * 4
    raw = raw[:4] + struct.pack("<I", len(raw) - 8) + raw[8:]
    p2 = tmp_path / "b.wav"
    p2.write_bytes(raw)
    assert tio.wav_info(p2)["frames"] == 10
    assert tio.read_wav(p2, use_native=False)[0].shape == tio.read_wav(p2, use_native=True)[0].shape == (10,)
    nodata = (b"RIFF" + struct.pack("<I", 4 + 24) + b"WAVE" + b"fmt " + struct.pack("<I", 16)
              + struct.pack("<HHIIHH", 1, 1, 8000, 16000, 2, 16))
    p3 = tmp_path / "nodata.wav"
    p3.write_bytes(nodata)
    with pytest.raises(ValueError, match="data"):
        tio.wav_info(p3)
    with pytest.raises(ValueError, match="data"):
        tio.read_wav(p3, use_native=False)


def test_use_native_true_without_the_codec_raises(monkeypatch, tmp_path):
    p = tmp_path / "a.wav"
    tio.write_wav(p, np.zeros(10, np.float32), 8000)
    _no_native(monkeypatch)
    with pytest.raises(RuntimeError, match="native WAV codec unavailable"):
        tio.read_wav(p, use_native=True)
    with pytest.raises(RuntimeError, match="native WAV codec unavailable"):
        tio.write_wav(tmp_path / "b.wav", np.zeros(10, np.float32), 8000, use_native=True)
    # auto falls back to the NumPy codec, with the same bytes
    tio.write_wav(tmp_path / "c.wav", np.zeros(10, np.float32), 8000)
    assert (tmp_path / "c.wav").read_bytes() == p.read_bytes()
    np.testing.assert_array_equal(tio.read_wav(p)[0], np.zeros(10, np.float32))


class TestLoad:
    @pytest.mark.parametrize("channels,mono", [(1, True), (2, True), (2, False)])
    def test_load_without_resampling_equals_jax(self, tmp_path, channels, mono):
        p = tmp_path / "a.wav"
        x = (0.25 * np.random.default_rng(1).standard_normal((channels, 1000))).astype(np.float32)
        tio.write_wav(p, x, 22050, bits=32)
        got, sr = tio.load(p, sr=None, mono=mono)
        ref, sr_ref = jio.load(p, sr=None, mono=mono)
        assert sr == sr_ref == 22050 and got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
        got, _ = tio.load(p, sr=22050, mono=mono)  # the file's rate: no resampling
        np.testing.assert_array_equal(got, ref)

    @pytest.mark.parametrize("orig_sr,target_sr,channels", [(44100, 22050, 2), (22050, 16000, 1)])
    def test_load_resamples_as_jax(self, tmp_path, orig_sr, target_sr, channels):
        # kaiser_best, the default: the contract's 2e-5 against the JAX load
        t = np.arange(orig_sr // 10) / orig_sr
        x = np.stack([0.5 * np.sin(2 * np.pi * f * t) for f in (440.0, 1234.5)[:channels]])
        p = tmp_path / "b.wav"
        tio.write_wav(p, x.astype(np.float32), orig_sr, bits=32)
        got, sr = tio.load(p, sr=target_sr)
        ref, sr_ref = jio.load(p, sr=target_sr)
        assert sr == sr_ref == target_sr
        assert isinstance(got, np.ndarray) and got.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)

    def test_offset_duration(self, tmp_path):
        y = np.arange(1000, dtype=np.float32) / 2000.0
        p = tmp_path / "d.wav"
        tio.write_wav(p, y, 1000, bits=32)
        out, _ = tio.load(p, sr=None, offset=0.25, duration=0.5)
        np.testing.assert_array_equal(out, y[250:750])
        np.testing.assert_array_equal(out, jio.load(p, sr=None, offset=0.25, duration=0.5)[0])
        with pytest.raises(ValueError, match="past the end"):
            tio.load(p, sr=None, offset=5.0)
        with pytest.raises(ValueError, match="non-negative"):
            tio.load(p, sr=None, offset=-1.0)

    def test_get_duration_and_to_mono(self, tmp_path):
        y = np.zeros(4410, np.float32)
        p = tmp_path / "e.wav"
        tio.write_wav(p, y, 22050)
        assert tio.get_duration(path=p) == jio.get_duration(path=p) == 0.2
        assert tio.get_duration(y=y, sr=22050) == 0.2
        st = np.random.default_rng(2).standard_normal((2, 5)).astype(np.float32)
        np.testing.assert_array_equal(tio.to_mono(st), jio.to_mono(st))
        with pytest.raises(ValueError):
            tio.get_duration()
        with pytest.raises(ValueError, match="1-D or"):
            tio.to_mono(np.zeros((1, 2, 3)))

    def test_resampling_load_needs_the_default_device(self, tmp_path):
        # NumPy in, NumPy out, but the resampling runs on the default
        # device: with ``cuda`` there and no card, load raises
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the raise needs its absence")
        p = tmp_path / "f.wav"
        tio.write_wav(p, np.zeros(441, np.float32), 44100, bits=32)
        tap.set_default_device("cuda")
        try:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tio.load(p, sr=22050)
            assert tio.load(p, sr=None)[0].shape == (441,)  # no device needed
        finally:
            tap.set_default_device("cpu")
