"""WAV audio file I/O (PCM 16/24/32 and IEEE float32) and ``load``.

Counterpart of `mlx_audio_primitives_tpu/utils/audio_io.py`, in NumPy on
the host, with the same native/fallback split: the C++ reader/writer
(`csrc/wavio.cpp`, the port's copy, loaded by `_native.py`) is the fast
path for bulk decode, and a pure-NumPy RIFF implementation is both the
always-available fallback and the oracle the tests hold the native codec
to, bit for bit. :func:`load` resamples with the port's ``resample`` on the
default device (the card unless the caller chose the CPU) and returns
NumPy, as the JAX package's ``load`` does.

Conventions (soundfile-compatible):

* `read_wav` returns float32 in [-1, 1): PCM samples scale by 2^(bits-1);
  shape `(frames,)` mono / `(channels, frames)` otherwise.
* `write_wav` accepts float `(frames,)` or `(channels, frames)`;
  `bits=16/24` write integer PCM (values clipped to [-1, 1]), `bits=32`
  writes IEEE float32 verbatim.
"""

from __future__ import annotations

import os
import struct
from typing import Any

import numpy as np

__all__ = ["read_wav", "write_wav", "wav_info", "to_mono", "get_duration", "load"]

_PCM = 1
_IEEE_FLOAT = 3
_EXTENSIBLE = 0xFFFE


def _parse_chunks(buf: bytes):
    """Yield (chunk_id, offset, size) for every top-level RIFF chunk."""
    if len(buf) < 12 or buf[:4] != b"RIFF" or buf[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    while pos + 8 <= len(buf):
        cid = buf[pos:pos + 4]
        (size,) = struct.unpack_from("<I", buf, pos + 4)
        body = pos + 8
        if body + size > len(buf):
            # tolerate a truncated FINAL data chunk (common with streamed
            # writers that never fixed up the header) but nothing else
            if cid == b"data":
                size = len(buf) - body
            else:
                raise ValueError(f"truncated chunk {cid!r}")
        yield cid, body, size
        pos = body + size + (size & 1)  # chunks pad to even offsets


def _parse_fmt(buf: bytes, off: int, size: int):
    if size < 16:
        raise ValueError("fmt chunk too short")
    fmt, channels, sr, _, _, bits = struct.unpack_from("<HHIIHH", buf, off)
    if fmt == _EXTENSIBLE:
        if size < 40:
            raise ValueError("extensible fmt chunk too short")
        (sub,) = struct.unpack_from("<H", buf, off + 24)
        fmt = sub
    if channels < 1:
        raise ValueError("channel count must be >= 1")
    return fmt, channels, sr, bits


def _scan_header(f) -> tuple[tuple, int]:
    """Seek-based header scan of an open binary file: returns
    ``(fmt_tuple, data_size)`` for the FIRST data chunk without loading
    chunk bodies (a multi-GB file costs a few small reads). Mirrors
    :func:`_parse_chunks` semantics, including the tolerated truncated
    final data chunk."""
    f.seek(0, os.SEEK_END)
    fsize = f.tell()
    f.seek(0)
    head = f.read(12)
    if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    fmt = None
    data_size = None
    pos = 12
    while pos + 8 <= fsize:
        f.seek(pos)
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid = hdr[:4]
        (size,) = struct.unpack("<I", hdr[4:])
        body = pos + 8
        if body + size > fsize:
            if cid == b"data":
                size = fsize - body
            else:
                raise ValueError(f"truncated chunk {cid!r}")
        if cid == b"fmt ":
            chunk = f.read(min(size, 64))
            fmt = _parse_fmt(chunk, 0, size)
        elif cid == b"data" and data_size is None:
            data_size = size
        pos = body + size + (size & 1)
    if fmt is None or data_size is None:
        raise ValueError("missing fmt or data chunk")
    return fmt, data_size


def wav_info(path: str | os.PathLike) -> dict[str, Any]:
    """Header-only probe: ``{"sr", "channels", "frames", "bits", "format"}``
    where format is ``"pcm"`` or ``"float"``. Reads only chunk headers (the
    data payload is never loaded); like :func:`read_wav`, the FIRST data
    chunk is the file's audio."""
    with open(path, "rb") as f:
        fmt, data_size = _scan_header(f)
    kind, channels, sr, bits = fmt
    if kind not in (_PCM, _IEEE_FLOAT):
        raise ValueError(f"unsupported WAVE format tag {kind}")
    if bits not in (16, 24, 32):
        raise ValueError(f"unsupported bit depth {bits}")
    if kind == _IEEE_FLOAT and bits != 32:
        raise ValueError("IEEE-float WAVE must be 32-bit")
    bytes_per = channels * (bits // 8)
    return {
        "sr": sr,
        "channels": channels,
        "frames": data_size // bytes_per,
        "bits": bits,
        "format": "float" if kind == _IEEE_FLOAT else "pcm",
    }


def _decode(raw: np.ndarray, kind: int, bits: int) -> np.ndarray:
    """Interleaved sample bytes -> float32 in [-1, 1)."""
    if kind == _IEEE_FLOAT:
        return raw.view("<f4").astype(np.float32)
    if bits == 16:
        return raw.view("<i2").astype(np.float32) / 32768.0
    if bits == 32:
        return raw.view("<i4").astype(np.float32) / 2147483648.0
    # 24-bit: sign-extend each 3-byte little-endian triple through int32
    b = raw.reshape(-1, 3).astype(np.uint32)
    val = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    val = val.astype(np.int32)
    val = np.where(val >= 1 << 23, val - (1 << 24), val)
    return val.astype(np.float32) / 8388608.0


def read_wav(
    path: str | os.PathLike,
    always_2d: bool = False,
    use_native: bool | None = None,
) -> tuple[np.ndarray, int]:
    """Read a WAV file -> ``(data, sample_rate)``.

    ``data`` is float32 in [-1, 1): ``(frames,)`` for mono (unless
    ``always_2d``), else ``(channels, frames)``. ``use_native`` follows the
    house tri-state: None = auto (native when available), False = force the
    NumPy path, True = require the native codec to be present (a file the
    codec rejects still surfaces the NumPy parser's precise ValueError —
    the two codecs accept exactly the same formats).
    """
    from .._native import has_native_wav, native_wav_read

    path = os.fspath(path)
    if use_native or (use_native is None and has_native_wav()):
        if use_native and not has_native_wav():
            raise RuntimeError("native WAV codec unavailable")
        out = native_wav_read(path)
        if out is not None:
            data, sr, channels = out
            return _layout(data, channels, always_2d), sr
        # the native codec rejected the file: fall through so the NumPy
        # parser raises its descriptive ValueError for the same defect

    with open(path, "rb") as f:
        buf = f.read()
    fmt = None
    data_off = data_size = None
    for cid, off, size in _parse_chunks(buf):
        if cid == b"fmt ":
            fmt = _parse_fmt(buf, off, size)
        elif cid == b"data" and data_off is None:
            data_off, data_size = off, size
    if fmt is None or data_off is None:
        raise ValueError("missing fmt or data chunk")
    kind, channels, sr, bits = fmt
    if kind not in (_PCM, _IEEE_FLOAT):
        raise ValueError(f"unsupported WAVE format tag {kind}")
    if bits not in (16, 24, 32) or (kind == _IEEE_FLOAT and bits != 32):
        raise ValueError(f"unsupported bit depth {bits}")
    bytes_per = channels * (bits // 8)
    n_frames = data_size // bytes_per
    raw = np.frombuffer(
        buf, np.uint8, count=n_frames * bytes_per, offset=data_off
    )
    data = _decode(raw, kind, bits)
    return _layout(data, channels, always_2d), sr


def _layout(flat: np.ndarray, channels: int, always_2d: bool) -> np.ndarray:
    out = flat.reshape(-1, channels).T  # (channels, frames)
    if channels == 1 and not always_2d:
        return np.ascontiguousarray(out[0])
    return np.ascontiguousarray(out)


def _encode(data: np.ndarray, bits: int) -> tuple[bytes, int]:
    """Float (frames, channels) interleaved -> (sample bytes, format tag)."""
    if bits == 32:
        return data.astype("<f4").tobytes(), _IEEE_FLOAT
    # NaN -> 0 keeps PCM encoding deterministic (and byte-identical to the
    # native codec, whose lrint(NaN) would otherwise be unspecified)
    clipped = np.clip(np.nan_to_num(data, nan=0.0, posinf=1.0, neginf=-1.0),
                      -1.0, 1.0)
    if bits == 16:
        scaled = np.round(clipped.astype(np.float64) * 32767.0)
        return scaled.astype("<i2").tobytes(), _PCM
    # 24-bit PCM: int32 scale, emit low 3 bytes of each sample
    scaled = np.round(clipped.astype(np.float64) * 8388607.0).astype(np.int32)
    as_u32 = scaled.reshape(-1).astype("<i4").view("<u4")
    b = np.empty((as_u32.size, 3), np.uint8)
    b[:, 0] = as_u32 & 0xFF
    b[:, 1] = (as_u32 >> 8) & 0xFF
    b[:, 2] = (as_u32 >> 16) & 0xFF
    return b.tobytes(), _PCM


def write_wav(
    path: str | os.PathLike,
    data: np.ndarray,
    sr: int,
    bits: int = 16,
    use_native: bool | None = None,
) -> None:
    """Write ``data`` (``(frames,)`` or ``(channels, frames)`` float) as WAV.

    ``bits``: 16/24 = integer PCM (input clipped to [-1, 1]; NaN encodes as
    0), 32 = IEEE float32 verbatim. ``use_native`` as in :func:`read_wav`.
    """
    if bits not in (16, 24, 32):
        raise ValueError(f"bits must be 16, 24 or 32, got {bits}")
    if sr <= 0:
        raise ValueError(f"sample rate must be positive, got {sr}")
    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        data = data[None]
    if data.ndim != 2:
        raise ValueError(f"data must be 1-D or 2-D, got shape {data.shape}")
    channels, frames = data.shape
    interleaved = np.ascontiguousarray(data.T)  # (frames, channels)

    from .._native import has_native_wav, native_wav_write

    path = os.fspath(path)
    if use_native and not has_native_wav():
        raise RuntimeError("native WAV codec unavailable")
    if use_native or (use_native is None and has_native_wav()):
        if native_wav_write(path, interleaved, sr, bits):
            return

    payload, tag = _encode(interleaved, bits)
    block = channels * (bits // 8)
    fact = b""
    if tag == _IEEE_FLOAT:
        fact = struct.pack("<4sII", b"fact", 4, frames)
    # the RIFF size counts the data chunk's pad byte (chunks align to even)
    padded = len(payload) + (len(payload) & 1)
    header = struct.pack(
        "<4sI4s4sIHHIIHH",
        b"RIFF",
        4 + 8 + 16 + len(fact) + 8 + padded,
        b"WAVE",
        b"fmt ",
        16,
        tag,
        channels,
        sr,
        sr * block,
        block,
        bits,
    )
    with open(path, "wb") as f:
        f.write(header)
        f.write(fact)
        f.write(struct.pack("<4sI", b"data", len(payload)))
        f.write(payload)
        if len(payload) & 1:
            f.write(b"\x00")


def to_mono(y: Any) -> np.ndarray:
    """Average a ``(channels, frames)`` signal down to ``(frames,)``
    (librosa `to_mono`); 1-D input passes through."""
    y = np.asarray(y, dtype=np.float32)
    if y.ndim == 1:
        return y
    if y.ndim == 2:
        return y.mean(axis=0).astype(np.float32)
    raise ValueError(f"to_mono expects 1-D or (channels, frames), got {y.ndim}-D")


def get_duration(
    y: Any | None = None,
    sr: int = 22050,
    path: str | os.PathLike | None = None,
) -> float:
    """Duration in seconds of a signal or a WAV file (librosa
    `get_duration` subset: from ``y`` + ``sr``, or header-only from
    ``path``)."""
    if path is not None:
        info = wav_info(path)
        return info["frames"] / float(info["sr"])
    if y is None:
        raise ValueError("Either y or path must be provided")
    return int(np.asarray(y).shape[-1]) / float(sr)


def load(
    path: str | os.PathLike,
    sr: int | None = 22050,
    mono: bool = True,
    offset: float = 0.0,
    duration: float | None = None,
    res_type: str = "kaiser_best",
    use_native: bool | None = None,
):
    """Load a WAV file -> ``(y, sr)`` — the librosa `load` entry point
    for this package's codec: decode (native C++ or NumPy RIFF parser),
    optional mono mixdown, optional ``offset``/``duration`` cropping, and
    resampling to ``sr`` (``sr=None`` keeps the file's rate). ``y`` is
    float32 in [-1, 1). ``res_type`` defaults to the 'kaiser_best'
    polyphase design (:func:`~.ops.resample.resample`) — this matches
    resampy / librosa < 0.10 (librosa >= 0.10 defaults to 'soxr_hq',
    which has no in-tree equivalent); pass 'fft' for the spectrum-surgery
    method. The resampling runs on the default device (``cuda`` unless the
    caller set another, raising without a CUDA device); ``y`` comes back as
    NumPy.
    """
    y, file_sr = read_wav(path, use_native=use_native)
    if mono:
        y = to_mono(y)
    if offset < 0:
        raise ValueError(f"offset must be non-negative, got {offset}")
    if offset or duration is not None:
        start = int(np.round(offset * file_sr))
        if start > y.shape[-1]:
            raise ValueError(
                f"offset {offset}s is past the end of the file "
                f"({y.shape[-1] / file_sr:.3f}s)"
            )
        stop = (
            y.shape[-1] if duration is None
            else min(y.shape[-1], start + int(np.round(duration * file_sr)))
        )
        y = y[..., start:stop]
    if sr is not None and sr != file_sr and y.shape[-1]:
        from ..ops.resample import resample as _resample

        # on the default device, back to NumPy, as the JAX package's np.asarray
        y = _resample(y, file_sr, sr, res_type=res_type).cpu().numpy()
        file_sr = sr
    elif sr is not None:
        file_sr = sr
    return y, file_sr
