"""Optional native (C++) table builders and WAV codec, loaded via ctypes.

Counterpart of `mlx_audio_primitives_tpu/_native.py`, with the same
contract: build the library once if a toolchain exists, run a live smoke
call (the ABI version, then one window) before trusting it, and fall back
silently to the NumPy builders on any failure; ``HAS_NATIVE`` says which
path is active, and a library that lacks a builder's symbol degrades that
builder alone. ``MLX_AUDIO_TPU_NO_NATIVE_BUILD=1`` forbids the build (a
library built earlier still loads).

The port keeps its own copies of the sources (``csrc/tables.cpp``,
``csrc/wavio.cpp``) and builds them with one ``g++`` call into
``build/torch_tables/<source hash>/`` beside the package, behind a file
lock so that concurrent processes build once; the library appears there by
an atomic rename, so a failed build leaves none. Unlike the JAX package,
which builds while it is imported, the port builds on first use: the first
table a cache misses, the first WAV read or write, or the first read of
``HAS_NATIVE``.

The native layer covers host float64 table math (windows, the mel scale,
the mel, bark and linear filterbanks, the DCT basis) and WAV decode/encode;
it never touches a kernel or the device.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("tables.cpp", "wavio.cpp")
BUILD_ROOT = Path(__file__).resolve().parents[1] / "build" / "torch_tables"
LIB_NAME = "libmapt_tables.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
ABI_VERSION = 2

_WINDOW_KINDS = {
    "hann": 0,
    "hamming": 1,
    "blackman": 2,
    "bartlett": 3,
    "rectangular": 4,
    "kaiser": 5,
}

_lock = threading.Lock()
_loaded = False
_lib: ctypes.CDLL | None = None
#: What loading found: the library's path, the seconds g++ took (0.0 when an
#: earlier build was reused), and why the NumPy path is active, if it is.
build_info: dict = {}

_F64P = ctypes.POINTER(ctypes.c_double)
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32, _I64, _F64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_double

#: the C functions, their argument types, and whether the library may lack
#: them (a builder or the codec added after the first ABI 2 build)
_SIGNATURES = {
    "mapt_abi_version": ((), False),
    "mapt_window": ((_I32, _I64, _I32, _F64, _F64P), False),
    "mapt_hz_to_mel": ((_F64P, _I64, _I32, _F64P), False),
    "mapt_mel_to_hz": ((_F64P, _I64, _I32, _F64P), False),
    "mapt_mel_filterbank": ((_I32, _I32, _I32, _F64, _F64, _I32, _I32, _F64P), False),
    "mapt_dct_basis_t": ((_I32, _I32, _I32, _F64P), False),
    "mapt_bark_filterbank": ((_I32, _I32, _I32, _F64, _F64, _I32, _I32, _F64P), True),
    "mapt_linear_filterbank": ((_I32, _I32, _I32, _F64, _F64, _I32, _F64P), True),
    "mapt_wav_info": ((ctypes.c_char_p, _I64P, _I32P, _I32P, _I32P, _I32P), True),
    "mapt_wav_read_f32": ((ctypes.c_char_p, _F32P, _I64, _I64P, _I32P), True),
    "mapt_wav_write": ((ctypes.c_char_p, _F32P, _I64, _I32, _I32, _I32), True),
}


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path | None:
    """The library's path, compiled unless this source hash was built
    before; None when there is no library and no build is allowed or
    possible (``build_info["error"]`` says why)."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    if os.environ.get("MLX_AUDIO_TPU_NO_NATIVE_BUILD") == "1":
        build_info["error"] = "no library built and MLX_AUDIO_TPU_NO_NATIVE_BUILD=1"
        return None
    cxx = shutil.which("g++")
    if cxx is None:
        build_info["error"] = "g++ not found"
        return None
    try:
        out_dir.mkdir(parents=True, exist_ok=True)
        lock_file = open(out_dir / "lock", "w")
    except OSError as e:
        build_info["error"] = f"cannot write {out_dir}: {e}"
        return None
    with lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if not lib.exists():
            tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            try:
                subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)],
                               capture_output=True, text=True, timeout=300, check=True)
            except subprocess.CalledProcessError as e:
                tmp.unlink(missing_ok=True)
                build_info["error"] = f"g++ failed with code {e.returncode}: {e.stderr[-2000:]}"
                return None
            except subprocess.TimeoutExpired:
                tmp.unlink(missing_ok=True)
                build_info["error"] = "g++ ran past 300 s"
                return None
            os.replace(tmp, lib)
            build_info["seconds"] = time.perf_counter() - t0
    return lib


def _open(path: Path) -> ctypes.CDLL | None:
    """Load the library, declare its functions and run the smoke call;
    None when any of that fails."""
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        build_info["error"] = f"cannot load {path}: {e}"
        return None
    for name, (argtypes, optional) in _SIGNATURES.items():
        if not hasattr(lib, name):
            if optional:
                continue
            build_info["error"] = f"{path} lacks {name}"
            return None
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = _I32
    if lib.mapt_abi_version() != ABI_VERSION:
        build_info["error"] = f"ABI version {lib.mapt_abi_version()}, expected {ABI_VERSION}"
        return None
    probe = np.empty(4, np.float64)
    if lib.mapt_window(0, 4, 1, 0.0, _ptr(probe)) != 0 or not np.isfinite(probe).all():
        build_info["error"] = "the smoke call failed"
        return None
    return lib


def library() -> ctypes.CDLL | None:
    """The loaded library, built and loaded on first use; None when the
    NumPy builders stand in."""
    global _lib, _loaded
    with _lock:
        if not _loaded:
            build_info.setdefault("seconds", 0.0)
            path = build()
            _lib = None if path is None else _open(path)
            build_info["path"] = None if _lib is None else str(path)
            _loaded = True
        return _lib


def __getattr__(name: str):
    # HAS_NATIVE is read when asked for: reading it loads the library
    if name == "HAS_NATIVE":
        return library() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_F64P)


def _has(symbol: str) -> bool:
    lib = library()
    return lib is not None and hasattr(lib, symbol)


def native_window(name: str, n: int, fftbins: bool, beta: float | None) -> np.ndarray | None:
    lib = library()
    if lib is None or name not in _WINDOW_KINDS:
        return None
    if name == "kaiser" and beta is None:
        beta = 8.6  # same default as the NumPy builder (ops/windows.py)
    out = np.empty(n, np.float64)
    rc = lib.mapt_window(_WINDOW_KINDS[name], n, int(fftbins), float(beta or 0.0), _ptr(out))
    return out if rc == 0 else None


def native_mel_filterbank(
    sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float,
    htk: bool, norm: str | None,
) -> np.ndarray | None:
    lib = library()
    if lib is None or norm not in (None, "slaney"):
        return None
    out = np.empty((n_mels, n_fft // 2 + 1), np.float64)
    rc = lib.mapt_mel_filterbank(
        sr, n_fft, n_mels, float(fmin), float(fmax), int(htk),
        1 if norm == "slaney" else 0, _ptr(out),
    )
    return out if rc == 0 else None


def native_dct_basis_t(n_out: int, n_in: int, norm: str | None) -> np.ndarray | None:
    lib = library()
    if lib is None or norm not in (None, "ortho"):
        return None
    out = np.empty((n_in, n_out), np.float64)
    rc = lib.mapt_dct_basis_t(n_out, n_in, 1 if norm == "ortho" else 0, _ptr(out))
    return out if rc == 0 else None


def native_bark_filterbank(
    sr: int, n_fft: int, n_bands: int, fmin: float, fmax: float,
    formula: str, norm: str | None,
) -> np.ndarray | None:
    if (
        not _has("mapt_bark_filterbank")
        or norm not in (None, "slaney")
        or formula not in ("zwicker", "traunmuller")
    ):
        return None
    out = np.empty((n_bands, n_fft // 2 + 1), np.float64)
    rc = library().mapt_bark_filterbank(
        sr, n_fft, n_bands, float(fmin), float(fmax),
        0 if formula == "zwicker" else 1, 1 if norm == "slaney" else 0,
        _ptr(out),
    )
    return out if rc == 0 else None


def native_linear_filterbank(
    sr: int, n_fft: int, n_bands: int, fmin: float, fmax: float,
    norm: str | None,
) -> np.ndarray | None:
    if not _has("mapt_linear_filterbank") or norm not in (None, "slaney"):
        return None
    out = np.empty((n_bands, n_fft // 2 + 1), np.float64)
    rc = library().mapt_linear_filterbank(
        sr, n_fft, n_bands, float(fmin), float(fmax),
        1 if norm == "slaney" else 0, _ptr(out),
    )
    return out if rc == 0 else None


def has_native_wav() -> bool:
    """Whether the loaded library carries the WAV codec."""
    return _has("mapt_wav_info")


def native_wav_read(path: str) -> tuple[np.ndarray, int, int] | None:
    """Decode a WAV file natively -> ``(interleaved_f32, sr, channels)``.

    Returns None (caller falls back to the NumPy codec) when the library is
    missing, pre-dates the codec, or the file uses a format it rejects."""
    if not has_native_wav():
        return None
    lib = library()
    p = os.fsencode(path)
    frames = ctypes.c_int64()
    ch = ctypes.c_int32()
    sr = ctypes.c_int32()
    bits = ctypes.c_int32()
    fmt = ctypes.c_int32()
    rc = lib.mapt_wav_info(
        p, ctypes.byref(frames), ctypes.byref(ch), ctypes.byref(sr),
        ctypes.byref(bits), ctypes.byref(fmt),
    )
    if rc == -1:
        raise OSError(f"cannot read WAV file: {path}")
    if rc != 0:
        return None
    out = np.empty(frames.value * ch.value, np.float32)
    # the read re-parses the file and reports the counts it decoded, so a
    # file rewritten between the two calls never leaves part of the buffer
    # uninitialized
    got_frames = ctypes.c_int64()
    got_ch = ctypes.c_int32()
    rc = lib.mapt_wav_read_f32(
        p, out.ctypes.data_as(_F32P), frames.value,
        ctypes.byref(got_frames), ctypes.byref(got_ch),
    )
    if rc != 0 or got_ch.value != ch.value:
        return None
    if got_frames.value != frames.value:
        out = out[: got_frames.value * got_ch.value]
    return out, sr.value, ch.value


def native_wav_write(path: str, interleaved: np.ndarray, sr: int, bits: int) -> bool:
    """Encode ``(frames, channels)`` float32 natively. False -> fall back."""
    if not has_native_wav():
        return False
    data = np.ascontiguousarray(interleaved, np.float32)
    frames, channels = data.shape
    rc = library().mapt_wav_write(
        os.fsencode(path), data.ctypes.data_as(_F32P),
        frames, channels, int(sr), int(bits),
    )
    if rc == -1:
        raise OSError(f"cannot write WAV file: {path}")
    return rc == 0


def native_hz_to_mel(f: np.ndarray, htk: bool) -> np.ndarray | None:
    lib = library()
    if lib is None:
        return None
    f = np.ascontiguousarray(f, np.float64)
    out = np.empty_like(f)
    rc = lib.mapt_hz_to_mel(_ptr(f), f.size, int(htk), _ptr(out))
    return out if rc == 0 else None


def native_mel_to_hz(m: np.ndarray, htk: bool) -> np.ndarray | None:
    lib = library()
    if lib is None:
        return None
    m = np.ascontiguousarray(m, np.float64)
    out = np.empty_like(m)
    rc = lib.mapt_mel_to_hz(_ptr(m), m.size, int(htk), _ptr(out))
    return out if rc == 0 else None
