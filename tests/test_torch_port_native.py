"""PyTorch port: the native table library (`_native.py`, `csrc/*.cpp`).

The port builds its own copy of the C++ sources with g++ into
``build/torch_tables/<source hash>/``. Each native builder is held bit for
bit to the JAX package's native builder (the same source, in float64) and,
in the float32 the tables are served in, to the port's NumPy builder (the
mel filterbank within 1e-13: its float64 math differs in the last bits, and
a filter's edge can be 0 on one path and ~1e-15 on the other); the public
ops serve the native tables, the JAX package's bit for bit. The loader's contract is the JAX
package's: the ABI check and smoke call, ``HAS_NATIVE``, per-function
degradation, ``MLX_AUDIO_TPU_NO_NATIVE_BUILD``, and a silent NumPy fallback
that leaves every table as it was.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import scipy.fft
import scipy.signal
from torch_port_util import same_bits

import mlx_audio_primitives_tpu as jap
import mlx_audio_primitives_tpu._native as jnat
import mlx_audio_primitives_tpu_torch as tap
from mlx_audio_primitives_tpu_torch import _native as tnat
from mlx_audio_primitives_tpu_torch.utils.cache import clear_all_caches

twin = importlib.import_module("mlx_audio_primitives_tpu_torch.ops.windows")
tmel = importlib.import_module("mlx_audio_primitives_tpu_torch.ops.mel")
tmfcc = importlib.import_module("mlx_audio_primitives_tpu_torch.ops.mfcc")
tfb = importlib.import_module("mlx_audio_primitives_tpu_torch.ops.filterbanks")

REPO = Path(__file__).resolve().parents[1]


def _numpy_path(monkeypatch) -> None:
    """Make the port's loader find no library (the NumPy builders stand
    in) for the rest of the test."""
    monkeypatch.setattr(tnat, "_loaded", True)
    monkeypatch.setattr(tnat, "_lib", None)


def _numpy_table(monkeypatch, cache, *args) -> np.ndarray:
    """The host table of ``cache`` from the port's NumPy builder (the
    native library switched off for the rest of the test)."""
    _numpy_path(monkeypatch)
    return cache._host_builder.__wrapped__(*args)


def test_library_builds_from_the_ports_sources():
    assert tnat.HAS_NATIVE and tnat.has_native_wav()
    path = Path(tnat.build_info["path"])
    assert path.parent.parent == REPO / "build" / "torch_tables"
    assert path.name == tnat.LIB_NAME and path.parent.name == tnat._digest()
    assert tnat.CSRC == REPO / "mlx_audio_primitives_tpu_torch" / "csrc"
    assert all((tnat.CSRC / s).exists() for s in tnat.SOURCES)


@pytest.mark.parametrize("name", ["hann", "hamming", "blackman", "bartlett", "rectangular", "kaiser"])
@pytest.mark.parametrize("n,fftbins", [(1, True), (7, False), (64, True), (255, False), (2048, True)])
def test_window_equals_jax_native_and_numpy(name, n, fftbins):
    beta = 8.6 if name == "kaiser" else None
    got = tnat.native_window(name, n, fftbins, beta)
    np.testing.assert_array_equal(got, jnat.native_window(name, n, fftbins, beta))
    ref = (twin._symmetric_window_np(name, n + 1, beta)[:n] if fftbins and n > 1
           else twin._symmetric_window_np(name, n, beta))
    assert same_bits(got.astype(np.float32), ref.astype(np.float32))


def test_window_against_scipy_and_degenerate_kinds():
    np.testing.assert_allclose(tnat.native_window("hann", 2048, True, None),
                               scipy.signal.get_window("hann", 2048), atol=1e-14, rtol=0)
    np.testing.assert_array_equal(tnat.native_window("hann", 1, True, None), [1.0])
    assert tnat.native_window("nuttall", 64, True, None) is None
    # the default kaiser beta is 8.6 on both paths, never a rectangle
    w = tnat.native_window("kaiser", 64, True, None)
    np.testing.assert_allclose(w, scipy.signal.get_window(("kaiser", 8.6), 64), atol=1e-13)
    assert w[0] < 0.01


@pytest.mark.parametrize("htk", [False, True])
@pytest.mark.parametrize("norm", ["slaney", None])
@pytest.mark.parametrize("sr,n_fft,n_mels,fmin,fmax", [
    (22050, 1024, 64, 0.0, 11025.0), (16000, 512, 26, 100.0, 7000.0), (22050, 2048, 128, 0.0, 11025.0),
])
def test_mel_filterbank_equals_jax_native_and_numpy(monkeypatch, htk, norm, sr, n_fft, n_mels,
                                                    fmin, fmax):
    args = (sr, n_fft, n_mels, fmin, fmax, htk, norm)
    got = tnat.native_mel_filterbank(*args)
    np.testing.assert_array_equal(got, jnat.native_mel_filterbank(*args))
    # the table the port serves is the JAX package's, bit for bit
    kw = dict(n_mels=n_mels, fmin=fmin, fmax=fmax, htk=htk, norm=norm)
    assert same_bits(tap.mel_filterbank(sr, n_fft, **kw), jap.mel_filterbank(sr, n_fft, **kw))
    # the NumPy fallback's float64 math agrees to ~1e-14; a filter's edge
    # can come out 0 on one path and ~1e-15 on the other (16 kHz, 26 HTK
    # mels: one element, 0 natively, 1.47e-15 in NumPy)
    ref = _numpy_table(monkeypatch, tmel._mel_filterbank_table, *args)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-13)
    np.testing.assert_allclose(got.astype(np.float32), ref.astype(np.float32), rtol=1e-7, atol=1e-13)


def test_unknown_norms_return_none():
    assert tnat.native_mel_filterbank(22050, 512, 10, 0, 11025, False, "l2") is None
    assert tnat.native_dct_basis_t(20, 64, "l2") is None
    assert tnat.native_bark_filterbank(22050, 512, 10, 0, 11025, "mel", "slaney") is None
    assert tnat.native_bark_filterbank(22050, 512, 10, 0, 11025, "zwicker", "l2") is None
    assert tnat.native_linear_filterbank(22050, 512, 10, 0, 11025, "l2") is None


@pytest.mark.parametrize("norm", ["ortho", None])
@pytest.mark.parametrize("n_out,n_in", [(20, 64), (13, 128), (40, 40)])
def test_dct_basis_equals_jax_native_and_numpy(monkeypatch, norm, n_out, n_in):
    got = tnat.native_dct_basis_t(n_out, n_in, norm)
    np.testing.assert_array_equal(got, jnat.native_dct_basis_t(n_out, n_in, norm))
    ref = scipy.fft.dct(np.eye(n_in), type=2, norm=norm, axis=-1)[:, :n_out]
    np.testing.assert_allclose(got, ref, atol=1e-13)
    ref = _numpy_table(monkeypatch, tmfcc._dct_basis_t, n_out, n_in, norm)
    assert same_bits(got.astype(np.float32), ref.astype(np.float32))


@pytest.mark.parametrize("formula", ["zwicker", "traunmuller"])
@pytest.mark.parametrize("norm", ["slaney", None])
def test_bark_filterbank_equals_jax_native_and_numpy(monkeypatch, formula, norm):
    args = (22050, 1024, 24, 0.0, 11025.0, formula, norm)
    got = tnat.native_bark_filterbank(*args)
    np.testing.assert_array_equal(got, jnat.native_bark_filterbank(*args))
    ref = _numpy_table(monkeypatch, tfb._bark_filterbank_table, *args)
    np.testing.assert_allclose(got, ref, atol=1e-13, rtol=0)
    assert same_bits(got.astype(np.float32), ref.astype(np.float32))


@pytest.mark.parametrize("norm", ["slaney", None])
def test_linear_filterbank_equals_jax_native_and_numpy(monkeypatch, norm):
    args = (16000, 512, 64, 100.0, 8000.0, norm)
    got = tnat.native_linear_filterbank(*args)
    np.testing.assert_array_equal(got, jnat.native_linear_filterbank(*args))
    ref = _numpy_table(monkeypatch, tfb._linear_filterbank_table, *args)
    assert same_bits(got.astype(np.float32), ref.astype(np.float32))


@pytest.mark.parametrize("htk", [False, True])
def test_mel_scale_equals_jax_native(htk):
    f = np.array([0.0, 200.0, 440.0, 999.9, 1000.0, 4000.0, 11025.0])
    m = tnat.native_hz_to_mel(f, htk)
    np.testing.assert_array_equal(m, jnat.native_hz_to_mel(f, htk))
    np.testing.assert_allclose(m, tap.hz_to_mel(f, htk=htk), atol=1e-12)
    np.testing.assert_array_equal(tnat.native_mel_to_hz(m, htk), jnat.native_mel_to_hz(m, htk))
    np.testing.assert_allclose(tnat.native_mel_to_hz(m, htk), f, atol=1e-8)


def test_public_ops_serve_the_native_tables():
    clear_all_caches()
    np.testing.assert_array_equal(
        tap.get_window("hann", 999).numpy(), tnat.native_window("hann", 999, True, None).astype(np.float32))
    np.testing.assert_array_equal(
        tap.mel_filterbank(22050, 512, n_mels=20).numpy(),
        tnat.native_mel_filterbank(22050, 512, 20, 0.0, 11025.0, False, "slaney").astype(np.float32))
    np.testing.assert_array_equal(
        tap.bark_filterbank(22050, 512, n_bands=24).numpy(),
        tnat.native_bark_filterbank(22050, 512, 24, 0.0, 11025.0, "zwicker", "slaney").astype(np.float32))
    np.testing.assert_array_equal(
        tap.linear_filterbank(22050, 512, n_bands=32).numpy(),
        tnat.native_linear_filterbank(22050, 512, 32, 0.0, 11025.0, "slaney").astype(np.float32))
    np.testing.assert_array_equal(
        tmfcc._dct_basis_t(20, 64, "ortho", device="cpu").numpy(),
        tnat.native_dct_basis_t(20, 64, "ortho").astype(np.float32))


@pytest.mark.parametrize("build", [
    lambda: tap.get_window("hamming", 400), lambda: tap.get_window(("kaiser", 4.0), 256),
    lambda: tap.mel_filterbank(16000, 512, n_mels=40, fmin=20.0, fmax=7600.0, htk=True),
    lambda: tap.bark_filterbank(16000, 512, n_bands=20, formula="traunmuller", norm=None),
    lambda: tap.linear_filterbank(22050, 1024, n_bands=48),
    lambda: tmfcc._dct_basis_t(13, 128, None, device="cpu"),
], ids=["hamming", "kaiser", "mel_htk", "bark_traunmuller", "linear", "dct"])
def test_numpy_fallback_serves_the_same_bits(monkeypatch, build):
    clear_all_caches()
    native = build()
    _numpy_path(monkeypatch)
    clear_all_caches()
    assert not tnat.HAS_NATIVE
    assert same_bits(build(), native)
    clear_all_caches()


def test_no_native_build_switch(monkeypatch, tmp_path):
    # no library under the build root and the switch set: no build, and
    # every builder returns None
    monkeypatch.setenv("MLX_AUDIO_TPU_NO_NATIVE_BUILD", "1")
    monkeypatch.setattr(tnat, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(tnat, "_loaded", False)
    monkeypatch.setattr(tnat, "_lib", None)
    monkeypatch.setattr(tnat, "build_info", {})
    assert tnat.library() is None and not tnat.HAS_NATIVE
    assert "MLX_AUDIO_TPU_NO_NATIVE_BUILD" in tnat.build_info["error"]
    assert tnat.native_window("hann", 8, True, None) is None
    assert not tnat.has_native_wav()
    assert list(tmp_path.iterdir()) == []


def test_failed_build_leaves_no_library(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    for name in tnat.SOURCES:
        (src / name).write_text("this is not C++\n")
    monkeypatch.setattr(tnat, "CSRC", src)
    monkeypatch.setattr(tnat, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(tnat, "_loaded", False)
    monkeypatch.setattr(tnat, "_lib", None)
    monkeypatch.setattr(tnat, "build_info", {})
    monkeypatch.delenv("MLX_AUDIO_TPU_NO_NATIVE_BUILD", raising=False)
    assert tnat.library() is None and not tnat.HAS_NATIVE
    assert "g++ failed" in tnat.build_info["error"]
    built = [p.name for p in (tmp_path / "build").rglob("*") if p.is_file()]
    assert built == ["lock"]


def test_missing_optional_symbol_degrades_that_builder(monkeypatch):
    lib = tnat.library()

    class Stale:
        """The library without the bark builder or the WAV codec."""

        def __getattr__(self, name):
            if name in ("mapt_bark_filterbank", "mapt_wav_info"):
                raise AttributeError(name)
            return getattr(lib, name)

    monkeypatch.setattr(tnat, "_lib", Stale())
    assert tnat.native_bark_filterbank(22050, 512, 10, 0.0, 11025.0, "zwicker", "slaney") is None
    assert not tnat.has_native_wav()
    assert tnat.native_wav_read("unused.wav") is None
    assert tnat.native_linear_filterbank(22050, 512, 10, 0.0, 11025.0, "slaney") is not None


def test_concurrent_processes_build_once(tmp_path):
    # four processes load the loader by its path (no torch import) and
    # build into one fresh root at once: the lock lets one compile, and
    # every one loads a library that passes the smoke call
    code = textwrap.dedent(f"""
        import importlib.util, sys
        from pathlib import Path
        spec = importlib.util.spec_from_file_location("nat", {str(tnat.__file__)!r})
        nat = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(nat)
        nat.BUILD_ROOT = Path(sys.argv[1])
        print(nat.library() is not None, nat.build_info.get("seconds", 0.0) > 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "MLX_AUDIO_TPU_NO_NATIVE_BUILD"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], stdout=subprocess.PIPE,
                              text=True, env=env) for _ in range(4)]
    outs = [p.communicate(timeout=300)[0].split() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert all(o[0] == "True" for o in outs)
    assert sum(o[1] == "True" for o in outs) == 1  # one process compiled
    libs = [p for p in tmp_path.rglob("*.so*")]
    assert [p.name for p in libs] == [tnat.LIB_NAME]
