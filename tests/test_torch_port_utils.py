"""PyTorch port: the profilers, warmup, the table-cache registry and the
dispatch names (`utils/profiler.py`, `memory_profiler.py`, `warmup.py`,
`cache.py`, `dispatch.py`).

Mirrors the JAX package's `tests/test_utils.py` on the CPU: section and
decorator timers, cache accesses and transfers logged with the tensors'
bytes, a ``torch.profiler`` trace written in TensorBoard's format, memory
readings of 0 without CUDA with ``estimate_operation_memory`` equal to the
JAX dict, ``warmup``'s keys and errors, and each dispatch name's documented
CUDA meaning (``MLX_AUDIO_TPU_DISABLE_PALLAS`` in a fresh interpreter).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_port_util import launch_counts, signals

import mlx_audio_primitives_tpu.utils as jutils
import mlx_audio_primitives_tpu_torch as tap
from mlx_audio_primitives_tpu_torch import utils as U
from mlx_audio_primitives_tpu_torch.kernels import _build
from mlx_audio_primitives_tpu_torch.utils import dispatch, memory_profiler
from mlx_audio_primitives_tpu_torch.utils.cache import table_cache

REPO = Path(__file__).resolve().parents[1]


class TestTableCache:
    def test_hit_miss_accounting(self):
        U.clear_all_caches()
        tap.get_window("hann", 777)
        tap.get_window("hann", 777)
        stats = U.cache_stats()["window"]
        assert stats == {"hits": 1, "misses": 1, "entries": 1}

    def test_clear_all(self):
        tap.get_window("hamming", 333)
        U.clear_all_caches()
        assert U.cache_stats()["window"] == {"hits": 0, "misses": 0, "entries": 0}

    def test_registry_names_the_jax_caches(self):
        tap.mel_filterbank(22050, 512, n_mels=16)
        names = set(U.cache_stats())
        assert {"window", "mel_filterbank", "dct_basis", "bark_filterbank",
                "linear_filterbank"} <= names

    def test_lru_eviction_and_recency(self):
        @table_cache("test_torch_evict", maxsize=2)
        def builder(n):
            return np.zeros(n)

        a1 = builder(1)
        builder(2)
        assert builder(1) is a1  # a hit refreshes recency
        builder(3)  # evicts 2, not 1
        assert builder(1) is a1
        assert builder.stats["entries"] == 2
        builder.clear()
        assert builder.stats == {"hits": 0, "misses": 0, "entries": 0}
        assert builder(1) is not a1

    def test_host_tier(self):
        fb = tap.mel_filterbank(22050, 1024, n_mels=32)
        from mlx_audio_primitives_tpu_torch.ops.mel import _mel_filterbank_table

        host = _mel_filterbank_table.host(22050, 1024, 32, 0.0, 11025.0, False, "slaney")
        assert host.dtype == np.float64
        np.testing.assert_array_equal(fb.numpy(), host.astype(np.float32))


class TestDispatchNames:
    def test_documented_values_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: these are the values without one")
        assert U.HAS_PALLAS is True and dispatch.KERNELS_ENABLED
        assert U.has_pallas_tpu() is False and U.HAS_PALLAS_TPU is False
        assert U.pallas_interpret_mode() is True
        assert U.default_backend() == "cpu"
        assert U.is_tpu() is False

    def test_resolve_use_pallas_has_the_jax_signature(self):
        # True: whenever kernels are enabled; None: only with default_on_tpu
        # and compiled kernels; False: never -- the JAX package's policy
        assert U.resolve_use_pallas(True) is True
        assert U.resolve_use_pallas(False) is False
        assert U.resolve_use_pallas(None) is False
        assert U.resolve_use_pallas(None, default_on_tpu=True) is U.has_pallas_tpu()
        assert U.resolve_use_pallas(True) == jutils.resolve_use_pallas(True)
        assert U.resolve_use_pallas(None) == jutils.resolve_use_pallas(None)

    def test_resolve_use_pallas_with_cuda_present(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert U.has_pallas_tpu() is True and U.default_backend() == "gpu"
        assert U.pallas_interpret_mode() is False
        assert U.resolve_use_pallas(None, default_on_tpu=True) is True
        monkeypatch.setattr(dispatch, "KERNELS_ENABLED", False)
        assert U.has_pallas_tpu() is False
        assert U.resolve_use_pallas(True) is False

    def test_kill_switch_in_a_fresh_interpreter(self):
        code = (
            "import mlx_audio_primitives_tpu_torch.utils as u, mlx_audio_primitives_tpu_torch.utils.dispatch as d;"
            "assert not u.HAS_PALLAS and not d.KERNELS_ENABLED;"
            "assert not u.has_pallas_tpu() and not u.HAS_PALLAS_TPU;"
            "assert not u.resolve_use_pallas(True);"
            "import torch; assert not d.kernel_route(None, torch.device('cuda', 0));"
            "print('ok')"
        )
        env = dict(os.environ, MLX_AUDIO_TPU_DISABLE_PALLAS="1")
        proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-500:]
        assert "ok" in proc.stdout

    def test_unknown_attribute_raises(self):
        with pytest.raises(AttributeError):
            U.NOT_A_NAME  # noqa: B018
        with pytest.raises(AttributeError):
            dispatch.NOT_A_NAME  # noqa: B018


class TestWarmup:
    def test_keys_and_launches(self):
        ops = ("stft", "istft", "melspectrogram", "mfcc", "chroma_stft", "pcen")
        before = launch_counts()
        times = U.warmup(signal_lengths=(4096,), batch_sizes=(1, 2), n_fft=512,
                         hop_length=128, n_mels=16, ops=ops)
        assert list(times) == [f"{op} b={b} len=4096" for b in (1, 2) for op in ops]
        assert all(t >= 0 for t in times.values())
        assert launch_counts() == before  # on the CPU the plain routes run

    def test_default_ops(self):
        times = U.warmup(signal_lengths=(2048,), n_fft=256, n_mels=8)
        assert list(times) == [f"{op} b=1 len=2048" for op in ("stft", "istft", "melspectrogram", "mfcc")]

    def test_rejects_unknown_op(self):
        with pytest.raises(ValueError, match="unknown warmup ops"):
            U.warmup(ops=("stft", "bogus"))

    def test_persistent_cache_moves_the_build_root(self, monkeypatch, tmp_path):
        monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT)
        U.enable_persistent_compilation_cache(str(tmp_path))
        assert _build.BUILD_ROOT == tmp_path


class TestProfiler:
    def setup_method(self):
        U.clear_profiling()
        U.enable_profiling()

    def teardown_method(self):
        U.disable_profiling()

    def test_profile_section(self):
        with U.profile_section("mel"):
            tap.melspectrogram(signals(0, (2048,)), n_fft=512, n_mels=16)
        assert len(U.get_profiling_data()["timings"]["mel"]) == 1

    def test_profile_decorator(self):
        @U.profile(name="op")
        def op():
            return torch.ones(10) * 2

        op()
        op()
        assert len(U.get_profiling_data()["timings"]["op"]) == 2
        assert U.profile(lambda: 3)() == 3

    def test_cache_accesses_logged(self):
        U.clear_all_caches()
        tap.get_window("hann", 555)
        tap.get_window("hann", 555)
        assert U.get_profiling_data()["cache_accesses"]["window"] == {"hits": 1, "misses": 1}

    def test_text_report_and_json(self, tmp_path):
        with U.profile_section("stft"):
            tap.melspectrogram(signals(1, (2048,)), n_fft=512, n_mels=16)
        U.log_sync_point("here")
        report = U.generate_text_report()
        assert "stft" in report and "cache hit rates" in report and "sync points: 1" in report
        U.export_json(str(tmp_path / "p.json"))
        data = json.loads((tmp_path / "p.json").read_text())
        assert data["sync_points"] == ["here"] and "stft" in data["timings"]

    def test_zero_overhead_when_disabled(self):
        U.disable_profiling()
        with U.profile_section("x"):
            pass
        U.tracked_to_device(np.ones(10, np.float32))
        U.log_cache_access("w", True)
        data = U.get_profiling_data()
        assert data["timings"] == {} and data["transfers"] == [] and data["cache_accesses"] == {}
        assert not U.is_profiling()

    def test_tracked_transfers_log_the_bytes(self):
        x = U.tracked_to_device(np.ones(1000, np.float32), context="w")
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        back = U.tracked_to_host(x, context="r")
        assert isinstance(back, np.ndarray) and back.shape == (1000,)
        U.tracked_to_device(np.ones((3, 5), np.float64), context="w64")
        transfers = U.get_profiling_data()["transfers"]
        assert transfers == [{"direction": "h2d", "context": "w", "bytes": 4000},
                             {"direction": "d2h", "context": "r", "bytes": 4000},
                             {"direction": "h2d", "context": "w64", "bytes": 120}]

    def test_device_trace_writes_a_tensorboard_trace(self, tmp_path):
        U.start_device_trace(str(tmp_path))
        with pytest.raises(RuntimeError, match="already running"):
            U.start_device_trace(str(tmp_path))
        tap.melspectrogram(signals(2, (2048,)), n_fft=512, n_mels=16)
        U.stop_device_trace()
        traces = list(tmp_path.rglob("*.pt.trace.json"))
        assert len(traces) == 1
        assert "aten::" in traces[0].read_text()
        with pytest.raises(RuntimeError, match="no device trace"):
            U.stop_device_trace()


class TestMemoryProfiler:
    def test_profile_memory_returns_result(self):
        out, prof = U.profile_memory(
            lambda: tap.melspectrogram(signals(3, (2, 4096)), n_fft=512, n_mels=32))
        assert out.shape == (2, 32, 33)
        assert prof.output_bytes == 2 * 32 * 33 * 4
        (a, b), prof2 = U.profile_memory(lambda: (torch.zeros(3), {"k": np.zeros(2)}))
        assert prof2.output_bytes == 12 + 16

    def test_readings_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: these are the readings without one")
        assert U.get_active_memory() == 0 and U.get_peak_memory() == 0
        assert not memory_profiler.memory_available()
        with U.track_memory() as outer:
            with U.track_memory() as inner:
                pass
        assert outer.peak == inner.peak == 0
        assert outer.extra["peak_is_process_lifetime"] is False  # the outermost resets
        assert inner.extra["peak_is_process_lifetime"] is True  # nested: no reset
        assert memory_profiler._depth == 0

    def test_memory_profile_properties(self):
        p = U.MemoryProfile(active_before=1_000_000, active_after=3_000_000, peak=5_000_000,
                            output_bytes=2_000_000)
        assert p.delta_mb == 2.0 and p.peak_mb == 5.0 and p.efficiency == 0.5

    @pytest.mark.parametrize("op", ["stft", "mel", "mfcc", "istft"])
    @pytest.mark.parametrize("length,batch", [(22050, 1), (661500, 64), (1000, 3)])
    def test_estimates_equal_the_jax_dict(self, op, length, batch):
        assert U.estimate_operation_memory(op, length, batch=batch) == \
            jutils.estimate_operation_memory(op, length, batch=batch)
        kw = dict(n_fft=1024, hop_length=256, n_mels=64, n_mfcc=13)
        assert U.estimate_operation_memory(op, length, batch, **kw) == \
            jutils.estimate_operation_memory(op, length, batch, **kw)
