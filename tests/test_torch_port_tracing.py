"""PyTorch port: the spans and counters inside the port (`utils/profiler.py`).

On the CPU: spans nest and keep their self time; with recording off no
hook reads a clock or opens a profiler range; under ``torch.profiler`` the
recording holds the session's calls alone, each span a CPU event of its
name on the profiler's clock; the routing counters name the route and
its reason; a table cache's miss is a span and a hit is not; the cache
accesses are ``cache_stats()``'s deltas. On the card (marked ``cuda``;
they skip without one): no port span is a device event in a traced call
of each benchmark cell's entry, and ``profile_section`` waits for nothing
inside its region and times it as CUDA events around it do.

The file imports no JAX: run the card's tests with the repository's
conftest left out (it imports JAX)::

    python -m pytest --noconftest -m cuda tests/test_torch_port_tracing.py
"""

from __future__ import annotations

import json
import statistics
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import mlx_audio_primitives_tpu_torch as tap
from mlx_audio_primitives_tpu_torch.utils import dispatch, profiler
from mlx_audio_primitives_tpu_torch.utils.cache import TableCache, clear_all_caches

#: the first part of every port span's and counter's name
PORT_LAYERS = ("ops.", "kernels.", "launch.", "tables.", "dispatch.")


@pytest.fixture(autouse=True)
def fresh():
    profiler.disable_profiling()
    profiler.clear_profiling()
    yield
    profiler.disable_profiling()
    profiler.clear_profiling()


def audio(n: int = 4096, seed: int = 0) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(n).astype(np.float32))


@profiler.traced("kernels.inner")
def _inner():
    time.sleep(0.002)


@profiler.traced("ops.leaf")
def _leaf():
    time.sleep(0.001)


@profiler.traced("ops.outer")
def _outer():
    time.sleep(0.002)
    _inner()
    _leaf()
    _inner()


def _records(tmp_path) -> dict:
    profiler.export_json(str(tmp_path / "p.json"))
    return json.loads((tmp_path / "p.json").read_text())


def test_spans_nest_and_self_time_is_duration_less_children(tmp_path):
    profiler.enable_profiling()
    _outer()
    data = _records(tmp_path)
    spans = data["spans"]
    assert {k: s["count"] for k, s in spans.items()} == {"ops.outer": 1, "kernels.inner": 2,
                                                         "ops.leaf": 1}
    outer, inner, leaf = spans["ops.outer"], spans["kernels.inner"], spans["ops.leaf"]
    children = inner["total_ms"] + leaf["total_ms"]
    assert outer["self_ms"] == pytest.approx(outer["total_ms"] - children, abs=1e-6)
    assert outer["self_ms"] >= 1.9 and inner["self_ms"] == inner["total_ms"] >= 3.9
    # outermost in its layer: the nested ops span is not, a span of another layer is
    assert outer["outer_ms"] == outer["total_ms"] and leaf["outer_ms"] == 0.0
    assert inner["outer_ms"] == inner["total_ms"]
    recs = {r["name"]: r for r in data["span_records"]}
    top = recs["ops.outer"]
    assert top["parent"] is None and top["call"] == top["id"]
    for r in data["span_records"]:
        assert r["call"] == top["id"]
        if r is not top:
            assert r["parent"] == top["id"]
            assert top["start_ns"] <= r["start_ns"] <= r["end_ns"] <= top["end_ns"]
    # the profiler's clock: Unix-epoch ns
    assert abs(top["end_ns"] - time.time_ns()) < 60e9
    assert data["span_records_dropped"] == 0


def _hook_op():
    tap.melspectrogram(audio(), n_fft=512, hop_length=128, n_mels=16)


def _hook_route():
    assert dispatch.route("stft", True, torch.device("cpu"), gate=False) is False


def _hook_count():
    profiler.count("dispatch.kernel.stft")


def _hook_span():
    with profiler.span("ops.x"):
        pass


def _hook_miss():
    TableCache("tracing_probe", lambda n: np.arange(n, dtype=np.float64))(7)


@pytest.mark.parametrize("hook", [_hook_op, _hook_route, _hook_count, _hook_span, _hook_miss])
def test_recording_off_reads_no_clock_and_opens_no_range(monkeypatch, hook):
    class NoClock:
        def __getattr__(self, name):
            raise AssertionError(f"time.{name} read while recording is off")

    def no_range(*_):
        raise AssertionError("a profiler range opened while recording is off")

    monkeypatch.setattr(profiler, "time", NoClock())
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", no_range)
    hook()
    data = profiler.get_profiling_data()
    assert data["spans"] == {} and data["counters"] == {}


def _session(calls: int) -> list:
    """``calls`` stft calls under a ``torch.profiler`` session; its events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(calls):
            tap.stft(audio(seed=i), n_fft=512, hop_length=128, use_pallas=True)
    return list(prof.profiler.kineto_results.events())


def test_a_profiler_session_records_its_own_calls(tmp_path):
    tap.stft(audio(), n_fft=512, hop_length=128, use_pallas=True)  # before: not recorded
    _session(2)
    tap.stft(audio(), n_fft=512, hop_length=128, use_pallas=True)  # between: not recorded
    events = _session(3)
    data = _records(tmp_path)
    assert data["spans"]["ops.stft"]["count"] == 3
    assert data["spans"]["kernels.stft_fused"]["count"] == 3
    assert data["counters"] == {"dispatch.kernel.stft": 3}
    port = [e for e in events if e.name().startswith(PORT_LAYERS)]
    assert sorted({e.name() for e in port}) == ["kernels.stft_fused", "ops.get_window",
                                                 "ops.stft"]
    assert all(e.device_type() == DeviceType.CPU for e in port)
    # each span beside its profiler event, on one clock
    starts = sorted(e.start_ns() for e in port if e.name() == "ops.stft")
    ours = sorted(r["start_ns"] for r in data["span_records"] if r["name"] == "ops.stft")
    assert len(starts) == len(ours) == 3
    assert max(abs(a - b) for a, b in zip(starts, ours)) < 5e6
    # the recording stays readable after the session, in every exporter
    assert "ops.stft: calls=3" in profiler.generate_text_report()
    assert "dispatch.kernel.stft: 3" in profiler.generate_text_report()


def test_profiling_enabled_keeps_one_recording_across_sessions():
    profiler.enable_profiling()
    _session(1)
    tap.stft(audio(), n_fft=512, hop_length=128, use_pallas=True)
    _session(1)
    assert profiler.get_profiling_data()["spans"]["ops.stft"]["count"] == 3


def _stft(**kw):
    return lambda: tap.stft(audio(), **kw)


def _mel(**kw):
    return lambda: tap.melspectrogram(audio(), n_mels=16, **kw)


ROUTES = [
    ("plain stft, a shape off the gate", _stft(n_fft=500, hop_length=125, use_pallas=True),
     {"dispatch.plain.stft.gate": 1}),
    ("stft's twin under the gate", _stft(n_fft=512, hop_length=128, use_pallas=True),
     {"dispatch.kernel.stft": 1}),
    ("an explicit fft_mode", _stft(n_fft=512, hop_length=128, fft_mode="matmul"), {}),
    ("a CPU tensor takes the plain route uncounted", _stft(n_fft=512, hop_length=128), {}),
    ("mel at a power K1 lacks", _mel(n_fft=512, hop_length=128, power=1.5, use_pallas=True),
     {"dispatch.plain.filterbank_spectrogram.power": 1}),
    ("mel's twin", _mel(n_fft=512, hop_length=128, use_pallas=True),
     {"dispatch.kernel.filterbank_spectrogram": 1}),
    ("istft off the gate", lambda: tap.istft(tap.stft(audio(), n_fft=500, hop_length=125),
                                             hop_length=125, use_pallas=True),
     {"dispatch.plain.istft.gate": 1}),
]


@pytest.mark.parametrize("call,counters", [r[1:] for r in ROUTES], ids=[r[0] for r in ROUTES])
def test_dispatch_counts_the_route_and_its_reason(call, counters):
    profiler.enable_profiling()
    call()
    assert profiler.get_profiling_data()["counters"] == counters


def test_route_counts_a_cuda_call_turned_off_by_use_pallas(monkeypatch):
    profiler.enable_profiling()
    cuda = torch.device("cuda", 0)
    assert dispatch.route("stft", False, cuda, gate=True) is False
    monkeypatch.setattr(dispatch, "KERNELS_ENABLED", False)
    assert dispatch.route("stft", None, cuda, gate=True) is False
    monkeypatch.setattr(dispatch, "KERNELS_ENABLED", True)
    assert dispatch.route("stft", None, cuda, fft_mode=True, gate=False) is False
    assert dispatch.route("stft", None, cuda, fft_mode=True, gate=True) is True
    assert profiler.get_profiling_data()["counters"] == {
        "dispatch.plain.stft.use_pallas": 2, "dispatch.plain.stft.gate": 1,
        "dispatch.kernel.stft": 1}


def test_a_table_miss_is_a_span_and_a_hit_is_not():
    cache = TableCache("tracing_table", lambda n: np.ones(n))
    profiler.enable_profiling()
    cache(5)
    assert profiler.get_profiling_data()["spans"]["tables.build.tracing_table"]["count"] == 1
    cache(5)
    cache(5)
    data = profiler.get_profiling_data()
    assert data["spans"]["tables.build.tracing_table"]["count"] == 1
    assert data["cache_accesses"]["tracing_table"] == {"hits": 2, "misses": 1}


def test_cache_accesses_are_the_stats_deltas_of_enabled_periods():
    cache = TableCache("tracing_deltas", lambda n: np.ones(n))
    cache(1)  # before profiling: not counted
    profiler.enable_profiling()
    cache(1)
    cache(2)
    clear_all_caches()  # zeroes the stats; the period keeps its count
    cache(1)
    profiler.log_cache_access("tracing_deltas", True)
    profiler.disable_profiling()
    cache(1)  # after: not counted
    assert profiler.get_profiling_data()["cache_accesses"]["tracing_deltas"] == {
        "hits": 2, "misses": 2}


# -- on the card --------------------------------------------------------------


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels and CUDA events have no CPU mode")
    return torch.device("cuda", 0)


def _cells() -> list[str]:
    from bench_port import registry

    return [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", _cells())
def test_no_port_span_is_a_device_event(card, cell):
    from bench_port import registry

    mix = registry.traffic(registry.cell(cell)["traffic"])
    cfg = registry.config(registry.cell(cell)["config"])
    call = registry.entry(mix["entry"]).program(tap, cfg)
    y = torch.randn((4, 5 * cfg["sr"]), device=card)
    call(y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call(y)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    port = [e for e in events if e.name().startswith(PORT_LAYERS)]
    assert any(e.name().startswith("launch.") for e in port)
    assert [e.name() for e in port if e.device_type() == DeviceType.CUDA] == []
    assert any(e.device_type() == DeviceType.CUDA for e in events)


def _region(y):
    for _ in range(5):
        tap.melspectrogram(y, n_fft=2048, hop_length=512, n_mels=128)


@pytest.mark.cuda
def test_profile_section_waits_for_nothing_and_agrees_with_cuda_events(card, monkeypatch):
    """A device-bound region (5 log-mels of 64 x 30 s), with profiling on
    for both timings, so that the host's share is the same in each."""
    y = torch.randn((64, 30 * 22050), device=card)
    profiler.enable_profiling()
    _region(y)
    real = torch.cuda.synchronize
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: (calls.append(a), real(*a)))
    synced = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        real()
        a.record()
        _region(y)
        b.record()
        real()
        synced.append(a.elapsed_time(b) / 1e3)
        real()
        calls.clear()
        with profiler.profile_section("region"):
            _region(y)
        assert calls == []
    got = profiler.get_profiling_data()["timings"]["region"]
    assert len(got) == 5
    ratio = statistics.median(got) / statistics.median(synced)
    assert abs(ratio - 1) < 0.05, (got, synced)
