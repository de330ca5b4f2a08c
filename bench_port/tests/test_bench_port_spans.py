"""The readers of the port's own spans and counters (``ops_self_ms``,
``wrapper_host_ms``, ``table_build_ms``, ``plain_route_pct``) on a traced
CPU run of the harness: the port records under the traced window's
profiler, the readers read that recording, and a run without a traced
window or a port without spans gives them nothing to read."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from bench_port import registry, run

READERS = ("ops_self_ms", "wrapper_host_ms", "table_build_ms", "plain_route_pct")


@pytest.fixture(autouse=True)
def small_traffic(monkeypatch):
    """Every mix at a few short clips: the same generator, entry and limits."""
    full = registry.traffic

    def small(name):
        mix = full(name)
        clips = mix["clips"]
        if clips["kind"] == "fixed":
            clips.update(batch=2, seconds=1.5)
            mix.update(pool=2, keep=1)
        else:
            clips["batch_audio_seconds"] = 8.0
        return mix

    monkeypatch.setattr(registry, "traffic", small)


def traced_run(cell: str, monkeypatch) -> tuple[dict, object]:
    """A traced CPU run of ``cell``: its result line and the ``run`` the
    readers read."""
    seen = {}
    metric = registry.metric

    def keep_run(name):
        read = metric(name)

        def wrapped(r):
            seen["run"] = r
            return read(r)
        return wrapped

    monkeypatch.setattr(registry, "metric", keep_run)
    res = run.measure(cell, registry.cell(cell), 2**31 + 4321, 0.2, True, torch.device("cpu"),
                      t0=time.perf_counter())
    return res["metrics"], seen["run"]


@pytest.mark.parametrize("cell", ["gtzan_librosa.logmel", "gtzan_librosa.features"])
def test_readers_on_a_plain_cpu_run(cell, monkeypatch):
    """On a CPU tensor the ops take their plain routes: no wrapper, no
    routing decision to count, no table built inside the window."""
    from mlx_audio_primitives_tpu_torch.utils import profiler

    metrics, r = traced_run(cell, monkeypatch)
    assert metrics["ops_self_ms"]["value"] > 0
    assert metrics["wrapper_host_ms"]["value"] == 0.0
    assert metrics["table_build_ms"]["value"] == 0.0
    assert "plain_route_pct" not in metrics
    # the outermost ops spans lie inside the harness's entry calls
    spans = profiler.get_profiling_data()["spans"]
    ops_ms = sum(s["outer_ms"] for k, s in spans.items() if k.startswith("ops."))
    assert 0.5 * 1e3 * r.traced.entry_s < ops_ms <= 1e3 * r.traced.entry_s


def test_readers_on_the_kernel_routes_twins(monkeypatch):
    """With the kernel route taken on the CPU (the wrappers run their plain
    twins), the wrappers' time and the routing counters are read."""
    from mlx_audio_primitives_tpu_torch.utils import dispatch

    monkeypatch.setattr(dispatch, "kernel_route", lambda flag, device: True)
    metrics, _ = traced_run("gtzan_librosa.features", monkeypatch)
    assert metrics["wrapper_host_ms"]["value"] > 0
    assert metrics["plain_route_pct"]["value"] == 0.0
    assert metrics["ops_self_ms"]["value"] > 0


def test_readers_read_nothing_without_a_recording(monkeypatch):
    from mlx_audio_primitives_tpu_torch.utils import profiler

    untraced = SimpleNamespace(trace=None, traced=None)
    for name in READERS:
        assert registry.metric(name)(untraced) is None
    # a port that keeps no spans, as before they were added
    monkeypatch.setattr(profiler, "get_profiling_data", lambda: {"timings": {}})
    traced = SimpleNamespace(trace=object(), traced=SimpleNamespace(issued=[0, 1]))
    for name in READERS:
        assert registry.metric(name)(traced) is None
