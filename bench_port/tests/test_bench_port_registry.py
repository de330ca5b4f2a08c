"""Every part of the benchmark is found by name, and a new file is found
with no edit to any file that is there."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from bench_port import registry


def test_every_cell_resolves():
    bench = registry.benchmark()
    for cell in bench["workloads"]:
        cfg, mix = registry.config(cell["config"]), registry.traffic(cell["traffic"])
        entry = registry.entry(mix["entry"])
        assert callable(registry.clips(mix["clips"]["kind"]).lengths)
        assert callable(registry.audio(mix["audio"]).make)
        assert callable(registry.loop(mix["loop"]).run)
        registry.reference(mix["entry"])
        for op in entry.ops(cfg):
            assert callable(registry.bound(op).cost)
        assert registry.limits(cell["name"])
        assert cell["chips"] == 1
    for m in bench["per_layer"] + bench["end_to_end"]:
        assert callable(registry.metric(m["name"]))
    assert {c["name"] for c in bench["configs"]} == {w["config"] for w in bench["workloads"]}


def test_config_files_match_benchmark():
    for c in registry.benchmark()["configs"]:
        data = json.loads((registry.ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] == []
        assert len(data["source"]) <= 200 and data["assumed"]


def test_unknown_names_raise():
    for find in (registry.config, registry.traffic, registry.clips, registry.audio,
                 registry.loop, registry.entry, registry.bound, registry.metric, registry.limits):
        with pytest.raises(KeyError):
            find("no_such_part")


def test_dotted_metric_falls_back_to_its_family():
    read = registry.metric("roofline_pct.some_new_entry")
    assert callable(read)


NEW_CLIPS = """
def lengths(clips, cfg, pool):
    import numpy as np
    law, rng = cfg["clip_seconds"], np.random.default_rng(clips["sizes_seed"])
    draw = law["min"] + (law["max"] - law["min"]) * rng.beta(*law["beta"], (pool, clips["batch"]))
    return [[int(round(s * cfg["sr"])) for s in row] for row in draw]
"""

NEW_AUDIO = """
import math, torch
def make(lengths, sr, gen, device):
    B, L = len(lengths), max(lengths)
    t = torch.arange(L, dtype=torch.float64, device=device) / sr
    f0 = 100 + 900 * torch.rand(B, 1, dtype=torch.float64, generator=gen, device=device)
    y = 0.3 * torch.sin(2 * math.pi * f0 * t * (1 + t))
    y[t[None, :] * sr >= torch.as_tensor(lengths, device=device)[:, None]] = 0
    return y.float()
"""

NEW_LOOP = """
import time
from ..window import Window, event, sync
def run(call, pool, order, seconds, device, keep=frozenset(), mark=False):
    w, t0 = Window(), time.perf_counter()
    i = 0
    while time.perf_counter() < t0 + seconds:
        idx = order[i % len(order)]
        i += 1
        start, end = event(device), event(device)
        start.record()
        out = call(pool[idx].y)
        end.record()
        end.synchronize()
        w.batch_ms.append(start.elapsed_time(end))
        w.issued.append(idx)
        if idx in keep:
            w.kept[idx] = out
    sync(device)
    w.seconds = time.perf_counter() - t0
    return w
"""


def test_new_files_are_found_without_edits(tmp_path):
    """A copy of the benchmark gains, as new files only, a configuration, a
    traffic mix with a new kind of clips (unbucketed lengths drawn from the
    law), a new kind of audio and a new loop, a bound, an end-to-end and a
    per-layer metric and a cell's limits; with the cell added to its
    ``BENCHMARK.json``, the copy finds each part by name and runs the cell
    on the CPU to a correct line that carries the new metric."""
    shutil.copytree(registry.HERE, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pkg = tmp_path / "bench_port"
    cfg = json.loads((pkg / "configs" / "ljspeech_hifigan.json").read_text())
    cfg["n_mels"] = 64
    (pkg / "configs" / "new_deployment.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "new_mix.json").write_text(json.dumps(
        {"entry": "logmel", "loop": "serial", "audio": "chirps",
         "clips": {"kind": "drawn", "batch": 3, "sizes_seed": 7}, "pool": 2, "keep": 1}))
    (pkg / "clips" / "drawn.py").write_text(NEW_CLIPS)
    (pkg / "audio" / "chirps.py").write_text(NEW_AUDIO)
    (pkg / "loops" / "serial.py").write_text(NEW_LOOP)
    (pkg / "bounds" / "new_op.py").write_text("def cost(cfg, lengths):\n    return 1.0, 2.0\n")
    (pkg / "metrics" / "clips_per_s.py").write_text(
        "def read(run):\n    return sum(len(run.shapes[i]) for i in run.window.issued)"
        " / run.window.seconds\n")
    (pkg / "metrics" / "new_metric.py").write_text("def read(run):\n    return 42.0\n")
    (pkg / "limits" / "new_deployment.new_mix.json").write_text(
        (pkg / "limits" / "ljspeech_hifigan.logmel_bucketed.json").read_text())
    bench = registry.benchmark()
    bench["configs"].append(dict(bench["configs"][1], name="new_deployment",
                                 file="bench_port/configs/new_deployment.json"))
    bench["workloads"].append({"name": "new_deployment.new_mix", "config": "new_deployment",
                               "traffic": "new_mix", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "clips_per_s", "unit": "clips/s", "better": "higher",
                                "bound": 0.03, "source": "host_clock",
                                "workloads": ["new_deployment.new_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    probe = textwrap.dedent("""
        import time, torch
        from bench_port import registry, run
        assert registry.HERE.parent == __import__("pathlib").Path.cwd()
        assert registry.bound("new_op").cost({}, [1]) == (1.0, 2.0)
        assert registry.metric("new_metric")(None) == 42.0
        cell = registry.cell("new_deployment.new_mix")
        res = run.measure(cell["name"], cell, 2**31 + 5, 0.3, False, torch.device("cpu"),
                          t0=time.perf_counter())
        assert res["correct"], res["checks"]
        assert set(res["metrics"]) == {"audio_s_per_s", "batch_ms_p95", "peak_mem_gib",
                                       "setup_s", "clips_per_s"}, res["metrics"]
        assert res["metrics"]["clips_per_s"]["value"] > 0
        print("found")
    """)
    env = dict(os.environ, PYTHONPATH=str(registry.ROOT))
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "found"
