"""``correct`` on the CPU at a size a test run holds: the harness's look for
a card is skipped (``run.measure`` on the CPU, where the port takes its
plain routes) and the rest of a run is driven. A sound run comes out
correct; the control (the reference in TF32) and each fault a cell can
have, planted under the timed call, come out not correct."""

from __future__ import annotations

import math
import time

import pytest
import torch

from bench_port import registry, run
from bench_port.reference.dsp import Prec

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.fixture(autouse=True)
def small_traffic(monkeypatch):
    """Every mix at a few short clips: the same generator, entry and limits."""
    full = registry.traffic

    def small(name):
        mix = full(name)
        clips = mix["clips"]
        if clips["kind"] == "fixed":
            clips.update(batch=3, seconds=1.5)
            mix.update(pool=3, keep=2)
        else:
            clips["batch_audio_seconds"] = 14.0
        return mix

    monkeypatch.setattr(registry, "traffic", small)


def drive(cell: str, override=None) -> dict:
    return run.measure(cell, registry.cell(cell), 2**31 + 99, 0.2, False, torch.device("cpu"),
                       t0=time.perf_counter(), call_override=override)


def _control(cell: str):
    """The reference in TF32, put in the program's place."""
    ref_mod = registry.reference(registry.traffic(registry.cell(cell)["traffic"])["entry"])
    return lambda ap, cfg, call: (lambda y: ref_mod.reference(y, cfg, Prec("tf32")))


def _each(fn):
    """Apply ``fn(name, tensor)`` to each output of the timed call."""
    def override(ap, cfg, call):
        return lambda y: {k: fn(k, v) for k, v in call(y).items()}
    return override


def _half_left_out(name, v):
    v = v.clone()
    v[v.shape[0] // 2:] = 0
    return v


def _one_altered(name, v):
    v = v.contiguous().clone()
    flat = v.view(-1)
    flat[flat.numel() // 3] += 0.05 * flat.abs().max()
    return v


def _tone_band_peaks_off(ap, cfg, call):
    """Every band whose valley lies at least 30 dB under its peak (a band
    that holds a tone) reads its peak 20% high: its valley-to-peak ratio
    moves by a sixth of itself, under 1e-3 as an absolute gap."""
    def wrong(y):
        out = call(y)
        c = out["contrast"]
        out["contrast"] = torch.where(c > 30.0, c + 10 * math.log10(1.2), c)
        return out
    return wrong


def test_a_wrong_peak_in_a_tone_band_is_not_correct():
    res = drive("gtzan_librosa.features", _tone_band_peaks_off)
    assert not res["correct"], res["checks"]
    checks = res["checks"]
    assert checks["contrast_rel_err"]["value"] > checks["contrast_rel_err"]["limit"]
    assert checks["contrast_ratio_err"]["value"] <= checks["contrast_ratio_err"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = drive(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"audio_s_per_s", "batch_ms_p95", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    res = drive(cell, _control(cell))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [_half_left_out, _one_altered], ids=["half_left_out",
                                                                       "one_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault):
    res = drive(cell, _each(fault))
    assert not res["correct"], res["checks"]
    assert res["failed"] >= 1


def test_missing_limits_are_not_correct(monkeypatch):
    monkeypatch.setattr(registry, "limits", lambda cell: (_ for _ in ()).throw(KeyError(cell)))
    assert not drive(CELLS[0])["correct"]
