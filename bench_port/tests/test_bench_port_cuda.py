"""On the card: one short run of each cell comes out correct, and the
control at the cell's own size does not. Skips without a card; run on the
card with ``python -m pytest -m cuda bench_port/tests``."""

from __future__ import annotations

import time

import pytest

from bench_port import registry, run

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(card, cell):
    res = run.measure(cell, registry.cell(cell), 2**31 + 1234, 1.0, False, card,
                      t0=time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(card, cell):
    from bench_port import calibrate

    limits = registry.limits(cell)
    for r in calibrate.readings(cell, [2**31 + 77], True, card):
        assert any(v > limits[k] for k, v in r["readings"].items()), r
