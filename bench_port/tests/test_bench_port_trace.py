"""The trace's reduction: the device's busy time is the union of its
intervals, and each idle gap is named by the host span open when it began."""

from __future__ import annotations

import pytest

from bench_port import trace


def test_union_gaps_and_labels():
    dev = [(0.0, 10.0, "k1"), (5.0, 12.0, "k2"), (20.0, 25.0, "k1"), (40.0, 41.0, "k3"),
           (50.0, 52.0, "k3")]
    host = [(11.0, 15.0, "entry call"), (15.0, 30.0, "event wait")]
    t = trace.reduce(dev, host)
    assert t.busy_s == pytest.approx((12 + 5 + 1 + 2) * 1e-6)
    assert t.device_s == pytest.approx((10 + 7 + 5 + 1 + 2) * 1e-6)
    assert t.by_name == pytest.approx({"k1": 15e-6, "k2": 7e-6, "k3": 3e-6})
    assert t.gaps == [(pytest.approx(8e-6), "entry call"), (pytest.approx(15e-6), "event wait"),
                      (pytest.approx(9e-6), "between spans")]


def test_breakdown_keeps_ten_entries_at_most():
    dev = [(2.0 * i, 2.0 * i + 1, f"k{i}") for i in range(30)]
    host = [(2.0 * i + 1, 2.0 * i + 2, ("entry call", "event wait", "batch select")[i % 3])
            for i in range(30)]
    b = trace.breakdown(trace.reduce(dev, host))
    assert len(b["device_ops"]) == 10 and len(b["idle_gaps"]) <= 10
    assert {name.split(":")[0] for name, _ in b["idle_gaps"]} == {"entry call", "event wait",
                                                                    "batch select"}
