"""Find the benchmark's parts by name, so that a new configuration, traffic
mix, entry, per-layer metric, op bound or set of limits is a new file and
no existing file changes.

    configs/<config>.json     a deployment: every op argument, ``assumed``, ``reduced``
    traffic/<mix>.json        a traffic mix: the entry, loop, clips and audio it names, its pool
    clips/<kind>.py           the batch shapes of one kind of clips (``clips.kind``)
    audio/<kind>.py           the seeded waveforms of one kind of audio (``audio``)
    loops/<loop>.py           one measured loop (``loop``)
    entries/<entry>.py        what the loop calls on the port, and how it is judged
    reference/<entry>.py      the plain float64 reference of that entry
    bounds/<op>.py            the operations and bytes one public op needs
    metrics/<metric>.py       the reader of one metric, end-to-end or per-layer
    limits/<cell>.json        the limits that decide ``correct`` in one cell

A metric named ``<family>.<part>`` without a file of its own is read by
``metrics/<family>.py`` with ``<part>`` as its argument (``roofline_pct.logmel``).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no {kind} named {name!r} (looked for {path.relative_to(ROOT)})")
    return json.loads(path.read_text())


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def limits(cell: str) -> dict:
    return _json("limits", cell)


def _module(kind: str, name: str) -> ModuleType:
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} named {name!r} (looked for {path.relative_to(ROOT)})")
    if "." not in name:
        return importlib.import_module(f"bench_port.{kind}.{name}")
    # a dotted metric name is a file name, not a package path
    spec = importlib.util.spec_from_file_location(f"bench_port.{kind}._{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def clips(kind: str) -> ModuleType:
    return _module("clips", kind)


def audio(kind: str) -> ModuleType:
    return _module("audio", kind)


def loop(name: str) -> ModuleType:
    return _module("loops", name)


def entry(name: str) -> ModuleType:
    return _module("entries", name)


def reference(name: str) -> ModuleType:
    return _module("reference", name)


def bound(op: str) -> ModuleType:
    return _module("bounds", op)


def metric(name: str):
    """The reader of a metric: a callable ``read(run) -> float | None``."""
    if (HERE / "metrics" / f"{name}.py").is_file():
        return _module("metrics", name).read
    family, _, part = name.partition(".")
    if part and (HERE / "metrics" / f"{family}.py").is_file():
        read = _module("metrics", family).read
        return lambda run: read(run, part)
    raise KeyError(f"no reader for the metric {name!r} in bench_port/metrics/")


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(workload: str) -> dict:
    """The workload's entry in ``BENCHMARK.json``."""
    for w in benchmark()["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"BENCHMARK.json has no workload named {workload!r}")
