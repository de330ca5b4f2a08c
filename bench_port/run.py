"""Run one cell of the port's benchmark once and print its result line.

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with an NVIDIA card. Set-up
imports the port, loads its kernels from the checkout's build cache
(``build/``; built there on a checkout's first run), makes the traffic's
pool of batches on the card from the seed and calls the entry once on each
batch shape; then the mix's loop (``loops/<loop>.py``) measures for
``--seconds``, and each metric of the line is read by its own reader
(``metrics/<metric>.py``).
With ``--trace 1`` a second window, of the same length up to 10 s, runs
under ``torch.profiler`` and the line carries the per-layer metrics. Once the
windows have closed and the peak memory has been read, the kept outputs are
held against the float64 reference (``reference/``) by the cell's limits
(``limits/<cell>.json``). The numbers compared go to standard error, each
with its limit, and into the line under ``checks``; the JSON line is the
last line of standard output.

Exit codes: 0 with a line (``correct`` may be false); 2 without a card, or
with fewer cards than the cell asks for; 3 if a module of JAX, the JAX
package or the JAX benchmarks was loaded (no line).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

from . import jaxfree, registry, traffic, window  # noqa: E402

#: The traced window's length at most: the profiler's events of a longer one
#: take minutes to read.
TRACE_SECONDS = 10.0


@dataclass
class Run:
    """What the metrics' readers read (``metrics/__init__.py``)."""
    cfg: dict
    entry: str
    ops: list
    shapes: list
    audio_s: list
    setup_s: float
    window: window.Window
    peak_bytes: int
    launches: dict
    misses: int
    traced: window.Window | None = None
    trace: object = None


def _launch_counts() -> dict:
    from mlx_audio_primitives_tpu_torch.kernels import _build

    return {k.name: k.launches for k in _build.KERNELS}


def _misses() -> int:
    from mlx_audio_primitives_tpu_torch.utils.cache import cache_stats

    return sum(s["misses"] for s in cache_stats().values())


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def judge(entry_mod, ref_mod, cfg: dict, pool: list, kept: dict,
          limits: dict) -> tuple[dict, int]:
    """The worst reading of each number over the kept batches, and how many
    kept batches broke a limit. A number without a limit breaks it."""
    from .reference.dsp import Prec

    worst, failed = {}, 0
    for idx, out in sorted(kept.items()):
        ref = ref_mod.reference(pool[idx].y, cfg, Prec("float64"))
        readings = entry_mod.compare(out, ref, cfg)
        del ref
        failed += any(not v <= limits.get(k, -1.0) for k, v in readings.items())
        for k, v in readings.items():
            worst[k] = max(worst.get(k, v), v)
    return worst, failed


def measure(workload: str, cell: dict, seed: int, seconds: float, trace: bool, device,
            t0: float = T0, call_override=None) -> dict:
    """Set up, measure and judge one run of ``cell``; the result line's dict.
    ``call_override(ap, cfg, call)`` replaces the timed call (the tests
    break the timed path with it)."""
    import torch

    cfg, mix = registry.config(cell["config"]), registry.traffic(cell["traffic"])
    entry_mod, ref_mod = registry.entry(mix["entry"]), registry.reference(mix["entry"])

    phases = {"torch": time.perf_counter() - t0}
    import mlx_audio_primitives_tpu_torch as ap

    phases["import"] = time.perf_counter() - t0
    if device.type == "cuda":
        from mlx_audio_primitives_tpu_torch.kernels import _build

        _build.library()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    phases["kernels"] = time.perf_counter() - t0
    call = entry_mod.program(ap, cfg)
    if call_override is not None:
        call = call_override(ap, cfg, call)
    shapes = traffic.batch_lengths(mix, cfg)
    pool = traffic.make_pool(mix, cfg, seed, device)
    order = traffic.schedule(len(pool), seed)
    keep = set(traffic.kept(mix, shapes, seed))
    loop = registry.loop(mix["loop"])
    phases["pool"] = time.perf_counter() - t0
    seen = set()
    for i, lengths in enumerate(shapes):        # warm every batch shape of the cell, once
        if (len(lengths), max(lengths)) not in seen:
            seen.add((len(lengths), max(lengths)))
            call(pool[i].y)
    window.sync(device)
    setup_s = time.perf_counter() - t0
    print("set-up, seconds from the start to the end of each phase: "
          + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()) + f", warm-up {setup_s:.3f}",
          file=sys.stderr)

    launches0, misses0 = _launch_counts(), _misses()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    w = loop.run(call, pool, order, seconds, device, keep)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    launches1 = _launch_counts()
    run = Run(cfg=cfg, entry=mix["entry"], ops=entry_mod.ops(cfg), shapes=shapes,
              audio_s=[b.audio_s for b in pool], setup_s=setup_s, window=w, peak_bytes=peak,
              launches={k: launches1[k] - launches0[k] for k in launches1},
              misses=_misses() - misses0)
    if trace:
        from torch.profiler import ProfilerActivity, profile

        from . import trace as trace_mod

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            run.traced = loop.run(call, pool, order, min(seconds, TRACE_SECONDS), device, keep,
                                  mark=True)
        run.trace = trace_mod.summarize(prof)
        del prof

    try:
        limits = registry.limits(workload)
    except KeyError:
        limits = {}
    kept = w.kept if run.traced is None else {**w.kept, **run.traced.kept}
    del call
    checks, failed = judge(entry_mod, ref_mod, cfg, pool, kept, limits)

    group = registry.benchmark()["per_layer" if trace else "end_to_end"]
    metrics = {}
    for m in group:
        if workload in m.get("workloads", [workload]):
            value = registry.metric(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power_limit"] = _power_limit()
    result = {"correct": bool(limits) and failed == 0, "attempted": len(w.issued),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.traced.seconds
        result["breakdown"] = trace_mod.breakdown(run.trace)
    result["checks"] = {k: {"value": v, "limit": limits.get(k)} for k, v in checks.items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = registry.cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"error: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = measure(args.workload, cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0))
    found = jaxfree.offending()
    if found:
        print(f"error: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
