"""What the traced window's ``torch.profiler`` trace says: the device's busy
time (the union of its kernel and copy intervals), the device time of all
its operations and by name, and its idle gaps named by the host span that
was open when each began. Nothing is exported: only these sums are kept."""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from .window import SPANS

NAMES = {"bench.select": "batch select", "bench.entry": "entry call", "bench.wait": "event wait"}


@dataclass
class Trace:
    busy_s: float = 0.0
    device_s: float = 0.0                               # the sum of every device interval
    by_name: dict = field(default_factory=dict)         # kernel name -> seconds
    gaps: list = field(default_factory=list)            # (seconds, host span) of each idle gap


def summarize(prof) -> Trace:
    """Reduce a finished ``torch.profiler.profile``'s raw events (no tree of
    function events is built, which would take minutes for a 10 s window):
    device intervals are the events on the CUDA device, host spans the
    window's ``record_function`` marks."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a, b = e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            if name not in SPANS:        # the marks' own ranges on the GPU timeline
                dev.append((a, b, name))
        elif name in SPANS:
            host.append((a, b, NAMES[name]))
    return reduce(dev, host)


def reduce(dev: list, host: list) -> Trace:
    """``dev``: (start_us, end_us, name) of device operations; ``host``:
    (start_us, end_us, label) of host spans."""
    t = Trace()
    dev.sort()
    host.sort()
    starts = [h[0] for h in host]
    end = None
    for a, b, name in dev:
        t.device_s += (b - a) * 1e-6
        t.by_name[name] = t.by_name.get(name, 0.0) + (b - a) * 1e-6
        if end is None or a >= end:
            if end is not None and a > end:
                t.gaps.append(((a - end) * 1e-6, _open_at(host, starts, end)))
            t.busy_s += (b - a) * 1e-6
            end = b
        elif b > end:
            t.busy_s += (b - end) * 1e-6
            end = b
    return t


def _open_at(host: list, starts: list, at: float) -> str:
    """The host span open at ``at``; the host's spans do not overlap."""
    i = bisect.bisect_right(starts, at) - 1
    if i >= 0 and host[i][1] >= at:
        return host[i][2]
    return "between spans"


def breakdown(t: Trace) -> dict:
    """The contract's ``breakdown``: the device operations that took most
    time, and the idle time by host span with the longest single gap of
    each, ten entries at most each."""
    ops = sorted(t.by_name.items(), key=lambda kv: -kv[1])[:10]
    by_span: dict = {}
    for s, label in t.gaps:
        total, longest = by_span.get(label, (0.0, 0.0))
        by_span[label] = (total + s, max(longest, s))
    gaps = []
    for label, (total, longest) in sorted(by_span.items(), key=lambda kv: -kv[1][0]):
        gaps += [[f"{label}: all gaps", total], [f"{label}: longest gap", longest]]
    return {"device_ops": [[name[:160], s] for name, s in ops], "idle_gaps": gaps[:10]}
