"""A closed loop that dispatches ahead, as a data loader with prefetch
feeds a front end.

Batches are issued back to back from the pool in the seed's order. Before
issuing a batch the host waits for the batch issued two before it to
complete, so at most two are in flight. A CUDA event is recorded on the
stream just before each batch's first call and just after its last; the
window ends with ``torch.cuda.synchronize()``. The host's own spans (batch
select, entry call, event wait) are timed on its clock and, under the
profiler, marked with ``record_function`` so that idle gaps can be named.
"""

from __future__ import annotations

import contextlib
import gc
import time
from collections import deque

import torch

from ..window import SPANS, Window, event, sync


def run(call, pool: list, order: list[int], seconds: float, device: torch.device,
        keep: set[int] = frozenset(), mark: bool = False) -> Window:
    label = torch.profiler.record_function if mark else (lambda _: contextlib.nullcontext())
    w = Window()
    events, inflight = [], deque()
    # the window's own bookkeeping grows by a few objects a batch; a cyclic
    # collection pass over them would stall the host for milliseconds
    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        while time.perf_counter() < deadline:
            with label(SPANS[0]):
                idx = order[i % len(order)]
                y = pool[idx].y
                i += 1
            if len(inflight) == 2:
                with label(SPANS[2]):
                    inflight.popleft().synchronize()
            with label(SPANS[1]):
                start, end = event(device), event(device)
                start.record()
                h0 = time.perf_counter()
                out = call(y)
                w.entry_s += time.perf_counter() - h0
                end.record()
            if idx in keep:
                w.kept[idx] = out
            del out
            inflight.append(end)
            events.append((start, end))
            w.issued.append(idx)
        sync(device)
        w.seconds = time.perf_counter() - t0
    finally:
        gc.enable()
    w.batch_ms = [s.elapsed_time(e) for s, e in events]
    return w
