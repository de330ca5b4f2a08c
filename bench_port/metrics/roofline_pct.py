"""``roofline_pct.<entry>``: the least time the card needs for the entry's
ops over every batch of the traced window (``bounds/<op>.py``), over the
device time of all operations in that window."""

from .. import registry
from ..bounds import seconds


def read(run, entry: str):
    if run.trace is None or run.entry != entry or not run.trace.device_s:
        return None
    per_batch = {}
    for idx in set(run.traced.issued):
        per_batch[idx] = sum(seconds(*registry.bound(op).cost(run.cfg, run.shapes[idx]))
                             for op in run.ops)
    least = sum(per_batch[idx] for idx in run.traced.issued)
    return 100.0 * least / run.trace.device_s
