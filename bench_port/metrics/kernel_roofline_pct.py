"""``kernel_roofline_pct.<kernel>``: one kernel's share of its roofline over
the traced window: the least time the card needs for the public op that the
kernel computes alone (``bounds/<op>.py``), summed over the traced batches,
over the device seconds of the trace's operations whose names contain
``<kernel>``. None where no such operation ran (a program without the
kernel) or the entry does not call the op."""

from .. import registry
from ..bounds import seconds

#: kernel -> the public op whose whole work it does
OPS = {"mel_fused_mixed_kernel": "melspectrogram"}


def read(run, kernel: str):
    op = OPS.get(kernel)
    if run.trace is None or op is None or op not in run.ops:
        return None
    device_s = sum(s for name, s in run.trace.by_name.items() if kernel in name)
    if not device_s:
        return None
    cost = registry.bound(op).cost
    least = sum(seconds(*cost(run.cfg, run.shapes[idx])) for idx in run.traced.issued)
    return 100.0 * least / device_s
