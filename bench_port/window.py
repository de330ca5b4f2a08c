"""What every measured loop (``loops/<loop>.py``) records: the window's
wall time, the pool batch of each issue, each batch's stream time between
its two CUDA events, the host's time inside the entry calls and the kept
outputs; and the host spans a loop marks for the profiler."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

SPANS = ("bench.select", "bench.entry", "bench.wait")


class _HostEvent:
    """A stand-in for ``torch.cuda.Event`` on the CPU, where work is done
    when the call returns (used by the CPU tests only)."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return 1e3 * (end.t - self.t)


def event(device: torch.device):
    return torch.cuda.Event(enable_timing=True) if device.type == "cuda" else _HostEvent()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Window:
    seconds: float = 0.0                  # wall time, first issue to the final synchronize
    issued: list[int] = field(default_factory=list)    # pool index of each batch, in order
    batch_ms: list[float] = field(default_factory=list)
    entry_s: float = 0.0                  # host time inside the entry calls
    kept: dict = field(default_factory=dict)           # pool index -> its last outputs
