"""Launches of the port's kernels (``Kernel.launches``) over the measured
window, divided by its batches: which route a batch took."""


def read(run):
    n = len(run.window.issued)
    return sum(run.launches.values()) / n if n else None
