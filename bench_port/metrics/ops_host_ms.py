"""The host's time inside the entry call (call to return, no synchronise),
summed over the measured window and divided by its batches."""


def read(run):
    n = len(run.window.issued)
    return 1e3 * run.window.entry_s / n if n else None
