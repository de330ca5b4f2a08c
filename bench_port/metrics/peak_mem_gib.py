"""``torch.cuda.max_memory_allocated()`` over the measured window, after
``reset_peak_memory_stats()`` at its start: the pool, the batches in
flight and the kept outputs."""


def read(run):
    return run.peak_bytes / 2**30
