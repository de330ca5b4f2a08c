"""Table-cache misses (``cache_stats()``) inside the measured window: each
one a table built while the traffic waits."""


def read(run):
    return float(run.misses)
