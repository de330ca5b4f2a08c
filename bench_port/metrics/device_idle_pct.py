"""The share of the traced window in which nothing ran on the device (the
union of its operations' intervals from ``torch.profiler``)."""


def read(run):
    if run.trace is None or not run.traced.seconds:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.traced.seconds)
