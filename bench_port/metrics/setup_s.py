"""Process start to the measured window: imports, the kernels loaded from
the checkout's build cache (built there on its first run), the pool made on
the card, each batch shape called once."""


def read(run):
    return run.setup_s
