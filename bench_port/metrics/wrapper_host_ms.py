"""The host's time in the port's kernel wrappers over the traced window,
per batch: the ``kernels.*`` spans outermost among kernel wrappers, their
``launch.*`` spans included."""

from ._recording import data, span_ms


def read(run):
    d = data(run)
    return None if d is None else span_ms(d, "kernels.", "outer_ms") / len(run.traced.issued)
