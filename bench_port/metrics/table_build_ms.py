"""The host's time building tables over the traced window, in all: the
port's ``tables.build.*`` spans (a table cache's miss: host build, cast,
copy to the device), outermost among them."""

from ._recording import data, span_ms


def read(run):
    d = data(run)
    return None if d is None else span_ms(d, "tables.build.", "outer_ms")
