"""The host's time in the public ops' own code over the traced window, per
batch: the self time of the port's ``ops.*`` spans (each op's span less the
spans it calls: other ops, kernel wrappers, table builds)."""

from ._recording import data, span_ms


def read(run):
    d = data(run)
    return None if d is None else span_ms(d, "ops.", "self_ms") / len(run.traced.issued)
