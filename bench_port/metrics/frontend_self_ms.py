"""The host's time in the port's front ends' own code over the traced
window, per batch: the self time of the port's ``models.*`` spans (a front
end's span less the ops, kernel wrappers and table builds it calls). None
where no such span ran."""

from ._recording import data, span_ms


def read(run):
    d = data(run)
    if d is None or not any(name.startswith("models.") for name in d["spans"]):
        return None
    return span_ms(d, "models.", "self_ms") / len(run.traced.issued)
