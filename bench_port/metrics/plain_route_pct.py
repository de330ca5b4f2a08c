"""The share of the routing decisions over the traced window that took the
plain route: the port's ``dispatch.plain.*`` counters over those and its
``dispatch.kernel.*`` counters (calls on a CUDA tensor, or with
``use_pallas=True``)."""

from ._recording import data


def read(run):
    d = data(run)
    if d is None:
        return None
    plain = sum(n for k, n in d["counters"].items() if k.startswith("dispatch.plain."))
    kernel = sum(n for k, n in d["counters"].items() if k.startswith("dispatch.kernel."))
    return 100.0 * plain / (plain + kernel) if plain + kernel else None
