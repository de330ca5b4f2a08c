"""The check that the run measured the port alone: no module of JAX, of the
JAX package or of the repository's JAX benchmarks is loaded. Names are
compared by their top-level part, whole: ``mlx_audio_primitives_tpu_torch``
is the port, ``mlx_audio_primitives_tpu`` the JAX package."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mlx_audio_primitives_tpu", "benchmarks",
                       "chip_smoke"})


def offending(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
