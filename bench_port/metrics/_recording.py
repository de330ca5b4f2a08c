"""What the per-layer readers of the port's own spans and counters share:
the recording the traced window left in the port (``utils/profiler.py``).
The window runs under ``torch.profiler``, and the port records while a
profiler session runs, from a fresh start at the session's first hook."""


def data(run):
    """``get_profiling_data()`` of the port after the traced window, or None
    without a traced window or where the port keeps no spans."""
    if run.trace is None or not run.traced.issued:
        return None
    from mlx_audio_primitives_tpu_torch.utils import profiler

    d = profiler.get_profiling_data()
    return d if "spans" in d and "counters" in d else None


def span_ms(d: dict, prefix: str, key: str) -> float:
    """The sum of ``key`` (``total_ms``, ``self_ms``, ``outer_ms``) over the
    spans whose names start with ``prefix``."""
    return sum((s[key] for name, s in d["spans"].items() if name.startswith(prefix)), 0.0)
