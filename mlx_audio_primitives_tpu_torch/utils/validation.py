"""Parameter validation helpers with consistent error messages.

Counterpart of `mlx_audio_primitives_tpu/utils/validation.py`; the messages
are the same so callers see the same errors from both packages.
"""

from __future__ import annotations


def validate_positive(value: float | int, name: str) -> None:
    """Raise ValueError unless ``value`` > 0."""
    if value <= 0:
        raise ValueError(f"{name} must be positive, got {value}")


def validate_non_negative(value: float | int, name: str) -> None:
    """Raise ValueError unless ``value`` >= 0."""
    if value < 0:
        raise ValueError(f"{name} must be non-negative, got {value}")


def validate_range(
    value: float | int,
    name: str,
    low: float | None = None,
    high: float | None = None,
    inclusive: bool = True,
) -> None:
    """Raise ValueError unless ``low <= value <= high`` (or strict if not inclusive)."""
    if low is not None:
        if inclusive and value < low:
            raise ValueError(f"{name} must be >= {low}, got {value}")
        if not inclusive and value <= low:
            raise ValueError(f"{name} must be > {low}, got {value}")
    if high is not None:
        if inclusive and value > high:
            raise ValueError(f"{name} must be <= {high}, got {value}")
        if not inclusive and value >= high:
            raise ValueError(f"{name} must be < {high}, got {value}")
