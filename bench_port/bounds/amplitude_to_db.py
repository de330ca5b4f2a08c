"""The same operations and bytes as ``power_to_db``: only the coefficient
differs."""

from .power_to_db import cost  # noqa: F401
