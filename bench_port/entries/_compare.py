"""The readings every entry's comparison is made of, worked out in float64."""

from __future__ import annotations

import torch


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap over the reference's largest magnitude."""
    got, ref = _pair(got, ref)
    return float((got - ref).abs().max() / ref.abs().max())


def abs_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = _pair(got, ref)
    return float((got - ref).abs().max())


def rel_err_where(got: torch.Tensor, ref: torch.Tensor, held: torch.Tensor) -> float:
    """The widest gap relative to the reference's own value, over the values
    that ``held`` marks; infinite where it marks none."""
    got, ref = _pair(got, ref)
    held = held.to(got.device)
    if not bool(held.any()):
        return float("inf")
    return float(((got - ref).abs() / ref)[held].max())


def mismatch_share(got: torch.Tensor, ref: torch.Tensor, step: float) -> float:
    """The share of values more than half a ``step`` from the reference's
    (a value on a grid of ``step``, such as a bin's frequency, that landed
    on another point of the grid)."""
    got, ref = _pair(got, ref)
    return float(((got - ref).abs() > step / 2).double().mean())


def _pair(got: torch.Tensor, ref: torch.Tensor):
    if got.shape != ref.shape:
        raise ValueError(f"output shape {tuple(got.shape)}, reference {tuple(ref.shape)}")
    if got.is_complex() or ref.is_complex():
        return got.to(torch.complex128), ref.to(device=got.device, dtype=torch.complex128)
    return got.double(), ref.to(device=got.device, dtype=torch.float64)
