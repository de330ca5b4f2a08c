"""PyTorch port: K6's plain twin and the dB conversion's route (on the CPU).

``to_db_plain`` is the composition ``power_to_db`` and ``amplitude_to_db``
ran before K6 existed, moved unchanged: it is held here bit for bit against
that composition, written out below, over the coefficients, ``amin``,
``ref`` (scalar and callable) and ``top_db``, and on inputs of one to three
dimensions holding NaN, +inf and values below ``amin``. The route takes K6
only for a scalar ``ref`` and a non-empty input, of any layout, and counts
the reason it did not; an empty input raises as it did. K6 itself runs only on
the card (``tests/test_torch_port_db_fused_cuda.py``).
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch
from torch_port_util import same_bits

import mlx_audio_primitives_tpu_torch as tap
from mlx_audio_primitives_tpu_torch.kernels import db_fused as k6
from mlx_audio_primitives_tpu_torch.kernels.db_fused import (fills_one_block, to_db_fused,
                                                             to_db_plain)
from mlx_audio_primitives_tpu_torch.utils import dispatch, profiler


def composition_before_k6(S, ref, coefficient, amin, top_db):
    """The body of ``ops/convert.py::_to_db`` before K6, after its checks."""
    if callable(ref):
        ref_value = torch.as_tensor(ref(S), dtype=S.dtype, device=S.device)
        ref_clamped = torch.clamp(ref_value, min=amin)
    else:
        ref_clamped = float(max(np.float32(ref), np.float32(amin)))
    S_db = coefficient * torch.log10(torch.clamp(S, min=amin) / ref_clamped)
    if top_db is not None:
        S_db = torch.maximum(S_db, S_db.max() - top_db)
    return S_db


def spectrum(shape, seed=0, special=True) -> torch.Tensor:
    """Powers over 14 decades, with a NaN, a +inf, a zero and values just
    below 1e-5 and 1e-10 when ``special``."""
    rng = np.random.default_rng(seed)
    S = (10.0 ** rng.uniform(-12, 2, size=shape)).astype(np.float32)
    flat = S.reshape(-1)
    if special:
        flat[:5] = [np.nan, np.inf, 0.0, 9e-6, 9e-11]
        rng.shuffle(flat)
    return torch.from_numpy(S)


def _max_ref(S):
    return S[torch.isfinite(S)].max()


REFS = {"1.0": 1.0, "2.5": 2.5, "callable": _max_ref}
CASES = list(itertools.product((10.0, 20.0), (1e-10, 1e-5), REFS, (None, 80.0)))


@pytest.mark.parametrize("coefficient,amin,ref,top_db", CASES)
def test_twin_is_the_composition_before_k6(coefficient, amin, ref, top_db):
    S = spectrum((3, 16, 21), special=False)
    want = composition_before_k6(S, REFS[ref], coefficient, amin, top_db)
    assert same_bits(to_db_plain(S, coefficient, REFS[ref], amin, top_db), want)
    public = tap.power_to_db if coefficient == 10.0 else tap.amplitude_to_db
    assert same_bits(public(S, ref=REFS[ref], amin=amin, top_db=top_db), want)


@pytest.mark.parametrize("shape,coefficient,top_db",
                         [((257,), 10.0, 80.0), ((40, 33), 20.0, None), ((2, 24, 19), 10.0, None),
                          ((2, 24, 19), 20.0, 80.0)])
def test_twin_on_nan_inf_and_values_below_amin(shape, coefficient, top_db):
    S = spectrum(shape, seed=len(shape))
    for amin, ref in ((1e-10, 1.0), (1e-5, 2.5)):
        want = composition_before_k6(S, ref, coefficient, amin, top_db)
        got = to_db_plain(S, coefficient, ref, amin, top_db)
        assert same_bits(got, want)
        # a NaN anywhere makes every value NaN once the floor is against the maximum
        assert bool(torch.isnan(got).all()) == (top_db is not None)
        assert same_bits(to_db_fused(S, coefficient, ref, amin, top_db), want)


def _gates(monkeypatch, S, **kw) -> dict:
    seen = {}

    def route(op, flag, device, **gates):
        seen.update(op=op, flag=flag, device=device.type, **gates)
        return False

    monkeypatch.setattr(dispatch, "route", route)
    tap.power_to_db(S, **kw)
    return seen


@pytest.mark.parametrize("case", ["contiguous", "callable_ref", "transposed", "empty"])
def test_the_route_is_asked_for_k6_with_its_gates(monkeypatch, case):
    S = spectrum((2, 8, 6), special=False)
    kw = dict(top_db=None)
    if case == "callable_ref":
        kw["ref"] = _max_ref
    elif case == "transposed":
        S = S.transpose(1, 2)
    elif case == "empty":
        S = S[:0]
    seen = _gates(monkeypatch, S, **kw)
    assert seen == dict(op="power_to_db", flag=None, device="cpu", ref=case != "callable_ref",
                        nonempty=case != "empty")


def test_the_route_counts_why_k6_was_not_taken():
    profiler.clear_profiling()
    profiler.enable_profiling()
    try:
        cuda = torch.device("cuda", 0)
        for op in ("power_to_db", "amplitude_to_db"):
            assert dispatch.route(op, None, cuda, ref=False, nonempty=True) is False
            assert dispatch.route(op, None, cuda, ref=True, nonempty=False) is False
            assert dispatch.route(op, None, cuda, ref=True, nonempty=True) is True
        counters = profiler.get_profiling_data()["counters"]
    finally:
        profiler.disable_profiling()
        profiler.clear_profiling()
    assert counters == {f"dispatch.{k}": 1 for k in (
        "plain.power_to_db.ref", "plain.power_to_db.nonempty", "kernel.power_to_db",
        "plain.amplitude_to_db.ref", "plain.amplitude_to_db.nonempty", "kernel.amplitude_to_db")}


VIEWS = {
    "contiguous": (lambda S: S, True),
    "transposed": (lambda S: S.transpose(1, 2), True),
    "permuted": (lambda S: S.permute(2, 0, 1), True),
    "unit_dims": (lambda S: S[:1, :, None].transpose(0, 2), True),
    "offset": (lambda S: S[1:], True),
    "strided": (lambda S: S[:, ::2], False),
    "column_slice": (lambda S: S[..., :5], False),
    "broadcast": (lambda S: S[:, :1].expand(4, 8, 6), False),
}


@pytest.mark.parametrize("view", VIEWS)
def test_k6_takes_a_layout_where_its_values_fill_one_block(view):
    """K6 maps each value where it lies and writes the result at the same
    offsets, so it takes a tensor as it is exactly when its values fill
    ``numel()`` neighbouring elements of storage, whatever the order of its
    dimensions; a strided or broadcast view is copied first."""
    make, fills = VIEWS[view]
    S = make(torch.arange(4 * 8 * 6, dtype=torch.float32).reshape(4, 8, 6))
    assert fills_one_block(S) is fills
    if fills:
        span = sorted(S.flatten().tolist())
        first = int(S.flatten().min())
        assert span == list(range(first, first + S.numel()))


@pytest.mark.parametrize("top_db", [None, 80.0])
@pytest.mark.parametrize("view", VIEWS)
def test_k6_launches_on_the_values_where_they_lie(monkeypatch, view, top_db):
    """The wrapper's arguments, its launcher call recorded instead of made:
    the input's own storage where its values fill one block (else a
    contiguous copy), a result with the input's strides, the float32
    reciprocal of ``ref``; one launch, or with ``top_db`` two (the maximum
    into the workspace, then the floor) in the one call."""
    calls = []
    monkeypatch.setattr(k6.KERNEL, "launch",
                        lambda device, *args, launches=1: calls.append((args, launches)))
    workspace = torch.empty(8)
    monkeypatch.setattr(k6, "_workspace", lambda device: workspace)
    make, fills = VIEWS[view]
    S = make(spectrum((4, 8, 6), special=False))
    out = k6._launch(S, coefficient=10.0, ref=2.5, amin=1e-10, top_db=top_db)
    assert out.shape == S.shape
    if fills:
        assert out.stride() == S.stride()
    [((s_ptr, out_ptr, n, amin, inv, coef, has_top_db, thr, slot), launches)] = calls
    assert (s_ptr == S.data_ptr()) is fills and out_ptr == out.data_ptr()
    assert (n, amin, coef) == (S.numel(), 1e-10, 10.0)
    assert np.float32(inv) == np.float32(1.0) / np.float32(2.5)
    if top_db is None:
        assert (has_top_db, thr, slot, launches) == (False, 0.0, None, 1)
    else:
        assert (has_top_db, thr, slot, launches) == (True, top_db, workspace.data_ptr(), 2)


@pytest.mark.parametrize("fn,coefficient", [(tap.power_to_db, 10.0), (tap.amplitude_to_db, 20.0)])
def test_an_empty_input_raises_as_before(fn, coefficient):
    S = torch.empty((2, 0, 5))
    with pytest.raises(RuntimeError) as before:
        composition_before_k6(S, 1.0, coefficient, 1e-5, 80.0)
    with pytest.raises(RuntimeError) as now:
        fn(S, amin=1e-5)
    assert str(now.value) == str(before.value)
    assert fn(S, top_db=None).shape == S.shape
