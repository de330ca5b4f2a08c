"""PyTorch port: K6 (the dB conversion) on the card, against its plain twin.

A CUDA kernel has no CPU mode, so these tests skip without a card. They
import no JAX: on a machine with the card, run them with the repository's
conftest left out (it imports JAX)::

    python -m pytest --noconftest -m cuda tests/test_torch_port_db_fused_cuda.py

K6 computes the twin's float32 operations in the twin's order, so the two
agree bit for bit (NaN where the twin has NaN): at the log-mel cells'
shapes, at a few values and one, on values that are not finite, at a ``ref``
whose reciprocal rounds, on an input that is not 16-byte aligned, and on a
transposed or strided mel, which the public op sends to K6 as it is. A call
is one launch, two with ``top_db``, and it waits for nothing on the host.
"""

from __future__ import annotations

import pytest
import torch

from mlx_audio_primitives_tpu_torch import power_to_db
from mlx_audio_primitives_tpu_torch.kernels import db_fused as k6
from mlx_audio_primitives_tpu_torch.utils import profiler

pytestmark = pytest.mark.cuda


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K6 has no CPU mode")
    return torch.device("cuda", 0)


def spectrum(shape, card, seed=0) -> torch.Tensor:
    """Powers over 14 decades, made on the card."""
    gen = torch.Generator(device=card).manual_seed(seed)
    return 10.0 ** (torch.rand(shape, generator=gen, device=card) * 14.0 - 12.0)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype == torch.float32 and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


# (shape, coefficient, amin, top_db): the 64 x 30 s, 128-mel log-mel with
# top_db 80; the bucketed cell's largest batch (508 clips of 4.75 s, 80
# mels) with no top_db; a streaming chunk's few frames; a single value; and
# a size whose end is not a whole float4
CASES = [((64, 128, 1292), 10.0, 1e-10, 80.0), ((508, 80, 410), 20.0, 1e-5, None),
         ((1, 128, 4), 10.0, 1e-10, 80.0), ((1, 128, 4), 20.0, 1e-5, None),
         ((1,), 10.0, 1e-10, 80.0), ((1,), 20.0, 1e-5, None), ((3, 7, 1001), 10.0, 1e-10, 80.0)]


@pytest.mark.parametrize("shape,coefficient,amin,top_db", CASES)
@pytest.mark.parametrize("ref", [1.0, 2.5])
def test_k6_is_its_twin_bit_for_bit(card, shape, coefficient, amin, top_db, ref):
    S = spectrum(shape, card, seed=len(shape))
    got = k6.to_db_fused(S, coefficient, ref, amin, top_db)
    assert same_bits(got, k6.to_db_plain(S, coefficient, ref, amin, top_db))


@pytest.mark.parametrize("top_db", [None, 80.0])
@pytest.mark.parametrize("special", ["nan", "inf", "zero"])
def test_k6_on_values_that_are_not_finite(card, special, top_db):
    S = spectrum((8, 128, 300), card, seed=3)
    value = {"nan": float("nan"), "inf": float("inf"), "zero": 0.0}[special]
    S.view(-1)[[17, 150_000, S.numel() - 1]] = value
    got = k6.to_db_fused(S, 10.0, 1.0, 1e-10, top_db)
    want = k6.to_db_plain(S, 10.0, 1.0, 1e-10, top_db)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert same_bits(torch.nan_to_num(got), torch.nan_to_num(want))


@pytest.mark.parametrize("spread", [0.0, 1e-6, 1e-3])
def test_k6_max_where_many_values_are_near_it(card, spread):
    """Values all equal, or within 1e-6 or 1e-3 of one another (about the
    share within which K6 takes each value's dB value for the maximum), at
    the log-mel cell's size: the floor is against the same maximum."""
    gen = torch.Generator(device=card).manual_seed(7)
    S = 0.5 + spread * torch.rand((64, 128, 1292), generator=gen, device=card)
    for coefficient, amin in ((10.0, 1e-10), (20.0, 1e-5)):
        got = k6.to_db_fused(S, coefficient, 1.0, amin, 1e-4)
        assert same_bits(got, k6.to_db_plain(S, coefficient, 1.0, amin, 1e-4))


@pytest.mark.parametrize("top_db", [None, 80.0])
def test_k6_on_an_input_that_is_not_16_byte_aligned(card, top_db):
    S = spectrum((4 * 128 * 97 + 1,), card, seed=5)[1:].view(4, 128, 97)
    assert S.is_contiguous() and S.data_ptr() % 16
    got = k6.to_db_fused(S, 10.0, 1.0, 1e-10, top_db)
    assert same_bits(got, k6.to_db_plain(S, 10.0, 1.0, 1e-10, top_db))


@pytest.mark.parametrize("top_db", [None, 80.0])
@pytest.mark.parametrize("view", ["transposed", "permuted", "strided"])
def test_k6_on_a_mel_that_is_not_contiguous(card, view, top_db):
    """``logmel_time_sharded`` hands ``power_to_db`` a transposed mel: K6
    maps a tensor that fills one dense block where its values lie (the
    result keeps its strides) and a strided view as a copy."""
    S = spectrum((64, 1292, 128), card, seed=9)
    S = {"transposed": S.transpose(1, 2), "permuted": S.permute(2, 0, 1),
         "strided": S[:, ::2, :].transpose(1, 2)}[view]
    assert not S.is_contiguous()
    before = k6.KERNEL.launches
    profiler.clear_profiling()
    profiler.enable_profiling()
    try:
        got = power_to_db(S, top_db=top_db)
        counters = profiler.get_profiling_data()["counters"]
    finally:
        profiler.disable_profiling()
        profiler.clear_profiling()
    assert counters.get("dispatch.kernel.power_to_db") == 1
    assert k6.KERNEL.launches == before + 1 + (top_db is not None)
    assert same_bits(got, k6.to_db_plain(S, 10.0, 1.0, 1e-10, top_db))
    if view != "strided":
        assert got.stride() == S.stride()


@pytest.mark.parametrize("top_db", [None, 80.0])
def test_launches_a_call_and_no_host_wait(card, top_db):
    S = spectrum((64, 128, 1292), card)
    power_to_db(S, top_db=top_db)  # the first call builds and loads the library
    before = k6.KERNEL.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = power_to_db(S, top_db=top_db)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert k6.KERNEL.launches == before + 1 + (top_db is not None)
    assert same_bits(out, k6.to_db_plain(S, 10.0, 1.0, 1e-10, top_db))
