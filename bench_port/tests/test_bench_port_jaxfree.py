"""The JAX-free check compares top-level module names whole."""

from __future__ import annotations

from bench_port import jaxfree


def test_port_and_bench_are_allowed():
    assert jaxfree.offending(["mlx_audio_primitives_tpu_torch", "mlx_audio_primitives_tpu_torch.ops",
                              "bench_port.run", "torch", "jaxtyping", "benchmarks_extra"]) == []


def test_jax_and_the_jax_package_are_found():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "mlx_audio_primitives_tpu",
            "mlx_audio_primitives_tpu.ops", "benchmarks.roofline", "chip_smoke", "torch"]
    assert jaxfree.offending(mods) == sorted(m for m in mods if m != "torch")


def test_this_process_is_clean():
    import bench_port.run  # noqa: F401
    import mlx_audio_primitives_tpu_torch  # noqa: F401

    assert jaxfree.offending() == []
