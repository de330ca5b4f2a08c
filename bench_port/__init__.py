"""The benchmark of the PyTorch and CUDA port (``mlx_audio_primitives_tpu_torch``).

``python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on an NVIDIA card and prints one
JSON line; ``registry.py`` says where each configuration, traffic mix,
entry, reference, op bound, per-layer metric and set of limits lives. It
imports neither JAX nor the JAX package.
"""
