"""PyTorch port: the four examples of `examples_torch/`, at the toy scale of
`tests/test_examples.py`, on the CPU.

Each example runs in this process; the parallelism tour also runs in one
spawned world of four gloo ranks (`torch_port_dist.py`), where every
section's mesh spans real ranks. The examples hold their own results (the
streamed features against the offline ops, the recovered musical
structure); these tests add the accuracy bar of `tests/test_examples.py`
and that the tour's losses are finite and fall. They are imported as
``examples_torch.<name>``: `tests/test_examples.py` puts `examples/`, whose
files have the same names, on ``sys.path``.
"""

from __future__ import annotations

import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch_port_util  # noqa: F401  (non-tensor inputs go to the CPU)
from torch_port_dist import case_results, run_world

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("train_keyword_spotter", "multichip_parallelism", "streaming_realtime",
            "music_analysis")
SECTIONS = ("dp x sp", "tp", "pp", "ep", "cp (ring)")


def example(name: str):
    return importlib.import_module(f"examples_torch.{name}")


def test_train_keyword_spotter_learns(tmp_path):
    m = example("train_keyword_spotter")
    # toy scale: enough steps that the loss clearly moves and the checkpoint
    # round trip + eval path all execute
    acc = m.main(steps=12, batch=16, checkpoint_dir=str(tmp_path), device="cpu")
    assert 0.0 <= acc <= 1.0
    assert acc > 1.5 / m.N_CLASSES  # clearly better than chance
    assert (tmp_path / "step_12.npz").exists()


def _assert_tour(losses: dict) -> None:
    assert tuple(losses) == SECTIONS
    for name, v in losses.items():
        v = np.asarray(v)
        assert np.isfinite(v).all() and v[-1] < v[0], (name, v)


def test_multichip_parallelism_tour_in_a_world_of_one():
    _assert_tour(example("multichip_parallelism").run_tour(steps=2, device="cpu"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("tour_world"), 4,
                     [{"id": "tour", "job": "tour", "args": {"steps": 2}}], {"none": np.zeros(1)})


@pytest.mark.parametrize("rank", range(4))
def test_multichip_parallelism_tour_on_four_ranks(world, rank):
    got = case_results(world[rank], "tour")
    assert "error" not in got, got.get("error")
    _assert_tour(got)
    # the loss is the same on every rank of a section
    np.testing.assert_array_equal(got["ep"], case_results(world[0], "tour")["ep"])


def test_streaming_realtime_exactness():
    example("streaming_realtime").main(streams=4, seconds=0.5, device="cpu")


def test_music_analysis_recovers_structure():
    example("music_analysis").main(bpm=120.0, sr=22050, device="cpu")


def test_examples_import_without_jax():
    # jax made unimportable in a fresh interpreter
    code = (
        "import sys, importlib; sys.modules['jax'] = None; "
        + "; ".join(f"importlib.import_module('examples_torch.{n}')" for n in EXAMPLES)
        + "; import mlx_audio_primitives_tpu_torch.models; "
        "print(sorted(m for m in sys.modules if m.split('.')[0] == 'mlx_audio_primitives_tpu'))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]"
