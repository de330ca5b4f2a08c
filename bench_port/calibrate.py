"""Readings for setting a cell's limits: the numbers compared, for the
program on many seeds and for the control on a few, in one process.

    python3 -m bench_port.calibrate --workload <cell> --seeds 1 2 ... [--control-seeds 7 8 9]

The program's readings come from its timed call on the batches a run keeps,
at the cell's own sizes; the control is the reference computed in TF32
(``reference/dsp.py``), put in the program's place. One JSON line per seed
and kind, then the largest program reading and the smallest control
reading of each number. Needs the card, as the runs do.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import registry, traffic
from .run import judge


def readings(workload: str, seeds: list[int], control: bool, device) -> list[dict]:
    import mlx_audio_primitives_tpu_torch as ap
    from .reference.dsp import Prec

    cell = registry.cell(workload)
    cfg, mix = registry.config(cell["config"]), registry.traffic(cell["traffic"])
    entry_mod, ref_mod = registry.entry(mix["entry"]), registry.reference(mix["entry"])
    if control:
        def call(y):
            return ref_mod.reference(y, cfg, Prec("tf32"))
    else:
        call = entry_mod.program(ap, cfg)
    shapes = traffic.batch_lengths(mix, cfg)
    out = []
    for seed in seeds:
        pool = traffic.make_pool(mix, cfg, seed, device)
        kept = {i: call(pool[i].y) for i in traffic.kept(mix, shapes, seed)}
        worst, _ = judge(entry_mod, ref_mod, cfg, pool, kept, {})
        out.append({"seed": seed, "kind": "control" if control else "program", "readings": worst})
        print(json.dumps(out[-1]), flush=True)
        del pool, kept
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    from mlx_audio_primitives_tpu_torch.kernels import _build

    _build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    prog = readings(args.workload, args.seeds, False, device)
    ctrl = readings(args.workload, args.control_seeds, True, device)
    keys = (prog or ctrl)[0]["readings"] if prog or ctrl else {}
    for k in keys:
        lower = max((r["readings"][k] for r in prog), default=None)
        upper = min((r["readings"][k] for r in ctrl), default=None)
        print(json.dumps({"number": k, "lower": lower, "upper": upper,
                          "ratio": upper / lower if lower and upper is not None else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
