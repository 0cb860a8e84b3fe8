#!/usr/bin/env python3
"""Readings behind the limits of a cell's compared numbers, on the card.

    python3 benchmark/limits.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--steps 1]

In one process: for each seed the cell's set-up (the first seed's warm-up
steps only), ``--steps`` steps through the timed path, and the compared
numbers of their outputs against the plain reference (the lower
readings); for each control seed the same, then the control in the
program's place (the plain reference with its ring sums in TF32: the
upper readings).  Prints one JSON line per reading.  The
benchmark's own runs do not run this.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [p for p in (HERE, ROOT) if p not in sys.path]

import torch  # noqa: E402

from hbench import runner  # noqa: E402


def readings(name, seeds, control_seeds, steps, device, root=ROOT,
             bench=HERE, build_dir=runner.BUILD):
    """Yield one dict per seed and kind ("program" or "control")."""
    import importlib

    spec = runner.load_spec(root)
    _, config, traffic = runner.cell_files(spec, name, bench, root)
    entry = importlib.import_module(f"entries.{traffic['entry']}")
    warm = traffic["warmup_steps"]
    for seed in list(seeds) + list(control_seeds):
        t = time.time()
        ctx = runner.make_context(config, dict(traffic, warmup_steps=warm),
                                  seed, device, build_dir)
        warm = 0
        cell = entry.Cell(ctx)
        cell.setup()
        kept = [cell.step(k, ctx.no_spans) for k in range(steps)]
        cell.release()
        kinds = ["program"] + (["control"] if seed in control_seeds else [])
        for kind in kinds:
            detail = {}
            numbers = cell.check(kept, "f64" if kind == "program" else "tf32",
                                 detail)
            yield dict(cell=name, seed=seed, kind=kind, seconds=time.time() - t,
                       **numbers, worst={k: str(v) for k, v in detail.items()})
        del cell, kept
        if device.type == "cuda":
            torch.cuda.empty_cache()


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--steps", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("limits: torch sees no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def ints(text):
        return [int(s) for s in text.split(",") if s]

    for row in readings(args.workload, ints(args.seeds),
                        ints(args.control_seeds), args.steps,
                        torch.device("cuda", 0)):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
