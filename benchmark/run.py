#!/usr/bin/env python3
"""The benchmark of heracles_tpu_torch on the card: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads and warms up the cell, measures for ``--seconds``, checks the
outputs against the plain reference, and prints one JSON line last
(:mod:`hbench.runner`).  Exits non-zero, with no result, where torch sees
fewer CUDA cards than the cell asks for.  Build caches stay in
``build/`` of the checkout.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for name, sub in (("TRITON_CACHE_DIR", "triton"),
                  ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[name] = os.path.join(ROOT, "build", "benchmark", sub)
sys.path[:0] = [p for p in (HERE, ROOT) if p not in sys.path]

from hbench import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(start=runner.process_start()))
