"""On the card: each cell runs once, briefly, through the command, and
comes out correct.  Skips, with the reason, where torch sees no card.

    python -m pytest -p no:cacheprovider -m cuda benchmark/tests
"""

import json
import os
import subprocess
import sys

import pytest

import bench_toy


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["spin0_n4096_l3000"])
def test_cell_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483701", "--seconds", "2", "--trace", "0"],
        cwd=bench_toy.ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
