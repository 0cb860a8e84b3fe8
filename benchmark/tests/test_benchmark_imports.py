"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole), and the reference loads no part of the program."""

import os
import subprocess
import sys

import bench_toy

RUN = """
import os, sys, time
dst = sys.argv[1]
sys.path[:0] = [os.path.join(dst, "benchmark"), sys.argv[2]]
import torch
from hbench import runner
spec = runner.load_spec(dst)
for cell in [w["name"] for w in spec["workloads"]]:
    for trace in (False, True):
        runner.run_cell(spec, cell, 12345, 0.5, trace, torch.device("cpu"),
                        time.time(), bench=os.path.join(dst, "benchmark"),
                        root=dst, build_dir=os.path.join(dst, "build"))
print(sorted({n.split(".")[0] for n in sys.modules}))
"""

REFERENCE = """
import sys
sys.path[:0] = [sys.argv[1]]
import reference.map_spectra, reference.plain_sht, reference.tables
print(sorted({n.split(".")[0] for n in sys.modules}))
"""


def _top_names(stdout):
    return set(eval(stdout.strip().splitlines()[-1]))


def test_runs_load_no_jax(tmp_path):
    dst = str(tmp_path)
    cache = bench_toy.make(dst)
    out = subprocess.run([sys.executable, "-c", RUN, dst, bench_toy.ROOT],
                         capture_output=True, text=True, timeout=900,
                         env={**os.environ, "HERACLES_TPU_CACHE": cache})
    assert out.returncode == 0, out.stderr[-3000:]
    names = _top_names(out.stdout)
    assert "heracles_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "heracles_tpu"}


def test_reference_loads_no_program():
    out = subprocess.run([sys.executable, "-c", REFERENCE, bench_toy.HERE],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    names = _top_names(out.stdout)
    assert not names & {"jax", "jaxlib", "flax", "heracles_tpu",
                        "heracles_tpu_torch"}


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from hbench import runner

    monkeypatch.setitem(sys.modules, "heracles_tpu_torch_like", object())
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "heracles_tpu.sub", object())
    assert runner.forbidden_modules() == ["heracles_tpu.sub"]


def test_run_without_a_card_fails_and_prints_no_result(tmp_path):
    """Here torch sees no card: the command exits non-zero with no result
    line, also in a directory that holds only BENCHMARK.json and the
    files under paths."""
    import shutil

    shutil.copytree(bench_toy.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(bench_toy.ROOT, "BENCHMARK.json"), tmp_path)
    for cwd in (bench_toy.ROOT, str(tmp_path)):
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "spin0_n4096_l3000", "--seed", "3", "--seconds", "1", "--trace",
             "0"], cwd=cwd, capture_output=True, text=True, timeout=300,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0
        assert '"correct"' not in out.stdout
