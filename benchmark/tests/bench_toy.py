"""A toy copy of the benchmark for the CPU tests: the cells' files at
nside 32 and lmax 48, with a toy pixel-window table written twice: into
the program's cache directory and, as a shipped table, into the copy's
``heracles_tpu/data`` (the directory the reference reads)."""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
NSIDE, LMAX = 32, 48


def make(dst, nside=NSIDE, lmax=LMAX, dtype=None):
    """Copy BENCHMARK.json and benchmark/ to ``dst`` at toy size; returns
    the program's cache directory (for HERACLES_TPU_CACHE)."""
    shutil.copytree(HERE, os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for c in spec["configs"]:
        path = os.path.join(dst, c["file"])
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(nside=nside, lmax=lmax, mmax=lmax)
        if dtype:
            cfg["dtype"] = dtype
        with open(path, "w") as f:
            json.dump(cfg, f)
    cache = os.path.join(dst, "pixwin")
    ell = np.arange(2 * lmax + 1.0)
    pw = np.stack([1 / (1 + 1e-3 * ell),
                   np.where(ell < 2, 0.0, 1 / (1 + 1.1e-3 * ell))])
    for d in (cache, data_dir(dst)):
        os.makedirs(d)
        np.save(os.path.join(d, f"pixwin_{nside}_{2 * lmax}_1_16_1.npy"), pw)
    return cache


def data_dir(dst):
    """The toy copy's shipped tables: what the reference reads there."""
    return os.path.join(dst, "heracles_tpu", "data")


def environ(mp, dst, cache):
    """Point the program's cache and, in this process, the reference's
    shipped tables at the toy copy's."""
    from reference import tables

    mp.setenv("HERACLES_TPU_CACHE", cache)
    mp.setattr(tables, "DATA", data_dir(dst))


def run(dst, cell, seconds=1.0, trace=False, seed=2**31 + 77):
    """One run of ``cell`` of the toy copy ``dst`` on the CPU, in process."""
    import time

    import torch

    from hbench import runner

    spec = runner.load_spec(dst)
    return runner.run_cell(spec, cell, seed, seconds, trace,
                           torch.device("cpu"), time.time(),
                           bench=os.path.join(dst, "benchmark"), root=dst,
                           build_dir=os.path.join(dst, "build"))
