"""Time the port's sharded entry points on every card a machine has.

    python3 tools/mesh_bench.py [--label NAME] [--reps 3]

Makes float32 maps at nside 4096 on the first card from a seeded torch
generator (2 spin-0 bins and 2 [Q, U] bins) and a mask spectrum from a
seeded numpy generator, all at lmax 3000, and runs, on three meshes of
``heracles_tpu_torch.parallel``:

* ``one``: ``make_mesh(1)``, the first card alone;
* ``virtual``: a (2, 2) mesh of four shards on the first card;
* ``cards``: ``make_mesh()`` over every visible card;

``pipeline_step`` of the four bins (mixed spins), ``map2alm_sharded`` of
the spin-0 and the spin-2 bins, ``alm2map_sharded`` of those alms and
``mixmat(mesh=)`` of the mask spectrum.  Each is timed on the host clock
between two synchronisations of every card, best of ``--reps`` after a
warm-up, and held against the ``one`` mesh's result: the pipeline grid to
1e-3 of the auto spectra (float32 alms of another ring-FFT plan), alms
and maps at the float32 kernel bar (2e-5 of the max), the mixing matrix
to 1e-12 of its max.  Prints one line per mesh that starts with
``--label``, with one more call of ``map2alm_sharded`` spin 0 in which
each shard's analysis is timed on the host: when it began and when its
work was queued (ms from the call's start; a shard that waited for a
card would show it), and the whole call.  Then which cards can
reach each other's memory directly (peer access), the rate of one map's
copy from the first card to each other card, and the cards' names and
power limits.  Needs CUDA cards and nvcc; imports no JAX.
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

NSIDE, LMAX = 4096, 3000


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def best_s(fn, reps):
    """(result, best seconds of ``reps`` calls after one warm-up)."""
    out = fn()
    best = float("inf")
    for _ in range(reps):
        sync_all()
        t0 = time.perf_counter()
        out = fn()
        sync_all()
        best = min(best, time.perf_counter() - t0)
    return out, best


def rel(got, want):
    got, want = got.cpu().to(torch.complex128), want.cpu().to(torch.complex128)
    return float((got - want).abs().max() / want.abs().max())


def grid_rel(got, want, lmin=2):
    """max over pairs and l >= lmin of |got - want| / sqrt(want_ii want_jj)."""
    got, want = got.cpu().double(), want.cpu().double()
    auto = torch.diagonal(want, dim1=0, dim2=1).T
    denom = torch.sqrt(auto[:, None, :] * auto[None, :, :])[..., lmin:]
    return float(((got - want)[..., lmin:].abs() / denom).max())


def shard_timeline(sht, fn):
    """fn() once, with each shard's analysis timed on the host: when its
    work began and when it was queued, in ms from the call's start, and
    the whole call (to every card's end)."""
    analysis = sht._map2alm_block
    marks = []

    def timed(*args):
        t0 = time.perf_counter()
        out = analysis(*args)
        marks.append((t0, time.perf_counter()))
        return out

    sync_all()
    start = time.perf_counter()
    sht._map2alm_block = timed
    try:
        fn()
    finally:
        sht._map2alm_block = analysis
    sync_all()
    total = time.perf_counter() - start
    return ("; ".join(f"shard {i} {1e3 * (a - start):.1f}/"
                      f"{1e3 * (b - start):.1f}"
                      for i, (a, b) in enumerate(marks))
            + f"; call {1e3 * total:.1f} ms")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="mesh")
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("mesh_bench: no CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from heracles_tpu_torch import parallel, twopoint
    from heracles_tpu_torch.ops import sht, sht_kernels

    dev = torch.device("cuda", 0)
    npix = 12 * NSIDE**2
    g = torch.Generator(device=dev).manual_seed(12)
    pos = torch.randn((2, npix), generator=g, device=dev)
    she = torch.randn((2, 2, npix), generator=g, device=dev)
    rng = np.random.default_rng(12)
    cl3 = rng.uniform(size=LMAX + 1) / (1.0 + np.arange(LMAX + 1)) ** 2

    meshes = {"one": parallel.make_mesh(1),
              "virtual": parallel.make_mesh(4, m_axis=2, devices=[dev] * 4),
              "cards": parallel.make_mesh()}
    for name, mesh in meshes.items():
        sht_kernels.reset_counts()
        secs, errs = {}, {}
        grid, secs["pipeline_step"] = best_s(
            lambda: parallel.pipeline_step(mesh, pos, LMAX, she), args.reps)
        a0, secs["map2alm spin 0"] = best_s(
            lambda: parallel.map2alm_sharded(mesh, pos, LMAX), args.reps)
        a2, secs["map2alm spin 2"] = best_s(
            lambda: parallel.map2alm_sharded(mesh, she, LMAX, spin=2),
            args.reps)
        m0, secs["alm2map spin 0"] = best_s(
            lambda: parallel.alm2map_sharded(mesh, a0, NSIDE, lmax=LMAX),
            args.reps)
        m2, secs["alm2map spin 2"] = best_s(
            lambda: parallel.alm2map_sharded(mesh, a2, NSIDE, lmax=LMAX,
                                             spin=2), args.reps)
        mm, secs["mixmat"] = best_s(
            lambda: torch.as_tensor(twopoint.mixmat(
                cl3, l1max=LMAX, l2max=LMAX, device=dev, mesh=mesh)),
            args.reps)
        out = dict(grid=grid, a0=a0[..., :LMAX + 1], a2=a2[..., :LMAX + 1],
                   m0=m0, m2=m2, mm=mm)
        if name == "one":
            ref, ref_secs = out, secs
        else:
            errs["pipeline_step"] = grid_rel(grid, ref["grid"])
            for k in ("a0", "a2", "m0", "m2", "mm"):
                errs[k] = rel(out[k], ref[k])
            bad = {k: v for k, v in errs.items()
                   if v > (1e-3 if k == "pipeline_step"
                           else 1e-12 if k == "mm" else 2e-5)}
            if bad:
                sys.exit(f"mesh_bench: {name} disagrees with one card: {bad}")
        shards = {str(d) for d in mesh.devices.flat}
        print(f"{args.label} {name} {mesh.shape} on {sorted(shards)}: "
              + ", ".join(f"{k} {v:.4f} s" for k, v in secs.items())
              + (" (speed-up on one card's: "
                 + ", ".join(f"{k} {ref_secs[k] / v:.2f}x"
                             for k, v in secs.items()) + ")"
                 if name != "one" else "")
              + (f"; against one card: "
                 + ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
                 if errs else "")
              + f"; launches over {1 + args.reps} calls each "
              f"{dict(sht_kernels.LAUNCHES)}; shards of one map2alm spin 0 "
              f"(begin/queued ms): "
              + shard_timeline(sht, lambda: parallel.map2alm_sharded(
                  mesh, pos, LMAX)), flush=True)
        del grid, a0, a2, m0, m2, mm, out
    n = torch.cuda.device_count()
    peers = [[int(i == j or torch.cuda.can_device_access_peer(i, j))
              for j in range(n)] for i in range(n)]
    rates = []
    for j in range(1, n):
        _, secs = best_s(lambda: pos[0].to(torch.device("cuda", j)), args.reps)
        rates.append(f"cuda:0 -> cuda:{j} {pos[0].nbytes / secs / 1e9:.1f} GB/s")
    print(f"{args.label} peer access {peers}; one map "
          f"({pos[0].nbytes / 1e9:.2f} GB) copied " + ", ".join(rates))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"{args.label} cards: {torch.cuda.device_count()} | "
          + " | ".join(smi.splitlines()))


if __name__ == "__main__":
    main()
