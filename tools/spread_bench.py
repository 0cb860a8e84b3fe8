"""Time the port's ES spreader (S1) on the card, whole and by stage.

    python3 tools/spread_bench.py [--label NAME] [--lmax 1000] [--reps 3]

Builds the kernels of this checkout's ``heracles_tpu_torch`` and spreads
seeded points (numpy; seed 4, as ``discrete_gridded_1e7_l1000``) into the
padded grid of ``--lmax`` at these shapes:

* ``cell``: 1e7 points uniform on the sphere, w 6, real values (the
  gridded cell); ``sorted``: the same points sorted by colatitude;
  ``clustered``: the same points squeezed into theta in [pi/2 - 0.2,
  pi/2 + 0.2], phi in [0, 0.4] (a deep field);
* ``page``: the cell's first 1e6 points (one catalogue page), w 6 real
  and complex, and w 13 real and complex.

For each shape it prints, on lines that start with ``--label``: the best
of ``--reps`` timed calls (ms, CUDA events, after a warm-up), checked
against the plain version at 1e-12 of the grid's max; the three stages
of one call timed apart (bin + scan, order, spread + flush); and the
bins, subproblems and largest bin.  At the cell also one ``index_add_`` of the precomputed
stencil (the library yardstick).  Then the card's name and power limit.
Needs a CUDA card and nvcc; imports no JAX.
"""

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

TOL = 1e-12  # float64 atomics add in an order that varies from run to run


def best_ms(fn, reps):
    """Best of ``reps`` CUDA-event timings of fn(), after one warm-up."""
    fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop))
    return best


def shapes(n_cell, n_page):
    """name -> (theta, phi, values (1, n) real or complex, w)."""
    rng = np.random.default_rng(4)
    theta = np.arccos(rng.uniform(-1, 1, size=n_cell))
    phi = rng.uniform(0, 2 * np.pi, size=n_cell)
    vals = rng.normal(size=(1, n_cell))
    order = np.argsort(theta, kind="stable")
    ct = np.pi / 2 - 0.2 + theta * (0.4 / np.pi)
    cp = phi * (0.4 / (2 * np.pi))
    p_t, p_p, p_v = theta[:n_page], phi[:n_page], vals[:, :n_page]
    p_c = p_v + 1j * p_v[:, ::-1]
    return {
        "cell": (theta, phi, vals, 6),
        "sorted": (theta[order], phi[order], vals[:, order], 6),
        "clustered": (ct, cp, vals, 6),
        "page/w6/real": (p_t, p_p, p_v, 6),
        "page/w6/cplx": (p_t, p_p, p_c, 6),
        "page/w13/real": (p_t, p_p, p_v, 13),
        "page/w13/cplx": (p_t, p_p, p_c, 13),
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="spread")
    parser.add_argument("--lmax", type=int, default=1000)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--npts", type=int, default=10_000_000)
    parser.add_argument("--page", type=int, default=1_000_000)
    args = parser.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

    from heracles_tpu_torch.ops import _build, nufft

    if not torch.cuda.is_available():
        raise SystemExit("spread_bench: torch sees no CUDA device")
    dev = torch.device("cuda")
    label, lmax = args.label, args.lmax
    kl = _build.load_library()
    print(label, f"build {kl.seconds:.1f} s", flush=True)

    for name, (theta, phi, vals, w) in shapes(args.npts, args.page).items():
        cplx = np.iscomplexobj(vals)
        pads = [nufft.alloc_padded(1, lmax, w, cplx, dev) for _ in range(2)]
        th, ph, v = nufft._spread_inputs(theta, phi, vals, pads[0])
        nufft.spread_padded_plain(th, ph, v, pads[1], w)
        want = nufft.fold_padded(pads[1], lmax, w)
        nufft.spread_padded(th, ph, v, lmax, w, pads[0])
        got = nufft.fold_padded(pads[0].clone(), lmax, w)
        rel = (got - want).abs().max().item() / want.abs().max().item()
        if not rel <= TOL:
            raise SystemExit(f"{label} {name}: {rel:.2e} of max against plain")
        ms = best_ms(lambda: nufft.spread_padded(th, ph, v, lmax, w, pads[0]),
                     args.reps)
        # the stages of one call, timed apart
        stage_ms = []
        scratch = None
        for stage in (nufft.STAGE_BIN, nufft.STAGE_ORDER, nufft.STAGE_SPREAD):
            def run(stage=stage):
                return nufft._launch(th, ph, v, pads[0], w, stages=stage,
                                     scratch=scratch)
            scratch = run()
            stage_ms.append(best_ms(run, args.reps))
        counts = scratch["counts"]
        stats = (f"{counts.numel()} bins, {int((counts > 0).sum())} with "
                 f"points, {int(scratch['subs'][-1])} subproblems, largest "
                 f"{int(counts.max())} points")
        line = (f"{label} {name} n{th.numel()} w{w}: {ms:.3f} ms ({rel:.1e} "
                f"of max); stages bin+scan / order / spread+flush "
                f"{' / '.join(f'{t:.3f}' for t in stage_ms)} ms; {stats}")
        if name == "cell":
            ntheta, nphi = nufft.grid_shape(lmax)
            idx, coef = nufft._stencil(th, ph, w, ntheta, nphi)
            contrib = (v[0, :, None, None] * coef).reshape(-1)
            idx = idx.reshape(-1)
            del coef
            flat = torch.zeros((ntheta + w) * (nphi + w), dtype=torch.float64,
                               device=dev)
            lib = best_ms(lambda: flat.index_add_(0, idx, contrib), args.reps)
            line += f"; index_add_ of the stencil {lib:.3f} ms"
            del idx, contrib, flat
        print(line, flush=True)
        del pads, th, ph, v, want, scratch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(label, f"card {smi}", flush=True)


if __name__ == "__main__":
    main()
