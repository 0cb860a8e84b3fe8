"""Decompose the port's map2alm time into its stages, on the card.

Twin of ``tools/profile_map2alm.py`` for ``heracles_tpu_torch``, with its
flags, seed 0 and JSON keys.  Each stage runs on its own, timed with CUDA
events after a warm-up (the least of ``--reps``):

* ``ring_analysis`` -- ``ringfft.ring_analysis`` with the ring weights
  (the weighted ring FFTs);
* ``fold_weight``   -- ``sht._folded_inputs``: the rings folded north on
  south, with the per-order sign;
* ``kernel``        -- the Wigner contraction, the spin-0 analysis kernel
  (B1) or the spin-pair one (B2) with its E, B combination;
* ``cl``            -- the C(l) of the rectangular alms;
* ``full``          -- ``sht.map2alm(packed=False)`` and the C(l) in one go.

The stages compose to exactly what ``sht.map2alm`` returns
(:func:`stages`).  Prints one JSON object, with the card's name and power
limit.  Needs a CUDA card; imports no JAX.

    python3 tools/torch_profile_map2alm.py [--nside 4096] [--lmax 3000]
                                           [--spin 0] [--reps 3]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402


def cl_rect(alm):
    """C(l) of rectangular (..., lmax+1, mmax+1) alms: the m = 0 column
    once, the others twice, over 2l + 1."""
    m = torch.arange(alm.shape[-1], device=alm.device)
    eps = torch.where(m == 0, 1.0, 2.0).to(alm.real.dtype)
    ells = torch.arange(alm.shape[-2], device=alm.device, dtype=alm.real.dtype)
    return ((alm.real**2 + alm.imag**2) * eps).sum(-1) / (2 * ells + 1)


def stages(maps, lmax, spin):
    """The stage functions of ``map2alm(maps, lmax, spin=spin,
    packed=False)``: ``ring(maps)`` -> spectra, ``fold(spectra)`` -> the
    kernel's inputs, ``kernel(inputs)`` -> rectangular alms, and ``cl``."""
    from heracles_tpu_torch.healpix import npix2nside
    from heracles_tpu_torch.ops import ringfft, sht, sht_kernels

    nside = npix2nside(maps.shape[-1])
    w = sht._weights_arr(nside, "ring")
    x, logch, logsh = sht._geometry(nside, maps.device)
    kw = dict(dd=False, x_lo=None)

    if spin == 0:
        def ring(m):
            return ringfft.ring_analysis(m, nside, lmax + 1, weight=w)[:1]

        def fold(F):
            return sht._folded_inputs(F, (0,))

        def kernel(args):
            return sht_kernels.analysis_spin0_folded(*args, x, logch, logsh,
                                                     lmax, 0, **kw)
    else:
        def ring(m):
            F, Fneg = ringfft.ring_analysis(torch.complex(m[0], m[1]), nside,
                                            lmax + 1, weight=w)
            return F, Fneg.conj()

        def fold(F):
            return sht._folded_inputs(F, (spin, -spin))

        def kernel(args):
            return sht._eb(*sht_kernels.analysis_pair_folded(
                *args, x, logch, logsh, lmax, spin, 0, **kw))
    return ring, fold, kernel, cl_rect


def profile(maps, lmax, spin, time_ms):
    """The stage times (``time_ms(fn)``: ms of one call) under the JAX
    tool's keys."""
    from heracles_tpu_torch.ops import sht

    ring, fold, kernel, cl = stages(maps, lmax, spin)
    out = {}
    out["ring_analysis_ms"] = time_ms(lambda: ring(maps))
    F = ring(maps)
    out["fold_weight_ms"] = time_ms(lambda: fold(F))
    args = fold(F)
    del F
    out["kernel_ms"] = time_ms(lambda: kernel(args))
    alm = kernel(args)
    del args
    out["cl_ms"] = time_ms(lambda: cl(alm))
    out["full_ms"] = time_ms(lambda: cl(sht.map2alm(maps, lmax, spin=spin,
                                                    packed=False)))
    return out


def event_timer(reps):
    """ms of one call: CUDA events around it after a warm-up, the least of
    ``reps``."""
    def time_ms(fn):
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
    return time_ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nside", type=int, default=4096)
    ap.add_argument("--lmax", type=int, default=3000)
    ap.add_argument("--spin", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_map2alm: torch sees no CUDA device; "
                         "this tool times the card only")
    from chip_smoke import card

    nside, lmax, spin = args.nside, args.lmax, args.spin
    npix = 12 * nside * nside
    rng = np.random.default_rng(0)
    shape = (npix,) if spin == 0 else (2, npix)
    maps = torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                           device="cuda")
    out = profile(maps, lmax, spin, event_timer(args.reps))
    out.update(nside=nside, lmax=lmax, spin=spin, card=card(),
               kind=torch.cuda.get_device_name(0))
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
