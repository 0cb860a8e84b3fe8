"""Plain reference of the ``map_spectra`` entry: maps -> alms -> spectra.

The alms of each map by the plain float64 analysis (ring weights, pixel
window deconvolution) and every cross-spectrum of them, and the numbers
that decide ``correct``: the program's alms and spectra against these.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from . import plain_sht, tables


def alms(config, maps, precision="f64"):
    """Rect alms (B, lmax + 1, mmax + 1) complex128 of (B, npix) maps,
    deconvolved by the scalar pixel window."""
    nside, lmax = config["nside"], config["lmax"]
    mmax = config.get("mmax", lmax)
    t = time.perf_counter()
    a = plain_sht.map2alm(maps, nside, lmax, mmax, spin=0,
                          weights=tables.ring_weights(nside),
                          precision=precision)
    if config.get("deconvolve", True):
        pw = tables.pixel_window(nside, lmax)[0]
        a = a / torch.as_tensor(pw, device=a.device)[:, None]
    print(f"# reference: alms of {maps.shape[0]} maps "
          f"{time.perf_counter() - t:.2f} s", file=sys.stderr, flush=True)
    return a


def rect(packed, lmax, mmax):
    """healpy-packed (..., nlm) -> rect (..., lmax + 1, mmax + 1)."""
    out = packed.new_zeros(packed.shape[:-1] + (lmax + 1, mmax + 1))
    pos = 0
    for m in range(mmax + 1):
        n = lmax + 1 - m
        out[..., m:, m] = packed[..., pos:pos + n]
        pos += n
    return out


def pack(a):
    """rect (..., lmax + 1, mmax + 1) -> healpy-packed (..., nlm)."""
    lmax, mmax = a.shape[-2] - 1, a.shape[-1] - 1
    return torch.cat([a[..., m:, m] for m in range(mmax + 1)], dim=-1)


def as_program(ref):
    """Rect alms of :func:`alms` in the program's place: (packed alms,
    {(i, j): spectrum}) as the entry keeps the program's."""
    n = ref.shape[0]
    cls = {(i, j): plain_sht.spectra(ref[i], ref[j]).cpu().numpy()
           for i in range(n) for j in range(i, n)}
    return pack(ref), cls


def numbers(config, got_alms, got_cls, ref):
    """The compared numbers of one step.

    ``got_alms``: the program's packed alms (B, nlm); ``got_cls``:
    {(i, j): (lmax + 1,) host array}; ``ref``: :func:`alms` of the same
    maps.  ``alm_err``: the largest, over maps and bands of
    ``plain_sht.BAND`` multipoles, of |a - a_ref| / |a_ref| (norms over
    the band's (l, m)); ``cl_err``: the largest, over pairs and l, of
    |C_ij - C_ij^ref| / sqrt(S_ii S_jj), S the reference auto-spectrum's
    mean over the band of l.  Bands, not single l: a low l has a few modes,
    whose power scatters from seed to seed.
    """
    lmax = config["lmax"]
    mmax = config.get("mmax", lmax)
    got = rect(got_alms.to(ref.device).to(torch.complex128), lmax, mmax)
    num = (got - ref).abs().square().sum(-1).cpu().numpy()
    den = ref.abs().square().sum(-1).cpu().numpy()
    width = plain_sht.BAND
    alm_err = float(np.max(np.sqrt(plain_sht.band_mean(num, width)
                                   / plain_sht.band_mean(den, width))))
    auto = plain_sht.band_mean(plain_sht.spectra(ref, ref).cpu().numpy())
    cl_err = 0.0
    for (i, j), cl in got_cls.items():
        want = plain_sht.spectra(ref[i], ref[j]).cpu().numpy()
        scale = np.sqrt(auto[i] * auto[j])
        cl_err = max(cl_err, float(np.max(np.abs(np.asarray(cl) - want) / scale)))
    return {"alm_err": alm_err, "cl_err": cl_err}
