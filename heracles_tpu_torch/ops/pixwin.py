"""Exact HEALPix pixel window functions (scalar and polarization), on torch.

Counterpart of :mod:`heracles_tpu.ops.pixwin`.  The window of an
azimuthally averaged HEALPix pixelisation is

    w_l^2 = < 4 pi / ((2l+1) Omega_p^2) sum_m |int_p sY*_lm dOmega|^2 >_p

averaged over all pixels p (s = 0 for the scalar window, s = 2 for the
polarization window).  As in the reference:

* each representative pixel is covered by its ``factor``^2 NESTED
  children at nside * factor, so the integral over the true pixel shape
  becomes an equal-area point sum;
* the per-pixel harmonic sums are reduced l by l by
  :func:`heracles_tpu_torch.ops.wigner.lambda_power_scan`, in float64 on
  the given device, so the (l, m) alm table of a pixel never exists;
* the smoothing of the point sum itself (the fine grid's own window) is
  multiplied back in from the children's second moment;
* one representative per ring: every ring's pixels are congruent up to an
  azimuthal rotation, and the azimuthal power average does not see it.

Windows are cached as ``pixwin_{nside}_{lmax}_{pol}_{factor}_{cap}.npy`` in
the directory ``$HERACLES_TPU_CACHE`` (default ``heracles_tpu_cache`` in the
temporary directory), the reference's file format and location, so each
package reads the other's cache; the tables shipped in
``heracles_tpu/data`` are read first.
"""

from __future__ import annotations

import functools
import glob
import logging
import os
import tempfile

import numpy as np
import torch

from .. import tracing
from ..healpix import _pix2ring_ipix, nest2ring, pix2ang_ring, ring2nest
from . import wigner
from .sht import _data_dir

logger = logging.getLogger(__name__)

__all__ = ["pixel_window_exact", "cap_window", "find_cached"]


def _cache_dir():
    return (os.environ.get("HERACLES_TPU_CACHE")
            or os.path.join(tempfile.gettempdir(), "heracles_tpu_cache"))


@tracing.spanned("pixwin.find_cached")
def find_cached(nside, lmax, pol):
    """A shipped or cached exact window covering (nside, lmax, pol), else None.

    Any file for the same nside with lmax' >= lmax serves (sliced); a
    pol=True file also serves pol=False requests (its first row).
    """
    data = _data_dir()
    pattern = f"pixwin_{int(nside)}_*.npy"
    paths = glob.glob(os.path.join(_cache_dir(), pattern))
    if data is not None:
        paths += glob.glob(os.path.join(data, pattern))
    for path in sorted(paths):
        try:
            _, _, lm, pl, _, _ = os.path.basename(path)[:-4].split("_")
            lm, pl = int(lm), int(pl)
        except ValueError:
            continue
        if lm < lmax or (pol and not pl):
            continue
        tracing.built("pixwin.find_cached")
        try:
            arr = np.load(path)
        except (OSError, ValueError):
            continue
        arr = arr[..., : lmax + 1]
        return arr if pol or arr.ndim == 1 else arr[0]
    return None


def cap_window(nside, lmax):
    """Equal-area spherical-cap approximation of the scalar window.

    w_l = [P_{l-1}(c) - P_{l+1}(c)] / ((2l+1)(1-c)), c = 1 - Omega/2pi.
    """
    c = 1.0 - np.pi / (3.0 * nside * nside) / (2.0 * np.pi)
    P = np.empty(lmax + 2)
    P[0] = 1.0
    P[1] = c
    for ell in range(2, lmax + 2):
        P[ell] = ((2 * ell - 1) * c * P[ell - 1] - (ell - 1) * P[ell - 2]) / ell
    w = np.empty(lmax + 1)
    w[0] = 1.0
    ell = np.arange(1, lmax + 1)
    w[1:] = (P[ell - 1] - P[ell + 1]) / ((2 * ell + 1) * (1.0 - c))
    return w


def _pixel_classes(nside, cap_samples):
    """Representative pixels (RING indices) and their multiplicities.

    The multiplicities sum to 12 nside^2.  Cap rings and the shoulder
    ring i = nside repeat their pixel shapes per quadrant;
    ``cap_samples > 1`` samples extra quadrant positions per such ring.
    """
    pix, wts = [], []
    for i in range(1, nside + 1):
        if i < nside:
            start, quad = 2 * i * (i - 1), i
        else:
            start, quad = 2 * nside * (nside - 1), nside
        js = np.unique(
            np.round(np.linspace(0, quad - 1, min(quad, cap_samples))).astype(int)
        )
        alloc = np.zeros(js.size)
        near = np.abs(np.arange(quad)[:, None] - js[None, :]).argmin(axis=1)
        np.add.at(alloc, near, 1.0)
        pix.extend(start + js)
        wts.extend(8.0 * alloc)  # 4 quadrants x N/S mirror
    # interior belt rings: all 4*nside pixels congruent (phi translations)
    for i in range(nside + 1, 2 * nside + 1):
        start = 2 * nside * (nside - 1) + (i - nside) * 4 * nside
        pix.append(start)
        wts.append(4.0 * nside * (1.0 if i == 2 * nside else 2.0))
    pix = np.asarray(pix, dtype=np.int64)
    wts = np.asarray(wts)
    assert wts.sum() == 12.0 * nside * nside
    return pix, wts


@functools.lru_cache(maxsize=16)
def _subcell_moment(nside, factor=8, cap_samples=1):
    """Mean squared angular distance of pixel mass from the pixel centre.

    To leading order the fine grid's own window is isotropic after the
    m average and depends on this second moment alone:
    w_sub(l) = 1 - l(l+1) s2 / 4 + O((l theta_pix)^4).
    """
    pix, wts = _pixel_classes(nside, cap_samples)
    th0, ph0 = pix2ang_ring(nside, pix)
    th, ph = _children_angles(nside, pix, factor)
    cosd = (
        np.sin(th0)[:, None] * np.sin(th) * np.cos(ph - ph0[:, None])
        + np.cos(th0)[:, None] * np.cos(th)
    )
    d2 = np.arccos(np.clip(cosd, -1.0, 1.0)) ** 2
    return float(np.einsum("r,r->", wts / (12.0 * nside * nside),
                           d2.mean(axis=1)))


def _subcell_window(nside, lmax):
    """Small-l window of the midpoint sub-sampling at ``nside``."""
    ells = np.arange(lmax + 1)
    return 1.0 - ells * (ells + 1) * _subcell_moment(int(nside)) / 4.0


def _children_angles(nside, pix, factor):
    """(theta, phi) of the NESTED children covering each pixel."""
    th, ph, _ = _children_angles_rings(nside, pix, factor)
    return th, ph


def _children_angles_rings(nside, pix, factor):
    """(theta, phi, ring) of the NESTED children covering each pixel.

    ``ring`` is the child's ring index at nside * factor: the children of
    one pixel span at most 2 factor - 1 rings, and the power scan sums the
    azimuthal phases per ring before the recurrence.
    """
    pn = np.asarray(ring2nest(nside, pix))
    kids = pn[:, None] * factor**2 + np.arange(factor**2)[None, :]
    kr = np.asarray(nest2ring(nside * factor, kids.ravel()))
    th, ph = pix2ang_ring(nside * factor, kr)
    ring, _ = _pix2ring_ipix(nside * factor, kr)
    return (
        th.reshape(kids.shape),
        ph.reshape(kids.shape),
        np.asarray(ring).reshape(kids.shape),
    )


def _lane_setup(lmax, pol):
    """(ms, ns, weights) for the power scan: scalar block (+ spin blocks)."""
    m = np.arange(lmax + 1)
    eps0 = np.where(m == 0, 1.0, 2.0)
    if not pol:
        return m, np.zeros_like(m), eps0[None, :]
    # full-m spin-2 power: |a_{+2,l0}|^2 once, then |a_+|^2 + |a_-|^2
    epsP = np.where(m == 0, 0.5, 1.0)
    ms = np.concatenate([m, m, m])
    ns = np.concatenate([np.zeros_like(m), np.full_like(m, 2),
                         np.full_like(m, -2)])
    weights = np.zeros((2, 3 * (lmax + 1)))
    weights[0, : lmax + 1] = eps0
    weights[1, lmax + 1 :] = np.concatenate([epsP, epsP])
    return ms, ns, weights


def _rep_powers(th, ph, lmax, pol, chunk=64, rings=None, device="cuda"):
    """(nreps, K, lmax+1) lane-weighted powers of each representative pixel.

    ``th``, ``ph``: (nreps, nchildren) child angles.  With ``rings`` (the
    children's ring indices) the azimuthal phases are summed per distinct
    ring first, so the recurrence runs over rows rather than points.
    Representatives go through the scan ``chunk`` at a time, in float64 on
    ``device``.
    """
    ms, ns, weights = _lane_setup(lmax, pol)
    nreps, nch = th.shape
    if rings is not None:
        # children sorted by ring: per-representative row ids and row theta
        order = np.argsort(rings, axis=1, kind="stable")
        rs = np.take_along_axis(rings, order, 1)
        th_s = np.take_along_axis(th, order, 1)
        ph_pts = np.take_along_axis(ph, order, 1)
        new = np.concatenate(
            [np.ones((nreps, 1), bool), rs[:, 1:] != rs[:, :-1]], axis=1
        )
        row_of = np.cumsum(new, axis=1) - 1
        nrows = int(row_of.max()) + 1
        th_rows = np.full((nreps, nrows), np.pi / 2)
        th_rows[np.arange(nreps)[:, None], row_of] = th_s
    else:
        nrows = nch
        row_of = np.broadcast_to(np.arange(nch)[None, :], (nreps, nch))
        th_rows, ph_pts = th, ph

    dev = torch.device(device)
    f64 = torch.float64

    def put(a, dtype=f64):
        tracing.copied("pixwin.exact", "h2d", dev)
        tracing.synced("pixwin.exact", dev)
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    x = put(np.cos(th_rows))
    logch = put(np.log(np.cos(th_rows / 2)))
    logsh = put(np.log(np.sin(th_rows / 2)))
    phase = put(ph_pts)
    row = put(row_of, torch.int64)
    mf = torch.arange(lmax + 1, dtype=f64, device=dev)
    nblocks = ms.size // (lmax + 1)
    out = []
    for c in range(0, nreps, chunk):
        sl = slice(c, c + chunk)
        nc = phase[sl].shape[0]
        # F[rep, row, m] = (1/nch) sum over the row's children of e^{-im phi}
        expm = torch.exp(-1j * mf * phase[sl, :, None])
        frow = torch.zeros((nc, nrows, lmax + 1, 2), dtype=f64, device=dev)
        frow.scatter_add_(1, row[sl, :, None, None].expand(-1, -1, lmax + 1, 2),
                          torch.view_as_real(expm))
        fw = (torch.view_as_complex(frow) / nch).repeat(1, 1, nblocks)
        out.append(wigner.lambda_power_scan(ms, ns, x[sl], logch[sl], logsh[sl],
                                            lmax, fw, weights))
    return tracing.to_host("pixwin.exact", torch.cat(out))


@functools.lru_cache(maxsize=16)
def pixel_window_exact(nside, lmax, *, pol=False, factor=16, cap_samples=1,
                       device="cuda"):
    """Exact azimuthally averaged pixel window(s) for ``nside``.

    Returns (lmax+1,) for ``pol=False``; (2, lmax+1) [temperature,
    polarization] for ``pol=True`` (the polarization window is zero for
    l < 2).  ``factor`` must be a power of two (NESTED subdivision).  A
    shipped or cached window is returned as it is; otherwise the window is
    computed in float64 on ``device`` (default the CUDA card) and cached.
    """
    nside, lmax = int(nside), int(lmax)
    if factor & (factor - 1):
        raise ValueError("factor must be a power of two")

    hit = find_cached(nside, lmax, pol)
    if hit is not None:
        return hit
    logger.info(
        "computing exact pixel window nside=%d lmax=%d pol=%s", nside, lmax, pol
    )
    tracing.built("pixwin.exact")
    pix, wts = _pixel_classes(nside, cap_samples)
    th, ph, rings = _children_angles_rings(nside, pix, factor)
    powers = _rep_powers(th, ph, lmax, pol, rings=rings, device=device)

    ells = np.arange(lmax + 1)
    wsq = np.einsum("r,rkl->kl", wts / (12.0 * nside * nside), powers)
    wsq *= 4.0 * np.pi / (2 * ells + 1)
    w = np.sqrt(np.maximum(wsq, 0.0))
    # the midpoint sum over-estimates the integral by the inverse of the
    # fine grid's own window; multiply it back in
    w *= _subcell_window(nside * factor, lmax)
    # w(l=0) = 1 analytically (Y_00 is constant over the pixel)
    if w[0, 0] > 0:
        w /= w[0, 0]
    # the true windows are non-increasing in l (the polarized one from its
    # l = 2 onset): project rounding noise onto the monotone cone
    w[0] = np.minimum.accumulate(np.minimum(w[0], 1.0))
    if pol and lmax >= 2:
        w[1, 2:] = np.minimum.accumulate(np.minimum(w[1, 2:], 1.0))

    if pol:
        w[1, : min(2, lmax + 1)] = 0.0
        out = w
    else:
        out = w[0]
    try:
        os.makedirs(_cache_dir(), exist_ok=True)
        np.save(os.path.join(
            _cache_dir(),
            f"pixwin_{nside}_{lmax}_{int(pol)}_{factor}_{cap_samples}.npy",
        ), out)
    except OSError:
        pass
    return out
