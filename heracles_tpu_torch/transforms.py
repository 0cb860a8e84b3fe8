"""Cl <-> correlation-function transforms on Gauss-Legendre nodes.

Carried over unchanged from :mod:`heracles_tpu.transforms` (host numpy,
cached tables): spectra are transformed to real-space correlation
functions sampled at the roots of P_{lmax+1} and back, in the CAMB
(TT, EE, BB, TE) block layout, for spin pairs (0,0), (0,2) and (2,2)
including EB as the imaginary part.

All Wigner-d functions (P_l = d^l_00, d^l_20, d^l_22, d^l_2,-2) are
generated by a three-term l-recurrence, simultaneously for every
quadrature node, and the transforms are single matmuls.
"""

from __future__ import annotations

from dataclasses import replace
from functools import lru_cache

import numpy as np

from .result import get_result_array

__all__ = ["cl2corr", "corr2cl"]


@lru_cache(maxsize=16)
def _gauss_legendre(npoints):
    x, w = np.polynomial.legendre.leggauss(npoints)
    x.flags.writeable = False
    w.flags.writeable = False
    return x, w


def wigner_d_table(a, b, x, lmax):
    """d^l_{a,b}(theta) for l = 0..lmax at cos(theta) = x (vectorised).

    Same three-term recurrence as the SHT engine
    (:mod:`heracles_tpu_torch.ops.wigner`); |a|, |b| <= 2 needs no scaling in
    float64.  Returns array (lmax+1, len(x)); entries with l < max(|a|,|b|)
    are zero.
    """
    x = np.asarray(x, dtype=np.float64)
    ch = np.sqrt((1.0 + x) / 2.0)  # cos(theta/2)
    sh = np.sqrt((1.0 - x) / 2.0)  # sin(theta/2)
    aa, ab = abs(a), abs(b)
    j0 = max(aa, ab)
    # seed: single surviving term of the Wigner-d sum formula at j0
    from math import factorial, sqrt

    if aa >= ab:
        c = b
        k0 = a - b if a >= 0 else 0
    else:
        c = a
        k0 = 0 if b > 0 else a + ab
    logc = sqrt(
        factorial(2 * j0) / (factorial(j0 + c) * factorial(j0 - c))
    )
    sign = -1.0 if k0 % 2 else 1.0
    seed = sign * logc * ch ** abs(a + b) * sh ** abs(a - b)

    out = np.zeros((lmax + 1, x.size))
    if j0 <= lmax:
        out[j0] = seed
    mn = a * b
    for ell in range(j0 + 1, lmax + 1):
        def coef(l):
            return np.sqrt((l * l - a * a) * (l * l - b * b)) / l

        alp = coef(ell)
        al = coef(ell - 1) if ell - 1 >= 1 else 0.0
        mid = (2 * ell - 1) * (x - mn / (ell * (ell - 1.0))) if ell > 1 else (
            2 * ell - 1
        ) * x
        out[ell] = (mid * out[ell - 1] - al * out[ell - 2]) / alp
    return out


@lru_cache(maxsize=16)
def _d_tables(lmax, npoints):
    """(P, d20, d22, d2m2) tables at the GL nodes, each (lmax+1, nx)."""
    x, _ = _gauss_legendre(npoints)
    P = wigner_d_table(0, 0, x, lmax)
    d20 = wigner_d_table(2, 0, x, lmax)
    d22 = wigner_d_table(2, 2, x, lmax)
    d2m2 = wigner_d_table(2, -2, x, lmax)
    return P, d20, d22, d2m2


def _cl2corr(cls, lmax=None, sampling_factor=1):
    """CAMB-layout transform: cls (L, 4) [TT,EE,BB,TE] -> corrs (nx, 4)
    [T, Q+U, Q-U, cross] at the GL nodes of degree lmax+1."""
    cls = np.asarray(cls, dtype=np.float64)
    if cls.ndim == 1:
        z = np.zeros_like(cls)
        cls = np.stack([cls, z, z, z], axis=-1)
    if lmax is None:
        lmax = cls.shape[0] - 1
    npoints = int(sampling_factor * lmax) + 1
    P, d20, d22, d2m2 = _d_tables(lmax, npoints)
    ls = np.arange(lmax + 1, dtype=np.float64)
    facs = (2 * ls + 1) / (4 * np.pi)
    ct = facs * cls[: lmax + 1, 0]
    cp = facs * (cls[: lmax + 1, 1] + cls[: lmax + 1, 2])
    cm = facs * (cls[: lmax + 1, 1] - cls[: lmax + 1, 2])
    cc = facs * cls[: lmax + 1, 3]
    corrs = np.stack(
        [ct @ P, cp @ d22, cm @ d2m2, cc @ d20],
        axis=-1,
    )
    return corrs


def _corr2cl(corrs, lmax=None, sampling_factor=1):
    """Inverse of :func:`_cl2corr` by Gauss-Legendre quadrature."""
    corrs = np.asarray(corrs, dtype=np.float64)
    if corrs.ndim == 1:
        z = np.zeros_like(corrs)
        corrs = np.stack([corrs, z, z, z], axis=-1)
    if lmax is None:
        lmax = corrs.shape[0] - 1
    npoints = int(sampling_factor * lmax) + 1
    x, w = _gauss_legendre(npoints)
    P, d20, d22, d2m2 = _d_tables(lmax, npoints)
    cls = np.zeros((lmax + 1, 4))
    cls[:, 0] = P @ (w * corrs[:, 0])
    T2 = d22 @ (w * corrs[:, 1] / 2)
    T4 = d2m2 @ (w * corrs[:, 2] / 2)
    cls[:, 1] = T2 + T4
    cls[:, 2] = T2 - T4
    cls[:, 3] = d20 @ (w * corrs[:, 3])
    return 2 * np.pi * cls


def cl2corr(cls):
    """Transform a dict of Cl Results to correlation-function Results.

    Handles spin pairs (0,0), (0,2)/(2,0) and (2,2); for (2,2) the EB/BE
    parts ride as the imaginary component through the complex transform.
    The returned Results carry the quadrature nodes cos(theta) in their
    ``ell`` slot.
    """
    out = {}
    for key, cl in cls.items():
        s1, s2 = cl.spin
        dtype = cl.array.dtype
        lmax = len(get_result_array(cl, "ell")[0]) - 1
        xvals, _ = _gauss_legendre(lmax + 1)
        wd = np.zeros_like(np.asarray(cl.array, dtype=float))
        if s1 != 0 and s2 != 0:
            z = np.zeros_like(np.asarray(cl[0, 0]))
            re = np.stack([z, cl[0, 0], cl[1, 1], z], axis=-1)
            im = np.stack([z, -cl[0, 1], cl[1, 0], z], axis=-1)
            w = _cl2corr(re) + 1j * _cl2corr(im)
            wd[0, 0] = w[:, 1].real
            wd[1, 1] = w[:, 2].real
            wd[0, 1] = w[:, 1].imag
            wd[1, 0] = w[:, 2].imag
        elif s1 != 0 or s2 != 0:
            z = np.zeros_like(np.asarray(cl[0]))
            wp = np.stack([z, z, z, cl[0] + cl[1]], axis=-1)
            wm = np.stack([z, z, z, cl[0] - cl[1]], axis=-1)
            wd[0] = _cl2corr(wp)[:, 3]
            wd[1] = _cl2corr(wm)[:, 3]
        else:
            wd = _cl2corr(np.asarray(cl.array))[:, 0]
        wd = np.asarray(wd, dtype=dtype)
        out[key] = replace(cl, ell=xvals, array=wd)
    return out


def corr2cl(wds):
    """Inverse of :func:`cl2corr` on a dict of correlation Results."""
    out = {}
    for key, wd in wds.items():
        s1, s2 = wd.spin
        dtype = wd.array.dtype
        xvals = get_result_array(wd, "ell")[0]
        lmax = len(xvals) - 1
        cl = np.zeros_like(np.asarray(wd.array, dtype=float))
        if s1 != 0 and s2 != 0:
            z = np.zeros_like(np.asarray(wd[0, 0]))
            re = np.stack([z, wd[0, 0], wd[1, 1], z], axis=-1)
            im = np.stack([z, wd[0, 1], wd[1, 0], z], axis=-1)
            rcl = _corr2cl(re)
            icl = _corr2cl(im)
            cl[0, 0] = rcl[:, 1]
            cl[1, 1] = rcl[:, 2]
            cl[0, 1] = -icl[:, 1]
            cl[1, 0] = icl[:, 2]
        elif s1 != 0 or s2 != 0:
            z = np.zeros_like(np.asarray(wd[0]))
            cp = _corr2cl(np.stack([z, z, z, wd[0]], axis=-1))[:, 3]
            cm = _corr2cl(np.stack([z, z, z, wd[1]], axis=-1))[:, 3]
            cl[0] = (cp + cm) / 2
            cl[1] = (cp - cm) / 2
        else:
            cl = _corr2cl(np.asarray(wd.array))[:, 0]
        cl = np.asarray(cl, dtype=dtype)
        out[key] = replace(wd, ell=np.arange(lmax + 1), array=cl)
    return out
