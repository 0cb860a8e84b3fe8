"""Spherical harmonic analysis and synthesis of HEALPix maps, on torch.

Counterpart of :mod:`heracles_tpu.ops.sht`:

* phase 1 (azimuth): batched ring FFTs (:mod:`.ringfft`);
* phase 2 (colatitude): the folded Wigner-d contractions of the Hopper
  kernels (:mod:`.sht_kernels`), or their plain versions on the CPU;
* quadrature: per-ring weights such that the analysis of band-limited
  maps is exact (shipped tables, else a host least-squares solve);
* synthesis (:func:`alm2map`) runs the two phases in reverse, and
  ``map2alm(iterations=N)`` refines the analysis by N Jacobi steps;
* ``dd=True`` runs the colatitude phase of a float32 transform in float64
  (the float64 instantiation of the kernels); the ring FFTs, the weights
  and the Jacobi residual stay in float32, as do the results.

Conventions (HEALPix/healpy): alms are healpy-packed at the API boundary
(index = m*(2*lmax+1-m)//2 + l) and rectangular (lmax+1, mmax+1)
internally; spin 2: a_E = -(a_{+2} + a_{-2})/2, a_B = i(a_{+2} - a_{-2})/2
with (Q + iU) = sum a_{+2,lm} {}_2Y_{lm}.
"""

from __future__ import annotations

import functools
import glob
import importlib.util
import logging
import os

import numpy as np
import torch

from ..healpix import npix2nside, nside2pixarea, ring_geometry
from . import ringfft, sht_kernels

logger = logging.getLogger(__name__)

__all__ = [
    "alm_size",
    "pack_alm",
    "unpack_alm",
    "map2alm",
    "alm2map",
    "ring_weights",
    "pixel_window",
    "resolve_lmax",
]


def resolve_lmax(nside, lmax=None):
    """Default band limit, 3 * nside // 2."""
    return 3 * nside // 2 if lmax is None else int(lmax)


def alm_size(lmax, mmax=None):
    """Packed alm length: sum over m = 0..mmax of (lmax - m + 1)."""
    mmax = lmax if mmax is None else mmax
    return (mmax + 1) * (lmax + 1) - mmax * (mmax + 1) // 2


def _pack_index(lmax, mmax, device):
    """(l_idx, m_idx) tensors giving rect coords of each packed entry."""
    m = torch.arange(mmax + 1, device=device)
    counts = lmax + 1 - m
    ms = torch.repeat_interleave(m, counts)
    # order m's run starts at (l, m) = (m, m)
    start = torch.cumsum(counts, 0) - counts
    ls = torch.arange(ms.numel(), device=device) - start[ms] + ms
    return ls, ms


def _flat_pack_index(lmax, mmax, device):
    ls, ms = _pack_index(lmax, mmax, device)
    return ls * (mmax + 1) + ms


def pack_alm(alm_rect, lmax=None, mmax=None):
    """Rectangular (..., lmax+1, mmax+1) -> healpy-packed (..., nlm)."""
    lmax = alm_rect.shape[-2] - 1 if lmax is None else int(lmax)
    mmax = alm_rect.shape[-1] - 1 if mmax is None else int(mmax)
    flat = alm_rect.reshape(alm_rect.shape[:-2] + (-1,))
    return flat[..., _flat_pack_index(lmax, mmax, alm_rect.device)]


def unpack_alm(alm_packed, lmax, mmax=None):
    """healpy-packed (..., nlm) -> rectangular (..., lmax+1, mmax+1)."""
    mmax = lmax if mmax is None else int(mmax)
    out = alm_packed.new_zeros(alm_packed.shape[:-1] + ((lmax + 1) * (mmax + 1),))
    out[..., _flat_pack_index(lmax, mmax, alm_packed.device)] = alm_packed
    return out.reshape(alm_packed.shape[:-1] + (lmax + 1, mmax + 1))


@functools.lru_cache(maxsize=32)
def _geom_arrays(nside):
    """Per-ring cos(theta), log cos(theta/2), log sin(theta/2) (host f64)."""
    z = ring_geometry(nside)["z"]
    logch = 0.5 * np.log((1.0 + z) / 2.0)
    logsh = 0.5 * np.log((1.0 - z) / 2.0)
    return z, logch, logsh


def _data_dir():
    """The tables shipped in ``heracles_tpu/data`` (found, not imported)."""
    spec = importlib.util.find_spec("heracles_tpu")
    if spec is None or not spec.submodule_search_locations:
        return None
    return os.path.join(list(spec.submodule_search_locations)[0], "data")


@functools.lru_cache(maxsize=32)
def ring_weights(nside, lmax_w=None):
    """Quadrature weights per pixel of each ring (numpy, float64).

    The minimum-norm correction to the uniform pixel-area weights such
    that sum_p w_p P_l(z_p) = 4 pi delta_{l0} for all even l <= lmax_w
    (odd l vanish by N/S symmetry).  Read from the shipped tables when
    one matches, else solved on the host (minutes at nside >= 4096).
    """
    nside = int(nside)
    lmax_w = 3 * nside if lmax_w is None else int(lmax_w)
    data = _data_dir()
    if data is not None:
        path = os.path.join(data, f"ringweights_{nside}_{lmax_w}.npy")
        if os.path.exists(path):
            return np.load(path)
    if nside >= 1024:
        logger.info("solving ring quadrature weights for nside=%d", nside)
    g = ring_geometry(nside)
    z = g["z"]
    nph = g["npix"].astype(np.float64)
    nhalf = 2 * nside  # rings 0..2*nside-1 cover z > 0 plus the equator
    zs = z[:nhalf]
    fold = np.where(np.arange(nhalf) == nhalf - 1, 1.0, 2.0)  # equator unpaired
    nev = lmax_w // 2 + 1
    A = np.empty((nev, nhalf))
    pm1 = np.ones_like(zs)
    p = zs.copy()
    A[0] = nph[:nhalf] * fold
    for ell in range(2, lmax_w + 1):
        pnext = ((2 * ell - 1) * zs * p - (ell - 1) * pm1) / ell
        pm1, p = p, pnext
        if ell % 2 == 0:
            A[ell // 2] = nph[:nhalf] * fold * p
    b = np.zeros(nev)
    b[0] = 4.0 * np.pi
    w0 = np.full(nhalf, nside2pixarea(nside))
    delta, *_ = np.linalg.lstsq(A, b - A @ w0, rcond=None)
    w_half = w0 + delta
    return np.concatenate([w_half, w_half[:-1][::-1]])


def _weights_arr(nside, weights):
    if weights is None:
        return np.full(4 * nside - 1, nside2pixarea(nside))
    if isinstance(weights, str) and weights == "ring":
        return ring_weights(nside)
    return np.asarray(weights, dtype=np.float64)


def _fold_rings(F, nside):
    """Split full-ring arrays (..., nr, nm) into (north, south-mirrored).

    North covers rings 0..2*nside-1 (incl. the equator); the south part
    is mirrored onto the same rows with a zero equator row (the equator
    is its own mirror and must enter once).
    """
    nhalf = 2 * nside
    FN = F[..., :nhalf, :]
    FS = torch.flip(F[..., nhalf:, :], dims=(-2,))
    FS = torch.cat([FS, FS.new_zeros(FS.shape[:-2] + (1, FS.shape[-1]))], dim=-2)
    return FN, FS


def _geometry(nside, device):
    """Northern-ring x (float64), log cos(theta/2), log sin(theta/2)."""
    nhalf = 2 * nside
    return tuple(torch.as_tensor(a[:nhalf], device=device)
                 for a in _geom_arrays(nside))


def _folded_inputs(Fw, ns):
    """The folded kernel inputs for full-ring spectra ``Fw`` of columns ``ns``.

    N/S mirror symmetry pairs column +n with column -n: each branch's
    even/odd inputs combine its own northern rows with its partner
    branch's southern rows, which carry a (-1)^m per-order sign.  Returns
    (Fe, Fo) for one spin-0 column, (FNp, Sp, FNm, Sm) for a +-s pair.
    """
    nm = Fw[0].shape[-1]
    nside = (Fw[0].shape[-2] + 1) // 4
    msign = torch.ones(nm, dtype=Fw[0].real.dtype, device=Fw[0].device)
    msign[1::2] = -1.0
    folded = [_fold_rings(f, nside) for f in Fw]
    if len(ns) == 1:
        FN, FS = folded[0]
        FS = FS * msign
        return FN + FS, FN - FS
    (FNp, FSp), (FNm, FSm) = folded
    return FNp, FSp * msign, FNm, FSm * msign


def _widen(arrays, dd):
    """(arrays, dtype to return to): complex64 operands widened for ``dd``.

    ``dd`` only matters for complex64 operands; complex128 ones pass as
    they are and nothing is cast back (the second value is None).
    """
    if dd and arrays[0].dtype == torch.complex64:
        return tuple(a.to(torch.complex128) for a in arrays), torch.complex64
    return arrays, None


def _narrow(arrays, dtype):
    return arrays if dtype is None else tuple(a.to(dtype) for a in arrays)


def _analysis_rect(Fw, lmax, ns, dd=False):
    """Folded Wigner analysis of full-ring spectra; tuple of rect alms.

    With ``dd`` the folded complex64 spectra are widened to complex128, so
    the recurrence and the ring sums run in float64, and the alms come
    back as complex64.
    """
    nside = (Fw[0].shape[-2] + 1) // 4
    x, logch, logsh = _geometry(nside, Fw[0].device)
    args, back = _widen(_folded_inputs(Fw, ns), dd)
    if len(ns) == 1:
        out = (sht_kernels.analysis_spin0_folded(*args, x, logch, logsh, lmax),)
    else:
        out = sht_kernels.analysis_pair_folded(*args, x, logch, logsh, lmax,
                                               abs(int(ns[0])))
    return _narrow(out, back)


def _unfold_rings(GN, GS):
    """Full-ring spectra from the folded synthesis' (GN, GS).

    The northern rows come as they are; the southern rows are the flipped
    GS without its equator row (the equator is its own mirror).
    """
    return torch.cat([GN, torch.flip(GS[..., :-1, :], dims=(-2,))], dim=-2)


def _synthesis_rect(alms, lmax, ns, nside, dd=False):
    """Folded Wigner synthesis of rect alms; tuple of full-ring spectra.

    ``alms``: one (..., lmax+1, nm) array per spin column n in ``ns``;
    returns one (..., nrings, nm) array each.  With ``dd`` complex64 alms
    are widened to complex128 for the recurrence and its sums, and the
    ring spectra come back as complex64.
    """
    x, logch, logsh = _geometry(nside, alms[0].device)
    alms, back = _widen(tuple(alms), dd)
    if len(ns) == 1:
        GN, GS = _narrow(sht_kernels.synthesis_spin0_folded(
            alms[0], x, logch, logsh, lmax), back)
        return (_unfold_rings(GN, GS),)
    GNp, GSp, GNm, GSm = _narrow(sht_kernels.synthesis_pair_folded(
        alms[0], alms[1], x, logch, logsh, lmax, abs(int(ns[0]))), back)
    return _unfold_rings(GNp, GSp), _unfold_rings(GNm, GSm)


def map2alm(maps, lmax=None, mmax=None, *, spin=0, weights="ring",
            iterations=0, packed=True, dd=None):
    """Spin-0/2 spherical harmonic analysis of HEALPix RING maps.

    ``maps``: (..., npix) real tensor for spin 0; (..., 2, npix) [Q, U]
    for spin 2.  ``weights``: "ring" (quadrature weights, default), None
    (pixel area) or per-ring weights.  ``iterations``: Jacobi refinement
    steps alm += A(w (f - S(alm))), healpy's ``iter=`` counterpart; each
    costs one synthesis and one analysis, with the residual formed on the
    maps' device and in their dtype.  Runs on the maps' device and in
    their precision (float32 -> complex64 alms, float64 -> complex128).
    ``dd``: True runs the Wigner recurrence and its ring sums of a float32
    transform in float64 (the kernels' float64 instantiation) while the
    ring FFTs, the weights and the residual stay in float32 and the alms
    come back as complex64; ``"comp"`` runs as True; None and False run
    in float32.  It is ignored for float64 maps.  (The reference's
    ``HERACLES_TPU_SHT_DD`` environment switch is not carried over.)
    Returns packed alms (..., nlm) for spin 0, or (..., 2, nlm) (E, B) for
    spin 2 (``packed=False``: rectangular (..., lmax+1, mmax+1)).
    """
    spin = abs(int(spin))
    nside = npix2nside(maps.shape[-1])
    lmax = resolve_lmax(nside, lmax)
    mmax = lmax if mmax is None else int(mmax)
    dd = bool(dd)  # None is False, "comp" runs as True
    out = _map2alm_once(maps, nside, lmax, mmax, spin, weights, dd)
    for _ in range(int(iterations)):
        resid = maps - alm2map(out, nside, lmax, mmax, spin=spin, packed=False,
                               dd=dd)
        out = out + _map2alm_once(resid, nside, lmax, mmax, spin, weights, dd)
    if packed:
        return pack_alm(out, lmax, mmax)
    return out


def _map2alm_once(maps, nside, lmax, mmax, spin, weights, dd=False):
    """One analysis pass; rectangular alms (E, B stacked for spin 2)."""
    w = _weights_arr(nside, weights)
    if spin == 0:
        F, _ = ringfft.ring_analysis(maps, nside, mmax + 1, weight=w)
        (out,) = _analysis_rect((F,), lmax, (0,), dd)
        return out
    u = torch.complex(maps[..., 0, :], maps[..., 1, :])
    F, Fneg = ringfft.ring_analysis(u, nside, mmax + 1, weight=w)
    # a_{+s,lm} = sum_r w slm(l,m,+s) F_m(r): column +s;
    # a_{-s,lm} = sum_r w slm(l,m,-s) conj(F_{-m}(r)): column -s
    a_p, a_m = _analysis_rect((F, Fneg.conj()), lmax, (spin, -spin), dd)
    return torch.stack([-(a_p + a_m) / 2, 1j * (a_p - a_m) / 2], dim=-3)


def alm2map(alm, nside, lmax=None, mmax=None, *, spin=0, packed=True,
            dd=None):
    """Spin-0/2 spherical harmonic synthesis onto HEALPix RING maps.

    ``alm``: packed (..., nlm) complex for spin 0, (..., 2, nlm) (E, B)
    for spin 2; rectangular (..., lmax+1, mmax+1) with ``packed=False``.
    Runs on the alms' device and in their precision (complex64 -> float32
    maps, complex128 -> float64).  ``dd``: as for :func:`map2alm`, the
    recurrence of a complex64 synthesis in float64 with float32 maps
    returned; ignored for complex128 alms.  Returns (..., npix) or
    (..., 2, npix) [Q, U].
    """
    dd = bool(dd)  # None is False, "comp" runs as True
    spin = abs(int(spin))
    nside = int(nside)
    if lmax is None:
        if packed:
            # invert nlm = (lmax+1)(lmax+2)/2 (mmax = lmax)
            nlm = alm.shape[-1]
            lmax = int((np.sqrt(8 * nlm + 1) - 3) / 2 + 0.5)
        else:
            lmax = alm.shape[-2] - 1
    lmax = int(lmax)
    mmax = lmax if mmax is None else int(mmax)
    if packed:
        alm = unpack_alm(alm, lmax, mmax)
    if spin == 0:
        (G,) = _synthesis_rect((alm,), lmax, (0,), nside, dd)
        return ringfft.ring_synthesis(G, None, nside)
    alm_e = alm[..., 0, :, :]
    alm_b = alm[..., 1, :, :]
    a_p = -(alm_e + 1j * alm_b)  # a_{+spin}
    a_m = -(alm_e - 1j * alm_b)  # a_{-spin}
    # u = sum_{m>=0} G+_m e^{im phi} + sum_{m>0} G-_m e^{-im phi} with
    # G+_m = sum_l a_{+s,lm} slm(l,m,+s) and
    # G-_m = sum_l conj(a_{-s,lm}) slm(l,m,-s) (reality relations)
    Gp, Gm = _synthesis_rect((a_p, a_m.conj()), lmax, (spin, -spin), nside,
                             dd)
    u = ringfft.ring_synthesis(Gp, Gm, nside, real_output=False)
    return torch.stack([u.real, u.imag], dim=-2)


def _pixwin_table(nside, lmax, pol):
    """A shipped exact window covering (nside, lmax, pol), else None."""
    data = _data_dir()
    if data is None:
        return None
    for path in sorted(glob.glob(os.path.join(data, f"pixwin_{int(nside)}_*.npy"))):
        _, _, lm, pl, _, _ = os.path.basename(path)[:-4].split("_")
        if int(lm) < lmax or (pol and not int(pl)):
            continue
        arr = np.load(path)[..., : lmax + 1]
        return arr if pol or arr.ndim == 1 else arr[0]
    return None


def _cap_window(nside, lmax):
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


@functools.lru_cache(maxsize=32)
def pixel_window(nside, lmax, *, pol=False, method="auto"):
    """HEALPix pixel window w(l), l = 0..lmax (numpy, float64).

    With ``pol=True`` returns (2, lmax+1) [temperature, polarization].
    ``method``: ``"exact"`` reads the shipped exact tables; ``"cap"`` is
    the equal-area spherical-cap closed form; ``"auto"`` takes a table
    where one covers (nside, lmax) and the cap form otherwise.  Exact
    windows without a table (which heracles_tpu computes on the fly for
    nside <= 32) are not ported yet (ROADMAP A13).
    """
    nside, lmax = int(nside), int(lmax)
    if method not in ("auto", "exact", "cap"):
        raise ValueError(f"unknown pixel window method: {method!r}")
    if method != "cap":
        table = _pixwin_table(nside, lmax, pol)
        if table is not None:
            return table
        if method == "exact" or nside <= 32:
            raise NotImplementedError(
                f"no shipped exact pixel window for nside={nside}, "
                f"lmax={lmax}; computing exact windows is not ported yet "
                "(ROADMAP A13)"
            )
    w = _cap_window(nside, lmax)
    if pol:
        w = np.stack([w, w])
        w[1, : min(2, lmax + 1)] = 0.0
    return w
