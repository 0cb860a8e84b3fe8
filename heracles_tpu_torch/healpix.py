"""HEALPix geometry: numpy index tables, a torch ang2pix and ud_grade.

Counterpart of :mod:`heracles_tpu.healpix` (Gorski et al. 2005): the
closed-form layout of the isolatitude rings, ``pix2ang_ring`` and the
RING <-> NEST conversion on the host (numpy, float64 and int64);
``ang2pix_ring`` on tensors, for the device-side scatter of catalogue
pages; and ``ud_grade``, whose index tables are built on the host and
whose gather and mean run on the map's device.
"""

from __future__ import annotations

import concurrent.futures
import functools
import os

import numpy as np
import torch

__all__ = [
    "nside2npix",
    "npix2nside",
    "nside2pixarea",
    "nside2nrings",
    "ring_geometry",
    "ang2pix_ring",
    "pix2ang_ring",
    "ring2nest",
    "nest2ring",
    "ud_grade",
]

# face row index (in units of nside) and face phi offset (in units of
# pi/4 / nside) of the 12 HEALPix base faces
_JRLL = np.array([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4])
_JPLL = np.array([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7])


def nside2npix(nside):
    return 12 * nside * nside


def npix2nside(npix):
    nside = int(round((npix / 12) ** 0.5))
    if 12 * nside * nside != npix:
        raise ValueError(f"npix {npix} is not a valid HEALPix pixel count")
    return nside


def nside2pixarea(nside):
    return 4 * np.pi / nside2npix(nside)


def nside2nrings(nside):
    return 4 * nside - 1


@functools.lru_cache(maxsize=32)
def ring_geometry(nside):
    """Host-side ring layout tables for the RING scheme.

    Returns a dict of numpy arrays of length ``4*nside-1`` (north to
    south): ``npix`` (pixels per ring), ``start`` (first pixel), ``z``
    (cos theta, float64), ``theta``, ``phi0`` (first pixel azimuth) and
    ``pair`` (index of the mirror ring).
    """
    nside = int(nside)
    nr = 4 * nside - 1
    i = np.arange(1, nr + 1)  # 1-based ring index from the north pole
    npix_r = np.where(
        i < nside, 4 * i, np.where(i <= 3 * nside, 4 * nside, 4 * (4 * nside - i))
    )
    start = np.concatenate([[0], np.cumsum(npix_r)[:-1]])
    z = np.empty(nr)
    north = i < nside
    south = i > 3 * nside
    eq = ~(north | south)
    z[north] = 1.0 - (i[north] ** 2) / (3.0 * nside**2)
    z[eq] = 4.0 / 3.0 - 2.0 * i[eq] / (3.0 * nside)
    isouth = 4 * nside - i[south]
    z[south] = -1.0 + (isouth**2) / (3.0 * nside**2)
    phi0 = np.empty(nr)
    phi0[north] = np.pi / (4.0 * i[north])
    # belt rings alternate: half-step offset iff (i + nside) is even
    s = (i[eq] - nside + 1) % 2
    phi0[eq] = np.where(s == 1, np.pi / (4.0 * nside), 0.0)
    phi0[south] = np.pi / (4.0 * isouth)
    theta = np.arccos(np.clip(z, -1.0, 1.0))
    # better accuracy near the poles: theta from sin for cap rings
    sth_cap = np.sqrt((1 - z) * (1 + z))
    theta = np.where(
        np.abs(z) > 0.99,
        np.where(z > 0, np.arcsin(sth_cap), np.pi - np.arcsin(sth_cap)),
        theta,
    )
    return {
        "npix": npix_r.astype(np.int64),
        "start": start.astype(np.int64),
        "z": z,
        "theta": theta,
        "phi0": phi0,
        "pair": (nr - 1) - np.arange(nr),
    }


def ang2pix_ring(nside, theta, phi, *, lonlat=False):
    """RING-scheme pixel index (int64 tensor) of directions (theta, phi).

    ``theta``/``phi``: float64 tensors in radians, or (lon, lat) in
    degrees with ``lonlat=True``; the result lies on their device.
    """
    if lonlat:
        lon, lat = theta, phi
        phi = torch.deg2rad(lon)
        theta = torch.deg2rad(90.0 - lat)
    z = torch.cos(theta)
    za = torch.abs(z)
    tt = torch.remainder(phi, 2 * np.pi) / (0.5 * np.pi)  # in [0, 4)

    # equatorial zone (|z| <= 2/3)
    temp1 = nside * (0.5 + tt)
    temp2 = nside * z * 0.75
    jp = torch.floor(temp1 - temp2).long()  # ascending edge line
    jm = torch.floor(temp1 + temp2).long()  # descending edge line
    ir = nside + 1 + jp - jm  # ring number counted from z = 2/3
    kshift = 1 - (ir & 1)
    ip = torch.div(jp + jm - nside + kshift + 1, 2, rounding_mode="floor")
    ip = torch.remainder(ip, 4 * nside)
    pix_eq = 2 * nside * (nside - 1) + (ir - 1) * (4 * nside) + ip

    # polar caps
    tp = tt - torch.floor(tt)
    tmp = nside * torch.sqrt(3.0 * (1.0 - za))
    jp_c = torch.floor(tp * tmp).long()
    jm_c = torch.floor((1.0 - tp) * tmp).long()
    ir_c = jp_c + jm_c + 1  # ring number counted from the closest pole
    ip_c = torch.floor(tt * ir_c).long()
    ip_c = torch.remainder(ip_c, 4 * ir_c)
    pix_north = 2 * ir_c * (ir_c - 1) + ip_c
    pix_south = nside2npix(nside) - 2 * ir_c * (ir_c + 1) + ip_c
    pix_cap = torch.where(z > 0, pix_north, pix_south)

    return torch.where(za <= 2.0 / 3.0, pix_eq, pix_cap)


def _isqrt(x):
    """Integer sqrt of an int64 array, robust to float rounding."""
    s = np.sqrt(x.astype(np.float64) + 0.5).astype(x.dtype)
    s = np.where((s + 1) * (s + 1) <= x, s + 1, s)
    return np.where(s * s > x, s - 1, s)


def _pix2ring_ipix(nside, pix):
    """(1-based ring index, 0-based index in the ring) of RING pixels."""
    npix = nside2npix(nside)
    ncap = 2 * nside * (nside - 1)
    pix = np.asarray(pix)

    # north cap
    iring_n = (1 + _isqrt(1 + 2 * pix)) // 2
    iphi_n = pix - 2 * iring_n * (iring_n - 1)

    # equatorial belt
    ipe = pix - ncap
    iring_e = ipe // (4 * nside) + nside
    iphi_e = np.mod(ipe, 4 * nside)

    # south cap
    ips = npix - 1 - pix
    iring_s0 = (1 + _isqrt(1 + 2 * ips)) // 2
    iring_s = 4 * nside - iring_s0
    iphi_s = 4 * iring_s0 - 1 - (ips - 2 * iring_s0 * (iring_s0 - 1))

    north = pix < ncap
    south = pix >= npix - ncap
    iring = np.where(north, iring_n, np.where(south, iring_s, iring_e))
    iphi = np.where(north, iphi_n, np.where(south, iphi_s, iphi_e))
    return iring, iphi


def pix2ang_ring(nside, pix, *, lonlat=False):
    """(theta, phi) of RING pixel centres (host numpy, float64); (lon,
    lat) in degrees with ``lonlat=True``."""
    iring, iphi = _pix2ring_ipix(nside, pix)
    north = iring < nside
    south = iring > 3 * nside
    irs = 4 * nside - iring
    z = np.where(
        north,
        1.0 - iring.astype(np.float64) ** 2 / (3.0 * nside**2),
        np.where(
            south,
            -1.0 + irs.astype(np.float64) ** 2 / (3.0 * nside**2),
            4.0 / 3.0 - 2.0 * iring.astype(np.float64) / (3.0 * nside),
        ),
    )
    nr = np.where(north, 4 * iring, np.where(south, 4 * irs, 4 * nside))
    shift = np.where(
        north | south, 1.0, ((iring - nside + 1) % 2).astype(np.float64)
    )
    phi = (iphi.astype(np.float64) + 0.5 * shift) * (2 * np.pi) / nr
    theta = np.arccos(np.clip(z, -1.0, 1.0))
    if lonlat:
        return np.degrees(phi), 90.0 - np.degrees(theta)
    return theta, phi


def _spread_bits(v):
    """Interleave zeros between the bits of v (int64, v < 2**29)."""
    v = v.astype(np.int64)
    v = (v | (v << 16)) & 0x0000FFFF0000FFFF
    v = (v | (v << 8)) & 0x00FF00FF00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0F
    v = (v | (v << 2)) & 0x3333333333333333
    v = (v | (v << 1)) & 0x5555555555555555
    return v


def _compress_bits(v):
    """The even bits of v, packed: the inverse of :func:`_spread_bits`."""
    v = v & 0x5555555555555555
    v = (v | (v >> 1)) & 0x3333333333333333
    v = (v | (v >> 2)) & 0x0F0F0F0F0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF00FF00FF
    v = (v | (v >> 8)) & 0x0000FFFF0000FFFF
    v = (v | (v >> 16)) & 0x00000000FFFFFFFF
    return v


def _ring2xyf(nside, pix):
    """RING pixel -> (ix, iy, face)."""
    pix = np.asarray(pix, dtype=np.int64)
    npix = nside2npix(nside)
    ncap = 2 * nside * (nside - 1)
    iring, iphi = _pix2ring_ipix(nside, pix)
    iphi = iphi + 1  # 1-based within the ring

    north = pix < ncap
    south = pix >= npix - ncap
    cap = north | south
    # polar caps: each ring spans the 4 polar faces
    nr = np.where(north, iring, np.where(south, 4 * nside - iring, nside))
    kshift = np.where(cap, 0, (iring - nside) & 1)
    ire = iring - nside + 1
    irm = 2 * nside + 2 - ire
    ifm = (iphi - ire // 2 + nside - 1) // nside
    ifp = (iphi - irm // 2 + nside - 1) // nside
    face_eq = np.where(ifp == ifm, ifp | 4, np.where(ifp < ifm, ifp, ifm + 8))
    face_cap = (iphi - 1) // nr + np.where(south, 8, 0)
    face = np.where(cap, face_cap, face_eq)

    irt = iring - _JRLL[face] * nside + 1
    ipt = 2 * iphi - _JPLL[face] * nr - kshift - 1
    ipt = np.where(ipt >= 2 * nside, ipt - 8 * nside, ipt)
    ix = (ipt - irt) >> 1
    iy = (-ipt - irt) >> 1
    return ix, iy, face


def _xyf2ring(nside, ix, iy, face):
    """(ix, iy, face) -> RING pixel."""
    nl4 = 4 * nside
    jr = _JRLL[face] * nside - ix - iy - 1  # ring index (1-based)

    north = jr < nside
    south = jr > 3 * nside
    nrs = nl4 - jr
    nr = np.where(north, jr, np.where(south, nrs, nside))
    n_before = np.where(
        north,
        2 * jr * (jr - 1),
        np.where(south, nside2npix(nside) - 2 * nrs * (nrs + 1),
                 2 * nside * (nside - 1) + (jr - nside) * nl4),
    )
    kshift = np.where(north | south, 0, (jr - nside) & 1)

    jp = (_JPLL[face] * nr + ix - iy + 1 + kshift) // 2
    jp = np.where(jp > nl4, jp - nl4, jp)
    jp = np.where(jp < 1, jp + nl4, jp)
    return n_before + jp - 1


def ring2nest(nside, pix):
    """NEST indices of RING pixels (host numpy, int64)."""
    ix, iy, face = _ring2xyf(nside, pix)
    return face * nside * nside + (_spread_bits(ix) | (_spread_bits(iy) << 1))


def nest2ring(nside, pix):
    """RING indices of NEST pixels (host numpy, int64)."""
    pix = np.asarray(pix, dtype=np.int64)
    face = pix // (nside * nside)
    rem = pix - face * nside * nside
    return _xyf2ring(nside, _compress_bits(rem), _compress_bits(rem >> 1), face)


# coarse pixels per block of the child table: the temporaries of a block
# stay in cache, and the blocks are spread over the host's cores
_GATHER_BLOCK = 1 << 16


@functools.lru_cache(maxsize=8)
def _udgrade_gather(nside_in, nside_out):
    """RING indices of the children (at nside_in) of each RING pixel at
    nside_out: an int64 array (npix_out, (nside_in // nside_out)**2), for a
    gather and a mean.

    A pixel (ix, iy) of a face has the children (k ix + dx, k iy + dy) of
    the same face, k = nside_in // nside_out: the children that are
    adjacent in NEST order, found without the bit interleave.
    """
    if nside_in % nside_out:
        raise ValueError(f"nside {nside_in} is not a multiple of {nside_out}")
    k = nside_in // nside_out
    npix_out = nside2npix(nside_out)
    dx, dy = np.arange(k * k) % k, np.arange(k * k) // k
    out = np.empty((npix_out, k * k), dtype=np.int64)

    def fill(lo):
        hi = min(lo + _GATHER_BLOCK, npix_out)
        ix, iy, face = (a[:, None] for a in
                        _ring2xyf(nside_out, np.arange(lo, hi)))
        out[lo:hi] = _xyf2ring(nside_in, k * ix + dx, k * iy + dy, face)

    # numpy releases the interpreter lock inside its loops
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as pool:
        list(pool.map(fill, range(0, npix_out, _GATHER_BLOCK)))
    return out


def ud_grade(m, nside_out, *, power=None, dtype=None):
    """Up- or downgrade RING-ordered maps (..., npix) to ``nside_out``.

    Degrading averages the child pixels, upgrading repeats the parent's
    value; ``power`` rescales by (nside_in / nside_out)**power.  ``m`` is a
    tensor; the index tables are built on the host (cached per pair of
    resolutions) and the gather and the mean run on the map's device.
    ``dtype``: the torch dtype of the result (default: the map's).
    """
    nside_in = npix2nside(m.shape[-1])
    nside_out = int(nside_out)
    if nside_in == nside_out:
        out = m
    elif nside_in > nside_out:
        gather = _udgrade_gather(nside_in, nside_out)
        out = m[..., torch.as_tensor(gather, device=m.device)].mean(dim=-1)
    else:
        gather = _udgrade_gather(nside_out, nside_in)
        parent = np.empty(nside2npix(nside_out), dtype=np.int64)
        parent[gather.reshape(-1)] = np.repeat(
            np.arange(nside2npix(nside_in)), (nside_out // nside_in) ** 2)
        out = m[..., torch.as_tensor(parent, device=m.device)]
    if power:
        out = out * (nside_in / nside_out) ** power
    if dtype is not None:
        out = out.to(dtype)
    return out
