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
  (the float64 instantiation of the kernels), and ``dd="comp"`` in the
  kernels' compensated float32 instantiation, which corrects the float32
  truncation of cos(theta) with its float32 residual (:func:`_x_lo`); the
  ring FFTs, the weights and the Jacobi residual stay in float32, as do
  the results.

Conventions (HEALPix/healpy): alms are healpy-packed at the API boundary
(index = m*(2*lmax+1-m)//2 + l) and rectangular (lmax+1, mmax+1)
internally; spin 2: a_E = -(a_{+2} + a_{-2})/2, a_B = i(a_{+2} - a_{-2})/2
with (Q + iU) = sum a_{+2,lm} {}_2Y_{lm}.
"""

from __future__ import annotations

import functools
import importlib.util
import logging
import os

import numpy as np
import torch

from .. import tracing
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
    "map2alm_host",
    "alm2map_host",
    "map2alm_async",
]

# the reference's padding unit of the order axis: a device mesh's blocks of
# orders are whole multiples of it (:func:`_mmax_pad`)
DEFAULT_M_CHUNK = 128


def resolve_lmax(nside, lmax=None):
    """Default band limit, 3 * nside // 2."""
    return 3 * nside // 2 if lmax is None else int(lmax)


def alm_size(lmax, mmax=None):
    """Packed alm length: sum over m = 0..mmax of (lmax - m + 1)."""
    mmax = lmax if mmax is None else mmax
    return (mmax + 1) * (lmax + 1) - mmax * (mmax + 1) // 2


@functools.lru_cache(maxsize=8)
def _pack_index(lmax, mmax, device):
    """(l_idx, m_idx) int64 tensors giving rect coords of each packed entry.

    Built on the host once per (lmax, mmax, device), as the reference
    builds it, and kept on ``device``: every caller shares the two
    tensors, so none may write to them.
    """
    tracing.built("sht.pack_index")
    m = np.arange(mmax + 1, dtype=np.int64)
    counts = lmax + 1 - m
    ms = np.repeat(m, counts)
    # order m's run starts at (l, m) = (m, m)
    start = np.cumsum(counts) - counts
    ls = np.arange(ms.size, dtype=np.int64) - start[ms] + ms
    return (ringfft._upload("sht.pack_index", ls, device),
            ringfft._upload("sht.pack_index", ms, device))


@functools.lru_cache(maxsize=8)
def _flat_pack_index(lmax, mmax, device):
    """The packed entries' flat index into (lmax+1, mmax+1), kept as
    :func:`_pack_index` keeps its tensors (shared: read only)."""
    tracing.built("sht.flat_pack_index")
    ls, ms = _pack_index(lmax, mmax, device)
    return ls * (mmax + 1) + ms


@tracing.spanned("sht.pack_alm")
def pack_alm(alm_rect, lmax=None, mmax=None):
    """Rectangular (..., lmax+1, mmax+1) -> healpy-packed (..., nlm)."""
    lmax = alm_rect.shape[-2] - 1 if lmax is None else int(lmax)
    mmax = alm_rect.shape[-1] - 1 if mmax is None else int(mmax)
    flat = alm_rect.reshape(alm_rect.shape[:-2] + (-1,))
    return flat[..., _flat_pack_index(lmax, mmax, alm_rect.device)]


@tracing.spanned("sht.unpack_alm")
def unpack_alm(alm_packed, lmax, mmax=None):
    """healpy-packed (..., nlm) -> rectangular (..., lmax+1, mmax+1)."""
    mmax = lmax if mmax is None else int(mmax)
    out = alm_packed.new_zeros(alm_packed.shape[:-1] + ((lmax + 1) * (mmax + 1),))
    out[..., _flat_pack_index(lmax, mmax, alm_packed.device)] = alm_packed
    return out.reshape(alm_packed.shape[:-1] + (lmax + 1, mmax + 1))


def _mmax_pad(mmax, m_chunk):
    """Orders 0..mmax padded up to whole chunks of ``m_chunk``."""
    return ((mmax + 1 + m_chunk - 1) // m_chunk) * m_chunk


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
    tracing.built("sht.ring_weights")
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


def _weights_on(nside, weights, device):
    """The per-ring weights of a transform on ``device``: None (the pixel
    area), "ring" (the quadrature weights) or an array of them.  The two
    named kinds are kept by (nside, kind, device), on a card as float64
    tensors there; an array is a float64 host array, which the ring
    analysis uploads in its call."""
    if weights is None or (isinstance(weights, str) and weights == "ring"):
        return _named_weights(int(nside), weights, torch.device(device))
    return np.asarray(weights, dtype=np.float64)


@functools.lru_cache(maxsize=8)
def _named_weights(nside, kind, device):
    if kind is None:
        w = np.full(4 * nside - 1, nside2pixarea(nside))
    else:
        w = ring_weights(nside)
    if not tracing.on_card(device):
        return w
    tracing.built("sht.weights")
    return ringfft._upload("sht.weights", w, device, torch.float64)


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


@functools.lru_cache(maxsize=8)
def _geometry(nside, device):
    """Northern-ring x (float64), log cos(theta/2), log sin(theta/2), built
    once per (nside, device) and kept on ``device`` (shared: read only)."""
    nhalf = 2 * nside
    tracing.built("sht.geometry")
    return tuple(ringfft._upload("sht.geometry", a[:nhalf], device)
                 for a in _geom_arrays(nside))


@functools.lru_cache(maxsize=32)
def _x_lo_array(nside):
    """float32 residual of the float64 northern-ring cos(theta): the comp
    recurrence's correction (the reference's ``_x_lo_array``)."""
    x64 = _geom_arrays(nside)[0][: 2 * nside]
    return (x64 - x64.astype(np.float32).astype(np.float64)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _x_lo(nside, dd, device):
    """``x_lo`` for the kernels: the residual where ``dd`` is "comp", kept
    on ``device`` as :func:`_geometry` is."""
    if dd != "comp":
        return None
    tracing.built("sht.x_lo")
    return ringfft._upload("sht.x_lo", _x_lo_array(nside), device)


def _dd_mode(dd):
    """The reference's reading of ``dd``: "comp", or else True / False
    (None is False: no environment switch)."""
    return "comp" if isinstance(dd, str) and dd == "comp" else bool(dd)


@functools.lru_cache(maxsize=8)
def _fold_sign(nm, m0, dtype, device):
    """(-1)^m of the orders m0..m0+nm-1 in ``dtype``, built once per
    (nm, m0, dtype, device) on ``device`` (shared: read only)."""
    tracing.built("sht.fold_sign")
    msign = torch.ones(nm, dtype=dtype, device=device)
    msign[(m0 + 1) % 2::2] = -1.0
    return msign


def _folded_inputs(Fw, ns, m0=0):
    """The folded kernel inputs for full-ring spectra ``Fw`` of columns ``ns``.

    N/S mirror symmetry pairs column +n with column -n: each branch's
    even/odd inputs combine its own northern rows with its partner
    branch's southern rows, which carry a (-1)^m per-order sign (column c
    is the order ``m0`` + c).  Returns (Fe, Fo) for one spin-0 column,
    (FNp, Sp, FNm, Sm) for a +-s pair.
    """
    nside = (Fw[0].shape[-2] + 1) // 4
    msign = _fold_sign(Fw[0].shape[-1], m0, Fw[0].real.dtype, Fw[0].device)
    folded = [_fold_rings(f, nside) for f in Fw]
    if len(ns) == 1:
        FN, FS = folded[0]
        FS = FS * msign
        return FN + FS, FN - FS
    (FNp, FSp), (FNm, FSm) = folded
    return FNp, FSp * msign, FNm, FSm * msign


def _analysis_rect(Fw, lmax, ns, dd=False, m0=0):
    """Folded Wigner analysis of full-ring spectra; tuple of rect alms.

    Column c of ``Fw`` and of the alms is the order ``m0`` + c.  ``dd``
    goes to the kernels (:mod:`.sht_kernels`): on complex64 spectra True
    runs the recurrence and the ring sums in float64 and "comp" the
    compensated float32 kernel; the alms come back as complex64.
    """
    nside = (Fw[0].shape[-2] + 1) // 4
    dev = Fw[0].device
    with tracing.span("sht.fold"):
        x, logch, logsh = _geometry(nside, dev)
        args = _folded_inputs(Fw, ns, m0)
        kw = dict(dd=dd, x_lo=_x_lo(nside, dd, dev))
    if len(ns) == 1:
        return (sht_kernels.analysis_spin0_folded(*args, x, logch, logsh,
                                                  lmax, m0, **kw),)
    return sht_kernels.analysis_pair_folded(*args, x, logch, logsh, lmax,
                                            abs(int(ns[0])), m0, **kw)


def _point_geometry(theta):
    """(x, log cos(theta/2), log sin(theta/2)) of point colatitudes.

    Host float64, the logs clamped at -1e4 at the poles (where orders
    m > 0 then underflow to exactly zero).  The kernels read the logs in
    float64, since the seed's exponent multiplies them by m.
    """
    th = np.asarray(theta, dtype=np.float64)
    with np.errstate(divide="ignore"):
        logch = np.maximum(np.log(np.abs(np.cos(th / 2))), -1e4)
        logsh = np.maximum(np.log(np.abs(np.sin(th / 2))), -1e4)
    return np.cos(th), logch, logsh


def _analysis_points(Fw, x, logch, logsh, lmax, ns):
    """Unfolded analysis over arbitrary points, through the folded kernels.

    The points take the place of rings and have no mirror partners: the
    spin-0 kernel with Fe = Fo contracts F at every l, and the pair kernel
    with zero southern rows gives the two independent +-s columns.
    ``Fw``: one (..., npts, lmax+1) spectrum per spin column in ``ns``;
    ``x``, ``logch``, ``logsh``: (npts,) float64 tensors.  Returns packed
    alms: (..., nlm) for spin 0, (..., 2, nlm) (E, B) for a spin pair.
    """
    if len(ns) == 1:
        alm = sht_kernels.analysis_spin0_folded(Fw[0], Fw[0], x, logch, logsh,
                                                lmax)
    else:
        zero = torch.zeros_like(Fw[0])
        alm = _eb(*sht_kernels.analysis_pair_folded(
            Fw[0], zero, Fw[1], zero, x, logch, logsh, lmax, abs(int(ns[0]))))
    return pack_alm(alm, lmax, lmax)


def _eb(a_p, a_m):
    """(E, B) on axis -3 from the +s and -s analysis columns."""
    return torch.stack([-(a_p + a_m) / 2, 1j * (a_p - a_m) / 2], dim=-3)


def _unfold_rings(GN, GS):
    """Full-ring spectra from the folded synthesis' (GN, GS).

    The northern rows come as they are; the southern rows are the flipped
    GS without its equator row (the equator is its own mirror).
    """
    return torch.cat([GN, torch.flip(GS[..., :-1, :], dims=(-2,))], dim=-2)


def _synthesis_rect(alms, lmax, ns, nside, dd=False, m0=0):
    """Folded Wigner synthesis of rect alms; tuple of full-ring spectra.

    ``alms``: one (..., lmax+1, nm) array per spin column n in ``ns``,
    column c being the order ``m0`` + c; returns one (..., nrings, nm)
    array each.  ``dd`` as for :func:`_analysis_rect`: complex64 alms give
    complex64 ring spectra in every mode.
    """
    dev = alms[0].device
    with tracing.span("sht.fold"):
        x, logch, logsh = _geometry(nside, dev)
        kw = dict(dd=dd, x_lo=_x_lo(nside, dd, dev))
    if len(ns) == 1:
        folded = [sht_kernels.synthesis_spin0_folded(alms[0], x, logch, logsh,
                                                     lmax, m0, **kw)]
    else:
        GNp, GSp, GNm, GSm = sht_kernels.synthesis_pair_folded(
            alms[0], alms[1], x, logch, logsh, lmax, abs(int(ns[0])), m0,
            **kw)
        folded = [(GNp, GSp), (GNm, GSm)]
    with tracing.span("sht.fold"):
        return tuple(_unfold_rings(GN, GS) for GN, GS in folded)


@tracing.spanned("sht.map2alm")
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
    come back as complex64; ``"comp"`` runs the compensated float32
    kernels (the float32 recurrence plus a stream that corrects the
    float32 truncation of cos(theta)); None and False run the plain
    float32 kernels.  It is ignored for float64 maps.  (The reference's
    ``HERACLES_TPU_SHT_DD`` environment switch is not carried over.)
    Returns packed alms (..., nlm) for spin 0, or (..., 2, nlm) (E, B) for
    spin 2 (``packed=False``: rectangular (..., lmax+1, mmax+1)).
    """
    spin = abs(int(spin))
    nside = npix2nside(maps.shape[-1])
    lmax = resolve_lmax(nside, lmax)
    mmax = lmax if mmax is None else int(mmax)
    dd = _dd_mode(dd)
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
    return _map2alm_block(maps, nside, lmax, 0, mmax + 1, spin,
                          _weights_on(nside, weights, maps.device), dd)


def _map2alm_block(maps, nside, lmax, m0, nm, spin, w, dd=False):
    """One analysis pass of the orders m0..m0+nm-1 (per-ring weights
    ``w``): rectangular (..., lmax+1, nm) alms, E, B stacked for spin 2;
    orders above lmax are zeros."""
    if spin == 0:
        F, _ = ringfft.ring_analysis(maps, nside, nm, weight=w, m0=m0)
        (out,) = _analysis_rect((F,), lmax, (0,), dd, m0)
        return out
    u = torch.complex(maps[..., 0, :], maps[..., 1, :])
    F, Fneg = ringfft.ring_analysis(u, nside, nm, weight=w, m0=m0)
    # a_{+s,lm} = sum_r w slm(l,m,+s) F_m(r): column +s;
    # a_{-s,lm} = sum_r w slm(l,m,-s) conj(F_{-m}(r)): column -s
    return _eb(*_analysis_rect((F, Fneg.conj()), lmax, (spin, -spin), dd,
                               m0))


@tracing.spanned("sht.alm2map")
def alm2map(alm, nside, lmax=None, mmax=None, *, spin=0, packed=True,
            dd=None):
    """Spin-0/2 spherical harmonic synthesis onto HEALPix RING maps.

    ``alm``: packed (..., nlm) complex for spin 0, (..., 2, nlm) (E, B)
    for spin 2; rectangular (..., lmax+1, mmax+1) with ``packed=False``.
    Runs on the alms' device and in their precision (complex64 -> float32
    maps, complex128 -> float64).  ``dd``: as for :func:`map2alm` (True
    the recurrence of a complex64 synthesis in float64, "comp" the
    compensated float32 kernels, float32 maps returned); ignored for
    complex128 alms.  Returns (..., npix) or
    (..., 2, npix) [Q, U].
    """
    dd = _dd_mode(dd)
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
    return _ring_maps(_synthesis_block(alm, nside, lmax, spin, dd), nside,
                      spin)


def _synthesis_block(alm, nside, lmax, spin, dd=False, m0=0):
    """Full-ring spectra of rectangular alms whose column c is the order
    ``m0`` + c: (G,) at spin 0, (G+, G-) for a spin pair ((E, B) on axis
    -3 of ``alm``)."""
    if spin == 0:
        return _synthesis_rect((alm,), lmax, (0,), nside, dd, m0)
    alm_e = alm[..., 0, :, :]
    alm_b = alm[..., 1, :, :]
    a_p = -(alm_e + 1j * alm_b)  # a_{+spin}
    a_m = -(alm_e - 1j * alm_b)  # a_{-spin}
    # u = sum_{m>=0} G+_m e^{im phi} + sum_{m>0} G-_m e^{-im phi} with
    # G+_m = sum_l a_{+s,lm} slm(l,m,+s) and
    # G-_m = sum_l conj(a_{-s,lm}) slm(l,m,-s) (reality relations)
    return _synthesis_rect((a_p, a_m.conj()), lmax, (spin, -spin), nside, dd,
                           m0)


def _ring_maps(Gs, nside, spin):
    """Maps from the full-ring spectra of :func:`_synthesis_block` (every
    order from 0): (..., npix), or (..., 2, npix) [Q, U] for a pair."""
    if spin == 0:
        return ringfft.ring_synthesis(Gs[0], None, nside)
    u = ringfft.ring_synthesis(Gs[0], Gs[1], nside, real_output=False)
    return torch.stack([u.real, u.imag], dim=-2)


def _host_copy_async(arr):
    """Start the copy of the tensor ``arr`` to the host; returns a
    zero-argument callable that gives it as a numpy array.

    On a card the copy runs on a side stream, into pinned host memory,
    after an event of the current stream, so the caller may queue more work
    before it calls the handle, which waits for the copy alone.  ``arr`` is
    recorded on the side stream, so the caching allocator does not hand
    its memory out before the copy is done.  A CPU tensor is copied when
    the handle is called.
    """
    if arr.device.type != "cuda":
        return lambda: arr.detach().numpy().copy()
    tracing.copied("sht.host_copy", "d2h", arr)
    computed = torch.cuda.Event()
    computed.record(torch.cuda.current_stream(arr.device))
    side = _copy_stream(arr.device)
    side.wait_event(computed)
    host = torch.empty(arr.shape, dtype=arr.dtype, pin_memory=True)
    with torch.cuda.stream(side):
        host.copy_(arr, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(side)
    arr.record_stream(side)

    def finish():
        tracing.synced("sht.host_copy", arr)
        copied.synchronize()
        return host.numpy()

    return finish


@functools.cache
def _copy_stream(device):
    """The side stream of a card on which results are copied to the host."""
    return torch.cuda.Stream(device)


def _on_device(a, device):
    """A tensor stays where it is; numpy input goes to ``device``."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    tracing.copied("sht.on_device", "h2d", device)
    tracing.synced("sht.on_device", device)
    return torch.as_tensor(np.ascontiguousarray(a, np.dtype(a.dtype.str)),
                           device=device)


def map2alm_async(maps, lmax=None, *, device="cuda", **kw):
    """Queue :func:`map2alm` and start the copy of its alms to the host.

    ``maps``: a tensor (analysed where it lies) or a numpy array (moved to
    ``device``, by default the card); ``kw`` go to :func:`map2alm`.
    Returns a zero-argument callable that gives the alms as a numpy array
    (the result of :func:`map2alm_host`); on a card the caller can queue
    the next transform before it calls the handle.
    """
    return _host_copy_async(map2alm(_on_device(maps, device), lmax, **kw))


def map2alm_host(maps, lmax=None, *, device="cuda", **kw):
    """:func:`map2alm` for host callers: numpy (or tensor) maps in, numpy
    alms out; numpy maps are analysed on ``device``."""
    return map2alm_async(maps, lmax, device=device, **kw)()


def alm2map_host(alm, nside, lmax=None, *, device="cuda", **kw):
    """:func:`alm2map` for host callers: numpy (or tensor) alms in, numpy
    maps out; numpy alms are synthesised on ``device``."""
    out = alm2map(_on_device(alm, device), nside, lmax, **kw)
    return tracing.to_host("sht.alm2map_host", out)


def pixel_window(nside, lmax, *, pol=False, method="auto", device="cuda"):
    """HEALPix pixel window w(l), l = 0..lmax (numpy, float64).

    With ``pol=True`` returns (2, lmax+1) [temperature, polarization].
    ``method``: ``"exact"`` integrates the (spin-weighted) harmonics over
    the true pixel shapes (:func:`.pixwin.pixel_window_exact`: a shipped
    or cached table, else computed in float64 on ``device``, by default
    the CUDA card, and cached); ``"cap"`` is the equal-area
    spherical-cap closed form; ``"auto"`` is exact where a table is
    shipped or cached or nside <= 32, and the cap form otherwise.
    """
    from . import pixwin

    nside, lmax = int(nside), int(lmax)
    if method not in ("auto", "exact", "cap"):
        raise ValueError(f"unknown pixel window method: {method!r}")
    if method == "auto":
        exact = nside <= 32 or pixwin.find_cached(nside, lmax, pol) is not None
        method = "exact" if exact else "cap"
    return _pixel_window(nside, lmax, bool(pol), method, torch.device(device))


@functools.lru_cache(maxsize=32)
def _pixel_window(nside, lmax, pol, method, device):
    from . import pixwin

    if method == "exact":
        return pixwin.pixel_window_exact(nside, lmax, pol=pol, device=device)
    w = pixwin.cap_window(nside, lmax)
    if pol:
        w = np.stack([w, w])
        w[1, : min(2, lmax + 1)] = 0.0
    return w
