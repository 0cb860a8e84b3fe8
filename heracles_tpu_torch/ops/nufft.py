"""Gridded (type-1 NUFFT) adjoint spherical-harmonic synthesis, on torch.

Counterpart of :mod:`heracles_tpu.ops.nufft`.  The exact pixel-free
adjoint costs O(N lmax^2) per point block; this path spreads the points
onto a (theta, phi) torus grid with an exponential-of-semicircle (ES)
kernel, deconvolves the kernel in Fourier space, and runs the analysis on
a coarse exact grid of lmax + 1 rings:

1. **spread** (:func:`spread_padded`): each point scatters onto a w x w
   stencil of the 2x oversampled torus with separable ES weights, into a
   wrap-padded float64 grid on the device (complex128 for spin values);
   :func:`fold_padded` folds the margins back onto the torus.  A CUDA
   grid launches the hand-written kernel
   (``heracles_tpu_torch/csrc/spread.cu``, built at first use by
   :mod:`._build`): the points are binned by 32 x 32 grid tile, sorted
   by bin, and each tile is summed in shared memory before one pass of
   global atomics (:func:`bin_points_plain` and :func:`subproblems_plain`
   are the plain versions of its binning).  A CPU grid takes
   :func:`spread_padded_plain` (``index_add_`` over the stencil),
   anything else raises;
2. **reduce** (:func:`_reduce_grid`): phi and theta FFTs, division by the
   kernel's transform, the coarse inverse FFT and the fold of the
   southern torus half with the extension sign (-1)^(m+s), all torch.fft
   glue in float64 on the grid's device; then the coarse rings go through
   the analysis kernels (:func:`heracles_tpu_torch.ops.sht._analysis_points`)
   in the requested precision.

The result equals sum_p v_p conj(sYlm(p)) to ~epsilon ||v||.  The JAX
package's host spreader (a g++ build loaded with ctypes), its numpy
fallback and its environment switch are not carried over: the spreader is
this module's kernel, on the grid's device.

``LAUNCHES`` counts spreader launches (one per call, whatever stages of
the kernel it runs) and ``PLAIN_RUNS`` runs of its plain version, both
under the name ``"spread"``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tracing
from . import sht

__all__ = [
    "adjoint_gridded",
    "alloc_padded",
    "bin_points",
    "bin_points_plain",
    "fold_padded",
    "grid_shape",
    "kernel_width",
    "spread_padded",
    "spread_padded_plain",
    "spread_torus",
    "subproblems_plain",
    "LAUNCHES",
    "PLAIN_RUNS",
    "reset_counts",
]

SIGMA = 2.0  # oversampling factor of the spread grid
_PLAIN_CHUNK = 1 << 16  # points per block of the plain spreader
# the kernel's bins: grid cells on a side of a tile, and the most points
# of one subproblem (csrc/spread.cu kTile, kMaxSub)
TILE = 32
MAX_SUB = 1024
# the kernel's stages (a mask): bin + scan, order, spread + flush
STAGE_BIN, STAGE_ORDER, STAGE_SPREAD = 1, 2, 4
STAGES_ALL = STAGE_BIN | STAGE_ORDER | STAGE_SPREAD

LAUNCHES = tracing.counter("nufft.LAUNCHES")
PLAIN_RUNS = tracing.counter("nufft.PLAIN_RUNS")


def reset_counts():
    """Zero every counter of :mod:`..tracing`, this module's among them."""
    tracing.reset()


def kernel_width(epsilon):
    """ES kernel width (stencil size) for aliasing error ``epsilon``.

    At 2x oversampling the ES kernel reaches ~10^-(w-1); clamped to 4..16
    (w = 16 ~ 1e-15, beyond float64).
    """
    w = int(np.ceil(np.log10(1.0 / float(epsilon)))) + 1
    return max(4, min(w, 16))


def _es_beta(w):
    # FINUFFT's calibrated ES shape parameter at sigma = 2
    return float(np.pi * w * (1.0 - 1.0 / (2.0 * SIGMA)) * 0.976)


def _es_kernel(z, beta):
    """exp(beta (sqrt(1 - z^2) - 1)) on |z| <= 1, 0 outside (numpy)."""
    inside = np.abs(z) <= 1.0
    t = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.where(inside, np.exp(beta * (t - 1.0)), 0.0)


def _kernel_ft(w, h, beta, ks):
    """kappahat(k) = int kappa(x / (w h / 2)) cos(k x) dx over the support."""
    half = 0.5 * w * h
    zq, wq = np.polynomial.legendre.leggauss(96)
    xq = zq * half
    kv = _es_kernel(zq, beta) * (half * wq)
    return np.cos(np.outer(np.asarray(ks, np.float64), xq)) @ kv


def _good_size(n):
    """Next FFT-friendly size >= n: 2^a times 1, 3 or 5."""
    best = 1 << (int(n - 1)).bit_length()
    for mult in (3, 5):
        p = 1
        while p * mult < n:
            p <<= 1
        best = min(best, p * mult)
    return best


def grid_shape(lmax):
    """(ntheta, nphi) of the oversampled torus spread grid."""
    n = _good_size(int(np.ceil(2 * SIGMA * (lmax + 1))))
    return n, n


def alloc_padded(nrows, lmax, w, complex_vals, device="cuda"):
    """A zero wrap-padded spreading grid (nrows, ntheta + w, nphi + w).

    float64, or complex128 for complex values, on ``device``.  The paged
    mapping path keeps one for a whole catalogue and folds it once.
    """
    ntheta, nphi = grid_shape(lmax)
    dtype = torch.complex128 if complex_vals else torch.float64
    return torch.zeros((nrows, ntheta + w, nphi + w), dtype=dtype,
                       device=device)


def fold_padded(pad, lmax, w):
    """Fold the torus wrap margins of ``pad``; returns the (nrows, ntheta,
    nphi) grid (``pad`` is updated in place and should not be reused)."""
    ntheta, nphi = grid_shape(lmax)
    pad[:, :w] += pad[:, ntheta:]
    pad = pad[:, :ntheta]
    pad[:, :, :w] += pad[:, :, nphi:]
    return pad[:, :, :nphi].contiguous()


def _tensor(a, dtype, device):
    """``a`` as a tensor of ``dtype`` on ``device`` (numpy input is copied:
    catalogue pages may be read-only)."""
    if isinstance(a, torch.Tensor):
        if not a.is_cuda:
            tracing.copied("nufft.inputs", "h2d", device)
            tracing.synced("nufft.inputs", device)
        return a.to(device=device, dtype=dtype)
    tracing.copied("nufft.inputs", "h2d", device)
    tracing.synced("nufft.inputs", device)
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def _spread_inputs(theta, phi, values, pad):
    """Angles (npts,) float64 and values (nrows, npts) of the pad's kind,
    on the pad's device."""
    dev = pad.device
    theta = _tensor(theta, torch.float64, dev).reshape(-1)
    phi = _tensor(phi, torch.float64, dev).reshape(-1)
    values = _tensor(values, pad.dtype, dev)
    # a page without points has a row count only from the grid
    npts = theta.shape[0]
    values = values.reshape((-1, npts) if npts else (pad.shape[0], 0))
    return theta, phi, values


def _check(theta, phi, values, pad, w):
    if pad.dtype not in (torch.float64, torch.complex128):
        raise TypeError(f"spread: the grid must be float64 or complex128, got "
                        f"{pad.dtype}")
    if pad.dim() != 3 or values.shape[0] != pad.shape[0]:
        raise ValueError(f"spread: grid {tuple(pad.shape)} and values "
                         f"{tuple(values.shape)} differ in rows")
    if phi.shape != theta.shape:
        raise ValueError("spread: theta and phi differ in length")
    if not 4 <= w <= 16:
        raise ValueError(f"spread: kernel width {w} outside 4..16")
    if pad.device.type not in ("cpu", "cuda"):
        raise ValueError(f"spread: unsupported device {pad.device}")


def _first_cell(u, half_w, n):
    """The stencil's first cell wrapped into [0, n), and u shifted with it."""
    j = torch.ceil(u - half_w)
    jw = torch.remainder(j, n)
    return jw.to(torch.int64), u + (jw - j)


def _stencil(theta, phi, w, ntheta, nphi):
    """Flat indices into the padded grid and ES weights of the w x w
    stencil of each point: two (npts, w, w) tensors (int64, float64)."""
    beta = _es_beta(w)
    half_w = 0.5 * w
    offs = torch.arange(w, device=theta.device)
    jt, ut = _first_cell(theta * (ntheta / (2 * np.pi)) - 0.5, half_w, ntheta)
    jp, up = _first_cell(phi * (nphi / (2 * np.pi)), half_w, nphi)

    def weights(j, u):
        z = ((j[:, None] + offs).to(torch.float64) - u[:, None]) / half_w
        t = 1.0 - z * z
        return torch.where(t > 0.0, torch.exp(
            beta * (torch.sqrt(torch.clamp(t, min=0.0)) - 1.0)), 0.0)

    coef = weights(jt, ut)[:, :, None] * weights(jp, up)[:, None, :]
    idx = ((jt[:, None, None] + offs[None, :, None]) * (nphi + w)
           + jp[:, None, None] + offs[None, None, :])
    return idx, coef


def spread_padded_plain(theta, phi, values, pad, w):
    """Plain version of the spreading kernel (same arguments as its launch).

    ``theta``, ``phi``: (npts,) float64; ``values``: (nrows, npts) of the
    kind of ``pad``, the (nrows, ntheta + w, nphi + w) wrap-padded grid,
    which is accumulated into with ``index_add_`` over the w x w stencil.
    """
    PLAIN_RUNS["spread"] += 1
    nrows, gt, gp = pad.shape
    flat = pad.view(nrows, -1)
    for start in range(0, theta.shape[0], _PLAIN_CHUNK):
        sl = slice(start, start + _PLAIN_CHUNK)
        idx, coef = _stencil(theta[sl], phi[sl], w, gt - w, gp - w)
        for r in range(nrows):
            contrib = values[r, sl, None, None] * coef
            flat[r].index_add_(0, idx.reshape(-1), contrib.reshape(-1))
    return pad


def _nbins(ntheta, nphi, tile=TILE):
    """(bins along theta, bins along phi) of the unpadded torus."""
    return -(-ntheta // tile), -(-nphi // tile)


def bin_points_plain(theta, phi, lmax, w, tile=TILE):
    """Plain version of the kernel's binning (stages A and B's offsets).

    Each point's bin is the ``tile`` x ``tile`` tile of the unpadded torus
    that holds its stencil's first cell.  Returns (bins (npts,) int64,
    counts (nbins,) int64, offsets (nbins,) int64, the exclusive scan of
    the counts), on the angles' device.
    """
    ntheta, nphi = grid_shape(lmax)
    half_w = 0.5 * w
    jt, _ = _first_cell(theta * (ntheta / (2 * np.pi)) - 0.5, half_w, ntheta)
    jp, _ = _first_cell(phi * (nphi / (2 * np.pi)), half_w, nphi)
    nbt, nbp = _nbins(ntheta, nphi, tile)
    bins = (jt // tile) * nbp + jp // tile
    counts = torch.bincount(bins, minlength=nbt * nbp)
    return bins, counts, torch.cumsum(counts, 0) - counts


def subproblems_plain(counts, max_sub=MAX_SUB):
    """Plain version of the kernel's subproblems (stage B's prefix and
    map).

    A bin of n points is ceil(n / ``max_sub``) subproblems.  Returns (subs
    (nbins + 1,), the exclusive prefix of the subproblems with the total
    last; bin and chunk (total,) of each subproblem, by binary search in
    ``subs``: the kernel's block i takes subproblem i).
    """
    nsub = (counts + max_sub - 1) // max_sub
    subs = torch.cat([torch.zeros(1, dtype=nsub.dtype, device=nsub.device),
                      torch.cumsum(nsub, 0)])
    blocks = torch.arange(int(subs[-1]), device=subs.device)
    # the last bin b with subs[b] <= block: it has a subproblem there
    bins = torch.searchsorted(subs, blocks, right=True) - 1
    return subs, bins, blocks - subs[bins]


def _record_stride(nvals):
    """float64 of one point's record: ut, up, the corner, its values,
    padded to whole 32-byte sectors (csrc/spread.cu)."""
    return 4 * ((3 + nvals + 3) // 4)


def _scratch(npts, nrows, ncomp, ntheta, nphi, device):
    """The kernel's scratch, by name (see csrc/spread.cu)."""
    nbins = int(np.prod(_nbins(ntheta, nphi)))
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "key": torch.empty((npts, 2), **i32),
        "counts": torch.empty(nbins, **i32),
        "offsets": torch.empty(nbins + 1, **i32),
        "subs": torch.empty(nbins + 1, **i32),
        "sub_bin": torch.empty(-(-npts // MAX_SUB) + nbins, **i32),
        "emax": torch.empty((nbins, nrows), **i32),
        "records": torch.empty((npts, _record_stride(nrows * ncomp)),
                               dtype=torch.float64, device=device),
        "order": torch.empty(npts, **i32),
    }


def _launch(theta, phi, values, pad, w, stages=STAGES_ALL, scratch=None):
    """Run the kernel's ``stages`` on CUDA tensors; returns the scratch.

    ``scratch`` from an earlier call carries the binning to a later stage
    (the stages can be timed apart); by default it is allocated here.
    """
    from . import _build

    kl = _build.load_library()
    nrows, gt, gp = pad.shape
    if not pad.is_contiguous():
        raise ValueError("spread: the grid must be contiguous")
    if theta.shape[0] >= 2**31 or nrows > 65535:
        raise ValueError(f"spread: {theta.shape[0]} points of {nrows} rows "
                         f"exceed the kernel's int32 offsets or its grid")
    vals = torch.view_as_real(values) if values.is_complex() else values
    vals = vals.contiguous()
    grid = torch.view_as_real(pad) if pad.is_complex() else pad
    ncomp = 2 if pad.is_complex() else 1
    theta, phi = theta.contiguous(), phi.contiguous()
    npts, ntheta, nphi = theta.shape[0], gt - w, gp - w
    if scratch is None:
        scratch = _scratch(npts, nrows, ncomp, ntheta, nphi, pad.device)
    with torch.cuda.device(pad.device):
        stream = torch.cuda.current_stream(pad.device).cuda_stream
        err = kl.lib.heracles_spread_es(
            theta.data_ptr(), phi.data_ptr(), vals.data_ptr(), grid.data_ptr(),
            npts, nrows, ncomp, ntheta, nphi, w, _es_beta(w),
            *(scratch[k].data_ptr() for k in ("key", "counts", "offsets",
                                              "subs", "sub_bin", "emax",
                                              "records", "order")),
            TILE, MAX_SUB, scratch["records"].shape[1], stages, stream)
    kl.check(err)
    LAUNCHES["spread"] += 1
    return scratch


def bin_points(theta, phi, lmax, w):
    """The kernel's binning of CUDA points (its stages A to C only).

    Returns (counts (nbins,), offsets (nbins + 1,), subs (nbins + 1,),
    sub_bin (subproblems,), order (npts,)), int32 tensors on the card:
    ``offsets`` and ``subs`` are the exclusive prefixes of the counts and
    of the subproblems, with the totals last; ``sub_bin`` is each
    subproblem's bin, ``order`` the points' original indices in bin order.
    """
    ntheta, nphi = grid_shape(lmax)
    # the grid's shape only: stages A to C do not touch it
    pad = torch.empty((1, ntheta + w, nphi + w), dtype=torch.float64,
                      device=theta.device)
    theta = _tensor(theta, torch.float64, pad.device).reshape(-1)
    phi = _tensor(phi, torch.float64, pad.device).reshape(-1)
    values = torch.zeros((1, theta.shape[0]), dtype=torch.float64,
                         device=pad.device)
    _check(theta, phi, values, pad, w)
    if pad.device.type != "cuda":
        raise ValueError("bin_points runs the kernel: the points must be on "
                         "the card (bin_points_plain is the plain version)")
    s = _launch(theta, phi, values, pad, w, STAGE_BIN | STAGE_ORDER)
    return (s["counts"], s["offsets"], s["subs"],
            s["sub_bin"][:int(s["subs"][-1])], s["order"])


def spread_padded(theta, phi, values, lmax, w, pad):
    """Spread one page of points into the wrap-padded grid ``pad`` (no fold).

    ``theta``, ``phi``: (npts,) radians; ``values``: (nrows, npts) real,
    or complex for a complex128 grid (numpy or tensors, moved to the
    grid's device).  ``pad`` from :func:`alloc_padded` for this ``lmax``
    and width ``w``; a CUDA grid launches the kernel, a CPU grid runs the
    plain version.  Returns ``pad``.
    """
    ntheta, nphi = grid_shape(lmax)
    if tuple(pad.shape[1:]) != (ntheta + w, nphi + w):
        raise ValueError(f"spread: grid {tuple(pad.shape)} is not the padded "
                         f"grid of lmax {lmax} and width {w}")
    theta, phi, values = _spread_inputs(theta, phi, values, pad)
    _check(theta, phi, values, pad, w)
    if pad.device.type == "cpu":
        return spread_padded_plain(theta, phi, values, pad, w)
    _launch(theta, phi, values, pad, w)
    return pad


def spread_torus(theta, phi, values, lmax, w, grid=None, *, device="cuda"):
    """Spread weighted points onto the (ntheta, nphi) torus grid.

    ``values``: (nrows, npts) real or complex.  Returns a (nrows, ntheta,
    nphi) float64 or complex128 tensor on ``device``; given ``grid``, a
    tensor of that shape, adds into it in place (on its device) and
    returns it, as the reference accumulates into its ``grid``.
    """
    values = torch.as_tensor(values)
    nrows = values.reshape(-1, np.shape(theta)[-1]).shape[0]
    if grid is not None:
        device = grid.device
    pad = alloc_padded(nrows, lmax, w, values.is_complex(), device)
    spread_padded(theta, phi, values, lmax, w, pad)
    out = fold_padded(pad, lmax, w)
    if grid is None:
        return out
    if tuple(grid.shape) != tuple(out.shape):
        raise ValueError(f"spread_torus: grid {tuple(grid.shape)} is not the "
                         f"torus grid {tuple(out.shape)} of lmax {lmax}")
    return grid.add_(out)


@functools.lru_cache(maxsize=8)
def _coarse_geometry(lmax):
    """Host float64 geometry of the coarse grid's lmax + 1 northern rings."""
    nc = 2 * (lmax + 1)
    th = (np.arange(nc // 2) + 0.5) * (2.0 * np.pi / nc)
    return sht._point_geometry(th)


@functools.lru_cache(maxsize=8)
def _deconv_factors(lmax, w):
    """Host constants of the reduce: 1/kernel-FT of phi, and of theta with
    the row phases (float64, complex128)."""
    ntheta, nphi = grid_shape(lmax)
    beta = _es_beta(w)
    ms = np.arange(lmax + 1)
    inv_phi = (2.0 * np.pi / nphi) / _kernel_ft(w, 2 * np.pi / nphi, beta, ms)
    ks = np.arange(-lmax, lmax + 1)
    ht = 2.0 * np.pi / ntheta
    # S_k = e^{-ik ht/2} FFT_k (half-offset rows), deconvolved; the coarse
    # inverse transform carries the matching e^{+ik hc/2} row phase
    hc = 2.0 * np.pi / (2 * (lmax + 1))
    dec = (ht / _kernel_ft(w, ht, beta, ks)) * np.exp(1j * ks * (hc - ht) / 2.0)
    return inv_phi, dec


def _reduce_grid(grid, lmax, w, spin, cdtype):
    """Torus grid -> packed alms on the grid's device.

    ``grid``: (nrows, ntheta, nphi) float64 (spin 0) or complex128 (spin
    values u = v1 + i v2).  The FFT glue runs in float64; the coarse
    analysis in ``cdtype`` (complex64 runs the float32 kernels).  Returns
    (nrows, nlm) for spin 0, else (nrows, 2, nlm) stacked (E, B).
    """
    dev = grid.device
    nm = lmax + 1
    nc = 2 * nm
    tracing.built("nufft.deconv_factors")
    inv_phi, dec = (tracing.upload("nufft.reduce_grid", a, dev)
                    for a in _deconv_factors(lmax, w))
    if grid.is_complex():
        full = torch.fft.fft(grid, dim=-1)
        idx = torch.remainder(-torch.arange(nm, device=dev), grid.shape[-1])
        lanes = (full[..., :nm], full[..., idx].conj())
        ns = (spin, -spin)
    else:
        lanes = (torch.fft.rfft(grid, dim=-1)[..., :nm],)
        ns = (0,)
    sgn = torch.ones(nm, dtype=torch.float64, device=dev)
    sgn[1::2] = -1.0
    if spin % 2:
        sgn = -sgn
    outs = []
    for F in lanes:
        # theta FFT over the torus rows; keep |k| <= lmax, deconvolved
        T = torch.fft.fft(F * inv_phi, dim=-2)
        # the coarse synthesis over nc rows: S_k at k = 0..lmax, then the
        # negative k at the end (the 1/nc of ifft is the Dirichlet-identity
        # normalisation of the row sum)
        spec = torch.zeros(T.shape[:-2] + (nc, nm), dtype=T.dtype, device=dev)
        spec[..., : lmax + 1, :] = T[..., : lmax + 1, :] * dec[lmax:, None]
        spec[..., nc - lmax :, :] = T[..., -lmax:, :] * dec[:lmax, None]
        G = torch.fft.ifft(spec, dim=-2)
        # fold the southern torus half: row nc-1-j pairs with row j
        GS = torch.flip(G[..., nc // 2 :, :], dims=(-2,))
        outs.append((G[..., : nc // 2, :] + sgn * GS).to(cdtype))
    tracing.built("nufft.coarse_geometry")
    x, logch, logsh = (tracing.upload("nufft.reduce_grid", a, dev)
                       for a in _coarse_geometry(lmax))
    return sht._analysis_points(tuple(outs), x, logch, logsh, lmax, ns)


def adjoint_gridded(theta, phi, values, lmax, spin=0, epsilon=1e-12,
                    f32=False, grid=None, device="cuda"):
    """a_lm = sum_p v_p conj(sYlm(p)) via kernel spreading, to ~epsilon.

    ``values``: (nrows, npts) real for spin 0; for spin != 0 the (2, npts)
    components (or one complex row u = v1 + i v2).  ``grid``: optionally a
    torus grid spread already (then ``theta``, ``phi`` and ``values`` are
    not read): the paged mapping path spreads page by page and reduces
    once.  Runs on ``device`` (the grid's if given); ``f32`` runs the
    coarse analysis in float32.  Returns packed alms, (nrows, nlm)
    complex for spin 0, (nrows, 2, nlm) (E, B) otherwise, as a tensor on
    that device.
    """
    spin = abs(int(spin))
    w = kernel_width(epsilon)
    if grid is None:
        vals = torch.as_tensor(values)
        if spin and not vals.is_complex():
            vals = torch.complex(vals[0].double(), vals[1].double())[None]
        elif not spin:
            vals = vals.to(torch.float64)
        grid = spread_torus(theta, phi, vals, lmax, w, device=device)
    cdtype = torch.complex64 if f32 else torch.complex128
    return _reduce_grid(grid, lmax, w, spin, cdtype)
