"""Scaled Wigner-d recurrences for the SHT, in plain PyTorch.

Counterpart of :mod:`heracles_tpu.ops.wigner`.  Everything is built on
the normalised spin-weighted functions

    slm(l, m; theta) = (-1)^m sqrt((2l+1)/4pi) d^l_{-m,-s}(theta),

evaluated by the three-term recurrence in l

    d^l = (A1(l) x + A0(l)) d^{l-1} - B(l) d^{l-2},   x = cos(theta),

seeded at j0 = max(|m|, |s|).  Each (ring, lane) carries a mantissa and
an integer exponent k counting factors of 2^60, because the seeds
~ sin^m(theta/2) underflow any float format near the poles long before
the recurrence reaches the region where the function is O(1); only
k = 0 and k = -1 emit.

Here live the host-f64 seed constants (:func:`spin0_seed_planes`,
:func:`pair_seed_planes`) that the Hopper kernels of
:mod:`heracles_tpu_torch.ops.sht_kernels` take, and the plain versions of
those kernels (:func:`analysis_spin0_folded_plain`,
:func:`analysis_pair_folded_plain`, :func:`synthesis_spin0_folded_plain`,
:func:`synthesis_pair_folded_plain`): one Python loop over l on tensors
(:func:`_lambda_rows`), vectorised over rings, lanes and the batch.  The seed is evaluated in
float64 and the recurrence coefficients are computed in float64, then
both are rounded to the working type, exactly as the kernels do.  Given
``x_lo``, the float32 residual of float64 cos(theta), a plain version runs
the kernels' compensated (comp) recurrence: a second stream per lane that
corrects the float32 truncation of x (:func:`comp_ratio`,
``csrc/wigner_recurrence.cuh``), step by step as the kernels' comp
instantiations do.  The four versions take the kernels' group of maps
``nb`` (:data:`GROUP_SIZES`, :func:`check_group`) and check it as the
kernels do; they are vectorised over the batch whatever it is.

The mixing matrices' host-f64 tables (:func:`wigner_table_host`,
:func:`legendre_sum_host`) are numpy, carried over unchanged.
"""

from __future__ import annotations

import collections
import functools
import math

import numpy as np
import torch

__all__ = [
    "wigner_seed_log",
    "wigner_seed_host",
    "spin0_seed_planes",
    "pair_seed_planes",
    "lambda_analysis_scan",
    "lambda_power_scan",
    "lambda_analysis_scan_folded",
    "analysis_spin0_folded_plain",
    "analysis_pair_folded_plain",
    "lambda_synthesis_scan_folded",
    "lambda_synthesis_scan",
    "synthesis_spin0_folded_plain",
    "synthesis_pair_folded_plain",
    "wigner_table",
    "wigner_table_host",
    "legendre_sum_host",
    "comp_ratio",
    "check_group",
    "GROUP_SIZES",
    "PLAIN_RUNS",
    "PLAIN_RUNS_BY_PRECISION",
]

_SCALE_LOG2 = 60
_SCALE = 2.0**_SCALE_LOG2
_INV_SCALE = 2.0**-_SCALE_LOG2
_NO_SEED = -(2**30)

# runs of the plain kernel versions, by kernel name (a run on the card
# shows that the main path did not go through its kernel), and the same
# runs by (name, "f32", "f64" or "f32c"), the last the comp recurrence
PLAIN_RUNS = collections.Counter()
PLAIN_RUNS_BY_PRECISION = collections.Counter()


# the groups of maps that share one recurrence in the kernels' launches:
# the instantiations of csrc/sht_analysis.cu, sht_analysis_pair.cu,
# sht_synthesis.cu and sht_synthesis_pair.cu
GROUP_SIZES = {"analysis_spin0_folded": (1, 2, 4, 8),
               "analysis_pair_folded": (1, 2, 4),
               "synthesis_spin0_folded": (1, 2, 4, 8),
               "synthesis_pair_folded": (1, 2, 4)}


def check_group(name, nb, batch):
    """Raise ValueError unless the kernel ``name`` has an instantiation for
    groups of ``nb`` maps and ``nb`` divides ``batch``; returns ``nb``."""
    sizes = GROUP_SIZES[name]
    if nb not in sizes:
        raise ValueError(f"{name}: nb={nb} has no instantiation (one of "
                         f"{sizes})")
    if batch % nb:
        raise ValueError(f"{name}: nb={nb} does not divide the batch of "
                         f"{batch} maps")
    return nb


def _batch(F):
    return math.prod(F.shape[:-2])


def _count_run(name, dtype, x_lo):
    PLAIN_RUNS[name] += 1
    prec = "f64" if dtype == torch.complex128 else "f32"
    PLAIN_RUNS_BY_PRECISION[name, prec + ("c" if x_lo is not None else "")] += 1


def comp_ratio(x, x_lo, device):
    """r = x_lo / x_hi of each ring, float32 on ``device``: the forcing of
    the comp recurrence's lo stream.

    ``x_hi`` is ``x`` rounded to float32, as the kernels read it; ``x_lo``
    is the float32 residual of float64 cos(theta) (None: zeros, which give
    the plain recurrence's values).  Formed as the reference forms it,
    ``where(x_hi != 0, x_lo / x_hi, 0)`` in float32
    (``heracles_tpu/ops/pallas_sht.py:3150-3160``).
    """
    xf = x.to(device=device, dtype=torch.float32)
    if x_lo is None:
        return torch.zeros_like(xf)
    xl = torch.as_tensor(x_lo).to(device=device, dtype=torch.float32)
    return torch.where(xf != 0, xl / xf, torch.zeros_like(xf))


@functools.lru_cache(maxsize=8)
def _log_factorials(n):
    """log(k!) for k = 0..n-1, host f64."""
    lf = np.zeros(n)
    np.cumsum(np.log(np.arange(1, n)), out=lf[1:])
    return lf


def _seed_consts(ms, ns):
    """(j0, sign, logC) of the seed d^{j0}_{-m,-n} per lane (host f64).

    The single surviving term of the Wigner-d sum at j0 = max(|m|, |n|);
    ``sign`` excludes the (-1)^m of slm.
    """
    ms = np.asarray(ms, dtype=np.int64)
    ns = np.broadcast_to(np.asarray(ns, dtype=np.int64), ms.shape)
    mp, npar = -ms, -ns
    a, b = np.abs(mp), np.abs(npar)
    j0 = np.maximum(a, b)
    c = np.where(a >= b, npar, mp)
    lf = _log_factorials(int(2 * j0.max(initial=0)) + 2)
    logc = 0.5 * (lf[2 * j0] - lf[j0 + c] - lf[j0 - c])
    k0 = np.where(
        a >= b,
        np.where(mp >= 0, mp - npar, 0),
        np.where(npar > 0, 0, mp + b),
    )
    sign = np.where(k0 % 2 == 0, 1.0, -1.0)
    return j0, sign, logc


def _msign(ms):
    return np.where(np.asarray(ms) % 2 == 0, 1.0, -1.0)


def spin0_seed_planes(ms):
    """Host seed constants (2, len(ms)) float64: [logC, sign * (-1)^m]."""
    ms = np.asarray(ms, dtype=np.int64)
    _, sign, logc = _seed_consts(ms, 0)
    return np.stack([logc, sign * _msign(ms)])


def pair_seed_planes(ms, spin):
    """Host seed constants (4, len(ms)) float64 of the +-s columns.

    Rows [logC_p, sign_p, logC_m, sign_m] (signs include (-1)^m): branch
    p (a_{+s}) seeds d^{j0}_{-m,-s}, branch m seeds d^{j0}_{-m,+s}.
    """
    ms = np.asarray(ms, dtype=np.int64)
    _, sgp, logcp = _seed_consts(ms, spin)
    _, sgm, logcm = _seed_consts(ms, -spin)
    msign = _msign(ms)
    return np.stack([logcp, sgp * msign, logcm, sgm * msign])


def wigner_seed_log(mp, npar, logch, logsh):
    """Log-magnitude and sign of the seed d^{j0}_{mp, npar}(theta).

    ``mp``, ``npar``: (lanes,) integer Wigner row and column indices (may
    be negative); ``logch``/``logsh``: (nr,) tensors of log cos(theta/2),
    log sin(theta/2).  Returns (j0, sign, logval) tensors of shapes
    (lanes,), (lanes,), (lanes, nr) on the logs' device, in their dtype:
    the single surviving term of the Wigner-d sum at j0 = max(|m|, |n|),
    its constant from host float64 log-factorials.
    """
    mp = np.asarray(mp, dtype=np.int64)
    npar = np.asarray(npar, dtype=np.int64)
    # _seed_consts takes the slm lanes (m, n) of d^{j0}_{-m,-n}
    j0, sign, logc = _seed_consts(-mp, -npar)
    dev, dt = logch.device, logch.dtype

    def lane(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dt,
                               device=dev)[:, None]

    logval = (lane(logc) + lane(np.abs(mp + npar)) * logch[None, :]
              + lane(np.abs(mp - npar)) * logsh[None, :])
    return (torch.as_tensor(j0, device=dev), lane(sign)[:, 0], logval)


def wigner_seed_host(ms, ns, theta):
    """Host-f64 seed planes (mant, k) with value = mant * 2^(60 k).

    ``theta``: (nr,) colatitudes.  Returns ``mant`` (lanes, nr) float64
    (sign folded in, incl. the (-1)^m slm factor) and ``k`` (lanes, nr)
    int32.
    """
    ms = np.asarray(ms, dtype=np.int64)
    ns = np.broadcast_to(np.asarray(ns, dtype=np.int64), ms.shape)
    theta = np.asarray(theta, dtype=np.float64)
    _, sign, logc = _seed_consts(ms, ns)
    pc = np.abs(ms + ns).astype(np.float64)
    ps = np.abs(ms - ns).astype(np.float64)
    with np.errstate(divide="ignore"):
        logch = np.log(np.cos(theta / 2.0))
        logsh = np.log(np.sin(theta / 2.0))
    with np.errstate(invalid="ignore"):
        logval = (
            logc[:, None]
            + np.where(pc[:, None] == 0, 0.0, pc[:, None] * logch[None, :])
            + np.where(ps[:, None] == 0, 0.0, ps[:, None] * logsh[None, :])
        )
    ls = logval / (np.log(2.0) * _SCALE_LOG2)
    with np.errstate(invalid="ignore"):
        k = np.floor(ls)
    tiny = ~np.isfinite(k)  # exact poles: sin or cos of theta/2 is 0
    k = np.where(tiny, _NO_SEED, k).astype(np.int32)
    mant = np.where(
        tiny, 0.0, (sign * _msign(ms))[:, None] * np.exp2((ls - k) * _SCALE_LOG2)
    )
    return mant, k


def _lane_seeds(ms, ns, logch, logsh, dtype):
    """Seeds (nr, lanes): mantissa in ``dtype``, exponent int32 (f64 math)."""
    _, sign, logc = _seed_consts(ms, ns)
    dev = logch.device

    def lane(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)[None, :]

    pc = lane(np.abs(ms + ns))
    ps = lane(np.abs(ms - ns))
    lch = logch.to(torch.float64)[:, None]
    lsh = logsh.to(torch.float64)[:, None]
    lv = (
        lane(logc)
        + torch.where(pc == 0, 0.0, pc * lch)
        + torch.where(ps == 0, 0.0, ps * lsh)
    )
    ls = lv / (math.log(2.0) * _SCALE_LOG2)
    kf = torch.floor(ls)
    mant = lane(sign * _msign(ms)) * torch.exp2((ls - kf) * _SCALE_LOG2)
    return mant.to(dtype), kf.to(torch.int32)


def _coeff_tables(ms, ns, j0, lmax, dtype, device):
    """(A1, A0, B), each (lmax+2, lanes): row L advances d^{L-1} -> d^L.

    Computed in float64 on the host, zero for L <= j0 (the recurrence is
    not live), then rounded to ``dtype`` on ``device``.  numpy's square
    root and division are IEEE, as the card's are; torch's CPU square root
    goes through MKL, whose first call in a process has come back off by
    ~1e-12 of its value.
    """
    m2, n2, mn = (np.asarray(a, np.float64) for a in (ms * ms, ns * ns, ms * ns))
    L = np.arange(lmax + 2, dtype=np.float64)[:, None]

    def a_of(ell):
        v = (ell * ell - m2) * (ell * ell - n2)
        return np.sqrt(np.maximum(v, 0.0)) / np.maximum(ell, 1.0)

    live = L > np.asarray(j0)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(live, 1.0 / a_of(L), 0.0)
        A1 = (2.0 * L - 1.0) * inv
        A0 = -(2.0 * L - 1.0) * mn / (np.maximum(L - 1.0, 1.0) * L) * inv
        B = a_of(L - 1.0) * inv
    return tuple(torch.as_tensor(t, device=device).to(dtype) for t in (A1, A0, B))


def _sorted_lanes(ms, ns):
    """Lanes (ms[i], ns[i]) in order of j0: (ms, ns, j0, order).

    ``order`` is the permutation applied, or None where the lanes were
    already in order.
    """
    ms = np.asarray(ms, dtype=np.int64)
    ns = np.broadcast_to(np.asarray(ns, dtype=np.int64), ms.shape)
    j0 = np.maximum(np.abs(ms), np.abs(ns))
    order = np.argsort(j0, kind="stable")
    if np.array_equal(order, np.arange(order.size)):
        return ms, ns, j0, None
    return ms[order], ns[order], j0[order], order


def _recurrence_rows(ms, ns, j0, x, logch, logsh, lmax, dtype, device,
                     x_lo=None):
    """The scaled recurrence in l that every plain version runs.

    Lanes (ms[i], ns[i]) must be in order of j0 (:func:`_sorted_lanes`).
    Yields ``(ell, mant, k)`` for each l with a live lane: the state of the
    first n lanes (those with j0 <= l; the rest are skipped), value =
    ``mant`` (nr, n) times 2^(60 ``k``), ``k`` (nr, n) int32.  Both are
    views that the next step overwrites.  The seed is evaluated in float64
    and the coefficients computed in float64, then both are rounded to
    ``dtype``, as the kernels do.  With ``x_lo`` each lane also carries
    the comp stream lo (zero at the seed, scaled with d), stepped as
    ``((a1 x + a0) lo + r (a1 x d)) - b lo'`` with r from
    :func:`comp_ratio`, and ``mant`` is d + lo.
    """
    mant, kseed = _lane_seeds(ms, ns, logch, logsh, dtype)
    A1, A0, B = _coeff_tables(ms, ns, j0, lmax, dtype, device)
    xs = x.to(device=device, dtype=dtype)[:, None]
    nr, nlanes = mant.shape
    # recurrence state, updated in place lane block by lane block
    dp = torch.zeros((nr, nlanes), dtype=dtype, device=device)
    dc = torch.zeros_like(dp)
    k = torch.full((nr, nlanes), _NO_SEED, dtype=torch.int32, device=device)
    comp = x_lo is not None
    if comp:
        xr = comp_ratio(x, x_lo, device).to(dtype)[:, None]
        lp = torch.zeros_like(dp)  # the lo stream at l - 1 and l
        lc = torch.zeros_like(dp)
    ells = np.arange(lmax + 1)
    n_live = np.searchsorted(j0, ells, side="right")
    n_old = np.searchsorted(j0, ells, side="left")
    one = torch.ones((), dtype=dtype, device=device)
    inv_scale = torch.full((), _INV_SCALE, dtype=dtype, device=device)
    for ell in range(lmax + 1):
        n, s0 = int(n_live[ell]), int(n_old[ell])
        if n == 0:
            continue
        if s0 < n:  # lanes seeded at this l
            dc[:, s0:n] = mant[:, s0:n]
            dp[:, s0:n] = 0.0
            k[:, s0:n] = kseed[:, s0:n]
            if comp:
                lc[:, s0:n] = 0.0
                lp[:, s0:n] = 0.0
        yield ell, (dc[:, :n] + lc[:, :n]) if comp else dc[:, :n], k[:, :n]
        if ell == lmax:
            break
        dcl, dpl = dc[:, :n], dp[:, :n]
        a1x = A1[ell + 1, :n] * xs
        a = a1x + A0[ell + 1, :n]
        dn = a * dcl - B[ell + 1, :n] * dpl
        over = dn.abs() > _SCALE
        sc = torch.where(over, inv_scale, one)
        if comp:
            ln = (a * lc[:, :n] + xr * (a1x * dcl)) - B[ell + 1, :n] * lp[:, :n]
            lp[:, :n] = lc[:, :n] * sc
            lc[:, :n] = ln * sc
        dp[:, :n] = dcl * sc
        dc[:, :n] = dn * sc
        k[:, :n] += over.to(torch.int32)


def _lambda_rows(ms, ns, j0, x, logch, logsh, lmax, dtype, device,
                 x_lo=None):
    """The loop over l shared by every plain analysis and synthesis.

    Yields ``(ell, lam)`` for each row of :func:`_recurrence_rows`, ``lam``
    (nr, n) being the emitted functions: the mantissa at k = 0, times 2^-60
    at k = -1, zero below (with ``x_lo``, the comp recurrence's d + lo).
    """
    one = torch.ones((), dtype=dtype, device=device)
    inv_scale = torch.full((), _INV_SCALE, dtype=dtype, device=device)
    for ell, mant, k in _recurrence_rows(ms, ns, j0, x, logch, logsh, lmax,
                                         dtype, device, x_lo):
        emit = torch.where(k == 0, one, torch.where(k == -1, inv_scale, 0.0))
        yield ell, mant * emit


def _unsort(outs, order, device):
    """Undo the lane permutation of :func:`_sorted_lanes` on the last axis."""
    if order is None:
        return outs
    inv = torch.as_tensor(np.argsort(order), device=device)
    return [o.index_select(-1, inv) for o in outs]


def _folded_scan(ms, ns, x, logch, logsh, lmax, Fa, Fb, split, x_lo=None):
    """The plain folded analysis.

    Lanes are (ms[i], ns[i]); ``Fa``/``Fb``: (..., nr, lanes) complex.
    ``split=False``: returns sum_r lam * (Fa on even l, Fb on odd l);
    ``split=True``: returns the pair (sum_r lam * Fa, sum_r lam * Fb).
    Outputs are (..., lmax+1, lanes) complex.  ``x_lo``: the comp
    recurrence (:func:`_recurrence_rows`).
    """
    ms, ns, j0, order = _sorted_lanes(ms, ns)
    device = Fa.device
    if order is not None:
        idx = torch.as_tensor(order, device=device)
        Fa = Fa.index_select(-1, idx)
        Fb = Fb.index_select(-1, idx)
    Fa = Fa.resolve_conj().resolve_neg()
    Fb = Fb.resolve_conj().resolve_neg()
    dtype = Fa.real.dtype
    Far = torch.view_as_real(Fa)
    Fbr = torch.view_as_real(Fb)
    batch = Fa.shape[:-2]
    nlanes = ms.size
    outs = [
        torch.zeros(batch + (lmax + 1, nlanes, 2), dtype=dtype, device=device)
        for _ in range(2 if split else 1)
    ]
    for ell, lam in _lambda_rows(ms, ns, j0, x, logch, logsh, lmax, dtype,
                                 device, x_lo):
        n = lam.shape[1]
        lam = lam[:, :, None]
        norm = math.sqrt((2 * ell + 1) / (4 * math.pi))
        if split:
            outs[0][..., ell, :n, :] = (lam * Far[..., :n, :]).sum(-3) * norm
            outs[1][..., ell, :n, :] = (lam * Fbr[..., :n, :]).sum(-3) * norm
        else:
            F = Far if ell % 2 == 0 else Fbr
            outs[0][..., ell, :n, :] = (lam * F[..., :n, :]).sum(-3) * norm
    outs = _unsort([torch.view_as_complex(o) for o in outs], order, device)
    return tuple(outs) if split else outs[0]


def _folded_synth(ms, ns, x, logch, logsh, lmax, a, aS, x_lo=None):
    """The plain folded synthesis: (sum_l a lam, sum_l (-1)^l aS lam).

    Lanes are (ms[i], ns[i]); ``a``/``aS``: (..., lmax+1, lanes) complex
    alms.  Each is multiplied by sqrt((2l+1)/4pi) (rounded from float64 to
    the working type, as the kernels do) before the sums.  Returns
    (GN, S), each (..., nr, lanes) complex, nr = len(x).  ``x_lo``: the
    comp recurrence (:func:`_recurrence_rows`).
    """
    ms, ns, j0, order = _sorted_lanes(ms, ns)
    device = a.device
    if order is not None:
        idx = torch.as_tensor(order, device=device)
        a = a.index_select(-1, idx)
        aS = aS.index_select(-1, idx)
    dtype = a.real.dtype
    ells = np.arange(lmax + 1, dtype=np.float64)
    norm = torch.as_tensor(np.sqrt((2.0 * ells + 1.0) * (0.25 / math.pi)),
                           device=device).to(dtype)[:, None, None]
    ar = torch.view_as_real(a.resolve_conj().resolve_neg()) * norm
    aSr = torch.view_as_real(aS.resolve_conj().resolve_neg()) * norm
    batch = a.shape[:-2]
    GN = torch.zeros(batch + (x.shape[0], ms.size, 2), dtype=dtype, device=device)
    S = torch.zeros_like(GN)
    for ell, lam in _lambda_rows(ms, ns, j0, x, logch, logsh, lmax, dtype,
                                 device, x_lo):
        n = lam.shape[1]
        lam = lam[:, :, None]
        GN[..., :n, :] += ar[..., ell, None, :n, :] * lam
        t = aSr[..., ell, None, :n, :] * lam
        if ell % 2:
            S[..., :n, :] -= t
        else:
            S[..., :n, :] += t
    return tuple(_unsort([torch.view_as_complex(GN), torch.view_as_complex(S)],
                         order, device))


def _swap_blocks(arr, dim=-1):
    """Swap the two equal halves of ``arr`` along ``dim`` (the +-n blocks)."""
    half = arr.shape[dim] // 2
    return torch.cat([arr.narrow(dim, half, half), arr.narrow(dim, 0, half)],
                     dim=dim)


def lambda_analysis_scan_folded(ms, ns, x, logch, logsh, lmax, FN, FS,
                                cross=False, *, x_lo=None):
    """Ring-pair-folded analysis: half the rings, parity-split spectra.

    ``FN``: (..., nhalf, lanes) northern ring spectra; ``FS``: the mirrored
    southern rows premultiplied by (-1)^m.  With ``cross=False`` each lane
    contracts FN + FS on even l and FN - FS on odd l; with ``cross=True``
    the lanes are two equal +-n blocks and the southern term of each lane
    goes to its partner lane of the other block with the sign (-1)^l.
    Returns (..., lmax+1, lanes) complex.  ``x_lo``: the float32
    residual of float64 cos(theta), for the comp recurrence.
    """
    if not cross:
        return _folded_scan(ms, ns, x, logch, logsh, lmax, FN + FS, FN - FS,
                            split=False, x_lo=x_lo)
    north, south = _folded_scan(ms, ns, x, logch, logsh, lmax, FN, FS,
                                split=True, x_lo=x_lo)
    sign = torch.ones(lmax + 1, 1, dtype=north.real.dtype, device=north.device)
    sign[1::2] = -1.0
    return north + sign * _swap_blocks(south)


def lambda_synthesis_scan_folded(ms, ns, x, logch, logsh, lmax, alm,
                                 cross=False, *, x_lo=None):
    """Ring-pair-folded synthesis: (GN, GS), each (..., nhalf, lanes).

    ``alm``: (..., lmax+1, lanes) complex.  GN holds the ring spectra on
    the northern rings, GS those of their mirrored southern partners,
    GS[L] = (-1)^{m_L} sum_l (-1)^l alm[l, P(L)] lam[l, L] routed back to
    column L (P is the swap of the two +-n lane blocks when ``cross``,
    the identity otherwise).  ``x_lo``: the comp recurrence, as for
    :func:`lambda_analysis_scan_folded`.
    """
    almP = _swap_blocks(alm) if cross else alm
    GN, S = _folded_synth(ms, ns, x, logch, logsh, lmax, alm, almP, x_lo)
    GS = _swap_blocks(S) if cross else S
    msign = torch.as_tensor(_msign(ms), dtype=GN.real.dtype, device=GN.device)
    return GN, GS * msign


def _lane_sums(ms, ns, x, logch, logsh, lmax, Fw):
    """The unfolded analysis, one l at a time: ``(order, rows)``.

    Lanes are (ms[i], ns[i]); ``Fw``: (..., nr, lanes) complex; ``x``,
    ``logch``, ``logsh``: (nr,), or with the leading axes of ``Fw`` (rings
    of their own per batch element).  ``rows`` yields ``(ell, a)`` with
    ``a`` (..., n, 2) the (re, im) sums over rings of slm * Fw for the
    first n lanes in order of j0; ``order`` is that lane permutation
    (:func:`_sorted_lanes`).
    """
    ms, ns, j0, order = _sorted_lanes(ms, ns)
    device = Fw.device
    if order is not None:
        Fw = Fw.index_select(-1, torch.as_tensor(order, device=device))
    dtype = Fw.real.dtype
    Fr = torch.view_as_real(Fw.resolve_conj().resolve_neg())
    rings = x.shape

    def rows():
        for ell, lam in _lambda_rows(ms, ns, j0, x.reshape(-1),
                                     logch.reshape(-1), logsh.reshape(-1),
                                     lmax, dtype, device):
            n = lam.shape[1]
            lam = lam.reshape(rings + (n, 1))
            norm = math.sqrt((2 * ell + 1) / (4 * math.pi))
            yield ell, (lam * Fr[..., :n, :]).sum(-3) * norm

    return order, rows()


def lambda_analysis_scan(ms, ns, x, logch, logsh, lmax, Fw):
    """alm[..., l, lane] = sum_r slm(l, m_lane, n_lane; theta_r) Fw[..., r, lane].

    The unfolded analysis over arbitrary rings (no mirror pairs).  Lanes
    are (ms[i], ns[i]) with ``ns`` the spin column; ``Fw``: (..., nr,
    lanes) complex ring coefficients premultiplied by any weights; ``x``,
    ``logch``, ``logsh``: (nr,) cos(theta) and the half-angle logs, or
    with the leading axes of ``Fw``.  Returns (..., lmax+1, lanes)
    complex, on the device and in the precision of ``Fw``.
    """
    out = torch.zeros(Fw.shape[:-2] + (lmax + 1, Fw.shape[-1], 2),
                      dtype=Fw.real.dtype, device=Fw.device)
    order, rows = _lane_sums(ms, ns, x, logch, logsh, lmax, Fw)
    for ell, a in rows:
        out[..., ell, : a.shape[-2], :] = a
    return _unsort([torch.view_as_complex(out)], order, Fw.device)[0]


def lambda_power_scan(ms, ns, x, logch, logsh, lmax, Fw, weights):
    """Per-l lane-weighted power of the analysis, reduced l by l.

    out[..., k, l] = sum_lane weights[k, lane] |a_l,lane|^2, with a the
    alms of :func:`lambda_analysis_scan` (same arguments), which are
    never held for more than one l.  ``weights``: (K, lanes) real.
    Returns (..., K, lmax+1) real.
    """
    w = torch.as_tensor(np.asarray(weights, np.float64), device=Fw.device)
    order, rows = _lane_sums(ms, ns, x, logch, logsh, lmax, Fw)
    if order is not None:
        w = w[:, torch.as_tensor(order, device=Fw.device)]
    w = w.to(Fw.real.dtype)
    out = torch.zeros(Fw.shape[:-2] + (w.shape[0], lmax + 1),
                      dtype=Fw.real.dtype, device=Fw.device)
    for ell, a in rows:
        out[..., ell] = (a * a).sum(-1) @ w[:, : a.shape[-2]].T
    return out


# The plain versions of the four kernels.  ``x_lo`` (the float32 residual
# of float64 cos(theta), a (nhalf,) tensor) runs the comp recurrence, the
# plain version of the kernels' compensated float32 instantiation; None
# the plain recurrence.


def analysis_spin0_folded_plain(Fe, Fo, x, logch, logsh, lmax, m0=0, *,
                                x_lo=None, nb=1):
    """Plain version of the spin-0 analysis kernel (same signature).

    alm[..., l, m] = sum_r lam_lm(x_r) (Fe on even l, Fo on odd l)[..., r, m],
    column c holding the order m0 + c (zeros for an order above lmax).
    ``nb`` is checked (:func:`check_group`) and changes nothing here.
    """
    check_group("analysis_spin0_folded", nb, _batch(Fe))
    _count_run("analysis_spin0_folded", Fe.dtype, x_lo)
    nm = Fe.shape[-1]
    return _folded_scan(m0 + np.arange(nm), 0, x, logch, logsh, lmax, Fe, Fo,
                        split=False, x_lo=x_lo)


def analysis_pair_folded_plain(FNp, Sp, FNm, Sm, x, logch, logsh, lmax, spin,
                               m0=0, *, x_lo=None, nb=1):
    """Plain version of the spin-pair analysis kernel (same signature).

    a_p = sum lam_p FNp + (-1)^l sum lam_m Sp and
    a_m = sum lam_m FNm + (-1)^l sum lam_p Sm; returns (a_p, a_m), column
    c holding the order m0 + c.  ``nb`` is checked (:func:`check_group`)
    and changes nothing here.
    """
    check_group("analysis_pair_folded", nb, _batch(FNp))
    _count_run("analysis_pair_folded", FNp.dtype, x_lo)
    nm = FNp.shape[-1]
    ms = np.tile(m0 + np.arange(nm), 2)
    ns = np.repeat(np.asarray([spin, -spin], np.int64), nm)
    out = lambda_analysis_scan_folded(
        ms, ns, x, logch, logsh, lmax,
        torch.cat([FNp, FNm], dim=-1), torch.cat([Sm, Sp], dim=-1),
        cross=True, x_lo=x_lo,
    )
    return out[..., :nm], out[..., nm:]


def synthesis_spin0_folded_plain(alm, x, logch, logsh, lmax, m0=0, *,
                                 x_lo=None, nb=1):
    """Plain version of the spin-0 synthesis kernel (same signature).

    GN = sum_l alm lam and GS = (-1)^m sum_l (-1)^l alm lam, each
    (..., nhalf, nm), column c holding the order m0 + c.  ``nb`` is
    checked (:func:`check_group`) and changes nothing here.  The
    reference takes any divisor of the batch (``pallas_sht.py:3081``, 3
    included); here a size without an instantiation raises ValueError,
    and since every ``nb`` gives the same numbers the results agree all
    the same.
    """
    check_group("synthesis_spin0_folded", nb, _batch(alm))
    _count_run("synthesis_spin0_folded", alm.dtype, x_lo)
    nm = alm.shape[-1]
    return lambda_synthesis_scan_folded(m0 + np.arange(nm), 0, x, logch,
                                        logsh, lmax, alm, x_lo=x_lo)


def synthesis_pair_folded_plain(alm_p, alm_m, x, logch, logsh, lmax, spin,
                                m0=0, *, x_lo=None, nb=1):
    """Plain version of the spin-pair synthesis kernel (same signature).

    GNp = sum a_p lam_p, GSp = (-1)^m sum (-1)^l a_p lam_m,
    GNm = sum a_m lam_m, GSm = (-1)^m sum (-1)^l a_m lam_p; returns
    (GNp, GSp, GNm, GSm), column c holding the order m0 + c.  ``nb`` is
    checked (:func:`check_group`) and changes nothing here.
    """
    check_group("synthesis_pair_folded", nb, _batch(alm_p))
    _count_run("synthesis_pair_folded", alm_p.dtype, x_lo)
    nm = alm_p.shape[-1]
    ms = np.tile(m0 + np.arange(nm), 2)
    ns = np.repeat(np.asarray([spin, -spin], np.int64), nm)
    GN, GS = lambda_synthesis_scan_folded(
        ms, ns, x, logch, logsh, lmax, torch.cat([alm_p, alm_m], dim=-1),
        cross=True, x_lo=x_lo,
    )
    return GN[..., :nm], GS[..., :nm], GN[..., nm:], GS[..., nm:]


def lambda_synthesis_scan(ms, ns, x, logch, logsh, lmax, alm):
    """G[..., r, lane] = sum_l alm[..., l, lane] slm(l, m_lane, n_lane; theta_r).

    The unfolded synthesis onto arbitrary rings (no mirror pairs): lanes
    (ms[i], ns[i]); ``alm``: (..., lmax+1, lanes) complex; ``x``,
    ``logch``, ``logsh``: (nr,).  Returns (..., nr, lanes) complex, on the
    device and in the precision of ``alm``.
    """
    ms, ns, j0, order = _sorted_lanes(ms, ns)
    device = alm.device
    if order is not None:
        alm = alm.index_select(-1, torch.as_tensor(order, device=device))
    dtype = alm.real.dtype
    ar = torch.view_as_real(alm.resolve_conj().resolve_neg())
    G = torch.zeros(alm.shape[:-2] + (x.shape[0], ms.size, 2), dtype=dtype,
                    device=device)
    for ell, lam in _lambda_rows(ms, ns, j0, x, logch, logsh, lmax, dtype,
                                 device):
        n = lam.shape[1]
        norm = math.sqrt((2 * ell + 1) / (4 * math.pi))
        G[..., :n, :] += ar[..., ell, None, :n, :] * (lam * norm)[:, :, None]
    return _unsort([torch.view_as_complex(G)], order, device)[0]


def wigner_table(m, n, x, logch, logsh, lmax):
    """Wigner-d table d^l_{-m,-n}(theta) for l = 0..lmax: (lmax+1, nr).

    One (m, n) pair on the rings ``x``, ``logch``, ``logsh`` ((nr,)
    tensors), by the scaled recurrence of the SHT in the precision of
    ``x`` (the rows of the slm functions before their normalisation, with
    their (-1)^m taken out).  Zero below j0 = max(|m|, |n|).
    """
    dtype = x.dtype
    out = torch.zeros((lmax + 1, x.shape[0]), dtype=dtype, device=x.device)
    ms, ns, j0, _ = _sorted_lanes([m], [n])
    sign = -1.0 if int(m) % 2 else 1.0
    for ell, lam in _lambda_rows(ms, ns, j0, x, logch, logsh, lmax, dtype,
                                 x.device):
        out[ell] = lam[:, 0] * sign
    return out


def wigner_table_host(m, n, theta, lmax):
    """Host-f64 Wigner-d table d^l_{-m,-n}(theta), shape (lmax+1, nr).

    Carried over from :mod:`heracles_tpu.ops.wigner` unchanged, so the
    mixing-matrix tables are the reference's own, bit for bit.  Small
    spins only (|m|, |n| <= ~32, where the unscaled recurrence neither
    under- nor overflows).  The tables feed the float64 Gram contraction
    of the mixing matrices (:mod:`.gram`).
    """
    m, n = int(m), int(n)
    mp, npar = -m, -n
    a, b = abs(mp), abs(npar)
    j0 = max(a, b)
    if j0 > 64:
        raise ValueError("wigner_table_host: unscaled recurrence needs "
                         f"small spins, got j0={j0}")
    theta = np.asarray(theta, np.float64)
    out = np.zeros((lmax + 1, theta.size))
    if j0 > lmax:
        return out
    # seed d^{j0}_{m', n'} = (-1)^k0 C cos^pc(t/2) sin^ps(t/2)
    c = npar if a >= b else mp
    lf = _log_factorials(2 * j0 + 2)
    logC = 0.5 * (lf[2 * j0] - lf[j0 + c] - lf[j0 - c])
    pc = abs(mp + npar)
    ps = abs(mp - npar)
    k0 = (mp - npar if mp >= 0 else 0) if a >= b else (0 if npar > 0 else mp + b)
    sign = 1.0 if k0 % 2 == 0 else -1.0
    ch, sh = np.cos(theta / 2.0), np.sin(theta / 2.0)
    out[j0] = sign * np.exp(logC) * ch**pc * sh**ps
    x = np.cos(theta)
    mn = float(m * n)  # m'*n' = (-m)(-n) = m*n
    m2, n2 = float(m * m), float(n * n)

    def a_of(ell):
        return np.sqrt((ell * ell - m2) * (ell * ell - n2)) / ell

    d_prev = np.zeros_like(out[j0])
    d_curr = out[j0]
    for ell in range(j0 + 1, lmax + 1):
        lf_, lm1 = float(ell), float(ell - 1)
        mid = (2.0 * lf_ - 1.0) * (x - mn / max(lm1 * lf_, 1.0))
        a_lm1 = a_of(lm1) if ell - 1 > j0 else 0.0
        d_new = (mid * d_curr - a_lm1 * d_prev) / a_of(lf_)
        out[ell] = d_new
        d_prev, d_curr = d_curr, d_new
    return out


def legendre_sum_host(coeffs, x):
    """Host-f64 sum_l coeffs[l] P_l(x) via the streaming recurrence.

    O(1) memory in l — used for the mixing matrices' mask correlation
    xi(x) at l3max ~ thousands without materialising the P table.
    Carried over from :mod:`heracles_tpu.ops.wigner` unchanged.
    """
    coeffs = np.asarray(coeffs, np.float64)
    x = np.asarray(x, np.float64)
    acc = np.full_like(x, coeffs[0])
    if coeffs.shape[0] == 1:
        return acc
    p_prev = np.ones_like(x)
    p_curr = x.copy()
    acc += coeffs[1] * p_curr
    for ell in range(2, coeffs.shape[0]):
        p_new = ((2 * ell - 1) * x * p_curr - (ell - 1) * p_prev) / ell
        acc += coeffs[ell] * p_new
        p_prev, p_curr = p_curr, p_new
    return acc
