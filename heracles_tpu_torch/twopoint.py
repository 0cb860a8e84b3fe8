"""Angular power spectra of alms, on torch.

Counterpart of the spectra half of :mod:`heracles_tpu.twopoint`:

* :func:`alm2cl` — (cross-)spectra of packed alms with broadcasting over
  leading axes and lmax truncation;
* :func:`angular_power_spectra` — all auto/cross spectra over field x bin
  combinations with pair dedup/canonical ordering, metadata merge with
  ``_1``/``_2`` suffixes, noise bias ``bias = (1/2 if spin2 x spin2) *
  fsky * musq / dens``, optional debias and binning; the whole pair grid
  is one float64 contraction per group of alms on their device;
* :func:`angular_power_spectra_samples`,
  :func:`angular_power_spectra_sample_stacks` — the same for many alm sets
  (jackknife samples) stacked on a leading sample axis: sample s's planes
  pair only with sample s's, in one batched contraction;
* :func:`debias_cls` — additive bias removal for l >= max(|s1|, |s2|),
  EE/BB only for spin2 x spin2, divided by the pixel window when the maps
  were deconvolved.

and of its mixing-matrix half:

* :func:`mixmat`, :func:`mixmat_eb`, :func:`mixing_matrices` — MASTER
  mixing matrices by Gauss-Legendre quadrature: host-f64 Wigner-d tables
  on the nodes, uploaded once and cached on the device, contracted
  against the node weights times the mask correlation by the float64
  Gram kernel (:mod:`.ops.gram`); spin-2 E/B blocks by the parity split;
* :func:`invert_mixing_matrix` — batched rcond-cut pseudo-inverses on
  the device (``torch.linalg.pinv``), with the M+/M- block
  diagonalisation of the E/B sector;
* :func:`apply_mixing_matrix` — host matrix-vector products, E/B aware.

Spectra and mixing matrices come back as host numpy arrays carrying their
metadata.
"""

from __future__ import annotations

import functools
import logging
import time
from collections.abc import Mapping
from dataclasses import replace
from datetime import timedelta
from itertools import combinations_with_replacement, product

import numpy as np
import torch

from . import tracing
from .core import TocDict, toc_match, update_metadata
from .devicemap import DeviceMap
from .ops import gram, sht
from .ops.wigner import legendre_sum_host, wigner_table_host
from .progress import NoProgress
from .result import Result, binned, get_result_array

__all__ = [
    "alm2cl",
    "alm2lmax",
    "angular_power_spectra",
    "angular_power_spectra_samples",
    "angular_power_spectra_sample_stacks",
    "apply_mixing_matrix",
    "debias_cls",
    "invert_mixing_matrix",
    "mixing_matrices",
    "mixmat",
    "mixmat_eb",
    "rect_pair_grid",
]

logger = logging.getLogger(__name__)

# per-contraction budget (bytes) for the unpacked float64 alm planes
_GRID_BUDGET = 2 * 2**30


def alm2lmax(alm, mmax=None):
    """lmax of a packed alm array (assumes mmax == lmax)."""
    return _nlm2lmax(np.shape(alm)[-1])


def _nlm2lmax(nlm):
    return (int((8 * nlm + 1) ** 0.5 + 0.01) - 3) // 2


def _tensor(a):
    if isinstance(a, DeviceMap):
        return a.array
    if isinstance(a, torch.Tensor):
        return a
    a = np.asanyarray(a)
    return torch.as_tensor(np.asarray(a, np.dtype(a.dtype.str)))


def rect_pair_grid(a1, a2, ms):
    """All-pairs spectra of rectangular alm plane stacks.

    ``a1``: (..., nA, nl, nm) complex, ``a2``: (..., nB, nl, nm) complex,
    ``ms``: (nm,) orders of the m axis.  Returns (..., nA, nB, nl)
    float64: the (2 - delta_m0)-weighted sum over the orders divided by
    (2l+1), accumulated in float64.  Leading axes (a sample axis) are
    batched, not paired: sample s's planes pair only with sample s's.
    """
    f64 = torch.float64
    tracing.built("twopoint.pair_weights")
    if not (isinstance(ms, torch.Tensor) and ms.device == a1.device):
        tracing.copied("twopoint.pair_grid", "h2d", a1)
    # staged at once: the copy waits for no work queued on the card
    ms = torch.as_tensor(ms).to(a1.device, non_blocking=True)
    eps = torch.where(ms == 0, 1.0, 2.0).to(f64)
    grid = torch.einsum("...alm,...blm->...abl", a1.real.to(f64) * eps,
                        a2.real.to(f64))
    grid += torch.einsum("...alm,...blm->...abl", a1.imag.to(f64) * eps,
                         a2.imag.to(f64))
    ells = torch.arange(a1.shape[-2], dtype=f64, device=a1.device)
    return grid / (2 * ells + 1)


def alm2cl(alm, alm2=None, *, lmax=None):
    """Angular (cross-)power spectrum of packed alms (float64 tensor).

    Broadcasts over leading axes as an outer product: alm (A..., nlm) and
    alm2 (B..., nlm) give cl of shape (A..., B..., lout+1) with
    lout = min(lmax, lmax(alm), lmax(alm2)).
    """
    a = _tensor(alm)
    b = a if alm2 is None else _tensor(alm2)
    lmax1, lmax2 = _nlm2lmax(a.shape[-1]), _nlm2lmax(b.shape[-1])
    lout = min(lmax1, lmax2) if lmax is None else min(lmax, lmax1, lmax2)
    r1 = sht.unpack_alm(a.reshape(-1, a.shape[-1]), lmax1)[..., : lout + 1, : lout + 1]
    r2 = sht.unpack_alm(b.reshape(-1, b.shape[-1]), lmax2)[..., : lout + 1, : lout + 1]
    grid = rect_pair_grid(r1, r2, torch.arange(lout + 1))
    return grid.reshape(a.shape[:-1] + b.shape[:-1] + (lout + 1,))


def _cross_grids(plan, nsamples, lmax, mesh=None, split=1):
    """Every needed (nlm1 x nlm2) spectra grid of sample-stacked alms.

    ``plan`` items are (key, alm1, alm2) where each alm is an
    (S, ..., nlm) stack over S = ``nsamples`` samples (tensor or numpy).
    The distinct stacks are grouped by nlm and their component planes
    concatenated, on the device of the first one that is not on the host.
    Returns ``(grids, slot)``: ``grids[nlm1, nlm2]`` is the (S, nA, nB,
    lout+1) host float64 array, one batched contraction per group (sample
    s's planes pair only with sample s's), chunked over the planes so that
    the unpacked float64 planes of all samples stay within
    ``_GRID_BUDGET``; ``slot[id(alm)]`` locates a stack as ``(nlm,
    first_row, leading_shape)``.

    With a device ``mesh`` the first stack is cut along axis ``split``
    (1: its plane rows, 0: its samples) into one block per shard, and the
    second stack is copied whole to every shard's device (rows) or cut
    the same way (samples); each shard computes its block's grid there
    (within the budget per device), and the blocks are gathered on the
    host.
    """
    rows, slot = {}, {}
    for arr in (a for _, a1, a2 in plan for a in (a1, a2)):
        if id(arr) in slot:
            continue
        a = _tensor(arr)
        nlm = a.shape[-1]
        group = rows.setdefault(nlm, [])
        slot[id(arr)] = (nlm, sum(p.shape[1] for p in group),
                         tuple(a.shape[1:-1]))
        group.append(a.reshape(nsamples, -1, nlm))
    stacks = {}
    for nlm, group in rows.items():
        dev = next((p.device for p in group if p.device.type != "cpu"),
                   group[0].device)
        cdt = torch.promote_types(group[0].dtype, torch.complex64)
        stacks[nlm] = torch.cat([p.to(device=dev, dtype=cdt) for p in group], 1)
    wanted = {(np.shape(a1)[-1], np.shape(a2)[-1]) for _, a1, a2 in plan}
    grids = {}
    for n1, n2 in wanted:
        if (n2, n1) in grids:
            grids[n1, n2] = grids[n2, n1].transpose(0, 2, 1, 3)
            continue
        s1, s2 = stacks[n1], stacks[n2]
        l1, l2 = _nlm2lmax(n1), _nlm2lmax(n2)
        lout = min(l1, l2) if lmax is None else min(lmax, l1, l2)
        if mesh is None:
            with tracing.span("twopoint.pair_grid"):
                grid = _pair_grid(s1, s2.to(s1.device), l1, l2, lout)
            with tracing.span("twopoint.to_host"):
                grid = tracing.to_host("twopoint.to_host", grid)
        else:
            devices = list(mesh.devices.flat)
            b1 = s1.tensor_split(len(devices), dim=split)
            # a sample pairs only with its own sample of the second stack
            b2 = (s2.tensor_split(len(devices), dim=0) if split == 0
                  else [s2] * len(devices))
            local = [(a.to(d), b.to(d)) for a, b, d in zip(b1, b2, devices)
                     if a.shape[split]]
            with tracing.span("twopoint.pair_grid"):
                blocks = [_pair_grid(a, b, l1, l2, lout) for a, b in local]
            with tracing.span("twopoint.to_host"):
                grid = np.concatenate(
                    [tracing.to_host("twopoint.to_host", b) for b in blocks],
                    axis=split)
        grids[n1, n2] = grid
    return grids, slot


def _pair_grid(s1, s2, l1, l2, lout):
    """(S, nA, nB, lout+1) float64 grid of two packed plane stacks on one
    device, chunked over the planes so that the unpacked float64 planes
    stay within ``_GRID_BUDGET``."""
    nsamples = s1.shape[0]
    per = max(1, _GRID_BUDGET // (16 * (max(l1, l2) + 1) ** 2 * nsamples))
    ms = torch.arange(lout + 1)
    grid = torch.empty((nsamples, s1.shape[1], s2.shape[1], lout + 1),
                       dtype=torch.float64, device=s1.device)
    for i0 in range(0, s1.shape[1], per):
        r1 = sht.unpack_alm(s1[:, i0 : i0 + per], l1)[..., : lout + 1, : lout + 1]
        for j0 in range(0, s2.shape[1], per):
            r2 = sht.unpack_alm(s2[:, j0 : j0 + per], l2)[..., : lout + 1, : lout + 1]
            grid[:, i0 : i0 + per, j0 : j0 + per] = rect_pair_grid(r1, r2, ms)
    return grid


def _grid_block(grids, slot, alm1, alm2):
    """One pair's (S, ...) cl blocks, with the outer-product leading shape
    of the two stacks."""
    n1, row, shape1 = slot[id(alm1)]
    n2, col, shape2 = slot[id(alm2)]
    g = grids[n1, n2]
    nc1 = int(np.prod(shape1, dtype=int))
    nc2 = int(np.prod(shape2, dtype=int))
    block = g[:, row : row + nc1, col : col + nc2]
    return block.reshape(g.shape[:1] + shape1 + shape2 + g.shape[-1:])


def _debias_cl(cl, bias=None, md=None, *, inplace=False, device="cuda"):
    """Subtract the additive noise bias (pixel-window aware; a window that
    has to be computed is computed on ``device``)."""
    if md is None:
        md = cl.dtype.metadata or {}
    if not inplace:
        cl = cl.copy()
        update_metadata(cl, **md)
    if bias is None:
        bias = md.get("bias")
        if bias is None:
            return cl

    spin1, spin2 = md.get("spin_1", 0), md.get("spin_2", 0)
    lmin = max(abs(spin1), abs(spin2))
    lmax = cl.shape[-1] - 1

    bl = np.zeros(cl.shape)
    if spin1 != 0 and spin2 != 0:
        # spin x spin: bias only in the EE and BB blocks
        if cl.shape[:2] != (2, 2):
            raise ValueError(f"spin x spin spectra must be (2, 2, ...), got {cl.shape}")
        bl[[0, 1], [0, 1], ..., lmin:] = bias
    else:
        bl[..., lmin:] = bias

    # deconvolved maps amplified the shot noise by 1/pixwin per side
    for i, s in ((1, spin1), (2, spin2)):
        if md.get(f"kernel_{i}") == "healpix":
            nside = md.get(f"nside_{i}")
            deconv = md.get(f"deconv_{i}", True)
            if nside is not None and deconv:
                if s == 0:
                    pw = sht.pixel_window(nside, lmax, device=device)
                elif s == 2:
                    pw = sht.pixel_window(nside, lmax, pol=True,
                                          device=device)[1]
                else:
                    pw = None
                if pw is not None:
                    bl[..., lmin:] /= pw[lmin:]

    cl[:] -= bl
    return cl


@tracing.spanned("twopoint.angular_power_spectra")
def angular_power_spectra(
    alms,
    alms2=None,
    *,
    lmax=None,
    debias=True,
    bins=None,
    weights=None,
    include=None,
    exclude=None,
    out=None,
    device=None,
    mesh=None,
):
    """All auto/cross angular power spectra of a set of alms.

    Keys of ``alms`` are (field, bin); results are keyed
    (field1, field2, bin1, bin2) with symmetric-pair dedup and canonical
    field ordering.  Values are DeviceMaps, tensors or numpy arrays with
    metadata; each result is a :class:`Result` over a host float64 array.
    The pair grid runs on ``device``, by default on the device of the
    values (the host for numpy arrays, such as alms read from a file).
    ``mesh``: a :class:`~heracles_tpu_torch.parallel.Mesh`; the grid's
    plane rows are then split across every shard, each shard pairing its
    rows with all the planes on its device (the same spectra).
    """
    logger.info(
        "computing cls for %d%s alm(s)",
        len(alms),
        f"x{len(alms2)}" if alms2 is not None else "",
    )
    t = time.monotonic()

    if alms2 is None:
        pairs = combinations_with_replacement(alms, 2)
        alms2 = alms
    else:
        pairs = product(alms, alms2)

    twopoint_names = set()
    cls = TocDict() if out is None else out

    # pass 1 (host): decide which pairs to compute, in canonical order
    plan = []
    for (k1, i1), (k2, i2) in pairs:
        if (k1, k2, i1, i2) in cls or (k2, k1, i2, i1) in cls:
            continue
        if (k1, k2) not in twopoint_names and (k2, k1) in twopoint_names:
            k1, k2, i1, i2 = k2, k1, i2, i1
            alm1, alm2 = alms2[k1, i1], alms[k2, i2]
        else:
            alm1, alm2 = alms[k1, i1], alms2[k2, i2]
        if not toc_match((k1, k2, i1, i2), include, exclude):
            continue
        plan.append(((k1, k2, i1, i2), alm1, alm2))
        twopoint_names.add((k1, k2))

    # pass 2 (device): the whole pair grid in a few contractions, the alms
    # as stacks of one sample
    one = {}
    for _, alm1, alm2 in plan:
        for alm in (alm1, alm2):
            if id(alm) not in one:
                a = _tensor(alm)[None]
                one[id(alm)] = a if device is None else a.to(device)
    grids, slot = _cross_grids(
        [(key, one[id(a1)], one[id(a2)]) for key, a1, a2 in plan], 1, lmax,
        mesh=mesh, split=1)
    device = (_compute_device(one.values()) if mesh is None
              else mesh.devices.flat[0])

    # pass 3 (host): metadata, noise bias, Result assembly
    with tracing.span("twopoint.results"):
        for key, alm1, alm2 in plan:
            cl = np.array(_grid_block(grids, slot, one[id(alm1)],
                                      one[id(alm2)])[0])
            cls[key] = _pair_result(key, cl, _metadata(alm1), _metadata(alm2),
                                    debias, bins, weights, device)

    logger.info(
        "computed %d cl(s) in %s",
        len(cls),
        timedelta(seconds=(time.monotonic() - t)),
    )
    return cls


def _pair_result(key, cl, md1, md2, debias, bins, weights, device):
    """The Result of one pair's host cl block: merged ``_1``/``_2``
    metadata, the noise bias of an auto-spectrum, optional debias and
    binning (a pixel window is computed on ``device``, where the grid
    ran)."""
    k1, k2, i1, i2 = key
    md1, md2 = md1 or {}, md2 or {}
    s1, s2 = md1.get("spin"), md2.get("spin")
    if s1 is None or s2 is None:
        raise ValueError(f"missing spin metadata for {k1} or {k2}")
    md = {f"{name}_1": value for name, value in md1.items()}
    md.update({f"{name}_2": value for name, value in md2.items()})
    bias = None
    if k1 == k2 and i1 == i2:
        fsky = md1.get("fsky")
        musq = md1.get("musq")
        dens = md1.get("dens")
        if fsky is not None and musq is not None and dens is not None:
            factor = 0.5 if s1 == s2 == 2 else 1.0
            bias = factor * fsky * musq / dens
    if bias is not None:
        md["bias"] = bias
    if debias and bias is not None:
        _debias_cl(cl, bias, md, inplace=True, device=device)
    update_metadata(cl, **md)
    result = Result(cl, spin=(s1, s2), axis=-1)
    if bins is not None:
        result = binned(result, bins, weights)
    return result


def _sample_pair_plan(keys, include, exclude):
    """Canonical pair plan over a shared key structure (host pass)."""
    twopoint_names = set()
    plan_keys = []
    for (k1, i1), (k2, i2) in combinations_with_replacement(keys, 2):
        if (k1, k2) not in twopoint_names and (k2, k1) in twopoint_names:
            k1, k2, i1, i2 = k2, k1, i2, i1
        if not toc_match((k1, k2, i1, i2), include, exclude):
            continue
        plan_keys.append((k1, k2, i1, i2))
        twopoint_names.add((k1, k2))
    return plan_keys


def _metadata(value):
    """The science metadata of an alm value (a bare tensor has none)."""
    if isinstance(value, DeviceMap):
        return value.metadata
    return dict(getattr(value.dtype, "metadata", None) or {})


def angular_power_spectra_samples(
    alms_list,
    *,
    lmax=None,
    debias=True,
    bins=None,
    weights=None,
    include=None,
    exclude=None,
    mesh=None,
):
    """:func:`angular_power_spectra` for many alm sets in one device pass.

    ``alms_list``: a sequence of alm dicts sharing the same keys (the
    delete-k jackknife samples).  Each key's alms are stacked over a
    leading sample axis and the whole (sample x pair x ell) grid is
    computed batched.  Returns a list of cls dicts, one per input, equal
    to mapping :func:`angular_power_spectra` over the list.  Values are
    DeviceMaps, tensors or numpy arrays; the metadata is the first
    sample's.  The grids run on the device of the values (the host for
    numpy); with a device ``mesh`` the samples are split across every
    shard.
    """
    if not alms_list:
        return []
    nsamples = len(alms_list)
    plan_keys = _sample_pair_plan(alms_list[0], include, exclude)

    stacks, metadata = {}, {}
    for k1, k2, i1, i2 in plan_keys:
        for k, i in ((k1, i1), (k2, i2)):
            if (k, i) in stacks:
                continue
            vals = [al[k, i] for al in alms_list]
            if any(isinstance(v, (DeviceMap, torch.Tensor)) for v in vals):
                stacks[k, i] = torch.stack([_tensor(v) for v in vals])
            else:
                stacks[k, i] = np.stack([np.asarray(v) for v in vals])
            metadata[k, i] = _metadata(vals[0])
    return angular_power_spectra_sample_stacks(
        stacks, metadata, nsamples, lmax=lmax, debias=debias, bins=bins,
        weights=weights, plan_keys=plan_keys, mesh=mesh,
    )


@tracing.spanned("twopoint.angular_power_spectra_sample_stacks")
def angular_power_spectra_sample_stacks(
    stacks,
    metadata,
    nsamples,
    *,
    lmax=None,
    debias=True,
    bins=None,
    weights=None,
    include=None,
    exclude=None,
    plan_keys=None,
    mesh=None,
):
    """Sample spectra from pre-stacked alms.

    ``stacks``: {(name, bin): (nsamples, ..., nlm)} tensors (on any
    device) or numpy arrays; the DICES device cache feeds the delete-k
    stacks it assembles on the card straight through here, and only the
    small float64 grids cross to the host.  ``metadata``: {(name, bin):
    dict} science metadata per key, shared by all samples (sample-specific
    bias corrections are applied downstream, as in the jackknife flow).
    ``mesh``: a device mesh; the sample axis is then split across every
    shard (the same spectra).
    """
    if plan_keys is None:
        plan_keys = _sample_pair_plan(list(stacks), include, exclude)
    plan = [((k1, k2, i1, i2), stacks[k1, i1], stacks[k2, i2])
            for k1, k2, i1, i2 in plan_keys]

    # pass 2 (device): every sample's pair grid, batched
    grids, slot = _cross_grids(plan, nsamples, lmax, mesh=mesh, split=0)
    device = (_compute_device(a for _, a1, a2 in plan for a in (a1, a2))
              if mesh is None else mesh.devices.flat[0])

    # pass 3 (host): per-sample metadata, bias, Result assembly
    outs = [TocDict() for _ in range(nsamples)]
    with tracing.span("twopoint.results"):
        for key, a1, a2 in plan:
            k1, k2, i1, i2 = key
            block = _grid_block(grids, slot, a1, a2)
            for s in range(nsamples):
                outs[s][key] = _pair_result(key, np.array(block[s]),
                                            metadata[k1, i1],
                                            metadata[k2, i2], debias, bins,
                                            weights, device)
    return outs


def debias_cls(cls, bias=None, *, inplace=False, device="cuda"):
    """Remove (metadata or explicit) noise bias from every cl; a pixel
    window that has to be computed is computed on ``device``."""
    out = cls if inplace else TocDict()
    for key in cls:
        out[key] = _debias_cl(cls[key], bias and bias.get(key),
                              inplace=inplace, device=device)
    return out


def _compute_device(values):
    """The first device of ``values`` (tensors or numpy) off the host, else
    the CPU: where a pair grid of them runs."""
    return next((v.device for v in values
                 if isinstance(v, torch.Tensor) and v.device.type != "cpu"),
                torch.device("cpu"))


# -- mixing matrices ------------------------------------------------------


@functools.lru_cache(maxsize=4)
def _leggauss(npoints):
    """Cached Gauss-Legendre rule: numpy's eigen-solve takes seconds at the
    production 4501 nodes, and every spin combination shares the rule."""
    tracing.built("twopoint.leggauss")
    with tracing.span("twopoint.leggauss"):
        return np.polynomial.legendre.leggauss(npoints)


def _gl_nodes(npoints):
    """Gauss-Legendre nodes, weights and colatitudes arccos(x), host f64."""
    x, w = _leggauss(npoints)
    return x, w, np.arccos(x)


@functools.lru_cache(maxsize=16)
def _mixmat_tables(l1max, l2max, s1, s2, npoints, device, block=None):
    """Device-resident float64 Wigner-d tables on the GL nodes.

    d^{l1}_{-s1,-s2} (K, l1max+1) and d^{l2}_{s1,s2} (K, l2max+1), built
    once per (sizes, spins, device) by the host-f64 recurrence, transposed
    once to the node-major layout the Gram kernel reads, and kept on the
    device across masks: the tables are mask-independent, only the node
    weights change per call.  ``block=(i, n)``: only the nodes of block i
    of n (:func:`_node_block`).
    """
    tracing.built("twopoint.mixmat_tables")
    with tracing.span("twopoint.mixmat_tables"):
        _, _, theta = _gl_nodes(npoints)
        if block is not None:
            theta = _node_block(theta, *block, fill=np.pi / 2)

        def upload(m, n, lmax):
            table = wigner_table_host(m, n, theta, lmax)
            return tracing.upload("twopoint.mixmat_tables",
                                  np.ascontiguousarray(table.T), device)

        A = upload(s1, s2, l1max)
        B = (A if (s1, s2, l1max) == (-s1, -s2, l2max)
             else upload(-s1, -s2, l2max))
        return A, B


def _node_block(a, i, n, fill=0.0):
    """Block i of n equal contiguous blocks of the node axis of ``a``, the
    axis padded with ``fill`` to a multiple of n."""
    per = -(-a.shape[0] // n)
    out = np.full(per, fill)
    part = a[i * per:(i + 1) * per]
    out[: part.shape[0]] = part
    return out


def _mixmat_operands(cl3, l1max, l2max, s1, s2, eb, device, block=None,
                     weights=None):
    """The Gram operands of one mixing matrix's GL quadrature.

    Returns the device tables ``(A, B)`` and the node weights: ``(w xi,)``
    or, for the E/B blocks, ``(w xi_even, w xi_odd)``, as float64 device
    vectors, with xi the mask correlation sum (2l+1)/4pi cl3 P_l at the
    nodes.  ``block=(i, n)``: the operands of the nodes of block i of n,
    the padding nodes at x = 0 with zero weight.  ``weights``: the host
    node weights of :func:`_mixmat_weights`, where already computed.
    """
    l3max = cl3.shape[-1] - 1
    npoints = (l1max + l2max + l3max) // 2 + 1
    A, B = _mixmat_tables(l1max, l2max, s1, s2, npoints, device, block)
    us = _mixmat_weights(cl3, l1max, l2max, eb) if weights is None else weights
    if block is not None:
        us = [_node_block(u, *block) for u in us]
    # staged at once: the copy waits for no work queued on the card
    tracing.copied("twopoint.mixmat_operands", "h2d", device, len(us))
    return A, B, [torch.as_tensor(u).to(device, non_blocking=True)
                  for u in us]


def _mixmat_weights(cl3, l1max, l2max, eb):
    """Host float64 node weights of the GL quadrature: ``(w xi,)`` or
    ``(w xi_even, w xi_odd)``."""
    l3max = cl3.shape[-1] - 1
    npoints = (l1max + l2max + l3max) // 2 + 1
    x, w, _ = _gl_nodes(npoints)
    ells3 = np.arange(l3max + 1, dtype=np.float64)
    xi = legendre_sum_host((2 * ells3 + 1) / (4 * np.pi) * cl3, x)
    if eb:
        # GL nodes are symmetric (x[::-1] == -x), so the even/odd parts of
        # xi split the integral by (l1 + l2) parity exactly
        xi_e = 0.5 * (xi + xi[::-1])
        xi_o = 0.5 * (xi - xi[::-1])
        return w * xi_e, w * xi_o
    return (w * xi,)


def _mixmat_gl_dispatch(cl3, l1max, l2max, s1, s2, eb, device, mesh=None):
    """Float64 GL quadrature of one mixing matrix; returns a finalize callable.

    The contractions are launched on ``device`` (asynchronously on a card)
    and the matrix is assembled there; the returned zero-argument callable
    copies it to the host.  The E/B blocks are parity-filtered at the
    integrand: M_plus / M_minus for (l1 + l2) even / odd are separate
    contractions against the even / odd parts of xi, so the small M_minus
    (EE -> BB leakage) entries come out at the contraction's own precision
    instead of eps * |M_plus|.

    With a device ``mesh`` the nodes are split into one block per shard:
    each shard builds its nodes' tables on its device and contracts them,
    and the float64 partials are summed on the mesh's first device.
    """
    if mesh is None:
        A, B, us = _mixmat_operands(cl3, l1max, l2max, s1, s2, eb, device)
        Gs = [gram.gram(A, B, u) for u in us]
    else:
        from .parallel import _psum

        devices = list(mesh.devices.flat)
        device = devices[0]
        weights = _mixmat_weights(cl3, l1max, l2max, eb)

        shards = [_mixmat_operands(cl3, l1max, l2max, s1, s2, eb, d,
                                   (i, len(devices)), weights)
                  for i, d in enumerate(devices)]
        Gs = [_psum([gram.gram(A, B, us[k]) for A, B, us in shards], devices,
                    dest=device)
              for k in range(len(weights))]
    ells2 = np.arange(l2max + 1, dtype=np.float64)
    pref = tracing.upload("twopoint.mixmat",
                          2 * np.pi * (2 * ells2 + 1) / (4 * np.pi), device)
    if not eb:
        M = Gs[0] * pref
    else:
        G_e, G_o = Gs
        ells1 = torch.arange(l1max + 1, device=device)
        even = (ells1[:, None] + torch.arange(l2max + 1, device=device)) % 2 == 0
        M_plus = torch.where(even, G_e, G_o) * pref
        M_minus = torch.where(even, G_o, G_e) * pref
        M = torch.stack([M_plus, M_minus, M_plus - M_minus])
    return lambda: tracing.to_host("twopoint.mixmat", M)


def _mixmat_dispatch(cl, *, l1max, l2max, l3max, spin, eb, device,
                     mesh=None):
    """Shared mixmat/mixmat_eb preprocessing; returns a finalize callable.

    Every cl dtype is computed in float64 (float32 converts exactly) and
    the matrix is float64, as both paths of the reference return it.
    """
    cl = tracing.to_host("twopoint.mixmat", _tensor(cl))
    if l3max is not None:
        cl = cl[..., : l3max + 1]
    lmax_default = cl.shape[-1] - 1
    l1max = lmax_default if l1max is None else int(l1max)
    l2max = lmax_default if l2max is None else int(l2max)
    s1, s2 = spin
    return _mixmat_gl_dispatch(np.asarray(cl, np.float64), l1max, l2max,
                               abs(s1), abs(s2), eb, torch.device(device),
                               mesh)


@tracing.spanned("twopoint.mixmat")
def mixmat(cl, *, l1max=None, l2max=None, l3max=None, spin=(0, 0),
           device="cuda", mesh=None):
    """MASTER mixing matrix M[l1, l2] for a (possibly spin-weighted) pair.

    Equivalent of ``convolvecl.mixmat``: M = (2 l2+1)/4pi sum_l3 (2 l3+1)
    cl[l3] (3j(l1,l2,l3; -s1,s1,0))(3j(l1,l2,l3; -s2,s2,0)).  Computed on
    ``device`` (default the CUDA card), or with the quadrature nodes split
    over every shard of a device ``mesh``; returns a host float64 array.
    """
    return _mixmat_dispatch(
        cl, l1max=l1max, l2max=l2max, l3max=l3max, spin=spin, eb=False,
        device=device, mesh=mesh,
    )()


@tracing.spanned("twopoint.mixmat_eb")
def mixmat_eb(cl, *, l1max=None, l2max=None, l3max=None, spin=(2, 2),
              device="cuda", mesh=None):
    """E/B mixing-matrix blocks (EE<->EE, EE<->BB, EB<->EB) for spin pairs.

    Equivalent of ``convolvecl.mixmat_eb``; the EB block equals
    M_plus - M_minus, consistent with the block-diagonal inversion of
    :func:`invert_mixing_matrix`.  Computed on ``device`` (default the CUDA
    card) or over a device ``mesh`` (as :func:`mixmat`); returns a host
    (3, l1max+1, l2max+1) float64 array.
    """
    return _mixmat_dispatch(
        cl, l1max=l1max, l2max=l2max, l3max=l3max, spin=spin, eb=True,
        device=device, mesh=mesh,
    )()


def _fields_device(fields):
    """Device of the first field whose mapper has one, else the CUDA card."""
    for field in fields:
        device = getattr(getattr(field, "mapper", None), "device", None)
        if device is not None:
            return torch.device(device)
    return torch.device("cuda")


@tracing.spanned("twopoint.mixing_matrices")
def mixing_matrices(
    fields,
    cls,
    *,
    l1max=None,
    l2max=None,
    l3max=None,
    bins=None,
    weights=None,
    out=None,
    progress=None,
    device=None,
    mesh=None,
):
    """Mixing matrices for all field pairs covered by the given mask cls.

    ``cls`` are mask (cross-)spectra keyed (mask1, mask2, bin1, bin2);
    fields are matched through their ``mask`` attribute.  The result is
    keyed (field1, field2, bin1, bin2) and wrapped as a Result with the
    *output* ell on axis -2.  The contractions run on ``device``, by
    default the device of the matched fields' mappers (the CUDA card when
    they have none), or over a device ``mesh`` (see :func:`mixmat`).
    """
    if out is None:
        out = TocDict()
    if progress is None:
        progress = NoProgress()

    masks = {}
    for key, field in fields.items():
        if field.mask is not None:
            masks.setdefault(field.mask, {})[key] = field
    if device is None:
        device = _fields_device(f for fs in masks.values() for f in fs.values())

    # phase 1: dispatch every pair's device contractions, so that later
    # pairs' host work (mask correlation, tables) overlaps earlier kernels
    done = set()
    pending = []
    current, total = 0, len(cls)
    for (k1, k2, i1, i2), cl in cls.items():
        current += 1
        progress.update(current, total)
        try:
            fields1 = masks[k1]
            fields2 = masks[k2]
        except KeyError:
            continue
        for f1, f2 in product(fields1, fields2):
            if (f1, f2, i1, i2) in done or (f2, f1, i2, i1) in done:
                continue
            done.add((f1, f2, i1, i2))
            spin1, spin2 = fields1[f1].spin, fields2[f2].spin
            finalize = _mixmat_dispatch(
                cl,
                l1max=l1max,
                l2max=l2max,
                l3max=l3max,
                spin=(spin1, spin2),
                eb=not (spin1 == 0 or spin2 == 0),
                device=device,
                mesh=mesh,
            )
            pending.append(((f1, f2, i1, i2), (spin1, spin2), finalize))

    # phase 2: materialise, in dispatch order
    for key, spins, finalize in pending:
        with progress.task(f"({key[0]}, {key[1]}, {key[2]}, {key[3]})"):
            mm = finalize()
            ell = np.arange(mm.shape[-2])
            result = Result(mm, spin=spins, ell=ell, axis=-2)
            if bins is not None:
                result = binned(result, bins, weights)
            out[key] = result
            del mm
    return out


@tracing.spanned("twopoint.pinv")
def _pinv_batch(a, rcond, device):
    """Batched rcond-cut pseudo-inverse of a host (k, n, m) float64 stack.

    One ``torch.linalg.pinv`` call on ``device``: ``rtol`` cuts singular
    values relative to the largest, which is what ``rcond`` means to the
    reference.  The spin-2 blocks (M+, M-, EB) invert independently.
    """
    a = tracing.upload("twopoint.pinv", np.array(a, np.float64), device)
    return tracing.to_host("twopoint.pinv", torch.linalg.pinv(a, rtol=rcond))


def invert_mixing_matrix(M, rcond=1e-5, progress=None, *, device="cuda"):
    """Pseudo-inverses of mixing matrices.

    For spin2 x spin2, the (EE, BB) sector is block-diagonalised by the
    M+ = M_EE + M_BB / M- = M_EE - M_BB transformation before pinv and
    recombined; EB inverts independently.  ``rcond`` is a number or a
    mapping of keys to numbers.  The pseudo-inverses of a key run as one
    batched call on ``device`` (default the CUDA card).
    """
    if progress is None:
        progress = NoProgress()
    device = torch.device(device)

    inv = {}
    current, total = 0, len(M)
    for key, value in M.items():
        current += 1
        progress.update(current, total)
        arr = value.array
        s1, s2 = value.spin
        *_, n, m = arr.shape
        if isinstance(rcond, Mapping):
            if key not in rcond:
                raise KeyError(f"Missing rcond value for wm key: {key}")
            rc = rcond[key]
        else:
            rc = rcond
        with progress.task(f"invert {key}"):
            ahost = np.asarray(arr, np.float64)
            if s1 != 0 and s2 != 0:
                blocks = np.stack(
                    [ahost[0] + ahost[1], ahost[0] - ahost[1], ahost[2]]
                )
                inv_p, inv_m, inv_eb = _pinv_batch(blocks, rc, device)
                inv_ee = (inv_p + inv_m) / 2
                inv_bb = (inv_p - inv_m) / 2
                arr_inv = np.array([inv_ee, inv_bb, inv_eb])
            else:
                arr_inv = _pinv_batch(ahost[None], rc, device)[0]
            if n != m:
                # pinv swaps input/output ell axes; rebuild angular arrays
                axis = value.axis[0]
                out_size = arr_inv.shape[axis]
                inv[key] = replace(
                    value,
                    array=arr_inv,
                    ell=np.arange(out_size),
                    lower=np.arange(out_size),
                    upper=np.arange(1, out_size + 1),
                    weight=np.ones(out_size),
                )
            else:
                inv[key] = replace(value, array=arr_inv)
    return inv


def apply_mixing_matrix(d, M):
    """Apply mixing matrices to data cls (block E/B handling for spin-2)."""
    out = {}
    for key in d.keys():
        dtype = d[key].array.dtype
        s1, s2 = d[key].spin
        data = np.atleast_2d(d[key].array)
        mat = M[key].array
        ell = get_result_array(M[key], "ell")[0]
        lower = get_result_array(M[key], "lower")[0]
        upper = get_result_array(M[key], "upper")[0]
        weight = get_result_array(M[key], "weight")[0]
        if s1 != 0 and s2 != 0:
            ee = mat[0] @ data[0, 0] + mat[1] @ data[1, 1]
            bb = mat[1] @ data[0, 0] + mat[0] @ data[1, 1]
            eb = mat[2] @ data[0, 1]
            be = mat[2] @ data[1, 0]
            mixed = np.array([[ee, eb], [be, bb]])
        else:
            mixed = np.squeeze(np.array([mat @ cl for cl in data]))
        mixed = np.asarray(mixed, dtype=dtype)
        out[key] = replace(
            d[key], array=mixed, ell=ell, lower=lower, upper=upper, weight=weight
        )
    return out
