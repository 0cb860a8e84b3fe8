"""Folded Wigner-d analysis and synthesis: the Hopper kernels and their dispatch.

Counterpart of :mod:`heracles_tpu.ops.pallas_sht`.
:func:`analysis_spin0_folded`, :func:`analysis_pair_folded`,
:func:`synthesis_spin0_folded` and :func:`synthesis_pair_folded` keep the
signatures and return layouts of their Pallas twins, ``dd``, ``x_lo``
and ``nb`` included, minus the arguments that tune the TPU or emulate
float64 seeds on it (``interpret``, ``contract``, ``skip``,
``ring_block``, ``m_chunk``, ``l_chunk``, ``seed_planes``, ``logch_lo``
and ``logsh_lo``: the kernels read the logs in float64).  The tensor
decides the path:

* a CPU tensor takes the plain version (:mod:`.wigner`);
* a CUDA tensor launches the hand-written kernel
  (``heracles_tpu_torch/csrc/sht_analysis.cu``, ``sht_analysis_pair.cu``,
  ``sht_synthesis.cu``, ``sht_synthesis_pair.cu``, built at first use by
  :mod:`._build`), or raises;
* complex64 input runs the float32 kernel, complex128 the float64 one;
  on complex64, ``dd=True`` runs the float64 kernel and returns complex64,
  and ``dd="comp"`` the compensated float32 kernel (the twin of the
  reference's ``_*_comp`` bodies), whose second stream per column corrects
  the float32 truncation of cos(theta) from ``x_lo``, the float32 residual
  of float64 cos(theta) (None: a zero stream, the plain kernel's values).
  complex128 ignores ``dd``.

All four run a batch of B maps in groups of ``nb``, the twin of the
reference's ``nb`` program: one block per (order, group) runs the Wigner
recurrence once and contracts it against every map of the group (the
analyses) or sums it against every map's alms (the syntheses).  The
syntheses take each map's sums in the order of the ``nb = 1`` kernel, so
every ``nb`` gives their numbers bit for bit.  The analyses' groups
contract on the tensor cores (3xTF32 in float32 and comp, float64 DMMA:
``csrc/tc_contract.cuh``), summing in another order: each ``nb > 1``
repeats its own bits from launch to launch and agrees with ``nb = 1`` and
the plain version within the float32 or float64 bar, not bit for bit.
``nb=None`` picks the group with :func:`pick_nb`; an ``nb`` that has no
instantiation (``wigner.GROUP_SIZES``) or does not divide B raises
ValueError on every device.

No kernel's shared memory grows with lmax; the one bound on it is
``LMAX_LIMIT``.  ``LAUNCHES`` counts kernel launches per kernel name,
``LAUNCHES_BY_PRECISION`` the same launches per (name, "f32", "f64" or
"f32c", the compensated kernel), ``LAUNCHES_BY_NB`` per (name, nb).
:func:`path_counts` is a diagnostic launch of the spin-0 analysis, of the
pair analysis' groups of maps or of either synthesis, plain or comp,
that tells which share of the work ran on each of the kernel's paths.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tracing
from . import wigner

__all__ = [
    "analysis_spin0_folded",
    "analysis_pair_folded",
    "synthesis_spin0_folded",
    "synthesis_pair_folded",
    "path_counts",
    "PATH_GROUPS",
    "LAUNCHES",
    "LAUNCHES_BY_PRECISION",
    "LAUNCHES_BY_NB",
    "LMAX_LIMIT",
    "NB_SIZES",
    "pick_nb",
    "reset_counts",
]

LAUNCHES = tracing.counter("sht_kernels.LAUNCHES")
LAUNCHES_BY_PRECISION = tracing.counter("sht_kernels.LAUNCHES_BY_PRECISION")
LAUNCHES_BY_NB = tracing.counter("sht_kernels.LAUNCHES_BY_NB")

# the kernels' dead path (csrc/sht_paths.cuh) rests on a step of the
# recurrence growing a value by less than sqrt(2 lmax) + 2 < 2^8.1: 8 steps
# without a rescale then stay clear of float32's overflow
LMAX_LIMIT = 32767

_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def reset_counts():
    """Zero every counter of :mod:`..tracing` (the kernel launch counts,
    the plain-version run counts, the host waits, copies and table
    builds)."""
    tracing.reset()


# the groups of maps pick_nb may take, by kernel and precision ("f32c":
# the compensated float32 kernel); pick_nb's docstring has the times and
# the rule they rest on
NB_SIZES = {
    "analysis_spin0_folded": {"f32": (1, 4), "f64": (1, 4),
                              "f32c": (1, 2, 4, 8)},
    "analysis_pair_folded": {"f32": (1, 2, 4), "f64": (1, 2, 4),
                             "f32c": (1, 2, 4)},
    "synthesis_spin0_folded": {"f32": (1, 2, 4), "f64": (1, 2, 4),
                               "f32c": (1, 2, 4)},
    "synthesis_pair_folded": {"f32": (1, 2, 4), "f64": (1, 2, 4),
                              "f32c": (1, 2, 4)},
}

# the groups of maps whose kernel has a counting twin (path_counts): the
# pair analysis' grouped kernel, the others' nb = 1 kernel
PATH_GROUPS = {
    "analysis_spin0_folded": (1,),
    "analysis_pair_folded": (2, 4),
    "synthesis_spin0_folded": (1,),
    "synthesis_pair_folded": (1,),
}


def pick_nb(B, lmax, name, precision="f32"):
    """The group of maps of a launch on a batch of ``B``: the largest
    ``nb`` of ``NB_SIZES[name][precision]`` that divides ``B`` (1 for
    B = 1, or where none larger does).

    The sizes follow the card's times of a batch of 8 at two sizes
    (``tools/sht_kernel_bench.py --batch 8 --nb 1,2,4,8 [--double |
    --comp]``, one NVIDIA H100 80GB HBM3 at 700 W, best of 3; each row
    from one run): a group is allowed where, at both sizes, it runs
    within 5% of every smaller allowed group (nb 1 always is).  ms a
    launch at nside 1024, lmax 1536 (allowed groups starred):

    ========== ====== ====== ====== ======  =====================
    kernel     nb 1   nb 2   nb 4   nb 8    resident blocks / SM
    ========== ====== ====== ====== ======  =====================
    B1 f32     9.54*  10.44  5.49*  5.96    6, 6, 4, 2
    B1 f64     15.33* 14.88  9.93*  11.93   3, 3, 2, 1
    B1 comp    17.56* 12.83* 6.72*  6.74*   5, 6, 4, 2
    B2 f32     23.43* 18.80* 12.90*         4, 4, 2
    B2 f64     37.23* 31.33* 25.66*         2, 2, 1
    B2 comp    36.58* 23.86* 15.13*         3, 4, 2
    B3 f32     6.74*  4.53*  3.60*  4.14    7, 5, 5, 5
    B3 f64     9.98*  7.08*  5.55*  6.79    5, 3, 3, 3
    B3 comp    10.87* 6.86*  4.86*  4.62    6, 5, 5, 5
    B4 f32     17.77* 12.17* 10.77*         4, 4, 4
    B4 f64     29.40* 19.46* 18.11*         2, 2, 2
    B4 comp    34.32* 16.33* 13.04*         3, 4, 4
    ========== ====== ====== ====== ======  =====================

    At nside 4096, lmax 3000 on 8 maps: B1 115.30 / 134.43 / 72.65 /
    79.29 ms (f32), 186.40 / 210.08 / 134.79 / 166.56 (f64), 222.79 /
    174.62 / 87.95 / 86.47 (comp) at nb 1 / 2 / 4 / 8; B2 323.07 /
    255.02 / 168.64 (f32), 532.13 / 440.62 / 356.94 (f64), 516.54 /
    320.90 / 197.68 (comp) at nb 1 / 2 / 4.  The analyses' groups
    contract on the tensor cores, a cost of each group whatever its nb,
    so B1's nb 2 (its 8 rows fill half of each product) loses to nb 1
    in float32 at both sizes and in float64 at nside 4096, and nb 8 (2
    blocks an SM) loses to nb 4 in float32 and float64.  A synthesis group keeps
    its sums in registers and owns fewer rings a thread as nb grows, so
    a block's tile of rings shrinks and each tile reads the order's alm
    column again: B3's nb 8 (a tile of 128 rings) loses at nside 1024
    in float32 and float64, and in comp at nside 4096, lmax 3000 on 8
    maps (B3 comp 143.01 / 83.18 / 58.34 / 77.81 ms at nb 1 / 2 / 4 /
    8), where B4's float32 nb 4 stays within 5% of nb 2 (220.24 / 163.19
    / 170.25 ms).  ``lmax`` is the reference's argument (its limit came
    from the TPU's VMEM); no kernel's shared memory grows with it on the
    card, so the rule does not read it.
    """
    del lmax
    return max(nb for nb in NB_SIZES[name][precision] if B % nb == 0)


def _group(name, nb, F, lmax, dd):
    """The group size of a call on the spectra or alms ``F``: ``nb``
    checked, or :func:`pick_nb`'s for None."""
    B = int(np.prod(F.shape[:-2], dtype=np.int64))
    if nb is None:
        mode = _mode(dd, F.dtype)
        precision = ("f64" if F.dtype == torch.complex128 or mode == "f64"
                     else "f32c" if mode == "comp" else "f32")
        return pick_nb(B, lmax, name, precision)
    return wigner.check_group(name, int(nb), B)


def _mode(dd, dtype):
    """How a transform of ``dtype`` runs for the reference's ``dd``: "f64"
    (complex64 with dd=True: the float64 kernel, complex64 returned),
    "comp" (complex64 with dd="comp") or None (as the dtype says)."""
    if dtype != torch.complex64 or not dd:
        return None
    return "comp" if isinstance(dd, str) and dd == "comp" else "f64"


def _run(mode, x, x_lo, inputs, plain, launch):
    """A kernel's outputs, as a tuple, in ``mode`` (:func:`_mode`).

    ``plain(*inputs, x_lo=)`` is its plain version (CPU tensors) and
    ``launch(inputs, x_lo)`` its launch (CUDA tensors), each with the rest
    of the call bound.  "f64" widens the inputs to complex128 and narrows
    the outputs back; "comp" passes ``x_lo``, zeros for None (the
    reference's zero stream), and the other modes pass None.
    """
    if mode == "f64":
        inputs = tuple(a.to(torch.complex128) for a in inputs)
    if mode != "comp":
        x_lo = None
    elif x_lo is None:
        x_lo = torch.zeros(x.shape, dtype=torch.float32)
    if inputs[0].device.type == "cpu":
        out = plain(*inputs, x_lo=x_lo)
    else:
        out = launch(inputs, x_lo)
    out = tuple(out) if isinstance(out, (tuple, list)) else (out,)
    if mode == "f64":
        out = tuple(o.to(torch.complex64) for o in out)
    return out


@functools.lru_cache(maxsize=16)
def _seed_planes(m0, nm, spin):
    ms = m0 + np.arange(nm)
    if spin is None:
        return wigner.spin0_seed_planes(ms)
    return wigner.pair_seed_planes(ms, spin)


def _check(name, what, arrays, rows, rings, nhalf):
    """Raise on inputs a kernel does not take.

    ``arrays`` must share dtype (complex64 or complex128), shape and
    device and be (..., rows, nm); the ring vectors ``rings`` must be
    (nhalf,).
    """
    F0 = arrays[0]
    if F0.dtype not in _REAL:
        raise TypeError(f"{name}: expected complex64 or complex128 {what}, "
                        f"got {F0.dtype}")
    for F in arrays[1:]:
        if F.shape != F0.shape or F.dtype != F0.dtype or F.device != F0.device:
            raise ValueError(f"{name}: {what} differ in shape, dtype or "
                             "device")
    if F0.dim() < 2 or F0.shape[-2] != rows:
        raise ValueError(f"{name}: {what} must be (..., {rows}, nm), "
                         f"got {tuple(F0.shape)}")
    for v in rings:
        if tuple(v.shape) != (nhalf,):
            raise ValueError(f"{name}: ring vectors must have shape "
                             f"({nhalf},), got {tuple(v.shape)}")
    if F0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {F0.device}")


def _launch(name, inputs, x, logch, logsh, lmax, spin, out_rows, nout,
            m0=0, paths=False, x_lo=None, nb=1):
    """Launch one kernel on CUDA tensors; returns its ``nout`` outputs.

    ``name`` is ``{analysis,synthesis}_{spin0,pair}_folded``; ``inputs``
    are its (..., rows, nm) complex operands, column c being the order
    m0 + c, and each output is (..., out_rows, nm).  ``x_lo`` (complex64
    only) launches the compensated float32 instantiation, with each
    ring's r = x_lo / x_hi (:func:`wigner.comp_ratio`).  ``nb``: the
    group of maps (checked by the caller).  ``paths=True``
    launches the kernel's diagnostic twin instead (float32 only, at an
    ``nb`` of ``PATH_GROUPS``; not counted in ``LAUNCHES``) and returns
    its three path counts as an int64 tensor.
    """
    from . import _build

    if lmax > LMAX_LIMIT:
        raise ValueError(f"{name}: lmax={lmax} is above {LMAX_LIMIT}")
    if m0 < 0:
        raise ValueError(f"{name}: m0={m0} is negative")
    kl = _build.load_library()
    direction = name.split("_")[0]
    pair = spin is not None
    comp = x_lo is not None
    A = inputs[0]
    dev = A.device
    real = _REAL[A.dtype]
    is_double = real == torch.float64
    if (paths or comp) and is_double:
        raise TypeError(f"{name}: the path counts and the comp kernel are "
                        "float32 launches")
    batch = A.shape[:-2]
    rows, nm = A.shape[-2:]
    B = int(np.prod(batch, dtype=np.int64))
    flat = [F.reshape(B, rows, nm).resolve_conj().resolve_neg().contiguous()
            for F in inputs]
    xv = x.to(device=dev, dtype=real).contiguous()
    xr = [wigner.comp_ratio(x, x_lo, dev).contiguous()] if comp else []
    lch = logch.to(device=dev, dtype=torch.float64).contiguous()
    lsh = logsh.to(device=dev, dtype=torch.float64).contiguous()
    # staged at once: the copy waits for no work queued on the card
    tracing.built("sht_kernels.seed_planes")
    tracing.copied("sht_kernels.seed_planes", "h2d", dev)
    seed = torch.as_tensor(_seed_planes(m0, nm, spin)).to(dev,
                                                          non_blocking=True)
    outs = [torch.empty((B, out_rows, nm), dtype=A.dtype, device=dev)
            for _ in range(nout)]
    prec = "f64" if is_double else ("f32c" if comp else "f32")
    fn = getattr(kl.lib, f"heracles_{direction}_{'pair' if pair else 'spin0'}_"
                         f"{'comp_' if comp else ''}"
                         f"{'paths_' if paths else ''}"
                         f"{'f64' if is_double else 'f32'}")
    counts = [torch.zeros(3, dtype=torch.int64, device=dev)] if paths else []
    ints = ((B, x.shape[0], nm, lmax) + ((int(spin),) if pair else ())
            + (m0, nb))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in flat), xv.data_ptr(),
                 *(t.data_ptr() for t in xr), lch.data_ptr(),
                 lsh.data_ptr(), seed.data_ptr(),
                 *(o.data_ptr() for o in outs + counts), *ints, stream)
    kl.check(err)
    if paths:
        return counts[0]
    LAUNCHES[name] += 1
    LAUNCHES_BY_PRECISION[name, prec] += 1
    LAUNCHES_BY_NB[name, nb] += 1
    return [o.reshape(batch + (out_rows, nm)) for o in outs]


def path_counts(name, *args, m0=0, dd=False, x_lo=None, nb=None):
    """Sub-chunks of 8 multipoles that the warps of one launch ran on the
    steady, the dead and the full path: a dict of three ints.

    ``name`` is ``"analysis_spin0_folded"``, ``"analysis_pair_folded"``,
    ``"synthesis_spin0_folded"`` or ``"synthesis_pair_folded"`` and
    ``args``, ``m0``, ``dd`` and ``x_lo`` are that function's own,
    complex64 tensors on the card (``dd="comp"`` counts the compensated
    kernel's paths).  ``nb``: one of ``PATH_GROUPS[name]``, the groups
    whose kernel has a counting twin (None: the largest of them that
    divides the batch and is at most :func:`pick_nb`'s).  A diagnostic
    twin of the kernel runs (the same code with three counters); its
    outputs are dropped and ``LAUNCHES`` does not count it.
    """
    if args[0].device.type != "cuda":
        raise ValueError("path_counts: the tensors must lie on the card")
    if name not in PATH_GROUPS:
        raise ValueError(f"path_counts: {name} has no path counts")
    if name == "analysis_pair_folded":
        FNp, Sp, FNm, Sm, x, logch, logsh, lmax, spin = args
        inputs, what, rows, nout = (FNp, Sp, FNm, Sm), "spectra", x.shape[0], 2
        spin, out_rows = abs(int(spin)), int(lmax) + 1
    elif name == "analysis_spin0_folded":
        Fe, Fo, x, logch, logsh, lmax = args
        inputs, spin, what, rows, nout = (Fe, Fo), None, "spectra", x.shape[0], 1
        out_rows = int(lmax) + 1
    elif name == "synthesis_spin0_folded":
        alm, x, logch, logsh, lmax = args
        inputs, spin, what, rows, nout = (alm,), None, "alms", int(lmax) + 1, 2
        out_rows = x.shape[0]
    elif name == "synthesis_pair_folded":
        alm_p, alm_m, x, logch, logsh, lmax, spin = args
        inputs, what, rows, nout = (alm_p, alm_m), "alms", int(lmax) + 1, 4
        spin, out_rows = abs(int(spin)), x.shape[0]
    _check(name, what, inputs, rows, (x, logch, logsh), x.shape[0])
    sizes = PATH_GROUPS[name]
    B = int(np.prod(inputs[0].shape[:-2], dtype=np.int64))
    if nb is None:
        top = _group(name, None, inputs[0], int(lmax), dd)
        nb = max((s for s in sizes if s <= top and B % s == 0), default=None)
    if nb not in sizes:
        raise ValueError(f"path_counts: {name} counts its paths at nb in "
                         f"{sizes}, not {nb}")
    wigner.check_group(name, nb, B)
    if dd == "comp":
        x_lo = torch.zeros(x.shape) if x_lo is None else x_lo
    elif dd:
        raise TypeError("path_counts: the path counts are float32 launches")
    else:
        x_lo = None
    counts = _launch(name, inputs, x, logch, logsh, int(lmax), spin, out_rows,
                     nout, m0=int(m0), paths=True, x_lo=x_lo, nb=nb)
    tracing.synced("sht_kernels.path_counts", counts)
    tracing.copied("sht_kernels.path_counts", "d2h", counts)
    return dict(zip(("steady", "dead", "full"), counts.tolist()))


@tracing.spanned("sht_kernels.analysis_spin0_folded")
def analysis_spin0_folded(Fe, Fo, x, logch, logsh, lmax, m0=0, *, dd=False,
                          x_lo=None, nb=None):
    """alm[..., l, m] = sum_r lam_lm(x_r) (Fe on even l, Fo on odd l)[..., r, m].

    ``Fe``/``Fo``: (..., nhalf, nm) complex parity-combined northern ring
    spectra (FN + FS and FN - FS, with FS the (-1)^m-signed mirrored
    southern rows); ``x``: (nhalf,) cos(theta); ``logch``/``logsh``:
    (nhalf,) log cos(theta/2), log sin(theta/2), read in float64 (pass
    float64 values for full seed accuracy).  Column c is the order
    ``m0`` + c (a device mesh's block of orders); an order above lmax
    gives zeros.  ``dd`` and ``x_lo`` as the reference's (module
    docstring); ``nb``: the maps of the batch that share one recurrence
    (None: :func:`pick_nb`), the same numbers for every ``nb``.  Returns
    (..., lmax+1, nm).
    """
    name = "analysis_spin0_folded"
    nhalf = x.shape[0]
    _check(name, "spectra", (Fe, Fo), nhalf, (x, logch, logsh), nhalf)
    m0, lmax = int(m0), int(lmax)
    nb = _group(name, nb, Fe, lmax, dd)
    (alm,) = _run(
        _mode(dd, Fe.dtype), x, x_lo, (Fe, Fo),
        lambda *F, x_lo: wigner.analysis_spin0_folded_plain(
            *F, x, logch, logsh, lmax, m0, x_lo=x_lo, nb=nb),
        lambda F, x_lo: _launch(name, F, x, logch, logsh, lmax, None,
                                lmax + 1, 1, m0=m0, x_lo=x_lo, nb=nb))
    return alm


@tracing.spanned("sht_kernels.analysis_pair_folded")
def analysis_pair_folded(FNp, Sp, FNm, Sm, x, logch, logsh, lmax, spin,
                         m0=0, *, dd=False, x_lo=None, nb=None):
    """Folded spin-pair analysis; returns (alm_p, alm_m).

    a_p[l] = sum_r lam_p FNp + (-1)^l lam_m Sp and
    a_m[l] = sum_r lam_m FNm + (-1)^l lam_p Sm, with lam_p / lam_m the
    slm columns n = +spin / -spin.  ``FN*``: (..., nhalf, nm) northern
    rows of each branch; ``S*``: the partner-paired (-1)^m-signed southern
    rows.  Column c is the order ``m0`` + c.  ``dd``, ``x_lo`` and ``nb``
    as for :func:`analysis_spin0_folded`.  Each output is
    (..., lmax+1, nm).
    """
    name = "analysis_pair_folded"
    nhalf = x.shape[0]
    _check(name, "spectra", (FNp, Sp, FNm, Sm), nhalf, (x, logch, logsh),
           nhalf)
    spin, m0, lmax = abs(int(spin)), int(m0), int(lmax)
    nb = _group(name, nb, FNp, lmax, dd)
    return _run(
        _mode(dd, FNp.dtype), x, x_lo, (FNp, Sp, FNm, Sm),
        lambda *F, x_lo: wigner.analysis_pair_folded_plain(
            *F, x, logch, logsh, lmax, spin, m0, x_lo=x_lo, nb=nb),
        lambda F, x_lo: _launch(name, F, x, logch, logsh, lmax, spin,
                                lmax + 1, 2, m0=m0, x_lo=x_lo, nb=nb))


@tracing.spanned("sht_kernels.synthesis_spin0_folded")
def synthesis_spin0_folded(alm, x, logch, logsh, lmax, m0=0, *, dd=False,
                           x_lo=None, nb=None):
    """Folded spin-0 synthesis: rectangular alm -> (GN, GS) ring spectra.

    ``alm``: (..., lmax+1, nm) complex; ``x``/``logch``/``logsh``: (nhalf,)
    northern-ring geometry as for :func:`analysis_spin0_folded`.  Returns
    GN = sum_l alm lam (the northern rings) and GS = (-1)^m sum_l (-1)^l
    alm lam (their mirrored southern partners), each (..., nhalf, nm).
    Column c is the order ``m0`` + c.  ``dd``, ``x_lo`` and ``nb`` as for
    :func:`analysis_spin0_folded`.
    """
    name = "synthesis_spin0_folded"
    lmax, m0 = int(lmax), int(m0)
    _check(name, "alms", (alm,), lmax + 1, (x, logch, logsh), x.shape[0])
    nb = _group(name, nb, alm, lmax, dd)
    return _run(
        _mode(dd, alm.dtype), x, x_lo, (alm,),
        lambda a, x_lo: wigner.synthesis_spin0_folded_plain(
            a, x, logch, logsh, lmax, m0, x_lo=x_lo, nb=nb),
        lambda a, x_lo: _launch(name, a, x, logch, logsh, lmax, None,
                                x.shape[0], 2, m0=m0, x_lo=x_lo, nb=nb))


@tracing.spanned("sht_kernels.synthesis_pair_folded")
def synthesis_pair_folded(alm_p, alm_m, x, logch, logsh, lmax, spin, m0=0, *,
                          dd=False, x_lo=None, nb=None):
    """Folded spin-pair synthesis; returns (GNp, GSp, GNm, GSm).

    ``alm_p``/``alm_m``: (..., lmax+1, nm) alms of the n = +spin and
    n = -spin columns.  GNp = sum a_p lam_p and GNm = sum a_m lam_m on
    the northern rings; GSp = (-1)^m sum (-1)^l a_p lam_m and
    GSm = (-1)^m sum (-1)^l a_m lam_p on their mirrored southern partners.
    Column c is the order ``m0`` + c.  ``dd``, ``x_lo`` and ``nb`` as for
    :func:`analysis_spin0_folded`.  Each is (..., nhalf, nm).
    """
    name = "synthesis_pair_folded"
    lmax, m0 = int(lmax), int(m0)
    _check(name, "alms", (alm_p, alm_m), lmax + 1, (x, logch, logsh),
           x.shape[0])
    spin = abs(int(spin))
    nb = _group(name, nb, alm_p, lmax, dd)
    return _run(
        _mode(dd, alm_p.dtype), x, x_lo, (alm_p, alm_m),
        lambda ap, am, x_lo: wigner.synthesis_pair_folded_plain(
            ap, am, x, logch, logsh, lmax, spin, m0, x_lo=x_lo, nb=nb),
        lambda a, x_lo: _launch(name, a, x, logch, logsh, lmax, spin,
                                x.shape[0], 4, m0=m0, x_lo=x_lo, nb=nb))
