"""Folded Wigner-d analysis and synthesis: the Hopper kernels and their dispatch.

Counterpart of :mod:`heracles_tpu.ops.pallas_sht`.
:func:`analysis_spin0_folded`, :func:`analysis_pair_folded`,
:func:`synthesis_spin0_folded` and :func:`synthesis_pair_folded` keep the
signatures and return layouts of their Pallas twins, ``dd`` and ``x_lo``
included, minus the arguments that tune the TPU or emulate float64 seeds
on it (``interpret``, ``contract``, ``skip``, ``ring_block``, ``nb``,
``m_chunk``, ``l_chunk``, ``seed_planes``, ``logch_lo`` and
``logsh_lo``: the kernels read the logs in float64).  The tensor decides
the path:

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

No kernel's shared memory grows with lmax; the one bound on it is
``LMAX_LIMIT``.  ``LAUNCHES`` counts kernel launches per kernel name,
``LAUNCHES_BY_PRECISION`` the same launches per (name, "f32", "f64" or
"f32c", the compensated kernel).  :func:`path_counts` is a diagnostic
launch of the spin-0 analysis or of either synthesis, plain or comp, that
tells which share of the work ran on each of the kernel's paths.
"""

from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from . import wigner

__all__ = [
    "analysis_spin0_folded",
    "analysis_pair_folded",
    "synthesis_spin0_folded",
    "synthesis_pair_folded",
    "path_counts",
    "LAUNCHES",
    "LAUNCHES_BY_PRECISION",
    "LMAX_LIMIT",
    "reset_counts",
]

LAUNCHES = collections.Counter()
LAUNCHES_BY_PRECISION = collections.Counter()

# the kernels' dead path (csrc/sht_paths.cuh) rests on a step of the
# recurrence growing a value by less than sqrt(2 lmax) + 2 < 2^8.1: 8 steps
# without a rescale then stay clear of float32's overflow
LMAX_LIMIT = 32767

_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def reset_counts():
    """Zero the kernel launch counts and the plain-version run counts."""
    LAUNCHES.clear()
    LAUNCHES_BY_PRECISION.clear()
    wigner.PLAIN_RUNS.clear()
    wigner.PLAIN_RUNS_BY_PRECISION.clear()


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
            m0=0, paths=False, x_lo=None):
    """Launch one kernel on CUDA tensors; returns its ``nout`` outputs.

    ``name`` is ``{analysis,synthesis}_{spin0,pair}_folded``; ``inputs``
    are its (..., rows, nm) complex operands, column c being the order
    m0 + c, and each output is (..., out_rows, nm).  ``x_lo`` (complex64
    only) launches the compensated float32 instantiation, with each
    ring's r = x_lo / x_hi (:func:`wigner.comp_ratio`).  ``paths=True``
    launches the kernel's diagnostic twin instead (float32 only, not
    counted in ``LAUNCHES``) and returns its three path counts as an int64
    tensor.
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
    ints = (B, x.shape[0], nm, lmax) + ((int(spin),) if pair else ()) + (m0,)
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
    return [o.reshape(batch + (out_rows, nm)) for o in outs]


def path_counts(name, *args, m0=0, dd=False, x_lo=None):
    """Sub-chunks of 8 multipoles that the warps of one launch ran on the
    steady, the dead and the full path: a dict of three ints.

    ``name`` is ``"analysis_spin0_folded"``, ``"synthesis_spin0_folded"``
    or ``"synthesis_pair_folded"`` and ``args``, ``m0``, ``dd`` and
    ``x_lo`` are that function's own, complex64 tensors on the card
    (``dd="comp"`` counts the compensated kernel's paths).
    A diagnostic twin of the kernel runs (the same code with three
    counters); its outputs are dropped and ``LAUNCHES`` does not count it.
    """
    if args[0].device.type != "cuda":
        raise ValueError("path_counts: the tensors must lie on the card")
    if name == "analysis_spin0_folded":
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
    else:
        raise ValueError(f"path_counts: {name} has no path counts")
    _check(name, what, inputs, rows, (x, logch, logsh), x.shape[0])
    if dd == "comp":
        x_lo = torch.zeros(x.shape) if x_lo is None else x_lo
    elif dd:
        raise TypeError("path_counts: the path counts are float32 launches")
    else:
        x_lo = None
    counts = _launch(name, inputs, x, logch, logsh, int(lmax), spin, out_rows,
                     nout, m0=int(m0), paths=True, x_lo=x_lo)
    return dict(zip(("steady", "dead", "full"), counts.tolist()))


def analysis_spin0_folded(Fe, Fo, x, logch, logsh, lmax, m0=0, *, dd=False,
                          x_lo=None):
    """alm[..., l, m] = sum_r lam_lm(x_r) (Fe on even l, Fo on odd l)[..., r, m].

    ``Fe``/``Fo``: (..., nhalf, nm) complex parity-combined northern ring
    spectra (FN + FS and FN - FS, with FS the (-1)^m-signed mirrored
    southern rows); ``x``: (nhalf,) cos(theta); ``logch``/``logsh``:
    (nhalf,) log cos(theta/2), log sin(theta/2), read in float64 (pass
    float64 values for full seed accuracy).  Column c is the order
    ``m0`` + c (a device mesh's block of orders); an order above lmax
    gives zeros.  ``dd`` and ``x_lo`` as the reference's (module
    docstring).  Returns (..., lmax+1, nm).
    """
    nhalf = x.shape[0]
    _check("analysis_spin0_folded", "spectra", (Fe, Fo), nhalf,
           (x, logch, logsh), nhalf)
    m0, lmax = int(m0), int(lmax)
    (alm,) = _run(
        _mode(dd, Fe.dtype), x, x_lo, (Fe, Fo),
        lambda *F, x_lo: wigner.analysis_spin0_folded_plain(
            *F, x, logch, logsh, lmax, m0, x_lo=x_lo),
        lambda F, x_lo: _launch("analysis_spin0_folded", F, x, logch, logsh,
                                lmax, None, lmax + 1, 1, m0=m0, x_lo=x_lo))
    return alm


def analysis_pair_folded(FNp, Sp, FNm, Sm, x, logch, logsh, lmax, spin,
                         m0=0, *, dd=False, x_lo=None):
    """Folded spin-pair analysis; returns (alm_p, alm_m).

    a_p[l] = sum_r lam_p FNp + (-1)^l lam_m Sp and
    a_m[l] = sum_r lam_m FNm + (-1)^l lam_p Sm, with lam_p / lam_m the
    slm columns n = +spin / -spin.  ``FN*``: (..., nhalf, nm) northern
    rows of each branch; ``S*``: the partner-paired (-1)^m-signed southern
    rows.  Column c is the order ``m0`` + c.  ``dd`` and ``x_lo`` as the
    reference's (module docstring).  Each output is (..., lmax+1, nm).
    """
    nhalf = x.shape[0]
    _check("analysis_pair_folded", "spectra", (FNp, Sp, FNm, Sm), nhalf,
           (x, logch, logsh), nhalf)
    spin, m0, lmax = abs(int(spin)), int(m0), int(lmax)
    return _run(
        _mode(dd, FNp.dtype), x, x_lo, (FNp, Sp, FNm, Sm),
        lambda *F, x_lo: wigner.analysis_pair_folded_plain(
            *F, x, logch, logsh, lmax, spin, m0, x_lo=x_lo),
        lambda F, x_lo: _launch("analysis_pair_folded", F, x, logch, logsh,
                                lmax, spin, lmax + 1, 2, m0=m0, x_lo=x_lo))


def synthesis_spin0_folded(alm, x, logch, logsh, lmax, m0=0, *, dd=False,
                           x_lo=None):
    """Folded spin-0 synthesis: rectangular alm -> (GN, GS) ring spectra.

    ``alm``: (..., lmax+1, nm) complex; ``x``/``logch``/``logsh``: (nhalf,)
    northern-ring geometry as for :func:`analysis_spin0_folded`.  Returns
    GN = sum_l alm lam (the northern rings) and GS = (-1)^m sum_l (-1)^l
    alm lam (their mirrored southern partners), each (..., nhalf, nm).
    Column c is the order ``m0`` + c.  ``dd`` and ``x_lo`` as the
    reference's (module docstring).
    """
    lmax, m0 = int(lmax), int(m0)
    _check("synthesis_spin0_folded", "alms", (alm,), lmax + 1,
           (x, logch, logsh), x.shape[0])
    return _run(
        _mode(dd, alm.dtype), x, x_lo, (alm,),
        lambda a, x_lo: wigner.synthesis_spin0_folded_plain(
            a, x, logch, logsh, lmax, m0, x_lo=x_lo),
        lambda a, x_lo: _launch("synthesis_spin0_folded", a, x, logch, logsh,
                                lmax, None, x.shape[0], 2, m0=m0, x_lo=x_lo))


def synthesis_pair_folded(alm_p, alm_m, x, logch, logsh, lmax, spin, m0=0, *,
                          dd=False, x_lo=None):
    """Folded spin-pair synthesis; returns (GNp, GSp, GNm, GSm).

    ``alm_p``/``alm_m``: (..., lmax+1, nm) alms of the n = +spin and
    n = -spin columns.  GNp = sum a_p lam_p and GNm = sum a_m lam_m on
    the northern rings; GSp = (-1)^m sum (-1)^l a_p lam_m and
    GSm = (-1)^m sum (-1)^l a_m lam_p on their mirrored southern partners.
    Column c is the order ``m0`` + c.  ``dd`` and ``x_lo`` as the
    reference's (module docstring).  Each is (..., nhalf, nm).
    """
    lmax, m0 = int(lmax), int(m0)
    _check("synthesis_pair_folded", "alms", (alm_p, alm_m), lmax + 1,
           (x, logch, logsh), x.shape[0])
    spin = abs(int(spin))
    return _run(
        _mode(dd, alm_p.dtype), x, x_lo, (alm_p, alm_m),
        lambda ap, am, x_lo: wigner.synthesis_pair_folded_plain(
            ap, am, x, logch, logsh, lmax, spin, m0, x_lo=x_lo),
        lambda a, x_lo: _launch("synthesis_pair_folded", a, x, logch, logsh,
                                lmax, spin, x.shape[0], 4, m0=m0, x_lo=x_lo))
