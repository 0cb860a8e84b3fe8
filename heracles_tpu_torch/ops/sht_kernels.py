"""Folded Wigner-d analysis and synthesis: the Hopper kernels and their dispatch.

Counterpart of :mod:`heracles_tpu.ops.pallas_sht`.
:func:`analysis_spin0_folded`, :func:`analysis_pair_folded`,
:func:`synthesis_spin0_folded` and :func:`synthesis_pair_folded` keep the
signatures and return layouts of their Pallas twins, minus the arguments
that tune the TPU or emulate wider arithmetic on it (``dd``, ``comp``,
``interpret``, ``contract``, ``skip``, ``ring_block``, ``nb``,
``m_chunk``, ``l_chunk``, ``seed_planes`` and the ``*_lo`` residuals).
The tensor decides the path:

* a CPU tensor takes the plain version (:mod:`.wigner`);
* a CUDA tensor launches the hand-written kernel
  (``heracles_tpu_torch/csrc/sht_analysis.cu``, ``sht_analysis_pair.cu``,
  ``sht_synthesis.cu``, built at first use by :mod:`._build`), or raises;
* complex64 input runs the float32 kernel, complex128 the float64 one.

``LAUNCHES`` counts kernel launches per kernel name.
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
    "LAUNCHES",
    "reset_counts",
]

LAUNCHES = collections.Counter()

# the largest dynamic shared memory a Hopper block may use: it bounds the
# lmax of the spin-0 analysis, whose block holds the order's whole column
# (the other kernels' shared memory does not grow with lmax)
_SMEM_LIMIT = 232448

_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def reset_counts():
    """Zero the kernel launch counts and the plain-version run counts."""
    LAUNCHES.clear()
    wigner.PLAIN_RUNS.clear()


@functools.lru_cache(maxsize=16)
def _seed_planes(nm, spin):
    if spin is None:
        return wigner.spin0_seed_planes(np.arange(nm))
    return wigner.pair_seed_planes(np.arange(nm), spin)


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


def _launch(name, inputs, x, logch, logsh, lmax, spin, out_rows, nout):
    """Launch one kernel on CUDA tensors; returns its ``nout`` outputs.

    ``name`` is ``{analysis,synthesis}_{spin0,pair}_folded``; ``inputs``
    are its (..., rows, nm) complex operands and each output is
    (..., out_rows, nm).
    """
    from . import _build

    kl = _build.load_library()
    direction = name.split("_")[0]
    pair = spin is not None
    A = inputs[0]
    dev = A.device
    real = _REAL[A.dtype]
    is_double = real == torch.float64
    if name == "analysis_spin0_folded":
        smem = kl.spin0_smem_bytes(is_double, lmax)
        if smem > _SMEM_LIMIT:
            raise ValueError(f"{name}: lmax={lmax} needs {smem} bytes of "
                             f"shared memory per block, more than "
                             f"{_SMEM_LIMIT}")
    batch = A.shape[:-2]
    rows, nm = A.shape[-2:]
    B = int(np.prod(batch, dtype=np.int64))
    flat = [F.reshape(B, rows, nm).resolve_conj().resolve_neg().contiguous()
            for F in inputs]
    xv = x.to(device=dev, dtype=real).contiguous()
    lch = logch.to(device=dev, dtype=torch.float64).contiguous()
    lsh = logsh.to(device=dev, dtype=torch.float64).contiguous()
    seed = torch.as_tensor(_seed_planes(nm, spin), device=dev)
    outs = [torch.empty((B, out_rows, nm), dtype=A.dtype, device=dev)
            for _ in range(nout)]
    fn = getattr(kl.lib, f"heracles_{direction}_{'pair' if pair else 'spin0'}_"
                         f"{'f64' if is_double else 'f32'}")
    ints = (B, x.shape[0], nm, lmax) + ((int(spin),) if pair else ())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in flat), xv.data_ptr(), lch.data_ptr(),
                 lsh.data_ptr(), seed.data_ptr(),
                 *(o.data_ptr() for o in outs), *ints, stream)
    kl.check(err)
    LAUNCHES[name] += 1
    return [o.reshape(batch + (out_rows, nm)) for o in outs]


def analysis_spin0_folded(Fe, Fo, x, logch, logsh, lmax):
    """alm[..., l, m] = sum_r lam_lm(x_r) (Fe on even l, Fo on odd l)[..., r, m].

    ``Fe``/``Fo``: (..., nhalf, nm) complex parity-combined northern ring
    spectra (FN + FS and FN - FS, with FS the (-1)^m-signed mirrored
    southern rows); ``x``: (nhalf,) cos(theta); ``logch``/``logsh``:
    (nhalf,) log cos(theta/2), log sin(theta/2), read in float64 (pass
    float64 values for full seed accuracy).  Returns (..., lmax+1, nm).
    """
    nhalf = x.shape[0]
    _check("analysis_spin0_folded", "spectra", (Fe, Fo), nhalf,
           (x, logch, logsh), nhalf)
    if Fe.device.type == "cpu":
        return wigner.analysis_spin0_folded_plain(Fe, Fo, x, logch, logsh, lmax)
    (alm,) = _launch("analysis_spin0_folded", (Fe, Fo), x, logch, logsh,
                     int(lmax), None, int(lmax) + 1, 1)
    return alm


def analysis_pair_folded(FNp, Sp, FNm, Sm, x, logch, logsh, lmax, spin):
    """Folded spin-pair analysis; returns (alm_p, alm_m).

    a_p[l] = sum_r lam_p FNp + (-1)^l lam_m Sp and
    a_m[l] = sum_r lam_m FNm + (-1)^l lam_p Sm, with lam_p / lam_m the
    slm columns n = +spin / -spin.  ``FN*``: (..., nhalf, nm) northern
    rows of each branch; ``S*``: the partner-paired (-1)^m-signed southern
    rows.  Each output is (..., lmax+1, nm).
    """
    nhalf = x.shape[0]
    _check("analysis_pair_folded", "spectra", (FNp, Sp, FNm, Sm), nhalf,
           (x, logch, logsh), nhalf)
    spin = abs(int(spin))
    if FNp.device.type == "cpu":
        return wigner.analysis_pair_folded_plain(FNp, Sp, FNm, Sm, x, logch,
                                                 logsh, lmax, spin)
    alm_p, alm_m = _launch("analysis_pair_folded", (FNp, Sp, FNm, Sm), x,
                           logch, logsh, int(lmax), spin, int(lmax) + 1, 2)
    return alm_p, alm_m


def synthesis_spin0_folded(alm, x, logch, logsh, lmax):
    """Folded spin-0 synthesis: rectangular alm -> (GN, GS) ring spectra.

    ``alm``: (..., lmax+1, nm) complex; ``x``/``logch``/``logsh``: (nhalf,)
    northern-ring geometry as for :func:`analysis_spin0_folded`.  Returns
    GN = sum_l alm lam (the northern rings) and GS = (-1)^m sum_l (-1)^l
    alm lam (their mirrored southern partners), each (..., nhalf, nm).
    """
    lmax = int(lmax)
    _check("synthesis_spin0_folded", "alms", (alm,), lmax + 1,
           (x, logch, logsh), x.shape[0])
    if alm.device.type == "cpu":
        return wigner.synthesis_spin0_folded_plain(alm, x, logch, logsh, lmax)
    GN, GS = _launch("synthesis_spin0_folded", (alm,), x, logch, logsh, lmax,
                     None, x.shape[0], 2)
    return GN, GS


def synthesis_pair_folded(alm_p, alm_m, x, logch, logsh, lmax, spin):
    """Folded spin-pair synthesis; returns (GNp, GSp, GNm, GSm).

    ``alm_p``/``alm_m``: (..., lmax+1, nm) alms of the n = +spin and
    n = -spin columns.  GNp = sum a_p lam_p and GNm = sum a_m lam_m on
    the northern rings; GSp = (-1)^m sum (-1)^l a_p lam_m and
    GSm = (-1)^m sum (-1)^l a_m lam_p on their mirrored southern partners.
    Each is (..., nhalf, nm).
    """
    lmax = int(lmax)
    _check("synthesis_pair_folded", "alms", (alm_p, alm_m), lmax + 1,
           (x, logch, logsh), x.shape[0])
    spin = abs(int(spin))
    if alm_p.device.type == "cpu":
        return wigner.synthesis_pair_folded_plain(alm_p, alm_m, x, logch,
                                                  logsh, lmax, spin)
    return tuple(_launch("synthesis_pair_folded", (alm_p, alm_m), x, logch,
                         logsh, lmax, spin, x.shape[0], 4))
