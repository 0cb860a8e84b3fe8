"""Algebra on dictionaries of angular power spectra and covariances.

Carried over unchanged from :mod:`heracles_tpu.utils` (host numpy).  The
pipeline passes spectra around as plain mappings from tuple keys
``(field1, field2, bin1, bin2)`` to :class:`~heracles_tpu_torch.result.Result`
blocks, and covariances as mappings from 8-tuples to matrix-valued
blocks.  This module supplies the bookkeeping algebra on those mappings:
symmetric-key lookup, elementwise combination, spin-0 axis padding, and
the flattening of a block dictionary into one data vector / covariance
matrix.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

__all__ = [
    "get_cl",
    "add_to_Cls",
    "sub_to_Cls",
    "expand_spin0_dims",
    "squeeze_spin0_dims",
    "impose_correlation",
    "flatten",
]


def _transposed(result):
    """The same spectrum viewed with its two fields swapped.

    Swapping the fields of a spectrum swaps its spin pair and, when both
    fields carry components (spin != 0), transposes the two leading
    component axes (E/B blocks).
    """
    s1, s2 = result.spin
    arr = result.array
    if s1 and s2:
        arr = np.swapaxes(arr, 0, 1)
    return replace(result, array=arr, spin=(s2, s1))


def get_cl(key, cls):
    """Look up ``cls[key]``, falling back to the transposed key.

    ``(a, b, i, j)`` and ``(b, a, j, i)`` describe the same measurement;
    only one of the two is stored.  When the fallback is taken, the
    returned block is component-transposed via :func:`_transposed`.
    """
    if key in cls:  # membership test, so TocDict pattern lookup can't trigger
        return cls[key]
    f1, f2, z1, z2 = key
    swapped = (f2, f1, z2, z1)
    if swapped not in cls:
        raise KeyError(f"no spectrum stored under {key!r} or {swapped!r}")
    return _transposed(cls[swapped])


def _combine(op, cls, other):
    """Apply ``op(block.array, other[key])`` across a spectrum dict."""
    return {
        key: replace(block, array=op(block.array, other[key]))
        for key, block in cls.items()
    }


def add_to_Cls(cls, x):
    """Per-key ``cls + x`` (``x`` maps keys to arrays or scalars)."""
    return _combine(np.add, cls, x)


def sub_to_Cls(cls, x):
    """Per-key ``cls - x`` (``x`` maps keys to arrays or scalars)."""
    return _combine(np.subtract, cls, x)


def expand_spin0_dims(result):
    """Pad a length-1 component axis in for every spin-0 entry.

    Brings every block to the uniform ``(c1, c2, ..., ell...)`` component
    layout so spin-0 x spin-2 blocks broadcast against spin-2 x spin-2
    ones.  Inverse of :func:`squeeze_spin0_dims`.
    """
    have = iter(result.shape)
    shape = [1 if s == 0 else next(have) for s in result.spin]
    shape.extend(have)
    pad = sum(1 for s in result.spin if s == 0)
    return replace(
        result,
        array=result.array.reshape(shape),
        axis=tuple(a + pad for a in result.axis),
    )


def squeeze_spin0_dims(result):
    """Drop the length-1 component axes belonging to spin-0 entries."""
    nspin = len(result.spin)
    comp, rest = result.shape[:nspin], result.shape[nspin:]
    for s, n in zip(result.spin, comp):
        assert not (s == 0 and n != 1), f"spin-0 component axis has size {n}"
    shape = [n for s, n in zip(result.spin, comp) if s != 0]
    shape.extend(rest)
    pad = sum(1 for s in result.spin if s == 0)
    return replace(
        result,
        array=result.array.reshape(shape),
        axis=tuple(a - pad for a in result.axis),
    )


def impose_correlation(cov_a, cov_b):
    """Blocks with the correlation of ``cov_a`` and the variances of ``cov_b``.

    Each output block is ``corr(a) * outer(std_b, std_b)`` computed as a
    single rescaling ``a * outer(r, r)`` with ``r = std_b / std_a``.
    """
    out = {}
    for key, block in cov_a.items():
        a = np.asarray(block)
        b = np.asarray(cov_b[key])
        ratio = np.sqrt(
            np.diagonal(b, axis1=-2, axis2=-1)
            / np.diagonal(a, axis1=-2, axis2=-1)
        )
        out[key] = replace(
            block, array=a * ratio[..., :, None] * ratio[..., None, :]
        )
    return out


def _ncomp(spins):
    """Total number of components for a run of spins (2 per spin != 0)."""
    n = 1
    for s in spins:
        n *= 1 if s == 0 else 2
    return n


def _block_matrix(result):
    """Reorder one covariance block to a flat (row, column) matrix.

    Rows interleave the first two spins' components with the first ell
    axis; columns do the same for the second pair.
    """
    a = np.asarray(result)
    half = len(result.spin) // 2
    nr, nc = _ncomp(result.spin[:half]), _ncomp(result.spin[half:])
    er, ec = a.shape[-2], a.shape[-1]
    return (
        a.reshape(nr, nc, er, ec)
        .swapaxes(1, 2)
        .reshape(nr * er, nc * ec)
    )


def flatten(results, order=None):
    """Assemble a dict of blocks into one vector or one matrix.

    Spectrum dicts (one ell axis per block) concatenate, component-major,
    into a single data vector.  Covariance dicts (two ell axes) assemble
    into the full matrix; a missing off-diagonal block is filled with the
    transpose of its mirror block.  ``order`` fixes the row/column order
    of the 4-tuple spectra keys ``(field1, field2, bin1, bin2)``.
    """
    depths = {len(r.axis) for r in results.values()}
    if len(depths) != 1:
        raise ValueError("cannot flatten blocks with mixed numbers of ell axes")
    (depth,) = depths

    if depth == 1:
        return np.concatenate([np.ravel(np.asarray(r)) for r in results.values()])
    if depth != 2:
        raise NotImplementedError("flatten supports vectors and matrices only")

    mats = {key: _block_matrix(r) for key, r in results.items()}
    if order is None:
        order = list(dict.fromkeys((k[0], k[1], k[4], k[5]) for k in mats))

    def tile(ki, kj):
        fwd = (ki[0], ki[1], kj[0], kj[1], ki[2], ki[3], kj[2], kj[3])
        if fwd in mats:
            return mats[fwd]
        mirror = (kj[0], kj[1], ki[0], ki[1], kj[2], kj[3], ki[2], ki[3])
        if mirror in mats:
            return mats[mirror].T
        raise KeyError(f"covariance block {fwd!r} absent (and no transpose)")

    return np.block([[tile(ki, kj) for kj in order] for ki in order])
