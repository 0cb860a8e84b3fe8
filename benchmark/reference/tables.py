"""Input tables of the plain reference: quadrature ring weights and pixel
windows.

Both are read only from the tables shipped as raw ``.npy`` files in
``heracles_tpu/data`` of the checkout (from disk: the package is not
imported), never from a directory the program writes.  Ring weights
without a shipped table are solved here, in numpy, from their definition
(:func:`solve_ring_weights`, which also reproduces the shipped tables).
A test points ``DATA`` at a directory of its own toy tables.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .plain_sht import ring_layout

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA = os.path.join(ROOT, "heracles_tpu", "data")


def ring_weights(nside):
    """Per-ring quadrature weights (4 nside - 1,), float64: the shipped
    table, else :func:`solve_ring_weights`."""
    n = int(nside)
    path = os.path.join(DATA, f"ringweights_{n}_{3 * n}.npy")
    if os.path.exists(path):
        return np.load(path)
    return solve_ring_weights(n)


def solve_ring_weights(nside):
    """The minimum-norm correction to the pixel area such that
    sum_p w_p P_l(z_p) = 4 pi delta_l0 for every even l <= 3 nside (odd l
    cancel between the hemispheres): (4 nside - 1,) float64."""
    n = int(nside)
    nph, _, z, _, _ = ring_layout(n)
    nhalf = 2 * n
    zs = z[:nhalf]
    count = nph[:nhalf] * np.where(np.arange(nhalf) == nhalf - 1, 1.0, 2.0)
    lw = 3 * n
    rows = []
    p_prev, p = np.ones_like(zs), zs.copy()
    rows.append(count.astype(np.float64))
    for ell in range(2, lw + 1):
        p_prev, p = p, ((2 * ell - 1) * zs * p - (ell - 1) * p_prev) / ell
        if ell % 2 == 0:
            rows.append(count * p)
    A = np.array(rows)
    b = np.zeros(A.shape[0])
    b[0] = 4.0 * np.pi
    w0 = np.full(nhalf, 4.0 * np.pi / (12.0 * n * n))
    delta, *_ = np.linalg.lstsq(A, b - A @ w0, rcond=None)
    half = w0 + delta
    return np.concatenate([half, half[:-1][::-1]])


def pixel_window(nside, lmax):
    """(2, lmax + 1) [scalar, polarisation] HEALPix pixel window, float64:
    the first shipped file ``pixwin_<nside>_<lmax'>_1_*.npy`` in ``DATA``
    with lmax' >= lmax."""
    n = int(nside)
    for path in sorted(glob.glob(os.path.join(DATA, f"pixwin_{n}_*_1_*.npy"))):
        if int(os.path.basename(path).split("_")[2]) >= lmax:
            return np.load(path)[:, : lmax + 1]
    raise FileNotFoundError(f"no polarisation pixel window table for nside "
                            f"{n} and lmax {lmax} in {DATA}")
