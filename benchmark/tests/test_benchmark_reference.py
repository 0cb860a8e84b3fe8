"""The plain reference itself: its chirp transform against the DFT's
definition, its Legendre rows against mpmath where they underflow a
plain recurrence, and its analysis against the program's float64 path
(two independent writings of one definition)."""

import math

import numpy as np
import pytest
import torch

from reference import plain_sht


def test_chirp_dft_is_the_dft():
    rng = np.random.default_rng(4)
    n = np.array([4, 12, 40, 100])
    M, L = 130, 256
    rows = np.zeros((2, n.size, L), complex)
    for r, k in enumerate(n):
        rows[:, r, :k] = rng.normal(size=(2, k)) + 1j * rng.normal(size=(2, k))
    got = plain_sht.chirp_dft(torch.as_tensor(rows), torch.as_tensor(n), M)
    for r, k in enumerate(n):
        j = np.arange(k)
        want = rows[:, r, :k] @ np.exp(-2j * np.pi * np.outer(j, np.arange(M)) / k)
        np.testing.assert_allclose(got[:, r].numpy(), want, atol=1e-11)


def test_slm_rows_where_seeds_underflow():
    mpmath = pytest.importorskip("mpmath")
    nside, lmax, m = 64, 380, 138
    _, _, z, sin_theta, _ = plain_sht.ring_layout(nside)
    r = 21
    x = torch.as_tensor(z[r:r + 1])
    cos_half = torch.sqrt((1 + x) / 2)
    sin_half = torch.as_tensor(sin_theta[r:r + 1]) / (2 * cos_half)
    rows = {ell: v[0, m, 0].item() for ell, v in
            plain_sht.slm_rows(lmax, lmax, (0,), x, sin_half, cos_half)
            if ell >= m}
    mpmath.mp.dps = 40
    xm = mpmath.mpf(z[r])
    s = mpmath.sqrt((1 - xm) * (1 + xm))
    cur = ((-1) ** m * mpmath.sqrt(mpmath.factorial(2 * m + 1) / (4 * mpmath.pi))
           / (2 ** m * mpmath.factorial(m)) * s ** m)
    prev = mpmath.mpf(0)
    for ell in range(m, lmax + 1):
        if ell > m:
            a = mpmath.sqrt((4 * ell * ell - 1) / mpmath.mpf(ell * ell - m * m))
            b = (mpmath.sqrt(((ell - 1) ** 2 - m * m)
                             / mpmath.mpf(4 * (ell - 1) ** 2 - 1))
                 if ell - 1 > m else 0)
            prev, cur = cur, a * (xm * cur - b * prev)
        assert math.isclose(rows[ell], float(cur), rel_tol=1e-9,
                            abs_tol=1e-300), ell


@pytest.mark.parametrize("spin", [0, 2])
def test_analysis_meets_the_programs_float64_path(spin):
    from heracles_tpu_torch.ops import sht

    nside, lmax = 16, 40
    rng = np.random.default_rng(9)
    shape = (2, 12 * nside ** 2) if spin == 0 else (2, 2, 12 * nside ** 2)
    maps = torch.as_tensor(rng.normal(size=shape))
    want = sht.map2alm(maps, lmax, spin=spin, weights="ring", packed=False)
    got = plain_sht.map2alm(maps, nside, lmax, spin=spin,
                            weights=sht.ring_weights(nside))
    assert float((got - want).abs().max()) < 1e-12 * float(want.abs().max())


@pytest.mark.parametrize("nside", [256, 512, 1024])
def test_shipped_ring_weights_meet_the_solver(nside):
    """The shipped ring-weight tables, which the program reads too, are
    the reference's own solution of their definition."""
    import os

    from reference import tables

    shipped = np.load(os.path.join(tables.DATA,
                                   f"ringweights_{nside}_{3 * nside}.npy"))
    solved = tables.solve_ring_weights(nside)
    assert np.abs(solved - shipped).max() < 1e-13 * np.abs(shipped).max()


def test_pixel_window_ignores_the_programs_cache(tmp_path, monkeypatch):
    """The reference reads the shipped tables only, never a window in the
    directory where the program keeps those it computed."""
    import os

    from reference import tables

    ell = np.arange(3073.0)
    np.save(tmp_path / "pixwin_4096_8192_1_16_1.npy", np.stack([ell, ell]))
    monkeypatch.setenv("HERACLES_TPU_CACHE", str(tmp_path))
    got = tables.pixel_window(4096, 3000)
    want = np.load(os.path.join(tables.DATA, "pixwin_4096_3072_1_16_1.npy"))
    np.testing.assert_array_equal(got, want[:, :3001])
