"""Exact pixel windows of the port against heracles_tpu on the CPU.

``heracles_tpu_torch.ops.pixwin`` and ``ops.wigner``'s unfolded scans
against the reference's, in float64 on the same child angles; the port's
``pixel_window`` against the reference's at nside 8 and 16; the cache
files of either package read by the other; a mapper keeps the window it
chose at its first transform, and a window file cached later serves a
new mapper.  Every test points
``HERACLES_TPU_CACHE`` at its own directory, so no window comes from an
earlier run.

Tolerances: the same float64 recurrence and sums taken in another order,
1e-10 (``rtol`` against the scipy oracle, absolute on windows <= 1); the
cache round trip is exact.
"""

import numpy as np
import pytest
import torch
from scipy.special import sph_harm_y

import jax.numpy as jnp

from heracles_tpu.ops import pixwin as jpw
from heracles_tpu.ops import sht as jsht
from heracles_tpu.ops import wigner as jw
from heracles_tpu_torch.ops import pixwin, sht, wigner


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("HERACLES_TPU_CACHE", str(tmp_path))
    jpw.pixel_window_exact.cache_clear()
    pixwin.pixel_window_exact.cache_clear()
    sht._pixel_window.cache_clear()
    jsht._pixel_window_cached.cache_clear()
    jsht._pixwin_resolved_exact.clear()
    yield tmp_path
    jpw.pixel_window_exact.cache_clear()
    pixwin.pixel_window_exact.cache_clear()
    sht._pixel_window.cache_clear()
    jsht._pixel_window_cached.cache_clear()
    jsht._pixwin_resolved_exact.clear()


def test_rep_powers_match_scipy_definition():
    """Scalar power sums equal the brute-force |int_p Y*_lm|^2 sums."""
    nside, f, lmax = 8, 4, 8
    pix = np.array([0, 7, 100, 400])  # cap, cap, shoulder-ish, belt
    th, ph = pixwin._children_angles(nside, pix, f)
    powers = pixwin._rep_powers(th, ph, lmax, pol=False, device="cpu")
    v = 1.0 / (f * f)
    for r in range(len(pix)):
        for ell in (0, 1, 4, 8):
            tot = 0.0
            for m in range(-ell, ell + 1):
                w = np.sum(v * np.conj(sph_harm_y(ell, m, th[r], ph[r])))
                tot += abs(w) ** 2
            np.testing.assert_allclose(powers[r, 0, ell], tot, rtol=1e-10)


@pytest.mark.parametrize("rings", [False, True])
@pytest.mark.parametrize("pol", [False, True])
def test_rep_powers_match_reference(pol, rings):
    nside, f, lmax = 8, 4, 10
    pix = np.array([0, 5, 60, 200, 300])
    th, ph, rg = pixwin._children_angles_rings(nside, pix, f)
    rg = rg if rings else None
    got = pixwin._rep_powers(th, ph, lmax, pol, rings=rg, device="cpu")
    want = jpw._rep_powers(th, ph, lmax, pol, rings=rg)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())


def test_power_scan_matches_analysis_scan():
    """The power reduction equals the weighted |alm|^2 of the plain scan,
    which equals the reference's lambda_analysis_scan."""
    nside, f, lmax = 8, 4, 8
    pix = np.array([3, 300])
    th, ph = pixwin._children_angles(nside, pix, f)
    ms, ns, weights = pixwin._lane_setup(lmax, True)
    x, logch, logsh = (torch.as_tensor(a) for a in (
        np.cos(th), np.log(np.cos(th / 2)), np.log(np.sin(th / 2))))
    Fw = (1.0 / th.shape[-1]) * np.exp(-1j * ms[None, None, :] * ph[..., None])
    power = wigner.lambda_power_scan(ms, ns, x, logch, logsh, lmax,
                                     torch.as_tensor(Fw), weights).numpy()
    alm = wigner.lambda_analysis_scan(ms, ns, x, logch, logsh, lmax,
                                      torch.as_tensor(Fw)).numpy()
    want = np.einsum("kn,rln->rkl", weights, np.abs(alm) ** 2)
    np.testing.assert_allclose(power, want, rtol=1e-10, atol=1e-14)
    for r in range(len(pix)):
        ref = np.asarray(jw.lambda_analysis_scan(
            jnp.asarray(ms), jnp.asarray(ns), jnp.asarray(x[r].numpy()),
            jnp.asarray(logch[r].numpy()), jnp.asarray(logsh[r].numpy()),
            lmax, jnp.asarray(Fw[r])))
        np.testing.assert_allclose(alm[r], ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("pol", [False, True])
def test_pixel_window_exact_matches_reference(cache, pol):
    got = pixwin.pixel_window_exact(8, 16, pol=pol, factor=8, device="cpu")
    want = jpw.pixel_window_exact(8, 16, pol=pol, factor=8)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("nside,lmax", [(8, 12), (16, 24)])
@pytest.mark.parametrize("pol", [False, True])
def test_pixel_window_auto_matches_reference(cache, nside, lmax, pol):
    """``"auto"`` computes the exact window at nside <= 32, as the
    reference does, and never raises."""
    got = sht.pixel_window(nside, lmax, pol=pol, device="cpu")
    want = jsht.pixel_window(nside, lmax, pol=pol)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    exact = sht.pixel_window(nside, lmax, pol=pol, method="exact",
                             device="cpu")
    np.testing.assert_array_equal(exact, got)
    cap = sht.pixel_window(nside, lmax, pol=pol, method="cap")
    assert 1e-4 < np.max(np.abs(cap - got)) < 2e-2


def test_cache_files_read_by_the_other_package(cache):
    """A window either package computed and cached is the other's."""
    ref = jpw.pixel_window_exact(4, 8, pol=True, factor=4)
    assert sorted(p.name for p in cache.iterdir()) == ["pixwin_4_8_1_4_1.npy"]
    np.testing.assert_array_equal(pixwin.find_cached(4, 8, True), ref)
    np.testing.assert_array_equal(pixwin.find_cached(4, 6, False), ref[0, :7])
    (cache / "pixwin_4_8_1_4_1.npy").unlink()

    port = pixwin.pixel_window_exact(4, 10, pol=False, factor=4, device="cpu")
    assert sorted(p.name for p in cache.iterdir()) == ["pixwin_4_10_0_4_1.npy"]
    np.testing.assert_array_equal(jpw.find_cached(4, 10, False), port)
    assert jpw.find_cached(4, 10, True) is None
    np.testing.assert_allclose(port[:9], ref[0], rtol=0, atol=1e-10)


def test_cap_window_is_the_reference_closed_form():
    np.testing.assert_array_equal(pixwin.cap_window(64, 96),
                                  jpw.cap_window(64, 96))


def test_mapper_keeps_its_window_and_a_new_file_serves_new_mappers(cache):
    """At nside 64 "auto" is the cap form until a window file is cached."""
    import heracles_tpu_torch as th

    nside, lmax = 64, 20
    maps = torch.as_tensor(np.random.default_rng(3).normal(size=12 * nside**2))
    raw = th.HealpixMapper(nside, lmax, deconvolve=False,
                           device="cpu").transform(maps).array
    mapper = th.HealpixMapper(nside, lmax, device="cpu")
    first = mapper.transform(maps).array
    np.testing.assert_allclose((first / raw).real.numpy()[: lmax + 1],
                               1 / pixwin.cap_window(nside, lmax), rtol=1e-12)
    np.save(cache / f"pixwin_{nside}_{lmax}_0_16_1.npy",
            np.full(lmax + 1, 0.5))
    assert torch.equal(mapper.transform(maps).array, first)
    new = th.HealpixMapper(nside, lmax, device="cpu").transform(maps).array
    assert torch.equal(new, 2 * raw)
