"""The port's Jacobi iterations, float32 synthesis and mapper against
heracles_tpu, on the CPU.

The second half of the synthesis tests (the first is
``tests/test_torch_synthesis.py``; two files so that two workers share
them): ``map2alm(iterations=)`` in float64 and float32, a round-trip
oracle, the mapper's ``transform(iterations=)`` and ``synthesize``, and
the JAX package's alms through the port's ``alm2map``.  The JAX side
runs as its own CPU tests run it: float64 through the jnp scans
(tests/conftest.py enables x64), the Pallas kernels in interpret mode for
float32.

Tolerances: float64 ``atol = 1e-10 * scale``; float32 at the bar of
tests/test_pallas.py (``atol = 2e-5 * scale, rtol = 2e-4``); the round
trip to 1e-8 of the largest alm after 3 iterations in float64.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import heracles_tpu as jh
import heracles_tpu_torch as th
from heracles_tpu.ops import sht as jsht
from heracles_tpu_torch.ops import sht

T = torch.as_tensor


def _close64(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-10 * np.abs(want).max())


def _cplx(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _band_limited(rng, lmax):
    """Random packed alms of a real map (a_{l0} real)."""
    nlm = sht.alm_size(lmax)
    alm = _cplx(rng, nlm)
    alm[: lmax + 1] = alm[: lmax + 1].real
    return alm


# -- iterations -------------------------------------------------------------------


@pytest.mark.parametrize("spin", [0, 2])
def test_map2alm_iterations(spin):
    nside, lmax = 8, 16
    rng = np.random.default_rng(30 + spin)
    npix = 12 * nside * nside
    # spin 0: a batch of two maps; spin 2: one [Q, U] pair
    maps = rng.normal(size=(2, npix))
    # the reference compiles every pass anew: two steps keep the test short
    want = jsht.map2alm(jnp.asarray(maps), lmax, spin=spin, iterations=2)
    got = sht.map2alm(T(maps), lmax, spin=spin, iterations=2)
    _close64(got, want)
    # the refinement moves the alms
    once = sht.map2alm(T(maps), lmax, spin=spin)
    assert not torch.allclose(got, once, rtol=0, atol=1e-8)


def test_alm2map_and_iterations_float32():
    """One float32 case: the spin-2 path, through both pair plain versions."""
    spin, nside, lmax = 2, 8, 16
    rng = np.random.default_rng(40 + spin)
    alm = _cplx(rng, (2, sht.alm_size(lmax)) if spin
                else sht.alm_size(lmax)).astype(np.complex64)
    want = np.asarray(jsht.alm2map(jnp.asarray(alm), nside, lmax, spin=spin))
    got = sht.alm2map(T(alm), nside, lmax, spin=spin)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                               atol=2e-5 * np.abs(want).max())
    maps = want.astype(np.float32)
    want = np.asarray(jsht.map2alm(jnp.asarray(maps), lmax, spin=spin,
                                   iterations=2))
    got = sht.map2alm(T(maps), lmax, spin=spin, iterations=2)
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                               atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("spin", [0, 2])
def test_round_trip(spin):
    """Band-limited alms come back from their map: 3 iterations to 1e-8."""
    nside, lmax = 32, 48
    rng = np.random.default_rng(50 + spin)
    alm = T(np.stack([_band_limited(rng, lmax) for _ in range(2)]) if spin
            else _band_limited(rng, lmax))
    if spin:  # E and B of a_{l<2} do not exist
        alm[..., np.asarray(sht._pack_index(lmax, lmax, "cpu")[0]) < 2] = 0
    maps = sht.alm2map(alm, nside, lmax, spin=spin)
    back0 = sht.map2alm(maps, lmax, spin=spin)
    back3 = sht.map2alm(maps, lmax, spin=spin, iterations=3)
    scale = alm.abs().max()
    err0 = float((back0 - alm).abs().max() / scale)
    err3 = float((back3 - alm).abs().max() / scale)
    assert err3 <= 1e-8 and err3 < err0


# -- the mapper and the pipeline's hand-offs -------------------------------------


@pytest.mark.parametrize("spin", [0, 2])
def test_mapper_iterations_and_synthesize(spin):
    """transform(iterations=) before deconvolution, and synthesize."""
    nside, lmax = 64, 96
    rng = np.random.default_rng(60 + spin)
    maps = rng.normal(size=(2, 12 * nside**2) if spin else (12 * nside**2,))
    jm = jh.HealpixMapper(nside, lmax, iterations=2)
    tm = th.HealpixMapper(nside, lmax, iterations=2, device="cpu")
    assert tm.iterations == 2
    want = jm.transform(maps.copy(), spin=spin)
    got = tm.transform(T(maps), spin=spin)
    _close64(got.array, want)
    assert got.metadata["deconv"] is True
    m_want = jm.synthesize(want, spin=spin)
    m_got = tm.synthesize(np.asarray(got), spin=spin)
    assert isinstance(m_got, th.DeviceMap)
    _close64(m_got.array, m_want)
    assert m_got.metadata == dict(m_want.dtype.metadata)


def test_mapper_synthesize_float32_devicemap():
    nside, lmax = 16, 24
    rng = np.random.default_rng(7)
    tm = th.HealpixMapper(nside, lmax, dtype=torch.float32, device="cpu")
    alm = th.DeviceMap(T(_band_limited(rng, lmax).astype(np.complex64)))
    m = tm.synthesize(alm)
    assert m.array.dtype == torch.float32 and m.shape == (12 * nside**2,)
    assert m.metadata["nside"] == nside and m.metadata["spin"] == 0


def test_jax_alms_through_port_alm2map():
    """heracles_tpu's alms, carried over with to_torch, give its maps."""
    nside, lmax = 16, 32
    rng = np.random.default_rng(8)
    jm = jh.HealpixMapper(nside, lmax, deconvolve=False)
    maps = {("POS", 0): rng.normal(size=12 * nside**2)}
    alms_j = jh.TocDict({k: jm.transform(v) for k, v in maps.items()})
    alms_t = th.to_torch(alms_j, device="cpu")
    for key, alm in alms_t.items():
        want = jsht.alm2map(jnp.asarray(alms_j[key]), nside, lmax)
        _close64(sht.alm2map(alm.array, nside, lmax), want)
