"""The port's synthesis against heracles_tpu, on the CPU.

Same numpy-made inputs through each heracles_tpu function and its
heracles_tpu_torch counterpart: the plain synthesis scans (the kernels'
plain versions, which the CPU path takes), ``ring_synthesis``,
``alm2map``, and the entry points' default device.  The iterations, the
float32 synthesis and the mapper are in
``tests/test_torch_synthesis_maps.py`` (two files, so that two workers
share them).  The JAX side runs as its own CPU tests run it: float64
through the jnp scans (tests/conftest.py enables x64), the Pallas
synthesis kernels in interpret mode for float32.

Tolerances: float64 ``atol = 1e-10 * scale`` (the same algorithm with
another summation order); float32 against the Pallas kernels at the bars
tests/test_pallas.py holds those kernels to (spin 0: ``atol = 2e-5 *
scale, rtol = 2e-4``; pair: ``atol = 3e-5 * scale, rtol = 3e-4``).
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import heracles_tpu_torch as th
from heracles_tpu.ops import ringfft as jrf
from heracles_tpu.ops import sht as jsht
from heracles_tpu.ops import wigner as jw
from heracles_tpu_torch import convert, mappers, twopoint
from heracles_tpu_torch.ops import _build, ringfft, sht, sht_kernels, wigner

T = torch.as_tensor


def _close64(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-10 * np.abs(want).max())


def _geometry(nside):
    nhalf = 2 * nside
    return [a[:nhalf] for a in jsht._geom_arrays(nside, "float64")]


def _cplx(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


# -- the plain synthesis scans --------------------------------------------------


@pytest.mark.parametrize("nside,lmax,batch", [(8, 16, 1), (16, 24, 2),
                                              (32, 70, 1)])
def test_synthesis_spin0_plain(nside, lmax, batch):
    rng = np.random.default_rng(nside + 5)
    nm = lmax + 1
    alm = _cplx(rng, (batch, lmax + 1, nm))
    x, lch, lsh = _geometry(nside)
    ms = np.arange(nm)
    wantN, wantS = jw.lambda_synthesis_scan_folded(
        jnp.asarray(ms), jnp.zeros_like(jnp.asarray(ms)), jnp.asarray(x),
        jnp.asarray(lch), jnp.asarray(lsh), lmax, jnp.asarray(alm),
    )
    GN, GS = sht_kernels.synthesis_spin0_folded(T(alm), T(x), T(lch), T(lsh),
                                                lmax)
    _close64(GN, wantN)
    _close64(GS, wantS)


def test_synthesis_spin0_plain_high_m():
    """High orders at small theta: the scaled seeds must not underflow."""
    nside, lmax, nm = 32, 48, 128
    rng = np.random.default_rng(2)
    alm = _cplx(rng, (lmax + 1, nm))
    x, lch, lsh = _geometry(nside)
    ms = np.arange(nm)
    wantN, wantS = jw.lambda_synthesis_scan_folded(
        jnp.asarray(ms), jnp.zeros_like(jnp.asarray(ms)), jnp.asarray(x),
        jnp.asarray(lch), jnp.asarray(lsh), lmax, jnp.asarray(alm),
    )
    GN, GS = sht_kernels.synthesis_spin0_folded(T(alm), T(x), T(lch), T(lsh),
                                                lmax)
    _close64(GN, wantN)
    _close64(GS, wantS)
    # orders above lmax have no l >= m to sum
    assert np.all(GN[:, lmax + 1:].numpy() == 0)


@pytest.mark.parametrize("nside,lmax,batch", [(8, 16, 1), (16, 24, 2),
                                              (32, 70, 1)])
def test_synthesis_pair_plain(nside, lmax, batch):
    """The cross scan's block swap written out (GSp sums a_p lam_m)."""
    spin = 2
    rng = np.random.default_rng(nside + 6)
    nm = lmax + 1
    ap, am = _cplx(rng, (batch, lmax + 1, nm)), _cplx(rng, (batch, lmax + 1, nm))
    x, lch, lsh = _geometry(nside)
    ms = np.tile(np.arange(nm), 2)
    ns = np.repeat([spin, -spin], nm)
    wantN, wantS = (np.asarray(w) for w in jw.lambda_synthesis_scan_folded(
        jnp.asarray(ms), jnp.asarray(ns), jnp.asarray(x), jnp.asarray(lch),
        jnp.asarray(lsh), lmax, jnp.asarray(np.concatenate([ap, am], -1)),
        cross=True,
    ))
    GNp, GSp, GNm, GSm = sht_kernels.synthesis_pair_folded(
        T(ap), T(am), T(x), T(lch), T(lsh), lmax, spin)
    _close64(GNp, wantN[..., :nm])
    _close64(GSp, wantS[..., :nm])
    _close64(GNm, wantN[..., nm:])
    _close64(GSm, wantS[..., nm:])


def test_synthesis_plain_float32_matches_pallas():
    """The float32 plain versions against the Pallas kernels (interpret)."""
    from heracles_tpu.ops.pallas_sht import (synthesis_pair_folded,
                                             synthesis_spin0_folded)

    nside, lmax, nm_pad, spin = 16, 24, 128, 2
    nhalf = 2 * nside
    rng = np.random.default_rng(9)
    x, lch, lsh = (a[:nhalf] for a in jsht._geom_arrays(nside, "float32"))
    xt, lcht, lsht = (T(a) for a in _geometry(nside))

    alm = _cplx(rng, (lmax + 1, nm_pad)).astype(np.complex64)
    want = synthesis_spin0_folded(
        jnp.asarray(alm), jnp.asarray(x), jnp.asarray(lch), jnp.asarray(lsh),
        lmax, ring_block=16, interpret=True)
    got = sht_kernels.synthesis_spin0_folded(T(alm), xt, lcht, lsht, lmax)
    scale = np.abs(np.asarray(want[0])).max()
    for g, w in zip(got, want):
        assert g.dtype == torch.complex64
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=2e-5 * scale, rtol=2e-4)

    ap = _cplx(rng, (2, lmax + 1, nm_pad)).astype(np.complex64)
    am = _cplx(rng, (2, lmax + 1, nm_pad)).astype(np.complex64)
    want = synthesis_pair_folded(
        jnp.asarray(ap), jnp.asarray(am), jnp.asarray(x), jnp.asarray(lch),
        jnp.asarray(lsh), lmax, spin, ring_block=16, interpret=True)
    got = sht_kernels.synthesis_pair_folded(T(ap), T(am), xt, lcht, lsht, lmax,
                                            spin)
    scale = np.abs(np.asarray(want[0])).max()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=3e-5 * scale, rtol=3e-4)


def test_synthesis_on_cpu_uses_plain(monkeypatch):
    """CPU tensors take the plain synthesis, launch nothing, build nothing."""
    sht_kernels.reset_counts()

    def no_build():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(_build, "load_library", no_build)
    nside, lmax = 8, 10
    x, lch, lsh = (T(a) for a in _geometry(nside))
    a = torch.ones((lmax + 1, lmax + 1), dtype=torch.complex128)
    sht_kernels.synthesis_spin0_folded(a, x, lch, lsh, lmax)
    sht_kernels.synthesis_pair_folded(a, a, x, lch, lsh, lmax, 2)
    assert sum(sht_kernels.LAUNCHES.values()) == 0
    assert wigner.PLAIN_RUNS == {"synthesis_spin0_folded": 1,
                                 "synthesis_pair_folded": 1}
    with pytest.raises(ValueError, match="alms must be"):
        sht_kernels.synthesis_spin0_folded(a[:-1], x, lch, lsh, lmax)
    with pytest.raises(TypeError, match="complex64 or complex128 alms"):
        sht_kernels.synthesis_spin0_folded(a.real, x, lch, lsh, lmax)


# -- ring synthesis, alm2map, iterations ----------------------------------------


@pytest.mark.parametrize("nside,nm", [(8, 13), (16, 25), (16, 40)])
def test_ring_synthesis(nside, nm):
    """Real output, and complex output with h_neg; nm = 40 > 2 nside
    aliases the belt and the caps."""
    rng = np.random.default_rng(nside * nm)
    nr = 4 * nside - 1
    hp, hn = _cplx(rng, (2, nr, nm)), _cplx(rng, (2, nr, nm))
    want = jrf.ring_synthesis(jnp.asarray(hp), None, nside)
    got = ringfft.ring_synthesis(T(hp), None, nside)
    assert got.dtype == torch.float64
    _close64(got, want)
    want = jrf.ring_synthesis(jnp.asarray(hp), jnp.asarray(hn), nside,
                              real_output=False)
    got = ringfft.ring_synthesis(T(hp), T(hn), nside, real_output=False)
    assert got.dtype == torch.complex128
    _close64(got, want)


@pytest.mark.parametrize("spin", [0, 2])
@pytest.mark.parametrize("nside,lmax", [(8, 16), (16, 40)])
def test_alm2map(nside, lmax, spin):
    rng = np.random.default_rng(nside + spin)
    nlm = sht.alm_size(lmax)
    alm = _cplx(rng, (2, nlm) if spin else (3, nlm))
    want = jsht.alm2map(jnp.asarray(alm), nside, lmax, spin=spin)
    got = sht.alm2map(T(alm), nside, lmax, spin=spin)
    _close64(got, want)
    # rectangular input, lmax from the shape
    rect = sht.unpack_alm(T(alm), lmax)
    _close64(sht.alm2map(rect, nside, spin=spin, packed=False), want)


def test_entry_points_default_to_the_card():
    """Every port entry point with a device choice defaults to cuda."""

    def default(fn, name="device"):
        return torch.device(inspect.signature(fn).parameters[name].default)

    cuda = torch.device("cuda")
    assert default(mappers.HealpixMapper) == cuda
    assert th.HealpixMapper(8).device == cuda  # resolved, nothing allocated
    assert default(twopoint.mixmat) == cuda
    assert default(twopoint.mixmat_eb) == cuda
    assert default(twopoint.invert_mixing_matrix) == cuda
    assert default(convert.to_torch) == cuda
    # mixing_matrices takes its fields' device, and the card when none has one
    assert twopoint._fields_device([]) == cuda
    cpu_field = type("F", (), {"mapper": th.HealpixMapper(8, device="cpu")})()
    assert twopoint._fields_device([cpu_field]) == torch.device("cpu")
