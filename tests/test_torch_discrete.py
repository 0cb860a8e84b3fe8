"""The port's pixel-free mapper against heracles_tpu on the CPU.

``DiscreteMapper`` (exact and gridded, spin 0 and spin 2, paged and
unpaged), ``ops.nufft`` (the plain spreader, ``adjoint_gridded``) and the
paged ``map_catalogs`` with ``Positions`` and ``Spin2Field``: the same
seeded numpy points go through both packages in float64.  The reference
runs once per module (it compiles every call anew).

Tolerances: the exact adjoint is the same float64 recurrence summed in
another order (the port sorts each block by colatitude), 1e-10 of the
largest alm; the gridded path against the reference's at epsilon 1e-12,
1e-11 of max, and against the exact adjoint at the bounds of the
reference's own test (tests/test_nufft.py:34): 3e-5, 3e-9 and 1e-11 of
max at epsilon 1e-5, 1e-9 and 1e-12; the spreader against the
reference's, the same float64 stencil sums in another order, 1e-13 of
max.
"""

import numpy as np
import pytest
import torch

import heracles_tpu as jh
import heracles_tpu_torch as th
from heracles_tpu.ops import nufft as jnufft
from heracles_tpu_torch.ops import nufft

LMAX = 16
NPTS = 400


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(11)
    theta = np.arccos(rng.uniform(-1, 1, NPTS))
    phi = rng.uniform(0, 2 * np.pi, NPTS)
    # a pole and an equator point: the clamped logs and the padding angle
    theta[:2] = 0.0, np.pi / 2
    return theta, phi, rng.normal(size=(2, NPTS))


@pytest.fixture(scope="module")
def reference(points):
    """The reference's exact and gridded alms of the points, once."""
    theta, phi, v = points
    mapper = jh.DiscreteMapper(LMAX)
    return {
        "exact": {s: np.asarray(mapper._adjoint_synthesis(theta, phi, v, spin=s))
                  for s in (0, 2)},
        "gridded": {s: np.asarray(jnufft.adjoint_gridded(theta, phi, v, LMAX,
                                                        spin=s, epsilon=1e-12))
                    for s in (0, 2)},
    }


def _close(got, want, rel):
    got = np.asarray(got)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.max(np.abs(got - want)) <= rel * scale


@pytest.mark.parametrize("spin", [0, 2])
@pytest.mark.parametrize("block", [128, 1 << 16])
def test_exact_adjoint_matches_reference(points, reference, spin, block):
    """Blocks of 128 points (a padded tail) and one block of all."""
    theta, phi, v = points
    mapper = th.DiscreteMapper(LMAX, point_block=block, device="cpu")
    got = mapper._adjoint_synthesis(theta, phi, v, spin)
    assert got.dtype == torch.complex128
    _close(got, reference["exact"][spin], 1e-10)


@pytest.mark.parametrize("spin", [0, 2])
def test_gridded_matches_reference(points, reference, spin):
    theta, phi, v = points
    got = nufft.adjoint_gridded(theta, phi, v, LMAX, spin=spin, epsilon=1e-12,
                                device="cpu")
    _close(got, reference["gridded"][spin], 1e-11)


@pytest.mark.parametrize("eps,bound", [(1e-5, 3e-5), (1e-9, 3e-9),
                                       (1e-12, 1e-11)])
@pytest.mark.parametrize("spin", [0, 2])
def test_gridded_matches_exact(points, spin, eps, bound):
    theta, phi, v = points
    exact = th.DiscreteMapper(LMAX, device="cpu")._adjoint_synthesis(
        theta, phi, v, spin).numpy()
    got = nufft.adjoint_gridded(theta, phi, v, LMAX, spin=spin, epsilon=eps,
                                device="cpu").numpy()
    _close(got.reshape(exact.shape), exact, bound)


@pytest.mark.parametrize("complex_vals", [False, True])
def test_plain_spreader_matches_reference(points, complex_vals):
    theta, phi, v = points
    vals = (v[0] + 1j * v[1])[None] if complex_vals else v
    w = nufft.kernel_width(1e-9)
    want = jnufft.spread_torus(theta, phi, vals, LMAX, w)
    nufft.reset_counts()
    got = nufft.spread_torus(theta, phi, torch.as_tensor(vals), LMAX, w,
                             device="cpu")
    assert nufft.PLAIN_RUNS["spread"] == 1 and not nufft.LAUNCHES
    assert got.dtype == (torch.complex128 if complex_vals else torch.float64)
    _close(got, want, 1e-13)
    # pages spread into one padded grid equal one spread of all points
    pad = nufft.alloc_padded(vals.shape[0], LMAX, w, complex_vals, "cpu")
    for sl in (slice(0, 150), slice(150, None)):
        nufft.spread_padded(theta[sl], phi[sl], vals[:, sl], LMAX, w, pad)
    _close(nufft.fold_padded(pad, LMAX, w), want, 1e-13)


@pytest.mark.parametrize("complex_vals", [False, True])
def test_spread_torus_adds_into_a_given_grid(points, complex_vals):
    """``spread_torus(grid=)``: the reference accumulates into a given
    grid and returns it; so does the port, in place, on the grid's
    device."""
    theta, phi, v = points
    vals = (v[0] + 1j * v[1])[None] if complex_vals else v
    w = nufft.kernel_width(1e-9)
    start = np.random.default_rng(12).normal(
        size=(vals.shape[0],) + nufft.grid_shape(LMAX))
    start = start.astype(vals.dtype)
    want = jnufft.spread_torus(theta, phi, vals, LMAX, w, grid=start.copy())
    grid = torch.as_tensor(start.copy())
    got = nufft.spread_torus(theta, phi, torch.as_tensor(vals), LMAX, w,
                             grid)
    assert got is grid
    _close(got, want, 1e-13)
    with pytest.raises(ValueError, match="not the torus grid"):
        nufft.spread_torus(theta, phi, torch.as_tensor(vals), LMAX, w,
                           grid[..., :-1])


def test_discrete_mapper_takes_nthreads(points):
    """``DiscreteMapper(nthreads=)``: the reference accepts it and ignores
    it; the port's mapper takes it and gives the same alms as without."""
    theta, phi, v = points
    want = np.asarray(jh.DiscreteMapper(LMAX, nthreads=4)._adjoint_synthesis(
        theta, phi, v, spin=0))
    mapper = th.DiscreteMapper(LMAX, nthreads=4, device="cpu")
    got = mapper._adjoint_synthesis(theta, phi, v, 0)
    _close(got, want, 1e-10)
    assert torch.equal(got, th.DiscreteMapper(LMAX, device="cpu")
                       ._adjoint_synthesis(theta, phi, v, 0))


def test_helpers_match_reference():
    for eps in (1e-3, 1e-5, 1e-9, 1e-12, 1e-17):
        assert nufft.kernel_width(eps) == jnufft.kernel_width(eps)
    for lmax in (0, 16, 100, 1000, 3000):
        assert nufft.grid_shape(lmax) == jnufft.grid_shape(lmax)
    inv_phi, dec = nufft._deconv_factors(LMAX, 10)
    jinv, jdec = jnufft._deconv_factors(LMAX, 10, np.float64)
    np.testing.assert_array_equal(inv_phi, jinv)
    np.testing.assert_array_equal(dec, jdec)
    from heracles_tpu.mappers import _point_geometry as jgeom
    from heracles_tpu_torch.ops.sht import _point_geometry

    theta = np.array([0.0, 0.3, np.pi / 2, 2.0, np.pi])
    for got, want in zip(_point_geometry(theta), jgeom(theta, np.float64)):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.fixture(scope="module")
def catalog_arrays():
    rng = np.random.default_rng(7)
    n = 1500
    return np.rec.fromarrays(
        [rng.uniform(0, 360, n), np.degrees(np.arcsin(rng.uniform(-1, 1, n))),
         rng.normal(0, 0.1, n), rng.normal(0, 0.1, n), rng.uniform(0.5, 1, n)],
        names=["RA", "DEC", "G1", "G2", "W"],
    )


def _map_catalogs(pkg, mapper, arr):
    cat = pkg.ArrayCatalog(arr)
    cat.page_size = 500  # several pages: the grid accumulates across them
    fields = {
        "POS": pkg.Positions(mapper, "RA", "DEC", overdensity=False),
        "SHE": pkg.Spin2Field(mapper, "RA", "DEC", "G1", "G2", "W"),
    }
    maps = pkg.map_catalogs(fields, {0: cat})
    return pkg.transform(fields, maps)


@pytest.fixture(scope="module")
def reference_paged(catalog_arrays):
    return _map_catalogs(jh, jh.DiscreteMapper(LMAX, method="gridded"),
                         catalog_arrays)


@pytest.mark.parametrize("method", ["gridded", "exact", "auto"])
def test_paged_mapping_matches_reference(catalog_arrays, reference_paged,
                                         method):
    mapper = th.DiscreteMapper(LMAX, method=method, point_block=512,
                               device="cpu")
    got = _map_catalogs(th, mapper, catalog_arrays)
    assert set(got) == set(reference_paged) == {("POS", 0), ("SHE", 0)}
    for key, want in reference_paged.items():
        assert isinstance(got[key], th.DeviceMap)
        _close(got[key], np.asarray(want), 1e-10)
        assert got[key].metadata == dict(want.dtype.metadata)
    assert got["SHE", 0].shape == (2, (LMAX + 1) * (LMAX + 2) // 2)


def test_map_values_auto_rule(points, reference):
    """At most 4 (lmax + 1) points take the exact path, more the gridded
    one; both add into the data in place."""
    theta, phi, v = points
    lon, lat = np.degrees(phi), 90.0 - np.degrees(theta)
    mapper = th.DiscreteMapper(LMAX, device="cpu")
    few = 4 * (LMAX + 1)
    data = mapper.create()
    assert data.metadata == dict(geometry="discrete", kernel="none", lmax=LMAX,
                                 spin=0)
    nufft.reset_counts()
    mapper.map_values(lon[:few], lat[:few], data, v[0, :few])
    assert not nufft.PLAIN_RUNS  # exact: no spread
    want = jh.DiscreteMapper(LMAX).create()
    jh.DiscreteMapper(LMAX).map_values(lon[:few], lat[:few], want, v[0, :few])
    _close(data, want, 1e-10)
    mapper.map_values(lon, lat, data, v[0])
    assert nufft.PLAIN_RUNS["spread"] == 1  # gridded
    _close(data, want + reference["exact"][0][0], 1e-10)
    eb = mapper.create(2, spin=2)
    mapper.map_values(lon, lat, eb, v, spin=2)
    _close(eb, reference["exact"][2], 1e-10)


def test_finish_takes_the_spin_of_begin(points, reference):
    theta, phi, v = points
    lon, lat = np.degrees(phi), 90.0 - np.degrees(theta)
    mapper = th.DiscreteMapper(LMAX, device="cpu")
    state = mapper.begin(2, spin=2)
    assert state["method"] == "gridded" and state["epsilon"] == 1e-12
    mapper.add(state, lon[:200], lat[:200], v[:, :200])
    mapper.add(state, lon[200:], lat[200:], v[:, 200:])
    out = mapper.finish(state)  # the default spin=0 is not the state's
    assert out.metadata["spin"] == 2 and out.shape == (2, reference["exact"][2].shape[-1])
    _close(out, reference["exact"][2], 1e-11)
    state = th.DiscreteMapper(LMAX, dtype=torch.complex64, device="cpu").begin()
    assert state["epsilon"] == 1e-5 and state["w"] == 6


def test_resample_and_protocol():
    rng = np.random.default_rng(3)
    nlm = (LMAX + 1) * (LMAX + 2) // 2
    alm = rng.normal(size=(2, nlm)) + 1j * rng.normal(size=(2, nlm))
    for lmax_out in (LMAX - 5, LMAX, LMAX + 4):
        got = th.DiscreteMapper(lmax_out, device="cpu").resample(alm)
        want = jh.DiscreteMapper(lmax_out).resample(alm)
        np.testing.assert_array_equal(np.asarray(got), want)
    mapper = th.DiscreteMapper(LMAX, device="cpu")
    assert isinstance(mapper, th.Mapper) and isinstance(mapper, jh.Mapper)
    assert mapper.area == 1.0 and mapper.lmax == LMAX
    data = mapper.create()
    assert mapper.transform(data) is data
    with pytest.raises(ValueError, match="method"):
        th.DiscreteMapper(LMAX, method="fast")
    with pytest.raises(TypeError):
        th.DiscreteMapper(LMAX, dtype=torch.float64)
