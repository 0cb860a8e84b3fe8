"""Entry points the port lacked, against heracles_tpu on the CPU.

``dd=`` on ``map2alm``, ``alm2map`` and ``HealpixMapper``; the
``device_maps=`` argument; ``map_values``; ``resample`` and the HEALPix
index functions behind it (``nside2nrings``, ``pix2ang_ring``,
``ring2nest``, ``nest2ring``, ``ud_grade``).  Inputs come from a numpy seed
and go through both packages.

Tolerances.  ``dd``: float32 input keeps its float32 ring FFTs in both
packages and only the Wigner stage widens (float64 in the port,
double-single float32 in the reference), so the two agree at the float32
bar of the other tests, ``atol = 2e-5 * scale, rtol = 2e-4``, and return
the same dtypes.  ``map_values``: the same float64 values summed into the
same pixels in another order, ``1e-12``.  The index functions are integer
arithmetic and float64 closed forms of the same operations: exact.
``ud_grade``: a mean of the same float64 children, ``1e-14``.

The reference's ``ud_grade`` numbers the pixels of its result in NEST order
(row i of its child table belongs to NEST pixel i) although its input is
RING-ordered; its own tests (a round trip, a constant map) cannot see
that.  The port's result is RING-ordered, which a map of the pixels' own
colatitudes shows, so the two are compared through ``ring2nest``: pixel r
of the port's degraded map is pixel ``ring2nest(r)`` of the reference's,
and the reference upgrades a map read in NEST order.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import heracles_tpu as jh
import heracles_tpu_torch as th
from heracles_tpu import healpix as jhp
from heracles_tpu.ops import sht as jsht
from heracles_tpu_torch import healpix as thp
from heracles_tpu_torch.ops import sht

T = torch.as_tensor
NSIDE, LMAX = 8, 12
NPIX = 12 * NSIDE**2


def _close32(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-5 * np.abs(want).max())


def _maps32(spin):
    rng = np.random.default_rng(70 + spin)
    return rng.normal(size=(2, NPIX) if spin else NPIX).astype(np.float32)


def _alms32(spin):
    rng = np.random.default_rng(80 + spin)
    shape = (2, sht.alm_size(LMAX)) if spin else (sht.alm_size(LMAX),)
    alm = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    alm[..., :LMAX + 1] = alm[..., :LMAX + 1].real  # a_{l0} of a real map
    return alm.astype(np.complex64)


# the reference compiles each of its transforms anew: run each once
_REFERENCE = {}


def _reference(kind, spin):
    """The reference's ``dd=True`` analysis of ``_maps32`` or synthesis of
    ``_alms32``, as numpy."""
    if (kind, spin) not in _REFERENCE:
        if kind == "map2alm":
            out = jsht.map2alm(jnp.asarray(_maps32(spin)), LMAX, spin=spin,
                               dd=True)
        else:
            out = jsht.alm2map(jnp.asarray(_alms32(spin)), NSIDE, LMAX,
                               spin=spin, dd=True)
        _REFERENCE[kind, spin] = np.asarray(out)
    return _REFERENCE[kind, spin]


# -- dd= ---------------------------------------------------------------------------


@pytest.mark.parametrize("dd", [True, "comp"])
@pytest.mark.parametrize("spin", [0, 2])
def test_map2alm_dd(spin, dd):
    want = _reference("map2alm", spin)
    got = sht.map2alm(T(_maps32(spin)), LMAX, spin=spin, dd=dd)
    assert want.dtype == np.complex64 and got.dtype == torch.complex64
    _close32(got, want)


@pytest.mark.parametrize("dd", [True, "comp"])
@pytest.mark.parametrize("spin", [0, 2])
def test_alm2map_dd(spin, dd):
    want = _reference("alm2map", spin)
    got = sht.alm2map(T(_alms32(spin)), NSIDE, LMAX, spin=spin, dd=dd)
    assert want.dtype == np.float32 and got.dtype == torch.float32
    _close32(got, want)


def test_map2alm_dd_with_iterations():
    """The Jacobi steps' syntheses and analyses take ``dd`` too."""
    maps = _maps32(0)
    want = np.asarray(jsht.map2alm(jnp.asarray(maps), LMAX, dd=True,
                                   iterations=1))
    got = sht.map2alm(T(maps), LMAX, dd=True, iterations=1)
    assert got.dtype == torch.complex64
    _close32(got, want)
    assert not torch.equal(got, sht.map2alm(T(maps), LMAX, dd=True))


@pytest.mark.parametrize("dd", [True, "comp"])
@pytest.mark.parametrize("spin", [0, 2])
def test_mapper_dd(spin, dd):
    """The mapper hands ``dd`` to its analysis and its synthesis."""
    mapper = th.HealpixMapper(NSIDE, LMAX, dtype=torch.float32, device="cpu",
                              deconvolve=False, dd=dd)
    assert mapper.dd == dd
    got = mapper.transform(T(_maps32(spin)), spin=spin)
    assert got.array.dtype == torch.complex64
    _close32(got.array, _reference("map2alm", spin))
    back = mapper.synthesize(T(_alms32(spin)), spin=spin)
    assert back.array.dtype == torch.float32
    _close32(back.array, _reference("alm2map", spin))
    # what dd changes: the same calls without it differ in the last bits
    plain = th.HealpixMapper(NSIDE, LMAX, dtype=torch.float32, device="cpu",
                             deconvolve=False)
    assert plain.dd is None
    assert not torch.equal(plain.transform(T(_maps32(spin)), spin=spin).array,
                           got.array)


def test_reference_mapper_dd():
    """The reference's own mapper with ``dd=True`` on the same map."""
    maps = _maps32(0)
    want = jh.HealpixMapper(NSIDE, LMAX, dtype=np.float32, deconvolve=False,
                            dd=True).transform(maps.copy())
    got = th.HealpixMapper(NSIDE, LMAX, dtype=torch.float32, device="cpu",
                           deconvolve=False, dd=True).transform(maps)
    assert np.asarray(want).dtype == np.complex64
    _close32(got.array, want)


@pytest.mark.parametrize("spin", [0, 2])
def test_dd_is_no_farther_from_float64(spin):
    """``dd`` widens the stage that loses the most in float32."""
    maps = T(_maps32(spin))
    a64 = sht.map2alm(maps.double(), LMAX, spin=spin)
    err = {dd: float((sht.map2alm(maps, LMAX, spin=spin, dd=dd).to(a64.dtype)
                      - a64).abs().max()) for dd in (False, True)}
    assert err[True] <= err[False]
    alm = T(_alms32(spin))
    m64 = sht.alm2map(alm.to(torch.complex128), NSIDE, LMAX, spin=spin)
    err = {dd: float((sht.alm2map(alm, NSIDE, LMAX, spin=spin, dd=dd).double()
                      - m64).abs().max()) for dd in (False, True)}
    assert err[True] <= err[False]


@pytest.mark.parametrize("dd", [None, False])
def test_dd_off_is_the_float32_path(dd):
    maps = T(_maps32(0))
    assert torch.equal(sht.map2alm(maps, LMAX, dd=dd), sht.map2alm(maps, LMAX))


@pytest.mark.parametrize("spin", [0, 2])
def test_dd_ignored_for_float64(spin):
    maps = T(_maps32(spin)).double()
    alm = sht.map2alm(maps, LMAX, spin=spin)
    assert alm.dtype == torch.complex128
    assert torch.equal(sht.map2alm(maps, LMAX, spin=spin, dd=True), alm)
    assert torch.equal(sht.map2alm(maps, LMAX, spin=spin, iterations=1, dd=True),
                       sht.map2alm(maps, LMAX, spin=spin, iterations=1))
    back = sht.alm2map(alm, NSIDE, LMAX, spin=spin)
    assert back.dtype == torch.float64
    assert torch.equal(sht.alm2map(alm, NSIDE, LMAX, spin=spin, dd="comp"), back)
    mapper = th.HealpixMapper(NSIDE, LMAX, device="cpu", deconvolve=False,
                              dd=True)
    assert torch.equal(mapper.transform(maps, spin=spin).array, alm)


# -- device_maps= ------------------------------------------------------------------


@pytest.mark.parametrize("device_maps", [None, True])
def test_device_maps_accepted(device_maps):
    mapper = th.HealpixMapper(NSIDE, device="cpu", device_maps=device_maps)
    assert isinstance(mapper.finish(mapper.begin()), th.DeviceMap)
    assert isinstance(mapper.create(), th.DeviceMap)


def test_device_maps_false_raises():
    with pytest.raises(ValueError, match="always returns a DeviceMap"):
        th.HealpixMapper(NSIDE, device="cpu", device_maps=False)


# -- map_values ----------------------------------------------------------------------


def _points(n=5000):
    rng = np.random.default_rng(90)
    lon = rng.uniform(-20.0, 380.0, n)  # wraps around
    lat = np.degrees(np.arcsin(rng.uniform(-1, 1, n)))
    lat[:2] = 90.0, -90.0  # the poles
    return lon, lat, rng


@pytest.mark.parametrize("dims", [(), (2,)])
@pytest.mark.parametrize("wrapped", [False, True])
def test_map_values(dims, wrapped):
    """In place into a tensor or a DeviceMap, on top of what it holds."""
    lon, lat, rng = _points()
    values = rng.normal(size=(*dims, lon.size))
    start = rng.normal(size=(*dims, NPIX))
    want = start.copy()
    jh.HealpixMapper(NSIDE).map_values(lon, lat, want, values)
    mapper = th.HealpixMapper(NSIDE, device="cpu")
    data = T(start.copy())
    held = th.DeviceMap(data, metadata={"spin": 0}) if wrapped else data
    assert mapper.map_values(lon, lat, held, values) is None
    np.testing.assert_allclose(data.numpy(), want, rtol=0, atol=1e-12)
    assert not np.array_equal(data.numpy(), start)


def test_map_values_is_add():
    """One scatter: ``map_values`` and ``add`` give the same bits, and a
    float32 tensor is added into in float32."""
    lon, lat, rng = _points()
    values = rng.normal(size=lon.size)
    mapper = th.HealpixMapper(NSIDE, dtype=torch.float32, device="cpu")
    state = mapper.add(mapper.begin(), lon, lat, values)
    data = mapper.create()
    mapper.map_values(lon, lat, data, values)
    assert data.array.dtype == torch.float32
    assert torch.equal(data.array, state)
    with pytest.raises(TypeError, match="tensor or a DeviceMap"):
        mapper.map_values(lon, lat, np.zeros(NPIX), values)


# -- the index functions -------------------------------------------------------------


@pytest.mark.parametrize("nside", [1, 2, 3, 8, 12, 32])
def test_pix2ang_ring(nside):
    assert thp.nside2nrings(nside) == jhp.nside2nrings(nside) == 4 * nside - 1
    pix = np.arange(12 * nside**2)
    for lonlat in (False, True):
        want = jhp.pix2ang_ring(nside, pix, lonlat=lonlat)
        got = thp.pix2ang_ring(nside, pix, lonlat=lonlat)
        for g, w in zip(got, want):
            assert g.dtype == np.float64
            np.testing.assert_array_equal(g, w)
    # and back through the port's ang2pix on tensors
    theta, phi = thp.pix2ang_ring(nside, pix)
    np.testing.assert_array_equal(
        thp.ang2pix_ring(nside, T(theta), T(phi)).numpy(), pix)


@pytest.mark.parametrize("nside", [1, 2, 8, 32])
def test_ring_nest(nside):
    pix = np.arange(12 * nside**2)
    nest = thp.ring2nest(nside, pix)
    assert nest.dtype == np.int64
    np.testing.assert_array_equal(nest, jhp.ring2nest(nside, pix))
    np.testing.assert_array_equal(thp.nest2ring(nside, pix),
                                  jhp.nest2ring(nside, pix))
    np.testing.assert_array_equal(thp.nest2ring(nside, nest), pix)
    # shapes other than a vector, as the child tables have
    block = pix.reshape(12, -1)[:, ::-1]
    np.testing.assert_array_equal(thp.nest2ring(nside, block),
                                  jhp.nest2ring(nside, block))


def _smooth(nside):
    """A map whose values tell where its pixels lie."""
    theta, phi = thp.pix2ang_ring(nside, np.arange(12 * nside**2))
    return np.cos(theta) + 0.3 * np.sin(phi)


@pytest.mark.parametrize("power", [None, -2])
@pytest.mark.parametrize("nside_in,nside_out", [(16, 8), (16, 4), (8, 32),
                                                (8, 8)])
def test_ud_grade(nside_in, nside_out, power):
    rng = np.random.default_rng(nside_in + nside_out)
    m = rng.normal(size=(2, 12 * nside_in**2))
    want = np.asarray(jhp.ud_grade(m, nside_out, power=power))
    got = thp.ud_grade(T(m), nside_out, power=power)
    assert got.dtype == torch.float64 and got.shape == want.shape
    if nside_out < nside_in:
        # the reference's result in its own (NEST) numbering; see the top
        want = want[:, jhp.ring2nest(nside_out, np.arange(want.shape[-1]))]
    elif nside_out > nside_in:
        permuted = m[:, jhp.nest2ring(nside_in, np.arange(m.shape[-1]))]
        want = np.asarray(jhp.ud_grade(permuted, nside_out, power=power))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-14)
    assert thp.ud_grade(T(m), nside_out, dtype=torch.float32).dtype \
        == torch.float32


@pytest.mark.parametrize("nside_in,nside_out", [(16, 8), (32, 8), (8, 16)])
def test_ud_grade_keeps_the_pixels_in_place(nside_in, nside_out):
    """RING in, RING out: a smooth map lands on itself at the other
    resolution, to within its variation over a pixel."""
    got = thp.ud_grade(T(_smooth(nside_in)), nside_out).numpy()
    coarse = min(nside_in, nside_out)
    assert np.abs(got - _smooth(nside_out)).max() < 1.0 / coarse
    with pytest.raises(ValueError, match="not a multiple"):
        thp.ud_grade(T(_smooth(12)), 8)


@pytest.mark.parametrize("nside_in", [16, 4, 8])
def test_mapper_resample(nside_in):
    """Values, the mapper's dtype, and the input's metadata with the new
    nside; numpy, tensor and DeviceMap input."""
    rng = np.random.default_rng(nside_in)
    m = rng.normal(size=12 * nside_in**2)
    md = dict(spin=0, nside=nside_in, geometry="healpix", catalog="c.fits")
    m_j = m.copy()
    jh.update_metadata(m_j, **md)
    want = jh.HealpixMapper(NSIDE, dtype=np.float32).resample(m_j)
    mapper = th.HealpixMapper(NSIDE, dtype=torch.float32, device="cpu")
    got = mapper.resample(th.DeviceMap(T(m), metadata=md))
    assert isinstance(got, th.DeviceMap)
    assert got.array.dtype == torch.float32 and got.shape == (NPIX,)
    assert got.metadata == dict(want.dtype.metadata) == {**md, "nside": NSIDE}
    want = np.asarray(want)
    if nside_in > NSIDE:
        want = want[jhp.ring2nest(NSIDE, np.arange(NPIX))]
    elif nside_in < NSIDE:
        permuted = m[jhp.nest2ring(nside_in, np.arange(m.size))]
        want = np.asarray(jhp.ud_grade(permuted, NSIDE)).astype(np.float32)
    # float32 of float64 means summed in another order
    np.testing.assert_allclose(got.array.numpy(), want, rtol=0, atol=1e-6)
    # a numpy map carries its metadata on its dtype; a tensor has none
    assert mapper.resample(m_j).metadata == got.metadata
    bare = mapper.resample(T(m))
    assert bare.metadata == {"nside": NSIDE}
    assert torch.equal(bare.array, got.array)
    # the result owns its data even where nothing is resampled
    if nside_in == NSIDE:
        same = T(m.astype(np.float32))
        assert mapper.resample(same).array.data_ptr() != same.data_ptr()


def test_new_entry_points_import_no_jax():
    """``dd=``, ``map_values`` and ``resample`` run, and DICES and the file
    layer import, without jax or heracles_tpu in the process."""
    code = (
        "import sys, numpy as np, torch, heracles_tpu_torch as th\n"
        "m = th.HealpixMapper(8, 12, dtype=torch.float32, device='cpu',\n"
        "                     deconvolve=False, dd=True, device_maps=True)\n"
        "data = m.create()\n"
        "m.map_values(np.array([10.0, 200.0]), np.array([-5.0, 60.0]), data,\n"
        "             np.array([1.0, 2.0]))\n"
        "alm = m.transform(data)\n"
        "assert alm.array.dtype == torch.complex64\n"
        "assert m.synthesize(alm).array.dtype == torch.float32\n"
        "low = th.HealpixMapper(4, device='cpu').resample(data)\n"
        "assert low.shape == (192,) and low.metadata['nside'] == 4\n"
        "assert th.healpix.ring2nest(4, np.arange(192)).max() == 191\n"
        "import heracles_tpu_torch.dices, heracles_tpu_torch.io\n"
        "from heracles_tpu_torch import fits, transforms, unmixing, utils\n"
        "assert callable(heracles_tpu_torch.dices.jackknife_cls)\n"
        "import heracles_tpu_torch.parallel as par\n"
        "mesh = par.make_mesh(4, m_axis=2, devices=['cpu'] * 4)\n"
        "q = par.map2alm_sharded(mesh, torch.ones(2, 192, dtype=torch.float64),"
        " 4)\n"
        "assert tuple(q.shape) == (2, 5, 256)\n"
        "bad = [m for m in ('jax', 'heracles_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
