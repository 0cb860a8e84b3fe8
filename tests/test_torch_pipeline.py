"""The port's 3x2pt pipeline against heracles_tpu, end to end on the CPU.

Catalogue -> maps -> alms -> spectra for positions + shear + visibility
in 2 tomographic bins, through ``map_catalogs`` -> ``transform`` ->
``angular_power_spectra`` of both packages, in float64 on the same
numpy-made inputs.  The JAX side runs as its own CPU tests run it
(float64 through the jnp scans).
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import heracles_tpu as jh
import heracles_tpu_torch as th

NSIDE, LMAX, NROWS, NBINS = 16, 24, 20_000, 2


def _catalog_arrays():
    """The bench recipe (bench.py's pipeline catalogue), one array per bin."""
    rng = np.random.default_rng(8)
    dtype = [(n, "f8") for n in ("RA", "DEC", "G1", "G2", "W")]
    out = []
    for _ in range(NBINS):
        arr = np.empty(NROWS, dtype)
        arr["RA"] = rng.uniform(0, 360, NROWS)
        arr["DEC"] = np.degrees(np.arcsin(rng.uniform(-1, 1, NROWS)))
        arr["G1"] = rng.normal(0, 0.1, NROWS)
        arr["G2"] = rng.normal(0, 0.1, NROWS)
        arr["W"] = rng.uniform(0.5, 1.0, NROWS)
        out.append(arr)
    return out


def _visibility():
    npix = 12 * NSIDE**2
    ring = np.arange(npix)
    return ((ring > npix // 5) & (ring < 4 * npix // 5)).astype(np.float64)


def _run(pkg, mapper):
    fields = {
        "POS": pkg.Positions(mapper, "RA", "DEC", mask="VIS", overdensity=False),
        "SHE": pkg.Shears(mapper, "RA", "DEC", "G1", "G2", "W", mask="VIS"),
        "VIS": pkg.Visibility(mapper),
    }
    catalogs = {}
    for i, arr in enumerate(_catalog_arrays()):
        cat = pkg.ArrayCatalog(arr)
        cat.page_size = 7_000  # several pages, the last one short
        cat.visibility = _visibility()
        catalogs[i] = cat
    maps = pkg.map_catalogs(fields, catalogs)
    alms = pkg.transform(fields, maps)
    cls = pkg.angular_power_spectra(alms)
    return maps, alms, cls


@pytest.fixture(scope="module")
def jax_run():
    return _run(jh, jh.HealpixMapper(NSIDE, LMAX, deconvolve=False))


@pytest.fixture(scope="module")
def torch_run():
    return _run(th, th.HealpixMapper(NSIDE, LMAX, deconvolve=False,
                                     device="cpu"))


def _assert_spectra_equal(got, want):
    # float64 on both sides, same algorithm with another summation order:
    # 1e-9 of each spectrum's largest value
    assert sorted(got) == sorted(want)
    for key in want:
        w = np.asarray(want[key])
        g = np.asarray(got[key])
        assert g.shape == w.shape, key
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9 * np.abs(w).max(),
                                   err_msg=str(key))


def test_pipeline_spectra_match(jax_run, torch_run):
    cls_j, cls_t = jax_run[2], torch_run[2]
    assert len(cls_t) == 21  # (6 choose 2) + 6 pairs of 3 fields x 2 bins
    _assert_spectra_equal(cls_t, cls_j)


def test_pipeline_metadata_match(jax_run, torch_run):
    cls_j, cls_t = jax_run[2], torch_run[2]
    for key in cls_j:
        md_j = dict(cls_j[key].dtype.metadata)
        md_t = dict(cls_t[key].dtype.metadata)
        assert md_t.keys() == md_j.keys(), key
        for name, value in md_j.items():
            if isinstance(value, float):
                # host numpy moments on identical pages: equal to rounding
                assert md_t[name] == pytest.approx(value, rel=1e-13), (key, name)
            else:
                assert md_t[name] == value, (key, name)
    # the bias ingredients are present where the reference has them
    md = cls_t["SHE", "SHE", 0, 0].dtype.metadata
    for name in ("bias", "fsky_1", "musq_1", "dens_1", "spin_1", "spin_2"):
        assert name in md
    assert "nbar_1" in cls_t["POS", "POS", 1, 1].dtype.metadata


def test_pipeline_maps_match(jax_run, torch_run):
    maps_j, maps_t = jax_run[0], torch_run[0]
    assert sorted(maps_t) == sorted(maps_j)
    for key in maps_j:
        # the same points scattered into the same pixels, then divided by
        # the same host-computed normalisation
        np.testing.assert_allclose(np.asarray(maps_t[key]), np.asarray(maps_j[key]),
                                   rtol=1e-13, atol=0, err_msg=str(key))


def test_jax_alms_through_port_spectra(jax_run):
    """heracles_tpu's alms, carried over with to_torch, give its spectra."""
    _, alms_j, cls_j = jax_run
    alms_t = th.to_torch(alms_j, device="cpu")
    assert all(isinstance(v, th.DeviceMap) for v in alms_t.values())
    _assert_spectra_equal(th.angular_power_spectra(alms_t), cls_j)
    back = th.to_numpy(alms_t)
    for key, value in alms_j.items():
        np.testing.assert_array_equal(back[key], value)
        assert back[key].dtype.metadata == value.dtype.metadata


def test_port_imports_no_jax():
    """``import heracles_tpu_torch``, its CLI and ``python -m
    heracles_tpu_torch --help`` load neither jax nor heracles_tpu."""
    code = (
        "import runpy, sys, heracles_tpu_torch, heracles_tpu_torch.cli\n"
        "import heracles_tpu_torch.ops.nufft, heracles_tpu_torch.ops.pixwin\n"
        "import heracles_tpu_torch.parallel\n"
        "sys.argv = ['heracles-tpu-torch', '--help']\n"
        "try:\n"
        "    runpy.run_module('heracles_tpu_torch', run_name='__main__')\n"
        "except SystemExit as exc:\n"
        "    assert exc.code == 0, exc.code\n"
        "bad = [m for m in ('jax', 'heracles_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_visibility_on_device_tensor():
    """A tensor visibility gives the same fsky and VIS map as numpy."""
    vis = _visibility()
    assert th.fsky_from_visibility(torch.as_tensor(vis)) == pytest.approx(
        th.fsky_from_visibility(vis), rel=1e-14)
    mapper = th.HealpixMapper(NSIDE, LMAX, deconvolve=False, device="cpu")
    cat = th.ArrayCatalog(_catalog_arrays()[0])
    cat.visibility = torch.as_tensor(vis, dtype=torch.float64)
    maps = th.map_catalogs({"VIS": th.Visibility(mapper)}, {0: cat})
    np.testing.assert_array_equal(np.asarray(maps["VIS", 0]), vis)


def test_devicemap_arithmetic_and_metadata():
    """DeviceMap: numpy metadata on a tensor, in-place and new results."""
    m = th.DeviceMap(torch.arange(6.0).reshape(2, 3), metadata={"spin": 0})
    th.update_metadata(m, nside=1)
    m /= 2.0
    m -= np.ones((2, 3))
    m *= 4.0
    m += m
    want = (np.arange(6.0).reshape(2, 3) / 2 - 1) * 8
    np.testing.assert_array_equal(np.asarray(m), want)
    assert np.asarray(m).dtype.metadata == {"spin": 0, "nside": 1}
    np.testing.assert_array_equal(np.asarray((m + 1) * 2 - m / 2),
                                  (want + 1) * 2 - want / 2)
    row = m[1]
    assert row.shape == (3,) and row.metadata == m.metadata
    other = copy.deepcopy(m)
    other /= 2.0  # a deep copy owns its tensor
    np.testing.assert_array_equal(np.asarray(m), want)
    m[0] = np.zeros(3)
    assert float(m.array[0].abs().sum()) == 0.0


@pytest.mark.parametrize("spin", [0, 2])
def test_mapper_transform_deconvolved(spin):
    """Pixel-window deconvolution (cap window at nside 64) as heracles_tpu."""
    nside, lmax = 64, 96
    rng = np.random.default_rng(spin)
    maps = rng.normal(size=(2, 12 * nside**2) if spin else (12 * nside**2,))
    want = jh.HealpixMapper(nside, lmax).transform(maps.copy(), spin=spin)
    got = th.HealpixMapper(nside, lmax, device="cpu").transform(
        torch.as_tensor(maps), spin=spin)
    assert got.metadata["deconv"] is True
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-10 * np.abs(want).max())


def test_debias_with_pixel_window():
    """The bias of deconvolved maps is divided by the window on each side."""
    from heracles_tpu import twopoint as jtp
    from heracles_tpu_torch import twopoint as ttp

    md = {"kernel_1": "healpix", "kernel_2": "healpix", "nside_1": 64,
          "nside_2": 64, "deconv_1": True, "deconv_2": True, "bias": 0.3}
    for s1, s2, shape in ((0, 0, (97,)), (2, 2, (2, 2, 97)), (0, 2, (2, 97))):
        cl = np.ones(shape)
        meta = {**md, "spin_1": s1, "spin_2": s2}
        np.testing.assert_array_equal(ttp._debias_cl(cl, md=meta),
                                      jtp._debias_cl(cl, md=meta))
