"""The port's file layer against heracles_tpu's, on the CPU.

FITS files written by either package are read by the other with equal
arrays and metadata: maps, alms, spectra, mixing matrices and the lazy
FITS-backed mappings.  ``read_vmap`` with and without ``transform``,
``FitsCatalog`` pages with selections, the two page filters, and
``ScalarField`` mapped through both packages, in float64.
"""

import numpy as np
import pytest
import torch

import heracles_tpu as jh
import heracles_tpu.fits as jfits
import heracles_tpu.healpix as jhp
import heracles_tpu.io as jio
import heracles_tpu_torch as th
import heracles_tpu_torch.fits as tfits
import heracles_tpu_torch.io as tio
from heracles_tpu_torch.result import get_result_array

PKGS = {"port": tio, "ref": jio}
PAIRS = [("port", "ref"), ("ref", "port"), ("port", "port")]
NSIDE = 4
NPIX = 12 * NSIDE**2


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert got.dtype == np.asarray(want).dtype
    assert dict(got.dtype.metadata or {}) == dict(want.dtype.metadata or {})


def _maps():
    rng = np.random.default_rng(0)
    m1 = rng.normal(size=NPIX)
    jh.update_metadata(m1, nside=NSIDE, spin=0, catalog="cat.fits", fsky=0.5)
    m2 = rng.normal(size=(2, NPIX)).astype(np.float32)
    jh.update_metadata(m2, nside=NSIDE, spin=2, geometry="healpix")
    return {("POS", 0): m1, ("SHE", 1): m2}


def _alms():
    rng = np.random.default_rng(1)
    a1 = rng.normal(size=21) + 1j * rng.normal(size=21)
    jh.update_metadata(a1, spin=0, lmax=5, deconv=False)
    a2 = (rng.normal(size=(2, 21)) + 1j * rng.normal(size=(2, 21)))
    jh.update_metadata(a2, spin=2, lmax=5, nside=4)
    return {("POS", 0): a1, ("SHE", 0): a2}


def _results(pkg):
    """A spin-2 spectrum with a bias, a spin-0 spectrum, a rectangular
    mixing matrix and a spin-2 (3, n, n) one, as ``pkg``'s Results."""
    rng = np.random.default_rng(2)
    cl = rng.normal(size=(2, 2, 8))
    jh.update_metadata(cl, bias=0.25, spin_1=2, spin_2=2)
    return {
        ("SHE", "SHE", 0, 0): pkg.Result(cl, spin=(2, 2), axis=-1),
        ("POS", "POS", 1, 1): pkg.Result(rng.normal(size=8), spin=(0, 0),
                                         ell=np.arange(8) + 0.5),
        ("A", "B", 0, 0): pkg.Result(
            rng.normal(size=(5, 9)), spin=(0, 0),
            ell=(np.arange(5) * 2.0, np.arange(9) * 1.0), axis=(0, 1)),
        ("SHE", "SHE", 0, 1): pkg.Result(rng.normal(size=(3, 6, 6)),
                                         spin=(2, 2), axis=-2),
    }


def _same_results(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        assert g.spin == w.spin and g.axis == w.axis, key
        assert dict(g.dtype.metadata or {}) == dict(w.dtype.metadata or {})
        for name in ("ell", "lower", "upper", "weight"):
            for a, b in zip(get_result_array(g, name),
                            get_result_array(w, name), strict=True):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("key", [("POS", 0), ("POS", "SHE", 1, 2), ("A-B", 3),
                                 ("x\\y", 1), "plain", 42, "a~\x00\x01b"])
def test_key_strings(key):
    s = tio._string_from_key(key)
    assert s == jio._string_from_key(key)
    assert tio._key_from_string(s) == jio._key_from_string(s)


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_maps_cross_package(tmp_path, writer, reader):
    path = str(tmp_path / "maps.fits")
    maps = _maps()
    PKGS[writer].write_maps(path, maps)
    out = PKGS[reader].read_maps(path)
    assert list(out) == list(maps)
    for key in maps:
        _same(out[key], maps[key])
    only = PKGS[reader].read_maps(path, include=[("POS", ...)])
    assert list(only) == [("POS", 0)]


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_alms_cross_package(tmp_path, writer, reader):
    path = str(tmp_path / "alms.fits")
    alms = _alms()
    PKGS[writer].write_alms(path, alms)
    out = PKGS[reader].read_alms(path)
    for key in alms:
        np.testing.assert_array_equal(out[key], alms[key])
        assert out[key].dtype.metadata == alms[key].dtype.metadata


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_results_cross_package(tmp_path, writer, reader):
    """Spectra and mixing matrices, one ell axis and two."""
    path = str(tmp_path / "cls.fits")
    wpkg = th if writer == "port" else jh
    results = _results(wpkg)
    PKGS[writer].write(path, results)
    _same_results(PKGS[reader].read(path), results)


def test_writers_take_device_maps_and_tensors(tmp_path):
    """A DeviceMap is written with its metadata, a bare tensor without;
    the reference reads both back."""
    maps = _maps()
    dm = th.DeviceMap(torch.as_tensor(np.asarray(maps["POS", 0], np.float64)),
                      metadata=maps["POS", 0].dtype.metadata)
    bare = torch.arange(NPIX, dtype=torch.float32)
    tio.write_maps(str(tmp_path / "m.fits"), {("POS", 0): dm, ("X", 1): bare})
    out = jio.read_maps(str(tmp_path / "m.fits"))
    _same(out["POS", 0], maps["POS", 0])
    np.testing.assert_array_equal(out["X", 1], bare.numpy())
    assert not out["X", 1].dtype.metadata
    alms = _alms()
    da = th.DeviceMap(torch.as_tensor(np.asarray(alms["SHE", 0], complex)),
                      metadata=alms["SHE", 0].dtype.metadata)
    tio.write_alms(str(tmp_path / "a.fits"), {("SHE", 0): da})
    back = jio.read_alms(str(tmp_path / "a.fits"))["SHE", 0]
    np.testing.assert_array_equal(back, alms["SHE", 0])
    assert back.dtype.metadata == alms["SHE", 0].dtype.metadata


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_fits_mappings_cross_package(tmp_path, writer, reader):
    w, r = PKGS[writer], PKGS[reader]
    wpkg = th if writer == "port" else jh
    maps, alms, results = _maps(), _alms(), _results(wpkg)
    for cls, values, name in ((w.MapFits, maps, "m"), (w.AlmFits, alms, "a"),
                              (w.ClsFits, results, "c"),
                              (w.MmsFits, results, "mm")):
        d = cls(str(tmp_path / f"{name}.fits"), clobber=True)
        for key, value in values.items():
            d[key] = value
    m = r.MapFits(str(tmp_path / "m.fits"))
    assert set(m) == set(maps) and len(m) == 2
    for key in maps:
        _same(m[key], maps[key])
    a = r.AlmFits(str(tmp_path / "a.fits"))
    for key in alms:
        np.testing.assert_array_equal(a[key], alms[key])
    for name, cls in (("c", r.ClsFits), ("mm", r.MmsFits)):
        d = cls(str(tmp_path / f"{name}.fits"))
        _same_results({key: d[key] for key in d}, results)
    with pytest.raises(KeyError):
        a["missing"]
    with pytest.raises(NotImplementedError):
        del a["POS", 0]


def test_append_and_clobber(tmp_path):
    path = str(tmp_path / "maps.fits")
    m = np.ones(48)
    jio.write_maps(path, {("A", 0): m})
    tio.write_maps(path, {("B", 0): m})  # the port appends to the reference's
    assert set(jio.read_maps(path)) == set(tio.read_maps(path)) == {("A", 0),
                                                                    ("B", 0)}
    tio.write_maps(path, {("C", 0): m}, clobber=True)
    assert set(jio.read_maps(path)) == {("C", 0)}


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_fits_tables_byte_for_byte(tmp_path, writer):
    """Both FITS layers write the same bytes and read each other's tables
    with every column type, TDIM shapes and long header keys."""
    rng = np.random.default_rng(3)
    cols = {
        "L": rng.normal(size=7) > 0, "B": np.arange(7, dtype=np.uint8),
        "I": np.arange(7, dtype=np.int16), "J": np.arange(7, dtype=np.int32),
        "K": np.arange(7, dtype=np.int64), "E": rng.normal(size=7).astype("f4"),
        "D": rng.normal(size=(7, 2, 3)), "C": (rng.normal(size=7) + 1j).astype("c8"),
        "M": rng.normal(size=(7, 4)) + 1j,
    }
    header = {"SHORT": 1, "A LONG KEY NAME": "text with 'quotes'", "F": 2.5,
              "T": True}
    paths = {}
    for name, mod in (("port", tfits), ("ref", jfits)):
        paths[name] = str(tmp_path / f"{name}.fits")
        f = mod.FitsFile(paths[name], mode="rw", clobber=True)
        f.write_table(cols, extname="TAB", header=header)
    with open(paths["port"], "rb") as a, open(paths["ref"], "rb") as b:
        assert a.read() == b.read()
    reader = tfits if writer == "ref" else jfits
    hdu = reader.FitsFile(paths[writer])["TAB"]
    data = hdu.read()
    for key, col in cols.items():
        np.testing.assert_array_equal(data[key], col)
    for key, value in header.items():
        assert hdu.read_header()[key] == value
    part = hdu.read_columns(["K", "D"], rows=(2, 5))
    np.testing.assert_array_equal(part["D"], cols["D"][2:5])


def _vmap_file(tmp_path, nside, nested=False):
    rng = np.random.default_rng(nside)
    m = rng.uniform(0.5, 1.0, size=12 * nside**2)
    m[:5] = jio.UNSEEN
    path = str(tmp_path / "vmap.fits")
    f = jfits.FitsFile(path, mode="rw", clobber=True)
    npix = m.size
    values = m[jhp.nest2ring(nside, np.arange(npix))] if nested else m
    hdr = jio._metadata_header({}, extra=jio._healpix_header(npix))
    if nested:
        hdr["ORDERING"] = "NESTED"
    f.write_table([values], names=["VMAP"], extname="V", header=hdr)
    return path, m


@pytest.mark.parametrize("nested", [False, True])
def test_read_vmap(tmp_path, nested):
    path, m = _vmap_file(tmp_path, 8, nested)
    got = tio.read_vmap(path)
    np.testing.assert_array_equal(got, jio.read_vmap(path))
    assert got[0] == 0.0 and got[10] == m[10]


@pytest.mark.parametrize("nside_out", [4, 16])
def test_read_vmap_regrades_ring_in_ring_out(tmp_path, nside_out):
    """``nside=`` goes through the port's RING ``ud_grade``; the
    reference's result is NEST-numbered (ROADMAP section C), so the two
    meet through ``ring2nest``."""
    path, _ = _vmap_file(tmp_path, 8)
    with pytest.warns(UserWarning, match="changing NSIDE"):
        got = tio.read_vmap(path, nside=nside_out)
    want = jio.read_vmap(path)
    npix = 12 * nside_out**2
    if nside_out < 8:
        want = np.asarray(jhp.ud_grade(want, nside_out))
        want = want[jhp.ring2nest(nside_out, np.arange(npix))]
    else:
        want = want[jhp.nest2ring(8, np.arange(want.size))]
        want = np.asarray(jhp.ud_grade(want, nside_out))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


def test_read_vmap_transform(tmp_path, monkeypatch):
    """Alms divided by the pixel window, on the CPU; at nside 64 both
    packages take the cap window (the port has no exact window without a
    shipped table; the reference is told to take the cap too)."""
    monkeypatch.setenv("HERACLES_TPU_PIXWIN", "cap")
    path, _ = _vmap_file(tmp_path, 64)
    got = tio.read_vmap(path, transform=True, lmax=24, device="cpu")
    want = jio.read_vmap(path, transform=True, lmax=24)
    assert got.dtype == np.complex128 and got.shape == want.shape == (325,)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def _catalog(n, seed):
    rng = np.random.default_rng(seed)
    arr = np.empty(n, [("RA", "f8"), ("DEC", "f8"), ("V", "f8"), ("W", "f8")])
    arr["RA"] = rng.uniform(0, 360, n)
    arr["DEC"] = np.degrees(np.arcsin(rng.uniform(-1, 1, n)))
    arr["V"] = rng.normal(size=n)
    arr["W"] = rng.uniform(0, 1, n)
    return arr


@pytest.mark.parametrize("selection", [None, "W > 0.5", ("W > 0.5", "RA < 180")])
def test_fits_catalog_pages(tmp_path, selection):
    arr = _catalog(120, 2)
    path = str(tmp_path / "cat.fits")
    f = tfits.FitsFile(path, mode="rw", clobber=True)
    f.write_table({n: arr[n] for n in arr.dtype.names}, extname="CAT")
    pages = {}
    for name, pkg in (("port", th), ("ref", jh)):
        cat = pkg.FitsCatalog(path, columns=["RA", "DEC", "W"])
        cat.page_size = 50
        assert cat.size == 120 and list(cat.names) == ["RA", "DEC", "W"]
        view = cat if selection is None else cat.where(selection)
        pages[name] = list(view)
    assert [p.size for p in pages["port"]] == [p.size for p in pages["ref"]]
    if selection is None:
        assert [p.size for p in pages["port"]] == [50, 50, 20]
    for got, want in zip(pages["port"], pages["ref"]):
        assert got.names == want.names
        for n in want.names:
            np.testing.assert_array_equal(got[n], want[n])


@pytest.mark.parametrize("kind", ["invalid", "invalid_weight", "footprint"])
def test_filters(kind):
    arr = _catalog(300, 4)
    arr["V"][::7] = np.nan
    arr["W"][::14] = 0.0
    fp = np.zeros(NPIX)
    fp[: NPIX // 2] = 1.0
    sizes, cols = {}, {}
    for name, pkg in (("port", th), ("ref", jh)):
        cat = pkg.ArrayCatalog(arr)
        cat.page_size = 100
        if kind == "footprint":
            cat.add_filter(pkg.FootprintFilter(fp, "RA", "DEC"))
        else:
            weight = "W" if kind == "invalid_weight" else None
            cat.add_filter(pkg.InvalidValueFilter("V", weight=weight,
                                                  warn=False))
        pages = list(cat)
        sizes[name] = [p.size for p in pages]
        cols[name] = np.concatenate([p["RA"] for p in pages])
    assert sizes["port"] == sizes["ref"] and sum(sizes["ref"]) < 300
    np.testing.assert_array_equal(cols["port"], cols["ref"])
    with pytest.warns(UserWarning, match="invalid values"):
        page = th.CatalogPage({"V": arr["V"][:10]})
        th.InvalidValueFilter("V")(page)
    assert page.size == 8


def test_scalar_field():
    """``ScalarField`` through ``map_catalogs`` of both packages: the map
    and its normalisation metadata (wbar, musq, dens, fsky)."""
    arr = _catalog(5000, 6)
    vis = np.ones(12 * 8**2)
    vis[:100] = 0.0
    out = {}
    for name, pkg, kw in (("port", th, {"device": "cpu"}), ("ref", jh, {})):
        mapper = pkg.HealpixMapper(8, **kw)
        fields = {"KAP": pkg.ScalarField(mapper, "RA", "DEC", "V", "W")}
        cat = pkg.ArrayCatalog(arr)
        cat.page_size = 1200
        cat.visibility = vis
        out[name] = pkg.map_catalogs(fields, {0: cat})["KAP", 0]
    got, want = out["port"], out["ref"]
    assert isinstance(got, th.DeviceMap)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-13, atol=1e-13)
    gmd, wmd = got.metadata, dict(want.dtype.metadata)
    assert set(gmd) == set(wmd)
    for key, value in wmd.items():
        if isinstance(value, float):
            assert gmd[key] == pytest.approx(value, rel=1e-13), key
        else:
            assert gmd[key] == value, key
