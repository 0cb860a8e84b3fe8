"""The port's mixing matrices and FMA-peak probe against heracles_tpu.

Every function runs with its ``heracles_tpu`` twin on the same numpy
inputs from a seed, on the CPU and in float64.  Where the JAX function
reaches a Pallas kernel (the double-single Gram of ``ops/df32.py``, the
probe kernels of ``tools/vpu_peak.py``) it runs in interpret mode, as the
JAX package's own tests run it.  Tolerances, with their reasons:

* Gram against the df32 kernel: 1e-12 of the largest entry, the bar
  ``tests/test_df32.py`` holds that kernel to against float64;
* Wigner tables and the Legendre sum: 1e-14 (the same numpy code);
* mixing matrices: each block to 1e-11 of its own largest entry (the
  same quadrature; the reference's float64 path builds its tables with a
  scaled device recurrence, its float32 path in double-single);
* pseudo-inverses and their application: 1e-9 relative (an SVD of a
  well-conditioned matrix in another LAPACK call order);
* the probe chains: steps * 2^-23 of the largest value, since an FMA
  and a multiply-then-add round differently at every step.
"""

import importlib.util
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import heracles_tpu as jh
import heracles_tpu_torch as th
from heracles_tpu import twopoint as jtp
from heracles_tpu.ops import df32
from heracles_tpu.ops import wigner as jw
from heracles_tpu_torch import twopoint as ttp
from heracles_tpu_torch.ops import fma_peak, gram, wigner

ROOT = Path(__file__).resolve().parent.parent
LMAX = 32


def _vpu_peak():
    spec = importlib.util.spec_from_file_location(
        "vpu_peak", ROOT / "tools" / "vpu_peak.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max()


def _mask_cl3(seed=7, n=2 * LMAX + 1):
    """A falling mask spectrum, as tests/test_df32.py makes it."""
    rng = np.random.default_rng(seed)
    return (1 / (1 + np.arange(n)) ** 2.5) * (1 + 0.2 * rng.standard_normal(n) ** 2)


def _well_conditioned_cl3(seed, lmax):
    """A mask spectrum whose mixing matrices invert stably."""
    rng = np.random.default_rng(seed)
    cl3 = np.zeros(lmax + 1)
    cl3[0] = 4 * np.pi
    cl3[1:] = rng.uniform(0, 0.05, lmax)
    return cl3


# -- the Gram contraction ---------------------------------------------------


def test_gram_matches_df32_kernel():
    """Weighted Gram against the Pallas df32 kernel on heavy-range data."""
    rng = np.random.default_rng(1)
    K, L1, L2 = 192, 17, 23
    A = rng.normal(size=(K, L1)) * np.exp(3 * rng.normal(size=(K, L1)))
    B = rng.normal(size=(K, L2)) * np.exp(3 * rng.normal(size=(K, L2)))
    u = rng.normal(size=K)
    want = df32.gram_df32(df32.split_f64(A), df32.split_f64(B),
                          df32.split_f64(u), a_tile=8, b_tile=16, k_chunk=64,
                          interpret=True)
    got = gram.gram(_t(A), _t(B), _t(u))
    assert got.dtype == torch.float64 and got.shape == (L1, L2)
    assert _rel(got, want) <= 1e-12


def test_gram_unweighted_matches_matmul_df32():
    """u=None is the unweighted product of the df32 matmul."""
    rng = np.random.default_rng(2)
    n, k, m = 13, 150, 21
    P = rng.normal(size=(n, k))
    Q = rng.normal(size=(k, m))
    hi, lo = df32.matmul_df32(
        tuple(jnp.asarray(z) for z in df32.split_f64(P)),
        tuple(jnp.asarray(z) for z in df32.split_f64(Q)),
        a_tile=8, b_tile=16, k_chunk=64, interpret=True,
    )
    want = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    got = gram.gram(_t(P.T), _t(Q))
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("bad", ["dtype", "nodes", "device"])
def test_gram_rejects_bad_operands(bad):
    A = torch.ones(5, 3, dtype=torch.float64)
    B = torch.ones(5, 4, dtype=torch.float64)
    u = torch.ones(5, dtype=torch.float64)
    if bad == "dtype":
        with pytest.raises(TypeError, match="float64"):
            gram.gram(A.float(), B, u)
    elif bad == "nodes":
        with pytest.raises(ValueError, match="node axes"):
            gram.gram(A, B[:4], u)
    else:
        with pytest.raises(ValueError, match="unsupported device"):
            gram.gram(A.to("meta"), B.to("meta"), u.to("meta"))


# -- host tables ------------------------------------------------------------


@pytest.mark.parametrize("m,n", [(0, 0), (2, 2), (-2, -2), (0, 2), (2, 0), (3, 1)])
def test_wigner_table_host_matches(m, n):
    x, _ = np.polynomial.legendre.leggauss(41)
    theta = np.arccos(x)
    got = wigner.wigner_table_host(m, n, theta, 30)
    want = jw.wigner_table_host(m, n, theta, 30)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)


def test_legendre_sum_host_matches():
    x, _ = np.polynomial.legendre.leggauss(57)
    coeffs = _mask_cl3()
    got = wigner.legendre_sum_host(coeffs, x)
    want = jw.legendre_sum_host(coeffs, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14 * np.abs(want).max())


# -- mixing matrices --------------------------------------------------------


@pytest.mark.parametrize("cl_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("spin,eb", [((0, 0), False), ((0, 2), False),
                                     ((2, 0), False), ((2, 2), True)])
def test_mixmat_matches_reference(spin, eb, cl_dtype, monkeypatch):
    """float64 cl against the reference's float64 path; float32 cl against
    its df32 path with the Pallas kernel in interpret mode."""
    if cl_dtype == np.float32:
        monkeypatch.setenv("HERACLES_TPU_MIXMAT_KERNEL", "interpret")
    cl3 = _mask_cl3().astype(cl_dtype)
    fn_j, fn_t = (jtp.mixmat_eb, ttp.mixmat_eb) if eb else (jtp.mixmat, ttp.mixmat)
    want = np.asarray(fn_j(cl3, l1max=LMAX, l2max=LMAX, spin=spin))
    got = fn_t(cl3, l1max=LMAX, l2max=LMAX, spin=spin, device="cpu")
    assert got.dtype == np.float64 and got.shape == want.shape
    for g, w in zip(got.reshape(-1, *got.shape[-2:]), want.reshape(-1, *want.shape[-2:])):
        assert _rel(g, w) <= 1e-11


def test_mixmat_sizes_and_counts():
    """l1max/l2max/l3max cut the matrix; the CPU path launches nothing."""
    gram.reset_counts()
    cl = np.ones(13)
    M = ttp.mixmat(cl, l1max=5, l2max=8, l3max=10, device="cpu")
    np.testing.assert_allclose(M, jtp.mixmat(cl, l1max=5, l2max=8, l3max=10),
                               rtol=0, atol=1e-12)
    assert M.shape == (6, 9)
    assert gram.LAUNCHES == {} and gram.PLAIN_RUNS == {"gram": 1}
    eb = ttp.mixmat_eb(_mask_cl3(), l1max=LMAX, l2max=LMAX, device="cpu")
    assert gram.PLAIN_RUNS == {"gram": 3}
    # the full-sky mask mixes nothing
    cl = np.zeros(11)
    cl[0] = 4 * np.pi
    np.testing.assert_allclose(ttp.mixmat(cl, device="cpu"), np.eye(11),
                               atol=1e-10)
    np.testing.assert_array_equal(eb[2], eb[0] - eb[1])


class _FakeField:
    def __init__(self, mask, spin):
        self.mask = mask
        self.spin = spin


@pytest.mark.parametrize("binned", [False, True])
def test_mixing_matrices_match_reference(binned):
    """Key set, shapes, axis and values, with and without bins."""
    lmax = 12
    fields = {"POS": _FakeField("VIS", 0), "SHE": _FakeField("WHT", 2)}
    cls = {
        ("VIS", "VIS", 0, 0): _well_conditioned_cl3(1, lmax),
        ("VIS", "WHT", 0, 0): _well_conditioned_cl3(2, lmax),
        ("WHT", "WHT", 0, 0): _well_conditioned_cl3(3, lmax),
        ("VIS", "VIS", 0, 1): _well_conditioned_cl3(4, lmax),
    }
    kw = dict(bins=np.array([0, 3, 7, 13]), weights="2l+1") if binned else {}
    want = jtp.mixing_matrices(fields, jh.TocDict(cls), **kw)
    got = ttp.mixing_matrices(fields, th.TocDict(cls), device="cpu", **kw)
    assert list(got) == list(want)
    assert set(got) == {
        ("POS", "POS", 0, 0), ("POS", "SHE", 0, 0), ("SHE", "SHE", 0, 0),
        ("POS", "POS", 0, 1),
    }
    for key in want:
        g, w = got[key], want[key]
        assert g.shape == w.shape and g.axis == w.axis and g.spin == w.spin, key
        for a, b in zip(np.reshape(g.array, (-1,) + g.shape[-2:]),
                        np.reshape(w.array, (-1,) + w.shape[-2:])):
            assert _rel(a, b) <= 1e-11, key
        if binned:
            np.testing.assert_allclose(g.ell, w.ell, rtol=1e-14)
    # binning acts on the output ell axis only
    n = 3 if binned else lmax + 1
    assert got["SHE", "SHE", 0, 0].shape == (3, n, lmax + 1)
    assert got["SHE", "SHE", 0, 0].axis == (1,)


@pytest.mark.parametrize("spin", [(0, 0), (2, 2)])
def test_invert_and_apply_match_reference(spin):
    lmax = 16
    rng = np.random.default_rng(sum(spin) + 13)
    cl3 = _well_conditioned_cl3(5, lmax)
    eb = spin != (0, 0)
    mm = (jtp.mixmat_eb if eb else jtp.mixmat)(cl3, spin=spin)
    key = ("A", "A", 0, 0)
    M = {key: jh.Result(np.asarray(mm), spin=spin, ell=np.arange(lmax + 1), axis=-2)}
    Mt = {key: th.Result(np.asarray(mm), spin=spin, ell=np.arange(lmax + 1), axis=-2)}
    arr = rng.normal(size=(2, 2, lmax + 1) if eb else (lmax + 1,))
    d = {key: jh.Result(arr, spin=spin)}
    dt = {key: th.Result(arr.copy(), spin=spin)}

    inv_j = jtp.invert_mixing_matrix(M, rcond=1e-5)
    inv_t = ttp.invert_mixing_matrix(Mt, rcond={key: 1e-5}, device="cpu")
    assert inv_t[key].array.shape == inv_j[key].array.shape
    assert _rel(inv_t[key].array, inv_j[key].array) <= 1e-9

    got = ttp.apply_mixing_matrix(dt, inv_t)[key]
    want = jtp.apply_mixing_matrix(d, inv_j)[key]
    assert got.array.shape == want.array.shape
    assert _rel(got.array, want.array) <= 1e-9
    np.testing.assert_array_equal(got.ell, want.ell)
    # M applied after its inverse gives the data back
    back = ttp.apply_mixing_matrix(ttp.apply_mixing_matrix(dt, Mt), inv_t)[key]
    sl = (..., slice(2, None)) if eb else (...,)
    np.testing.assert_allclose(back.array[sl], arr[sl], rtol=1e-6, atol=1e-10)


def test_invert_rectangular_rebuilds_ell():
    cl = _well_conditioned_cl3(6, 14)
    mm = ttp.mixmat(cl, l1max=8, l2max=12, device="cpu")
    key = ("A", "A", 0, 0)
    M = {key: th.Result(mm, spin=(0, 0), ell=np.arange(9), axis=-2)}
    want = jtp.invert_mixing_matrix(
        {key: jh.Result(mm, spin=(0, 0), ell=np.arange(9), axis=-2)})[key]
    got = ttp.invert_mixing_matrix(M, device="cpu")[key]
    assert got.array.shape == (13, 9)
    for name in ("ell", "lower", "upper", "weight"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    with pytest.raises(KeyError, match="Missing rcond"):
        ttp.invert_mixing_matrix(M, rcond={}, device="cpu")


# -- the toy 3x2pt pipeline through the mixing matrices -----------------------

NSIDE, PLMAX, NROWS = 16, 24, 20_000


def _on_cpu(pkg):
    """The port's mapper argument that keeps it on the CPU."""
    return {"device": "cpu"} if pkg is th else {}


def _pipeline(pkg, vis):
    mapper = pkg.HealpixMapper(NSIDE, PLMAX, deconvolve=False, **_on_cpu(pkg))
    fields = {
        "POS": pkg.Positions(mapper, "RA", "DEC", mask="VIS", overdensity=False),
        "SHE": pkg.Shears(mapper, "RA", "DEC", "G1", "G2", "W", mask="VIS"),
        "VIS": pkg.Visibility(mapper),
    }
    rng = np.random.default_rng(8)
    catalogs = {}
    for i in range(2):
        arr = np.empty(NROWS, [(n, "f8") for n in ("RA", "DEC", "G1", "G2", "W")])
        arr["RA"] = rng.uniform(0, 360, NROWS)
        arr["DEC"] = np.degrees(np.arcsin(rng.uniform(-1, 1, NROWS)))
        arr["G1"] = rng.normal(0, 0.1, NROWS)
        arr["G2"] = rng.normal(0, 0.1, NROWS)
        arr["W"] = rng.uniform(0.5, 1.0, NROWS)
        catalogs[i] = pkg.ArrayCatalog(arr)
        catalogs[i].visibility = vis
    cls = pkg.angular_power_spectra(
        pkg.transform(fields, pkg.map_catalogs(fields, catalogs)))
    mask_cls = {k: v for k, v in cls.items() if k[:2] == ("VIS", "VIS")}
    return fields, cls, pkg.mixing_matrices(fields, mask_cls, l3max=PLMAX)


def test_pipeline_through_mixing_matrices():
    npix = 12 * NSIDE**2
    ring = np.arange(npix)
    vis = ((ring > npix // 5) & (ring < 4 * npix // 5)).astype(np.float64)
    _, cls_j, mms_j = _pipeline(jh, vis)
    fields, cls_t, mms_t = _pipeline(th, vis)
    assert list(mms_t) == list(mms_j)
    assert len(mms_t) == 10  # 3 POSxPOS, 4 POSxSHE / SHExPOS, 3 SHExSHE
    for key in mms_j:
        g, w = mms_t[key], mms_j[key]
        assert g.shape == w.shape and g.axis == w.axis and g.spin == w.spin
        # the mask spectra agree to 1e-9 of their largest value
        for a, b in zip(np.reshape(g.array, (-1,) + g.shape[-2:]),
                        np.reshape(w.array, (-1,) + w.shape[-2:])):
            assert _rel(a, b) <= 1e-9, key
    assert ttp.mixing_matrices(fields, {}) == {}
    # the mixing matrices of the mask spectra, applied to the data spectra
    data_t = {k: v for k, v in cls_t.items() if k in mms_t}
    data_j = {k: v for k, v in cls_j.items() if k in mms_j}
    got = ttp.apply_mixing_matrix(data_t, mms_t)
    want = jtp.apply_mixing_matrix(data_j, mms_j)
    # every matrix but (SHE, POS, 0, 1), whose spectrum is keyed (POS, SHE, 1, 0)
    assert sorted(got) == sorted(want) and len(got) == 9
    for key in want:
        assert _rel(got[key].array, want[key].array) <= 1e-9, key


# -- Weights and get_masks ----------------------------------------------------


def test_weights_field_matches_reference():
    rng = np.random.default_rng(3)
    n = 5000
    arr = np.empty(n, [("RA", "f8"), ("DEC", "f8"), ("W", "f8")])
    arr["RA"] = rng.uniform(0, 360, n)
    arr["DEC"] = np.degrees(np.arcsin(rng.uniform(-1, 1, n)))
    arr["W"] = rng.uniform(0.0, 1.0, n)
    arr["W"][::7] = 0.0  # zero weights are dropped
    maps = {}
    for pkg in (jh, th):
        mapper = pkg.HealpixMapper(8, 12, deconvolve=False, **_on_cpu(pkg))
        field = pkg.Weights(mapper, "RA", "DEC", "W")
        cat = pkg.ArrayCatalog(arr)
        cat.page_size = 1500
        maps[pkg] = pkg.map_catalogs({"WHT": field}, {0: cat})["WHT", 0]
    np.testing.assert_allclose(np.asarray(maps[th]), np.asarray(maps[jh]),
                               rtol=1e-13, atol=0)
    md_j, md_t = maps[jh].dtype.metadata, np.asarray(maps[th]).dtype.metadata
    assert md_t.keys() == md_j.keys()
    for name, value in md_j.items():
        assert md_t[name] == (pytest.approx(value, rel=1e-13)
                              if isinstance(value, float) else value), name
    assert md_t["musq"] == 1.0 and md_t["spin"] == 0


@pytest.mark.parametrize("kwargs", [
    {},
    {"comb": 2},
    {"comb": 2, "include": [("POS",), ("SHE",)]},
    {"include": [("SHE_E",)], "append_eb": True},
    {"comb": 2, "exclude": [("POS", "SHE_B")], "append_eb": True},
    {"comb": 3, "exclude": [("POS", "POS", "POS")]},
])
def test_get_masks_matches_reference(kwargs):
    def make(pkg):
        mapper = pkg.HealpixMapper(8, 12, **_on_cpu(pkg))
        return {
            "POS": pkg.Positions(mapper, "RA", "DEC", mask="VIS"),
            "SHE": pkg.Shears(mapper, "RA", "DEC", "G1", "G2", mask="WHT"),
            "VIS": pkg.Visibility(mapper),
            "WHT": pkg.Weights(mapper, "RA", "DEC"),
        }

    got = th.get_masks(make(th), **kwargs)
    assert got == jh.get_masks(make(jh), **kwargs)
    assert got  # every case keeps some masks


# -- the FMA-peak probe ---------------------------------------------------------


@pytest.mark.parametrize("kind", ["fma", "rec3"])
def test_probe_chains_match_pallas(kind):
    """The plain chains against vpu_peak's Pallas kernels in interpret mode."""
    vpu = _vpu_peak()
    kern = {"fma": vpu._fma_kernel, "rec3": vpu._rec3_kernel}[kind]
    rows, steps, nchain = 8, 128, 2
    a = np.full((rows, 128), 1.0 + 2.0**-20, np.float32)
    b = np.full((rows, 128), 1.0 - 2.0**-20, np.float32)
    want = np.asarray(pl.pallas_call(
        partial(kern, steps=steps, nchain=nchain),
        out_shape=jax.ShapeDtypeStruct((rows, 128), jnp.float32),
        interpret=True,
    )(jnp.asarray(a), jnp.asarray(b)))
    fma_peak.reset_counts()
    got = fma_peak.chains(torch.as_tensor(a), torch.as_tensor(b), kind, steps, nchain)
    assert got.dtype == torch.float32 and got.shape == (rows, 128)
    assert fma_peak.LAUNCHES == {} and fma_peak.PLAIN_RUNS == {"fma_peak": 1}
    assert _rel(got.numpy().astype(np.float64), want) <= steps * 2.0**-23
    assert np.all(np.isfinite(want))


def test_probe_counts_and_checks():
    a, b = fma_peak.inputs(2, torch.float64, "cpu")
    # steps are whole loop iterations, as vpu_peak.run counts them
    assert fma_peak.executed_steps(200) == 192
    with pytest.raises(ValueError, match="steps must be"):
        fma_peak.chains(a, b, "fma", 63, 1)
    with pytest.raises(ValueError, match="nchain"):
        fma_peak.chains(a, b, "fma", 64, 3)
    with pytest.raises(ValueError, match="unknown probe"):
        fma_peak.chains(a, b, "fma3", 64, 1)
    with pytest.raises(TypeError, match="float32 or float64"):
        fma_peak.chains(a.half(), b.half(), "fma", 64, 1)
    with pytest.raises(ValueError, match="times the card"):
        fma_peak.run("fma", 2, 64, 1, dtype=torch.float32, device="cpu")
    # the 64-step fma chain from 0.5 a towards a / (1 - b)
    out = fma_peak.chains(a, b, "fma", 64, 1)
    want = 0.5 * a
    for _ in range(64):
        want = want * b + a
    torch.testing.assert_close(out, want, rtol=0, atol=0)
