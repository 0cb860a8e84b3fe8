"""The port's host algebra against heracles_tpu's, on the CPU.

``utils`` (spectra-dict algebra), ``transforms`` (Cl <-> correlation
function on Gauss-Legendre nodes), ``unmixing`` (NaturalSpice) and the
``Mapper`` protocol, on the same seeded inputs in float64.
"""

import numpy as np
import pytest
import torch

import heracles_tpu as jh
import heracles_tpu.mapper as jmapper
import heracles_tpu.transforms as jtr
import heracles_tpu.unmixing as jun
import heracles_tpu.utils as jut
import heracles_tpu_torch as th
import heracles_tpu_torch.mapper as tmapper
import heracles_tpu_torch.transforms as ttr
import heracles_tpu_torch.unmixing as tun
import heracles_tpu_torch.utils as tut

LMAX = 12
SPINS = [(0, 0), (0, 2), (2, 0), (2, 2)]


def _cl(pkg, spin, seed, lmax=LMAX):
    rng = np.random.default_rng(seed)
    shape = tuple(2 for s in spin if s) + (lmax + 1,)
    arr = rng.normal(size=shape) + 3.0
    jh.update_metadata(arr, bias=0.1 * seed)
    return pkg.Result(arr, spin=spin)


def _cls(pkg):
    return {
        ("A", "A", 0, 0): _cl(pkg, (0, 0), 1),
        ("A", "B", 0, 0): _cl(pkg, (0, 2), 2),
        ("B", "B", 0, 0): _cl(pkg, (2, 2), 3),
    }


def _same(got, want, rtol=1e-13):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.spin == w.spin and g.axis == w.axis, key
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol,
                                   atol=rtol * np.abs(np.asarray(w)).max())
        for a, b in zip(tuple(np.atleast_1d(g.ell)), tuple(np.atleast_1d(w.ell))):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("key", [("A", "B", 0, 0), ("B", "A", 0, 0),
                                 ("B", "B", 0, 0)])
def test_get_cl(key):
    got = tut.get_cl(key, _cls(th))
    want = jut.get_cl(key, _cls(jh))
    assert got.spin == want.spin
    np.testing.assert_array_equal(got.array, want.array)
    with pytest.raises(KeyError):
        tut.get_cl(("C", "A", 0, 0), _cls(th))


@pytest.mark.parametrize("op", ["add_to_Cls", "sub_to_Cls"])
def test_add_sub(op):
    x = {key: 0.5 * i for i, key in enumerate(_cls(th))}
    _same(getattr(tut, op)(_cls(th), x), getattr(jut, op)(_cls(jh), x))


@pytest.mark.parametrize("spin", SPINS)
def test_spin0_dims(spin):
    got = tut.expand_spin0_dims(_cl(th, spin, 4))
    want = jut.expand_spin0_dims(_cl(jh, spin, 4))
    assert got.shape == want.shape and got.axis == want.axis
    np.testing.assert_array_equal(got.array, want.array)
    back = tut.squeeze_spin0_dims(got)
    assert back.shape == _cl(th, spin, 4).shape and back.axis == (len(back.shape) - 1,)


def _cov(pkg):
    rng = np.random.default_rng(5)
    n = LMAX + 1
    a = rng.normal(size=(n, n))
    b = rng.normal(size=(2, n, n))
    c = rng.normal(size=(2, 2, n, n))
    return {
        ("A", "A", "A", "A", 0, 0, 0, 0): pkg.Result(a @ a.T, spin=(0, 0, 0, 0),
                                                     axis=(-2, -1)),
        ("A", "A", "A", "B", 0, 0, 0, 0): pkg.Result(b, spin=(0, 0, 0, 2),
                                                     axis=(-2, -1)),
        ("A", "B", "A", "B", 0, 0, 0, 0): pkg.Result(
            np.einsum("ijlk,ijmk->ijlm", c, c), spin=(0, 2, 0, 2),
            axis=(-2, -1)),
    }


def test_flatten():
    np.testing.assert_array_equal(tut.flatten(_cls(th)), jut.flatten(_cls(jh)))
    np.testing.assert_array_equal(tut.flatten(_cov(th)), jut.flatten(_cov(jh)))


def test_impose_correlation():
    a, b = _cov(th), {k: v for k, v in _cov(th).items()}
    b = {k: v.__class__(np.asarray(v) * 2.0, spin=v.spin, axis=v.axis)
         for k, v in b.items()}
    rb = {k: v.__class__(np.asarray(v) * 2.0, spin=v.spin, axis=v.axis)
          for k, v in _cov(jh).items()}
    with np.errstate(invalid="ignore"):
        got = tut.impose_correlation(a, b)
        want = jut.impose_correlation(_cov(jh), rb)
    for key, w in want.items():
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(w),
                                   rtol=1e-14, equal_nan=True)


@pytest.mark.parametrize("spin", SPINS)
def test_cl2corr_matches_reference(spin):
    cls = {("X", "Y", 0, 0): _cl(th, spin, 7)}
    rcls = {("X", "Y", 0, 0): _cl(jh, spin, 7)}
    _same(ttr.cl2corr(cls), jtr.cl2corr(rcls))
    _same(ttr.corr2cl(ttr.cl2corr(cls)), jtr.corr2cl(jtr.cl2corr(rcls)))


@pytest.mark.parametrize("spin", SPINS)
def test_cl2corr_round_trip(spin):
    """corr2cl undoes cl2corr: l >= |s| for spin-weighted rows (the
    Wigner-d functions vanish below)."""
    cl = _cl(th, spin, 8)
    back = ttr.corr2cl(ttr.cl2corr({("X", "Y", 0, 0): cl}))[("X", "Y", 0, 0)]
    lmin = max(abs(s) for s in spin)
    np.testing.assert_allclose(np.asarray(back)[..., lmin:],
                               np.asarray(cl)[..., lmin:], rtol=1e-11)
    np.testing.assert_array_equal(back.ell, np.arange(LMAX + 1))


@pytest.mark.parametrize("a,b", [(0, 0), (2, 0), (2, 2), (2, -2), (0, 2)])
def test_wigner_d_table(a, b):
    x, _ = ttr._gauss_legendre(9)
    np.testing.assert_allclose(ttr.wigner_d_table(a, b, x, 10),
                               jtr.wigner_d_table(a, b, x, 10), rtol=0,
                               atol=1e-15)
    # P_1(x) = x for (0, 0)
    if (a, b) == (0, 0):
        np.testing.assert_allclose(ttr.wigner_d_table(0, 0, x, 1)[1], x)


@pytest.mark.parametrize("theta_max", [None, 40.0])
def test_naturalspice(theta_max):
    """Data spectra of fields A (spin 0) and B (spin 2) with masks M, N of
    a higher band limit, deconvolved in real space."""
    rng = np.random.default_rng(9)
    lmask = 2 * LMAX

    def inputs(pkg):
        d = _cls(pkg)
        m = {}
        for key, spin in ((("M", "M", 0, 0), (0, 0)), (("M", "N", 0, 0), (0, 0)),
                          (("N", "N", 0, 0), (0, 0))):
            arr = np.exp(-np.arange(lmask + 1) / 5.0) * (1 + 0.1 * rng.random())
            m[key] = pkg.Result(arr, spin=spin)
        return d, m

    state = rng.bit_generator.state
    d, m = inputs(th)
    rng.bit_generator.state = state
    rd, rm = inputs(jh)
    fields = {"A": th.Positions(None, mask="M"), "B": th.Shears(None, mask="N")}
    rfields = {"A": jh.Positions(None, mask="M"), "B": jh.Shears(None, mask="N")}
    with np.errstate(all="ignore"):
        got = tun.naturalspice(d, m, fields, theta_max=theta_max)
        want = jun.naturalspice(rd, rm, rfields, theta_max=theta_max)
    _same(got, want, rtol=1e-12)
    assert tun.logistic(np.array([-2.0]))[0] == 2.0


def test_mapper_protocol():
    """The port's HealpixMapper satisfies both packages' ``Mapper``
    protocol, and the port's protocol is the reference's."""
    mapper = th.HealpixMapper(4, device="cpu")
    assert isinstance(mapper, tmapper.Mapper)
    assert isinstance(mapper, th.Mapper)
    assert isinstance(mapper, jmapper.Mapper)
    assert not isinstance(object(), tmapper.Mapper)
    members = {n for n in vars(jmapper.Mapper) if not n.startswith("_")}
    assert members == {n for n in vars(tmapper.Mapper) if not n.startswith("_")}
    assert isinstance(jh.HealpixMapper(4), tmapper.Mapper)


def test_transform_resident_and_async_on_the_cpu():
    """On a CPU tensor ``transform_resident`` is ``transform`` and
    ``transform_async``'s handle gives the host alms with their metadata."""
    rng = np.random.default_rng(11)
    mapper = th.HealpixMapper(4, 6, deconvolve=False, device="cpu")
    m = torch.as_tensor(rng.normal(size=(3, 2, 192)))
    md = {"spin": 2, "fsky": 0.5}
    want = mapper.transform(m, spin=2, metadata=md)
    res = mapper.transform_resident(m, spin=2, metadata=md)
    assert isinstance(res, th.DeviceMap) and torch.equal(res.array, want.array)
    assert res.metadata == want.metadata
    handle = mapper.transform_async(m, spin=2, metadata=md)
    assert callable(handle)
    got = handle()
    assert isinstance(got, np.ndarray) and got.shape == (3, 2, 28)
    np.testing.assert_array_equal(got, want.array.numpy())
    assert dict(got.dtype.metadata) == want.metadata
