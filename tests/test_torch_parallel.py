"""The port's device mesh (``heracles_tpu_torch.parallel``) against heracles_tpu.

The port runs on ``make_mesh(8, m_axis=2, devices=["cpu"] * 8)``, a (4, 2)
("batch", "m") mesh of shards that share the CPU, and the JAX package on
the 8-device CPU mesh that ``tests/conftest.py`` gives it.  Inputs are
float64, made with a seeded numpy generator and handed to both, at
nside 8 / lmax 12 (the size of ``tests/test_parallel.py``).

``pipeline_step`` is held against the JAX sharded function (its jnp path).
The JAX sharded analysis and synthesis take 25-40 s each to compile here,
so ``map2alm_sharded``, ``alm2map_sharded``, the sharded mapper methods,
``transform(mesh=)``, the spectra, the mixing matrices and DICES are held
against the JAX single-device functions, which the JAX package's own
tests hold equal to its sharded ones.  Tolerances: float64 sums in
another order, ``rtol 1e-10`` and ``atol 1e-12`` of the largest value for
alms and maps, ``1e-12`` for spectra and mixing matrices.
"""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import heracles_tpu as jh
import heracles_tpu.dices as jdices
import heracles_tpu_torch as th
import heracles_tpu_torch.dices as tdices
from heracles_tpu import parallel as jpar
from heracles_tpu.ops import sht as jsht
from heracles_tpu_torch import parallel as tpar
from heracles_tpu_torch.ops import gram, ringfft, sht, wigner

NSIDE, LMAX = 8, 12
NPIX = 12 * NSIDE**2
RTOL, ATOL = 1e-10, 1e-12


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * np.abs(want).max())


@pytest.fixture(scope="module")
def mesh():
    m = tpar.make_mesh(8, m_axis=2, devices=["cpu"] * 8)
    assert m.shape == {"batch": 4, "m": 2} and m.size == 8
    assert m.axis_names == ("batch", "m")
    return m


@pytest.fixture(scope="module")
def jmesh():
    m = jpar.make_mesh(8)
    assert m.devices.size == 8 and m.shape["m"] == 2
    return m


@pytest.fixture(scope="module")
def maps():
    """8 spin-0 maps and 4 [Q, U] pairs (float64)."""
    rng = np.random.default_rng(7)
    return rng.normal(size=(8, NPIX)), rng.normal(size=(4, 2, NPIX))


def _padded_m():
    """The reference's padded order axis on a 2-wide "m" axis."""
    return jpar._m_block(LMAX, 2) * 2


@pytest.mark.parametrize("spin", [0, 2])
def test_map2alm_sharded(mesh, maps, spin):
    m = maps[spin // 2]
    got = tpar.map2alm_sharded(mesh, torch.as_tensor(m), LMAX, spin=spin)
    assert tuple(got.shape) == m.shape[:-1] + (LMAX + 1, _padded_m())
    assert got.dtype == torch.complex128
    want = np.asarray(jsht.map2alm(m, lmax=LMAX, spin=spin, packed=False))
    _close(got[..., : LMAX + 1], want)
    assert not got[..., LMAX + 1:].any()


@pytest.mark.parametrize("spin", [0, 2])
def test_alm2map_sharded(mesh, maps, spin):
    m = maps[spin // 2]
    alm = np.asarray(jsht.map2alm(m, lmax=LMAX, spin=spin, packed=False))
    padded = np.pad(alm, [(0, 0)] * (alm.ndim - 1)
                    + [(0, _padded_m() - LMAX - 1)])
    got = tpar.alm2map_sharded(mesh, torch.as_tensor(padded), NSIDE,
                               lmax=LMAX, spin=spin)
    want = np.asarray(jsht.alm2map(alm, NSIDE, lmax=LMAX, spin=spin,
                                   packed=False))
    _close(got, want)
    # the unpadded layout is padded by the function itself
    _close(tpar.alm2map_sharded(mesh, torch.tensor(alm), NSIDE, spin=spin),
           want)


@pytest.mark.parametrize("mixed", [False, True])
def test_pipeline_step(mesh, jmesh, maps, mixed):
    """Against the JAX sharded pipeline step: the spin-0 grid, and the
    mixed-spin grid whose rows and columns each shard emits in its own
    order and the function permutes."""
    import jax.numpy as jnp

    m0, m2 = maps
    args = (m2,) if mixed else ()
    want = np.asarray(jpar.pipeline_step(
        jmesh, jnp.asarray(m0), LMAX, *map(jnp.asarray, args), engine="jnp"))
    got = tpar.pipeline_step(mesh, torch.as_tensor(m0), LMAX,
                             *map(torch.as_tensor, args))
    assert got.dtype == torch.float64
    _close(got, want, rtol=1e-12, atol=1e-12)


def test_pipeline_step_batch_must_split(mesh, maps):
    with pytest.raises(ValueError, match="batch"):
        tpar.pipeline_step(mesh, torch.as_tensor(maps[0][:6]), LMAX)


def test_m_offset_real_orders(mesh):
    """Orders of the second "m" block that are real (lmax above the first
    block of 128): analysis and synthesis through the mesh against the
    unsharded transforms (after ``tests/test_parallel_sharded.py``)."""
    nside, lmax = 64, 160
    rng = np.random.default_rng(23)
    m = rng.normal(size=(mesh.shape["batch"], 12 * nside**2))
    got = tpar.map2alm_sharded(mesh, torch.as_tensor(m), lmax)
    assert got.shape[-1] == jpar._m_block(lmax, 2) * 2 == 256
    want = np.asarray(jsht.map2alm(m, lmax=lmax, packed=False))
    _close(got[..., : lmax + 1], want)
    back = tpar.alm2map_sharded(mesh, got, nside, lmax=lmax)
    _close(back, sht.alm2map(torch.tensor(want), nside, lmax, packed=False))


@pytest.mark.parametrize("spin", [0, 2])
def test_map2alm_sharded_dd(mesh, maps, spin):
    """``dd=True`` on float32 maps: the float64 Wigner stage brings the
    sharded alms to the float64 ones, closer than float32 (after
    ``tests/test_parallel_dd.py``)."""
    m = maps[spin // 2]
    want = np.asarray(jsht.map2alm(m, lmax=LMAX, spin=spin, packed=False))
    m32 = torch.as_tensor(m, dtype=torch.float32)
    a_dd = tpar.map2alm_sharded(mesh, m32, LMAX, spin=spin, dd=True)
    a_pl = tpar.map2alm_sharded(mesh, m32, LMAX, spin=spin, dd=False)
    assert a_dd.dtype == a_pl.dtype == torch.complex64
    scale = np.abs(want).max()
    err_dd = np.abs(a_dd[..., : LMAX + 1].numpy() - want).max() / scale
    err_pl = np.abs(a_pl[..., : LMAX + 1].numpy() - want).max() / scale
    assert err_dd < 5e-7 and err_dd <= err_pl, (err_dd, err_pl)


def test_engine_only_auto(mesh, maps):
    with pytest.raises(ValueError, match="engine"):
        tpar.map2alm_sharded(mesh, torch.as_tensor(maps[0]), LMAX,
                             engine="jnp")


def test_make_mesh_without_a_card_raises(monkeypatch):
    """No visible card: make_mesh() raises and builds no CPU mesh."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.make_mesh(4, m_axis=2)


def test_make_mesh_shapes():
    assert tpar.make_mesh(devices=["cpu"] * 6).shape == {"batch": 3, "m": 2}
    assert tpar.make_mesh(3, devices=["cpu"] * 6).shape == {"batch": 3, "m": 1}
    assert tpar.make_mesh(4, m_axis=4, devices=["cpu"] * 4).shape == {
        "batch": 1, "m": 4}
    with pytest.raises(ValueError):
        tpar.make_mesh(6, m_axis=4, devices=["cpu"] * 6)
    with pytest.raises(ValueError):
        tpar.make_mesh(9, devices=["cpu"] * 8)


def test_example_batch(mesh, jmesh):
    got = tpar.example_batch(mesh, nside=NSIDE, seed=3, spin2=True)
    want = jpar.example_batch(jmesh, nside=NSIDE, seed=3, spin2=True)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_collectives_on_shared_devices():
    """Shards that share a device: the sum and the gather in shard order."""
    devs = [torch.device("cpu")] * 3
    parts = [torch.full((2, 3), float(i)) for i in range(3)]
    for t in tpar._psum(parts, devs):
        np.testing.assert_array_equal(t.numpy(), np.full((2, 3), 3.0))
    whole = tpar._all_gather(parts, devs, dim=-1, dest=devs[0])
    np.testing.assert_array_equal(whole.numpy(),
                                  np.repeat([[0.0, 1.0, 2.0]], 3, axis=1)
                                  .reshape(1, 9).repeat(2, axis=0))


def test_collectives_between_distinct_cards(mesh, maps, monkeypatch):
    """The path of distinct cards, ``torch.cuda.comm``, with that module's
    functions stood in for on the CPU as they behave on the card: a complex
    tensor goes in and comes back as its real view.  The sharded results
    equal those of the shared-device path."""
    import types

    from torch.nn.parallel import comm as real_comm

    real = real_comm._handle_complex
    calls = []

    def record(name, out):
        calls.append(name)
        return out

    fake = types.SimpleNamespace(
        gather=lambda ts, dim, destination: record(
            "gather", torch.cat([real(t) for t in ts], dim)),
        broadcast=lambda t, devices: record(
            "broadcast", tuple(real(t).clone() for _ in devices)),
        reduce_add=lambda ts, destination: record(
            "reduce_add", sum(ts[1:], ts[0].clone())),
    )
    m0 = torch.as_tensor(maps[0])
    m2 = torch.as_tensor(maps[1])
    want = [tpar.pipeline_step(mesh, m0, LMAX, m2),
            tpar.map2alm_sharded(mesh, m2, LMAX, spin=2)]
    want.append(tpar.alm2map_sharded(mesh, want[1], NSIDE, spin=2))
    monkeypatch.setattr(torch.cuda, "comm", fake, raising=False)
    monkeypatch.setattr(tpar, "_distinct_cards", lambda devices: True)
    got = [tpar.pipeline_step(mesh, m0, LMAX, m2),
           tpar.map2alm_sharded(mesh, m2, LMAX, spin=2)]
    got.append(tpar.alm2map_sharded(mesh, got[1], NSIDE, spin=2))
    assert set(calls) == {"gather", "broadcast", "reduce_add"}
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("spin", [0, 2])
def test_transform_and_synthesize_sharded(mesh, maps, spin):
    """The mapper's sharded methods against the reference's transform and
    synthesize of the same stack (deconvolved, so the metadata and the
    window go through too); 6 bins are padded to the batch axis' 8."""
    m = maps[spin // 2][:3] if spin else maps[0][:6]
    jmapper = jh.HealpixMapper(NSIDE, LMAX)
    want = jmapper.transform(m.copy(), spin=spin)
    tmapper = th.HealpixMapper(NSIDE, LMAX, device="cpu")
    got = tmapper.transform_sharded(mesh, m.copy(), spin=spin)
    assert isinstance(got, th.DeviceMap)
    assert got.metadata["deconv"] is True
    _close(got, want)
    back = tmapper.synthesize_sharded(mesh, got, spin=spin)
    _close(back, jmapper.synthesize(np.asarray(want), spin=spin))
    assert back.metadata["nside"] == NSIDE and back.metadata["spin"] == spin


def test_transform_sharded_iterations(mesh, maps):
    """Jacobi iterations run sharded: equal to the unsharded transform."""
    tmapper = th.HealpixMapper(NSIDE, LMAX, deconvolve=False, iterations=2,
                               device="cpu")
    m = torch.as_tensor(maps[0][:4])
    _close(tmapper.transform_sharded(mesh, m), tmapper.transform(m))


@pytest.mark.parametrize("spin", [0, 2])
def test_transform_sharded_iterations_match_the_reference(mesh, maps, spin):
    """The reference's ``transform_sharded`` drops the mapper's Jacobi
    iterations (heracles_tpu/mappers.py:325-327) though it promises the
    alms of ``transform``; the port's sharded iterated transform gives
    what it promises: the reference's unsharded ``transform`` of the same
    maps."""
    m = maps[spin // 2][:4]
    want = jh.HealpixMapper(NSIDE, LMAX, deconvolve=False,
                            iterations=2).transform(m.copy(), spin=spin)
    tmapper = th.HealpixMapper(NSIDE, LMAX, deconvolve=False, iterations=2,
                               device="cpu")
    got = tmapper.transform_sharded(mesh, torch.as_tensor(m), spin=spin)
    _close(got.array, np.asarray(want))


def _fields(pkg, **kw):
    mapper = pkg.HealpixMapper(NSIDE, LMAX, deconvolve=False, **kw)
    return {
        "POS": pkg.Positions(mapper, "RA", "DEC", mask="VIS"),
        "SHE": pkg.Spin2Field(mapper, "RA", "DEC", "G1", "G2", mask="VIS"),
    }


def _field_maps(pkg, fields, maps):
    out = {}
    for i in range(3):
        pos = fields["POS"].mapper.create(spin=0)
        pos[:] = maps[0][i]
        she = fields["SHE"].mapper.create(2, spin=2)
        she[:] = maps[1][i]
        out["POS", i], out["SHE", i] = pos, she
    return out


@pytest.fixture(scope="module")
def ref_spectra(maps):
    fields = _fields(jh)
    alms = jh.transform(fields, _field_maps(jh, fields, maps))
    return alms, jh.angular_power_spectra(alms)


def test_transform_and_spectra_with_mesh(mesh, maps, ref_spectra):
    """``transform(mesh=)`` (every group through ``transform_sharded``) and
    ``angular_power_spectra(mesh=)`` (plane rows split over the shards)."""
    want_alms, want_cls = ref_spectra
    fields = _fields(th, device="cpu")
    alms = th.transform(fields, _field_maps(th, fields, maps), mesh=mesh)
    assert sorted(alms) == sorted(want_alms)
    for key, want in want_alms.items():
        _close(alms[key], want)
        assert alms[key].dtype.metadata == want.dtype.metadata
    cls = th.angular_power_spectra(alms, mesh=mesh)
    assert sorted(cls) == sorted(want_cls)
    for key, want in want_cls.items():
        _close(cls[key].array, want.array, rtol=1e-12, atol=1e-12)
    samples = th.angular_power_spectra_samples([alms, alms], mesh=mesh)
    assert len(samples) == 2
    for got in samples:
        for key, want in want_cls.items():
            _close(got[key].array, want.array, rtol=1e-12, atol=1e-12)


def test_mixmat_with_mesh(mesh):
    """GL nodes split over the shards: mixmat / mixmat_eb / mixing_matrices
    against the reference (after ``tests/test_parallel_sharded.py``)."""
    from heracles_tpu import twopoint as jtp

    lmax = 16
    rng = np.random.default_rng(31)
    cl = rng.uniform(size=lmax + 1) / (1 + np.arange(lmax + 1))
    for fn, spin in (("mixmat", (0, 0)), ("mixmat", (0, 2)),
                     ("mixmat_eb", (2, 2))):
        want = getattr(jtp, fn)(cl, l1max=lmax, l2max=lmax, spin=spin)
        got = getattr(th, fn)(cl, l1max=lmax, l2max=lmax, spin=spin,
                              mesh=mesh)
        _close(got, want, rtol=1e-12, atol=1e-12)
    fields = _fields(jh)
    fields["VIS"] = jh.Visibility(fields["POS"].mapper)
    tfields = _fields(th, device="cpu")
    tfields["VIS"] = th.Visibility(tfields["POS"].mapper)
    mask_cls = {("VIS", "VIS", 0, 0): cl}
    want = jh.mixing_matrices(fields, mask_cls)
    got = th.mixing_matrices(tfields, mask_cls, mesh=mesh)
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key].array, want[key].array, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("K", [37, 8, 3])
def test_gram_sharded(mesh, K):
    """K split into equal blocks, the padding of zero weight: equal to
    ``gram`` (K 3 leaves five shards on padding alone)."""
    rng = np.random.default_rng(K)
    A, B, u = (torch.as_tensor(rng.normal(size=s))
               for s in ((K, 5), (K, 7), (K,)))
    _close(gram.gram_sharded(mesh, A, B, u), gram.gram(A, B, u), 1e-12)
    _close(gram.gram_sharded(mesh, A, B), gram.gram(A, B), 1e-12)


@pytest.mark.parametrize("spin", [0, 2])
def test_adjoint_synthesis_sharded(mesh, spin):
    """Points split over the shards (padded at theta = pi/2 with zero
    values) against the reference's exact adjoint."""
    lmax, npts = 16, 203
    rng = np.random.default_rng(11 + spin)
    theta = np.arccos(rng.uniform(-1, 1, npts))
    phi = rng.uniform(0, 2 * np.pi, npts)
    theta[:2] = 0.0, np.pi / 2
    v = rng.normal(size=(2 if spin else 1, npts))
    want = np.asarray(jh.DiscreteMapper(lmax)._adjoint_synthesis(
        theta, phi, v, spin=spin))
    mapper = th.DiscreteMapper(lmax, point_block=16, device="cpu")
    got = mapper.adjoint_synthesis_sharded(mesh, theta, phi, v, spin=spin)
    _close(got.reshape(want.shape), want)


def test_jackknife_cls_with_mesh(mesh, tmp_path):
    """DICES with a mesh, at ``tests/test_parallel_dd.py``'s size, against
    the reference without one: file mode, delete-1 samples."""
    nside, lmax, njk = 8, 12, 4
    npix = 12 * nside**2
    rng = np.random.default_rng(66)
    m = rng.normal(size=npix) + 1.0
    jk_map = (np.arange(npix) * njk // npix + 1).astype(float)

    def run(pkg, d, **kw):
        dev = {"device": "cpu"} if pkg is th else {}
        mapper = pkg.HealpixMapper(nside, lmax=lmax, deconvolve=False, **dev)
        fields = {"POS": pkg.Positions(mapper, "RA", "DEC",
                                       overdensity=False)}
        mm, vv = m.copy(), np.ones(npix)
        pkg.update_metadata(mm, spin=0, fsky=1.0)
        pkg.update_metadata(vv, spin=0, fsky=1.0)
        dices = tdices if pkg is th else jdices
        return dices.jackknife_cls({("POS", 0): mm}, {("POS", 0): vv}, jk_map,
                                   fields, dir=str(tmp_path / d), **kw)

    want = run(jh, "ref")
    got = run(th, "port", mesh=mesh)
    assert set(got) == set(want)
    for k in want:
        for key in want[k]:
            _close(got[k][key].array, want[k][key].array, rtol=1e-9,
                   atol=1e-11)


def test_compute_jk_alms_mesh_refuses_device_cache(mesh):
    fields = _fields(th, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        tdices.compute_jk_alms({}, {}, np.ones(NPIX), fields, dir=None,
                               device_cache=True, mesh=mesh)


# -- the order offset of the kernels' plain versions, ring_analysis ------


def _geom(nside):
    return [torch.as_tensor(a) for a in sht._geometry(nside, "cpu")]


def test_plain_kernels_m0(maps):
    """The plain versions on a block of orders m0..m0+nm-1 equal those
    columns of the m0 = 0 run, and orders above lmax give zeros.  (The
    ring sums of a narrower block round in another order on the CPU: to
    1e-15 of the largest value; the kernels repeat bit for bit on the
    card, ``tests/test_torch_kernels.py``.)"""
    nside, lmax, nm = 8, 12, 13
    x, lch, lsh = _geom(nside)
    rng = np.random.default_rng(5)
    F = [torch.as_tensor(rng.normal(size=(2, 2 * nside, nm))
                         + 1j * rng.normal(size=(2, 2 * nside, nm)))
         for _ in range(4)]
    A = [torch.as_tensor(rng.normal(size=(2, lmax + 1, nm))
                         + 1j * rng.normal(size=(2, lmax + 1, nm)))
         for _ in range(2)]
    cases = (
        (wigner.analysis_spin0_folded_plain, F[:2], ()),
        (wigner.analysis_pair_folded_plain, F, (2,)),
        (wigner.synthesis_spin0_folded_plain, A[:1], ()),
        (wigner.synthesis_pair_folded_plain, A, (2,)),
    )
    for fn, ins, extra in cases:
        full = fn(*ins, x, lch, lsh, lmax, *extra)
        full = full if isinstance(full, tuple) else (full,)
        for m0, width in ((5, 6), (10, 8), (13, 4)):
            block = [torch.nn.functional.pad(t[..., m0:m0 + width],
                                             (0, max(0, m0 + width - nm)))
                     for t in ins]
            got = fn(*block, x, lch, lsh, lmax, *extra, m0)
            got = got if isinstance(got, tuple) else (got,)
            real = max(0, min(width, lmax + 1 - m0))
            for g, f in zip(got, full):
                assert not g[..., real:].any()
                if real:
                    f = f[..., m0:m0 + real].numpy()
                    np.testing.assert_allclose(g[..., :real].numpy(), f,
                                               rtol=0,
                                               atol=1e-15 * np.abs(f).max())


@pytest.mark.parametrize("complex_in", [False, True])
def test_ring_analysis_m0(complex_in):
    """A block of orders is the transform of m0 + nm orders, sliced."""
    nside = 8
    rng = np.random.default_rng(9)
    shape = (2, 12 * nside**2)
    m = rng.normal(size=shape) + (1j * rng.normal(size=shape) if complex_in
                                  else 0)
    w = sht.ring_weights(nside)
    for m0, nm in ((0, 13), (7, 9), (16, 20)):
        full = ringfft.ring_analysis(torch.as_tensor(m), nside, m0 + nm,
                                     weight=w)
        block = ringfft.ring_analysis(torch.as_tensor(m), nside, nm,
                                      weight=w, m0=m0)
        for b, f in zip(block, full):
            if f is None:
                assert b is None
                continue
            np.testing.assert_allclose(b.numpy(), f[..., m0:].numpy(),
                                       rtol=0, atol=1e-15 * f.abs().max())


# -- the sht host wrappers and the wigner functions ------------------------


@pytest.mark.parametrize("spin", [0, 2])
def test_sht_host_wrappers(maps, spin):
    m = maps[spin // 2][:2]
    want = np.asarray(jsht.map2alm_host(m, lmax=LMAX, spin=spin))
    got = sht.map2alm_host(m, LMAX, spin=spin, device="cpu")
    assert isinstance(got, np.ndarray)
    _close(got, want)
    _close(sht.map2alm_async(m, LMAX, spin=spin, device="cpu")(), want)
    back = np.asarray(jsht.alm2map_host(want, NSIDE, lmax=LMAX, spin=spin))
    _close(sht.alm2map_host(want, NSIDE, LMAX, spin=spin, device="cpu"), back)


def test_wigner_functions():
    """``wigner_table``, ``lambda_synthesis_scan`` and ``wigner_seed_log``
    against the reference's, in float64 on the same rings."""
    import jax.numpy as jnp

    from heracles_tpu.ops import wigner as jw

    rng = np.random.default_rng(0)
    theta = np.sort(rng.uniform(0.01, np.pi - 0.01, 17))
    x, lch, lsh = np.cos(theta), np.log(np.cos(theta / 2)), np.log(
        np.sin(theta / 2))
    J = [jnp.asarray(a) for a in (x, lch, lsh)]
    T = [torch.as_tensor(a) for a in (x, lch, lsh)]
    for m, n in ((0, 0), (-2, 2), (3, -1)):
        _close(wigner.wigner_table(m, n, *T, 20),
               jw.wigner_table(m, n, *J, 20), rtol=0, atol=1e-13)
    ms, ns = np.array([0, 1, 2, 3, 2]), np.array([0, 0, 2, -2, -2])
    alm = rng.normal(size=(2, 21, 5)) + 1j * rng.normal(size=(2, 21, 5))
    _close(wigner.lambda_synthesis_scan(ms, ns, *T, 20, torch.as_tensor(alm)),
           jw.lambda_synthesis_scan(jnp.asarray(ms), jnp.asarray(ns), *J, 20,
                                    jnp.asarray(alm)), rtol=0, atol=1e-13)
    mp, npar = np.array([0, -1, 2, -3, 4]), np.array([0, 2, -2, -2, 1])
    for g, w in zip(wigner.wigner_seed_log(mp, npar, T[1], T[2]),
                    jw.wigner_seed_log(jnp.asarray(mp), jnp.asarray(npar),
                                       J[1], J[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-14,
                                   atol=1e-13)


# -- every public entry point of heracles_tpu has a twin -------------------

# reference module -> the port's twin, where the name differs
_MODULE_TWINS = {"ops.df32": "ops.gram", "ops.pallas_sht": "ops.sht_kernels"}
# (reference module, name) -> the port's (module, name) where it differs
_RENAMED = {
    ("ops.df32", "gram_df32"): ("ops.gram", "gram"),
    ("ops.df32", "gram_df32_ref"): ("ops.gram", "gram_plain"),
    ("ops.df32", "gram_df32_sharded"): ("ops.gram", "gram_sharded"),
    ("ops.df32", "matmul_df32"): ("ops.gram", "gram"),
    ("ops.pallas_sht", "spin0_seed_planes"): ("ops.wigner",
                                              "spin0_seed_planes"),
    ("ops.pallas_sht", "pair_seed_planes"): ("ops.wigner", "pair_seed_planes"),
}
# keywords of the reference that its twin drops on purpose, by (reference
# module, keyword)
_DROPPED_KEYWORDS = {
    ("healpix", "xp"): "the array module (numpy or jax.numpy) of the "
                       "reference's dual functions; the port's are torch",
    ("ops.nufft", "complex_vals"): "fold_padded reads it from the grid's "
                                   "dtype",
    ("ops.ringfft", "plan"): "precomputed ring-FFT plans passed through a "
                             "jit boundary; the port plans per call",
    ("ops.ringfft", "chirps"): "precomputed chirp FFTs passed through a jit "
                               "boundary; the port's Bluestein FFT takes none",
    ("ops.sht", "m_chunk"): "the TPU's order tile; the port pads orders "
                            "only for a device mesh (sht.DEFAULT_M_CHUNK)",
    ("ops.sht", "fft_chirps"): "as ringfft's chirps",
    ("ops.sht", "fft_chirps_synth"): "as ringfft's chirps",
    ("ops.wigner", "seed"): "host seed planes for the float32 scans; the "
                            "port evaluates every seed in float64 itself",
    ("ops.wigner", "dd"): "the jnp scans' double-single mode; the port's "
                          "scans run in their input's dtype, float64 "
                          "natively",
    ("ops.wigner", "x_lo"): "the residual the scans' double-single mode "
                            "reads",
    ("ops.df32", "a_tile"): "VMEM tiling of the TPU Gram kernel",
    ("ops.df32", "b_tile"): "VMEM tiling of the TPU Gram kernel",
    ("ops.df32", "k_chunk"): "VMEM tiling of the TPU Gram kernel",
    ("ops.df32", "interpret"): "Pallas interpret mode",
    ("ops.df32", "block"): "the TPU Gram kernel's blocking read-back; the "
                           "port's gram returns a tensor on the card",
    ("ops.df32", "P"): "matmul_df32(P, Q) is the port's gram(P.T, Q), "
                       "whose operands are named A and B",
    ("ops.df32", "Q"): "as P",
    ("ops.pallas_sht", "m_chunk"): "VMEM tiling of the TPU kernels",
    ("ops.pallas_sht", "ring_block"): "VMEM tiling of the TPU kernels",
    ("ops.pallas_sht", "l_chunk"): "the l-chunked VMEM tiling of the TPU "
                                   "pair synthesis (_synth_pair_kernel_lc)",
    ("ops.pallas_sht", "contract"): "the TPU kernels' ring-contraction "
                                    "strategy (a halving tree or FMAs)",
    ("ops.pallas_sht", "skip"): "the TPU synthesis' block-skip heuristic",
    ("ops.pallas_sht", "interpret"): "Pallas interpret mode",
    ("ops.pallas_sht", "nb"): "maps sharing one recurrence: speed only, "
                              "perf_opt work (ROADMAP B-next 3)",
    ("ops.pallas_sht", "logch_lo"): "float32 residuals of the seed's logs: "
                                    "the kernels read the logs in float64",
    ("ops.pallas_sht", "logsh_lo"): "as logch_lo",
    ("ops.pallas_sht", "seed_planes"): "host seed constants; the wrappers "
                                       "compute them for their block of "
                                       "orders (m0)",
}

# names that only emulate on the TPU what the H100 has natively, or that
# the port has no use for
_EMULATION_ONLY = {
    ("", "HealpixMapper.DATAPATH"): "a data path the reference itself "
                                    "leaves unread; the port's CLI logs "
                                    "that --healpix-datapath is not read",
    ("mappers", "HealpixMapper.DATAPATH"): "as above",
    ("ops.df32", "split_f64"): "splits float64 into float32 (hi, lo) pairs: "
                               "the card computes in native float64",
    ("ops.df32", "add_df32"): "adds double-single pairs: native float64",
    ("ops.df32", "gram_result"): "joins a double-single (hi, lo) result: "
                                 "the Gram kernel returns float64",
    ("ops.ringfft", "chirp_fft_planes"): "precomputed chirp FFTs passed "
                                         "through a jit boundary; the "
                                         "port's Bluestein FFT takes none",
}


def _public(module):
    """``__all__`` and the public functions and classes a module defines."""
    names = set(getattr(module, "__all__", ()))
    names |= {n for n, o in vars(module).items()
              if not n.startswith("_")
              and (inspect.isfunction(o) or inspect.isclass(o))
              and o.__module__ == module.__name__}
    return names


def _reference_modules():
    out = {"": jh}
    for info in pkgutil.walk_packages(jh.__path__, "heracles_tpu."):
        if info.name.endswith("__main__"):
            continue
        out[info.name[len("heracles_tpu."):]] = importlib.import_module(
            info.name)
    return out


def test_every_public_name_has_a_twin():
    """Every public name of every heracles_tpu module has its twin in the
    port (same module and name, or a listed rename), or is listed as
    emulation-only with its reason; every public method of a class has
    one too, and every keyword of a function, method or constructor
    (``mesh=`` among them) is taken by its twin or listed in
    ``_DROPPED_KEYWORDS`` with its reason."""
    missing = []
    for rel, ref in sorted(_reference_modules().items()):
        twin = _MODULE_TWINS.get(rel, rel)
        port = importlib.import_module(
            "heracles_tpu_torch" + ("." + twin if twin else ""))
        for name in sorted(_public(ref)):
            if (rel, name) in _EMULATION_ONLY:
                continue
            pmod, pname = _RENAMED.get((rel, name), (twin, name))
            pmod = importlib.import_module(
                "heracles_tpu_torch" + ("." + pmod if pmod else ""))
            if not hasattr(pmod, pname):
                missing.append(f"{rel}.{name}")
                continue
            robj, pobj = getattr(ref, name), getattr(pmod, pname)
            if inspect.isclass(robj):
                for meth in dir(robj):
                    if (not meth.startswith("_") and not hasattr(pobj, meth)
                            and (rel, f"{name}.{meth}") not in _EMULATION_ONLY):
                        missing.append(f"{rel}.{name}.{meth}")
                funcs = [(f"{name}.{meth}", getattr(robj, meth),
                          getattr(pobj, meth, None)) for meth in dir(robj)
                         if not meth.startswith("_")
                         and inspect.isfunction(getattr(robj, meth))]
                funcs.append((f"{name}()", robj.__init__, pobj.__init__))
            else:
                funcs = [(name, robj, pobj)]
            for label, rf, pf in funcs:
                if not callable(rf) or pf is None:
                    continue
                try:
                    rp = inspect.signature(rf).parameters
                    pp = inspect.signature(pf).parameters
                except (TypeError, ValueError):
                    continue
                if any(p.kind == p.VAR_KEYWORD for p in pp.values()):
                    continue
                for kw, p in rp.items():
                    if (p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
                            and kw not in pp
                            and (rel, kw) not in _DROPPED_KEYWORDS):
                        missing.append(f"{rel}.{label}({kw}=)")
    assert not missing, missing
