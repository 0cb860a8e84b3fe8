"""Hopper kernels against their plain PyTorch versions.

These tests need an NVIDIA Hopper card and ``nvcc``; they carry the
``cuda`` marker and skip elsewhere.  The file imports no JAX, so on the
card it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

Tolerances: the analysis and synthesis kernels are held to the bar the
Pallas kernels were held to against the jnp scans (tests/test_pallas.py):
float32 ``atol = 2e-5 * scale, rtol = 2e-4`` (the same algorithm, with
float32 sums taken in another order), the pair synthesis ``atol = 3e-5 *
scale, rtol = 3e-4``; float64 ``atol = 1e-11 * scale``.  The Gram
kernel to 1e-12 of the largest entry (float64 sums in another order), the
probe kernels to steps * eps of the largest value (an FMA and a
multiply-then-add round differently at every step).
"""

import numpy as np
import pytest
import torch

from heracles_tpu_torch.healpix import ring_geometry
from heracles_tpu_torch.ops import fma_peak, gram, sht_kernels, wigner

pytestmark = pytest.mark.cuda

# (nside, lmax, batch): a batched case, odd nside, lmax > 2*nside and the
# high-order case of tests/test_pallas.py (seeds near the poles)
CASES = [(16, 24, 3), (33, 80, 1), (64, 191, 1)]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from heracles_tpu_torch.ops import _build

    print(_build.load_library().log)
    return torch.device("cuda")


def _inputs(nside, lmax, batch, nspec, cdtype, device, seed, nm=None):
    rng = np.random.default_rng(seed)
    nhalf = 2 * nside
    shape = (batch, nhalf, lmax + 1 if nm is None else nm)
    spectra = [
        torch.as_tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape),
                        dtype=cdtype, device=device)
        for _ in range(nspec)
    ]
    z = ring_geometry(nside)["z"][:nhalf]
    geom = [torch.as_tensor(a, device=device) for a in (
        z, 0.5 * np.log((1.0 + z) / 2.0), 0.5 * np.log((1.0 - z) / 2.0))]
    return spectra, geom


def _assert_close(got, want, cdtype, tol32=(2e-5, 2e-4)):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    scale = np.abs(want).max()
    assert np.all(np.isfinite(got))
    if cdtype == torch.complex64:
        np.testing.assert_allclose(got, want, atol=tol32[0] * scale,
                                   rtol=tol32[1])
    else:
        np.testing.assert_allclose(got, want, atol=1e-11 * scale, rtol=0)


def _alms(nside, lmax, batch, nalm, cdtype, device, seed, nm=None):
    rng = np.random.default_rng(seed)
    shape = (batch, lmax + 1, lmax + 1 if nm is None else nm)
    alms = [torch.as_tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape),
                            dtype=cdtype, device=device) for _ in range(nalm)]
    return alms, _inputs(nside, lmax, 1, 0, cdtype, device, seed)[1]


@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("nside,lmax,batch", CASES)
def test_spin0_kernel_matches_plain(cuda, nside, lmax, batch, cdtype):
    (Fe, Fo), geom = _inputs(nside, lmax, batch, 2, cdtype, cuda, 0)
    want = wigner.analysis_spin0_folded_plain(Fe, Fo, *geom, lmax)
    before = sht_kernels.LAUNCHES["analysis_spin0_folded"]
    got = sht_kernels.analysis_spin0_folded(Fe, Fo, *geom, lmax)
    torch.cuda.synchronize()
    assert sht_kernels.LAUNCHES["analysis_spin0_folded"] == before + 1
    _assert_close(got, want, cdtype)
    # each row summed over warps and ring tiles in a fixed order, no
    # atomics: the kernel repeats bit for bit
    assert torch.equal(got, sht_kernels.analysis_spin0_folded(Fe, Fo, *geom,
                                                              lmax))


@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("nside,lmax,batch", CASES)
def test_pair_kernel_matches_plain(cuda, nside, lmax, batch, cdtype):
    F, geom = _inputs(nside, lmax, batch, 4, cdtype, cuda, 1)
    want = wigner.analysis_pair_folded_plain(*F, *geom, lmax, 2)
    before = sht_kernels.LAUNCHES["analysis_pair_folded"]
    got = sht_kernels.analysis_pair_folded(*F, *geom, lmax, 2)
    torch.cuda.synchronize()
    assert sht_kernels.LAUNCHES["analysis_pair_folded"] == before + 1
    for g, w in zip(got, want):
        _assert_close(g, w, cdtype)
    # each row summed over ring tiles in a fixed order, no atomics: the
    # kernel repeats bit for bit
    again = sht_kernels.analysis_pair_folded(*F, *geom, lmax, 2)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("nside,lmax,batch", CASES)
def test_synthesis_spin0_kernel_matches_plain(cuda, nside, lmax, batch, cdtype):
    (alm,), geom = _alms(nside, lmax, batch, 1, cdtype, cuda, 2)
    want = wigner.synthesis_spin0_folded_plain(alm, *geom, lmax)
    before = sht_kernels.LAUNCHES["synthesis_spin0_folded"]
    got = sht_kernels.synthesis_spin0_folded(alm, *geom, lmax)
    torch.cuda.synchronize()
    assert sht_kernels.LAUNCHES["synthesis_spin0_folded"] == before + 1
    for g, w in zip(got, want):
        assert g.shape == (batch, 2 * nside, lmax + 1)
        _assert_close(g, w, cdtype)
    # each output written once, no atomics: the kernel repeats bit for bit
    again = sht_kernels.synthesis_spin0_folded(alm, *geom, lmax)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("nside,lmax,batch", CASES)
def test_synthesis_pair_kernel_matches_plain(cuda, nside, lmax, batch, cdtype):
    alms, geom = _alms(nside, lmax, batch, 2, cdtype, cuda, 3)
    want = wigner.synthesis_pair_folded_plain(*alms, *geom, lmax, 2)
    before = sht_kernels.LAUNCHES["synthesis_pair_folded"]
    got = sht_kernels.synthesis_pair_folded(*alms, *geom, lmax, 2)
    torch.cuda.synchronize()
    assert sht_kernels.LAUNCHES["synthesis_pair_folded"] == before + 1
    for g, w in zip(got, want):
        _assert_close(g, w, cdtype, tol32=(3e-5, 3e-4))
    # each output written once, no atomics: the kernel repeats bit for bit
    again = sht_kernels.synthesis_pair_folded(*alms, *geom, lmax, 2)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


# two ring tiles of 512, the second ragged (nhalf = 600), more orders than
# lmax + 1 (the orders above lmax come out zero), a batch
TILED = (300, 70, 2, 76)


@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
def test_spin0_kernel_over_ring_tiles(cuda, cdtype):
    nside, lmax, batch, nm = TILED
    (Fe, Fo), geom = _inputs(nside, lmax, batch, 2, cdtype, cuda, 8, nm=nm)
    want = wigner.analysis_spin0_folded_plain(Fe, Fo, *geom, lmax)
    got = sht_kernels.analysis_spin0_folded(Fe, Fo, *geom, lmax)
    torch.cuda.synchronize()
    assert got.shape == (batch, lmax + 1, nm)
    _assert_close(got, want, cdtype)
    assert torch.all(got[..., lmax + 1:] == 0)
    assert torch.equal(got, sht_kernels.analysis_spin0_folded(Fe, Fo, *geom,
                                                              lmax))


@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
def test_synthesis_spin0_kernel_over_ring_tiles(cuda, cdtype):
    """The second tile's last warps hold padding rings beside seeded ones."""
    nside, lmax, batch, nm = TILED
    (alm,), geom = _alms(nside, lmax, batch, 1, cdtype, cuda, 13, nm=nm)
    want = wigner.synthesis_spin0_folded_plain(alm, *geom, lmax)
    got = sht_kernels.synthesis_spin0_folded(alm, *geom, lmax)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == (batch, 2 * nside, nm)
        _assert_close(g, w, cdtype)
        assert torch.all(g[..., lmax + 1:] == 0)
    again = sht_kernels.synthesis_spin0_folded(alm, *geom, lmax)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
def test_synthesis_pair_kernel_over_ring_tiles(cuda, cdtype):
    nside, lmax, batch, nm = TILED
    alms, geom = _alms(nside, lmax, batch, 2, cdtype, cuda, 9, nm=nm)
    want = wigner.synthesis_pair_folded_plain(*alms, *geom, lmax, 2)
    got = sht_kernels.synthesis_pair_folded(*alms, *geom, lmax, 2)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == (batch, 2 * nside, nm)
        _assert_close(g, w, cdtype, tol32=(3e-5, 3e-4))
        assert torch.all(g[..., lmax + 1:] == 0)
    again = sht_kernels.synthesis_pair_folded(*alms, *geom, lmax, 2)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.parametrize("pair", [False, True])
def test_synthesis_kernels_on_tiny_alms(cuda, pair):
    """The float32 kernels hold the alms times 2^-60 in their tables: alms
    of 1e-12 (the Jacobi residuals of a float32 round trip are larger) must
    stay clear of the subnormals and keep the full-size agreement."""
    nside, lmax, batch = CASES[2]
    alms, geom = _alms(nside, lmax, batch, 2 if pair else 1, torch.complex64,
                       cuda, 10)
    alms = [a * 1e-12 for a in alms]
    if pair:
        want = wigner.synthesis_pair_folded_plain(*alms, *geom, lmax, 2)
        got = sht_kernels.synthesis_pair_folded(*alms, *geom, lmax, 2)
    else:
        want = wigner.synthesis_spin0_folded_plain(*alms, *geom, lmax)
        got = sht_kernels.synthesis_spin0_folded(*alms, *geom, lmax)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _assert_close(g, w, torch.complex64,
                      tol32=(3e-5, 3e-4) if pair else (2e-5, 2e-4))


@pytest.mark.parametrize("name", ["analysis_spin0_folded",
                                  "synthesis_spin0_folded",
                                  "synthesis_pair_folded"])
def test_path_counts(cuda, name):
    """The diagnostic launch counts every warp's sub-chunks of 8
    multipoles, by path: at nside 256 the warp nearest the pole is dead at
    the highest orders, and belt rings emit from their seed on."""
    nside, lmax, batch = 256, 191, 2
    nhalf, nm = 2 * nside, lmax + 1
    if name == "analysis_spin0_folded":
        args, geom = _inputs(nside, lmax, batch, 2, torch.complex64, cuda, 12)
        spin, extra = 0, ()
    elif name == "synthesis_spin0_folded":
        args, geom = _alms(nside, lmax, batch, 1, torch.complex64, cuda, 12)
        spin, extra = 0, ()
    else:
        args, geom = _alms(nside, lmax, batch, 2, torch.complex64, cuda, 12)
        spin, extra = 2, (2,)
    before = dict(sht_kernels.LAUNCHES)
    counts = sht_kernels.path_counts(name, *args, *geom, lmax, *extra)
    assert dict(sht_kernels.LAUNCHES) == before
    assert set(counts) == {"steady", "dead", "full"}
    # one tile of 4 warps per block; per order a synthesis takes its
    # column's multipoles in eights, the analysis in chunks of two eights
    j0 = np.maximum(np.arange(nm), spin)
    per = 16 if name == "analysis_spin0_folded" else 8
    subs = int((np.ceil((lmax + 1 - j0) / per) * (per // 8)).sum())
    assert sum(counts.values()) == batch * 4 * -(-nhalf // 512) * subs
    assert counts["steady"] > 0 and counts["dead"] > 0 and counts["full"] > 0
    with pytest.raises(TypeError, match="float32"):
        sht_kernels.path_counts(name, *(a.to(torch.complex128) for a in args),
                                *geom, lmax, *extra)


@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("lmax", [6200, 7400, 30000])
def test_spin0_kernel_at_high_lmax(cuda, lmax, cdtype):
    """lmax 6200 (HealpixMapper's default at nside 4096 is 6144), 7400 and
    30000: the rows go to the output section by section, so no lmax is
    refused for the block's shared memory (a whole column at lmax 30000
    would not fit it in either type).  Few orders keep the plain version
    cheap."""
    nside, nm = 8, 16 if lmax < 10000 else 4
    rng = np.random.default_rng(lmax)
    F = [torch.as_tensor(rng.normal(size=(2 * nside, nm))
                         + 1j * rng.normal(size=(2 * nside, nm)),
                         dtype=cdtype, device=cuda) for _ in range(2)]
    geom = _inputs(nside, lmax, 1, 0, cdtype, cuda, 7)[1]
    want = wigner.analysis_spin0_folded_plain(*F, *geom, lmax)
    got = sht_kernels.analysis_spin0_folded(*F, *geom, lmax)
    torch.cuda.synchronize()
    assert got.shape == (lmax + 1, nm)
    _assert_close(got, want, cdtype)


def test_lmax_limit(cuda):
    """The one bound on lmax is the dead path's (csrc/sht_paths.cuh)."""
    lmax = sht_kernels.LMAX_LIMIT + 1
    F = torch.zeros((4, 2), dtype=torch.complex64, device=cuda)
    geom = _inputs(2, lmax, 1, 0, torch.complex64, cuda, 0)[1]
    with pytest.raises(ValueError, match="is above"):
        sht_kernels.analysis_spin0_folded(F, F, *geom, lmax)


@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("pair", [False, True])
def test_synthesis_kernels_at_high_lmax(cuda, pair, cdtype):
    """lmax 6200 (HealpixMapper's default at nside 4096 is 6144): the
    coefficient and alm table streams through shared memory in chunks, so
    its size does not limit lmax; 16 orders keep the plain version cheap."""
    nside, lmax, nm = 8, 6200, 16
    rng = np.random.default_rng(6)
    alms = [torch.as_tensor(rng.normal(size=(lmax + 1, nm))
                            + 1j * rng.normal(size=(lmax + 1, nm)),
                            dtype=cdtype, device=cuda)
            for _ in range(2 if pair else 1)]
    geom = _inputs(nside, lmax, 1, 0, cdtype, cuda, 6)[1]
    if pair:
        want = wigner.synthesis_pair_folded_plain(*alms, *geom, lmax, 2)
        got = sht_kernels.synthesis_pair_folded(*alms, *geom, lmax, 2)
    else:
        want = wigner.synthesis_spin0_folded_plain(*alms, *geom, lmax)
        got = sht_kernels.synthesis_spin0_folded(*alms, *geom, lmax)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == (2 * nside, nm)
        _assert_close(g, w, cdtype, tol32=(3e-5, 3e-4) if pair else (2e-5, 2e-4))


@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
def test_synthesis_spin0_kernel_at_lmax_30000(cuda, cdtype):
    """As the spin-0 analysis: the table streams in chunks of 128
    multipoles at any lmax up to the dead path's limit, and a ring's steady
    path lasts for thousands of sub-chunks.  4 orders keep the plain
    version cheap."""
    nside, lmax, nm = 8, 30000, 4
    rng = np.random.default_rng(lmax)
    alm = torch.as_tensor(rng.normal(size=(lmax + 1, nm))
                          + 1j * rng.normal(size=(lmax + 1, nm)),
                          dtype=cdtype, device=cuda)
    geom = _inputs(nside, lmax, 1, 0, cdtype, cuda, 7)[1]
    want = wigner.synthesis_spin0_folded_plain(alm, *geom, lmax)
    got = sht_kernels.synthesis_spin0_folded(alm, *geom, lmax)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == (2 * nside, nm)
        _assert_close(g, w, cdtype)


@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("lmax", [6200, 7400])
def test_pair_kernel_at_high_lmax(cuda, lmax, cdtype):
    """lmax 6200 (HealpixMapper's default at nside 4096 is 6144) and 7400,
    above the ~7200 that the whole-column table of the first pair kernel
    allowed in float64: the block's shared memory no longer grows with
    lmax.  16 orders keep the plain version cheap."""
    nside, nm = 8, 16
    rng = np.random.default_rng(lmax)
    F = [torch.as_tensor(rng.normal(size=(2 * nside, nm))
                         + 1j * rng.normal(size=(2 * nside, nm)),
                         dtype=cdtype, device=cuda) for _ in range(4)]
    geom = _inputs(nside, lmax, 1, 0, cdtype, cuda, 7)[1]
    want = wigner.analysis_pair_folded_plain(*F, *geom, lmax, 2)
    got = sht_kernels.analysis_pair_folded(*F, *geom, lmax, 2)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == (lmax + 1, nm)
        _assert_close(g, w, cdtype)


# (K, L1, L2): K not a multiple of the MMA depth (8) or the stage (16),
# L1 = 1, L not a multiple of the MMA fragments (16 x 8), the warp tile
# (64 x 24) or the block tile (192 x 96), and tiles on both sides of every
# edge
GRAM_CASES = [(37, 1, 70), (4501 // 9, 65, 129), (1000, 130, 3),
              (21, 193, 97), (4501, 3, 1)]


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("K,L1,L2", GRAM_CASES)
def test_gram_kernel_matches_plain(cuda, K, L1, L2, weighted):
    rng = np.random.default_rng(K)
    A = torch.as_tensor(rng.normal(size=(K, L1)), device=cuda)
    B = torch.as_tensor(rng.normal(size=(K, L2)), device=cuda)
    u = torch.as_tensor(rng.normal(size=K), device=cuda) if weighted else None
    want = gram.gram_plain(A, B, u)
    before = gram.LAUNCHES["gram"]
    got = gram.gram(A, B, u)
    torch.cuda.synchronize()
    assert gram.LAUNCHES["gram"] == before + 1
    assert got.shape == (L1, L2) and got.device == A.device
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    # a fixed summation order: the kernel repeats itself bit for bit
    np.testing.assert_array_equal(gram.gram(A, B, u).cpu().numpy(), got)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("K,L", [(37, 1), (603, 200), (4501, 3001)])
def test_gram_kernel_with_a_as_b(cuda, K, L, weighted):
    """The spin-0 case passes one table as A and B; the last shape is a
    production contraction (K 4501, 3001 x 3001)."""
    rng = np.random.default_rng(K + L)
    A = torch.as_tensor(rng.normal(size=(K, L)), device=cuda)
    u = torch.as_tensor(rng.normal(size=K), device=cuda) if weighted else None
    want = gram.gram_plain(A, A, u)
    got = gram.gram(A, A, u)
    torch.cuda.synchronize()
    assert got.shape == (L, L)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-12 * scale
    assert torch.equal(gram.gram(A, A, u), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["fma", "rec3"])
@pytest.mark.parametrize("nchain", [1, 4])
def test_probe_kernel_matches_plain(cuda, kind, dtype, nchain):
    steps = 256
    a, b = fma_peak.inputs(33, dtype, cuda)
    want = fma_peak.chains_plain(a, b, kind, steps, nchain)
    before = fma_peak.LAUNCHES["fma_peak"]
    got = fma_peak.chains(a, b, kind, steps, nchain)
    torch.cuda.synchronize()
    assert fma_peak.LAUNCHES["fma_peak"] == before + 1
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=steps
                               * torch.finfo(dtype).eps * np.abs(want).max())


def test_probe_run_reports_a_rate(cuda):
    seconds, n_ops = fma_peak.run("fma", 64, 256, 2, dtype=torch.float32,
                                  device=cuda)
    assert seconds > 0 and n_ops == 64 * 128 * 256 * 2 * 2


def test_dd_transform_launches_the_float64_kernels(cuda):
    """``dd=True`` on a float32 map: the float64 instantiations run, the
    alms come back complex64 and closer to the float64 transform's."""
    from heracles_tpu_torch.ops import sht

    nside, lmax = 32, 48
    rng = np.random.default_rng(14)
    maps = torch.as_tensor(rng.normal(size=(2, 12 * nside**2)),
                           dtype=torch.float32, device=cuda)
    for spin, name in ((0, "spin0"), (2, "pair")):
        sht_kernels.reset_counts()
        got = sht.map2alm(maps, lmax, spin=spin, iterations=1, dd=True)
        torch.cuda.synchronize()
        assert got.dtype == torch.complex64
        assert dict(sht_kernels.LAUNCHES_BY_PRECISION) == {
            (f"analysis_{name}_folded", "f64"): 2,
            (f"synthesis_{name}_folded", "f64"): 1}
        want = sht.map2alm(maps.double(), lmax, spin=spin, iterations=1)
        plain = sht.map2alm(maps, lmax, spin=spin, iterations=1)
        err = [float((a.to(want.dtype) - want).abs().max()) for a in (got, plain)]
        assert err[0] < err[1]


@pytest.mark.parametrize("spin", [0, 2])
def test_transform_async_matches_transform(cuda, spin):
    """``transform_async``'s host alms equal ``transform``'s bit for bit,
    for a batch whose next batch was dispatched before the handle was
    called (its source tensor dropped meanwhile), with the metadata."""
    import heracles_tpu_torch as th

    nside, lmax = 32, 48
    mapper = th.HealpixMapper(nside, lmax, dtype=torch.float32, device=cuda,
                              deconvolve=False)
    rng = np.random.default_rng(15 + spin)
    shape = (4,) + ((2,) if spin else ()) + (12 * nside**2,)
    batches = [torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                               device=cuda) for _ in range(3)]
    md = {"spin": spin, "fsky": 0.25}
    want = [np.asarray(mapper.transform(b, spin=spin, metadata=md))
            for b in batches]
    sht_kernels.reset_counts()
    handles = [mapper.transform_async(batches[0].clone(), spin=spin,
                                      metadata=md)]
    for b in batches[1:]:
        handles.append(mapper.transform_async(b, spin=spin, metadata=md))
        # work of the next batch on the compute stream, and the caller's
        # reference to the source gone, before the handle is called
        torch.empty(1 << 26, device=cuda).normal_()
    got = [h() for h in handles]
    name = "analysis_pair_folded" if spin else "analysis_spin0_folded"
    assert sht_kernels.LAUNCHES[name] == 3
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.complex64
        np.testing.assert_array_equal(g, w)
        assert dict(g.dtype.metadata) == {**md, "deconv": False}


def test_deletek_on_the_card_matches_the_host(cuda):
    """Device-mode DICES (alms resident on the card, delete-k samples
    assembled there) against memory mode (host numpy alms, samples
    assembled on the host), float64 maps of 3 regions."""
    import heracles_tpu_torch as th
    from heracles_tpu_torch.dices import jackknife as jk_mod

    nside, lmax, njk = 16, 24, 5
    mapper = th.HealpixMapper(nside, lmax, device=cuda, deconvolve=False)
    fields = {"POS": th.Positions(mapper, "RA", "DEC", mask="VIS"),
              "SHE": th.Spin2Field(mapper, "RA", "DEC", "G1", "G2", mask="VIS"),
              "VIS": th.Visibility(mapper)}
    rng = np.random.default_rng(16)
    npix = 12 * nside**2
    pos = mapper.create(spin=0)
    pos[:] = rng.normal(size=npix)
    th.update_metadata(pos, fsky=1.0, musq=1.0, dens=100.0)
    she = mapper.create(2, spin=2)
    she[:] = rng.normal(size=(2, npix))
    th.update_metadata(she, fsky=1.0, musq=1.0, dens=100.0)
    vis = mapper.create(spin=0)
    vis[:] = 1.0
    th.update_metadata(vis, fsky=1.0)
    labels = np.repeat(np.arange(1, njk + 1), -(-npix // njk))[:npix]
    data, vmaps = {("POS", 0): pos, ("SHE", 0): she}, {("VIS", 0): vis}
    out = {}
    for mode, cache_mode in (("device", True), ("memory", False)):
        alms = jk_mod.compute_jk_alms(data, vmaps, labels, fields, dir=None,
                                      region_batch=3, device_cache=cache_mode)
        first = alms["data", 1]["POS", 0]
        assert isinstance(first, th.DeviceMap) == cache_mode
        for nd in (1, 2):
            for mc in ("Fast", "Full"):
                out[mode, nd, mc] = jk_mod.compute_jk_cls_from_alms(
                    labels, fields, mask_correction=mc, nd=nd, dir=None,
                    alms_cache=alms, sample_batch=4)
    for nd in (1, 2):
        for mc in ("Fast", "Full"):
            dev, host = out["device", nd, mc], out["memory", nd, mc]
            assert set(dev) == set(host)
            for regions, cls in host.items():
                for key, want in cls.items():
                    got = dev[regions][key]
                    w = np.asarray(want)
                    np.testing.assert_allclose(np.asarray(got), w, rtol=1e-12,
                                               atol=1e-12 * np.abs(w).max())
                    assert got.dtype.metadata == want.dtype.metadata
