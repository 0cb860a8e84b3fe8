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


def _points(npts, seed, device):
    """Point geometry (random colatitudes, two at the poles, unsorted)."""
    from heracles_tpu_torch.ops.sht import _point_geometry

    rng = np.random.default_rng(seed)
    theta = np.arccos(rng.uniform(-1, 1, npts))
    theta[:2] = 0.0, np.pi
    phi = rng.uniform(0, 2 * np.pi, npts)
    geom = [torch.as_tensor(a, device=device) for a in _point_geometry(theta)]
    return theta, phi, geom


@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("npts,lmax", [(1001, 40), (4097, 200)])
def test_analysis_kernels_on_points(cuda, npts, lmax, cdtype):
    """B1 with Fe = Fo and B2 with zero southern rows over unsorted points
    (a count that is no multiple of 4, pole-clamped logs) against their
    plain versions."""
    from heracles_tpu_torch.ops import sht

    _, _, geom = _points(npts, 5, cuda)
    rng = np.random.default_rng(6)
    shape = (1, npts, lmax + 1)
    F = [torch.as_tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape),
                         dtype=cdtype, device=cuda) for _ in range(2)]
    before = dict(sht_kernels.LAUNCHES)
    got = sht._analysis_points(F[:1], *geom, lmax, (0,))
    want = wigner.analysis_spin0_folded_plain(F[0], F[0], *geom, lmax)
    _assert_close(got, sht.pack_alm(want, lmax, lmax), cdtype)
    got = sht._analysis_points(F, *geom, lmax, (2, -2))
    zero = torch.zeros_like(F[0])
    want = wigner.analysis_pair_folded_plain(F[0], zero, F[1], zero, *geom,
                                             lmax, 2)
    torch.cuda.synchronize()
    _assert_close(got, sht.pack_alm(sht._eb(*want), lmax, lmax), cdtype)
    for name in ("analysis_spin0_folded", "analysis_pair_folded"):
        assert sht_kernels.LAUNCHES[name] == before.get(name, 0) + 1


@pytest.mark.parametrize("complex_vals", [False, True])
@pytest.mark.parametrize("w", [4, 6, 13, 16])
def test_spread_kernel_matches_plain(cuda, w, complex_vals):
    """The spreader against its plain version at 1e-12 of the grid's max
    (float64 atomics add in an order that varies from run to run)."""
    from heracles_tpu_torch.ops import nufft

    theta, phi, _ = _points(20001, 7, cuda)
    rng = np.random.default_rng(8)
    lmax = 100
    vals = rng.normal(size=(2, theta.size))
    vals = (vals[0] + 1j * vals[1])[None] if complex_vals else vals
    pads = [nufft.alloc_padded(vals.shape[0], lmax, w, complex_vals, cuda)
            for _ in range(2)]
    theta_t, phi_t = (torch.as_tensor(a, device=cuda) for a in (theta, phi))
    vals_t = torch.as_tensor(vals, device=cuda)
    before = nufft.LAUNCHES["spread"]
    nufft.spread_padded(theta_t, phi_t, vals_t, lmax, w, pads[0])
    torch.cuda.synchronize()
    assert nufft.LAUNCHES["spread"] == before + 1
    nufft.spread_padded_plain(theta_t, phi_t, vals_t, pads[1], w)
    got, want = (nufft.fold_padded(p, lmax, w).cpu().numpy() for p in pads)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def _spread_cases(case, w):
    """(theta, phi, values, lmax) of one edge case of the spreader at
    width ``w``."""
    rng = np.random.default_rng(12)
    lmax, nrows, npts = 100, 1, 20001
    if case == "empty":
        npts = 0
    theta = np.arccos(rng.uniform(-1, 1, npts))
    phi = rng.uniform(0, 2 * np.pi, npts)
    if case == "one_tile":
        # every stencil corner in rows 97..126 and columns 65..94, inside
        # the tile (3, 2): 20 subproblems
        from heracles_tpu_torch.ops import nufft

        ntheta, nphi = nufft.grid_shape(lmax)
        theta = (97.5 + w / 2 + rng.uniform(0, 29, npts)) * 2 * np.pi / ntheta
        phi = (65 + w / 2 + rng.uniform(0, 29, npts)) * 2 * np.pi / nphi
    elif case == "poles_wrap":
        theta = rng.choice([0.0, np.pi, 1e-9, np.pi - 1e-9], npts)
        phi = rng.choice([0.0, 2 * np.pi - 1e-15, 1e-3, 2 * np.pi - 1e-3], npts)
    elif case == "rows3":
        nrows = 3
    elif case == "nonfinite":
        vals = rng.normal(size=(nrows, npts))
        vals[0, :3] = np.nan, np.inf, -np.inf
        return theta, phi, vals, lmax
    elif case == "scales":
        # a bin's largest |v| sets its fixed-point scale: tiny, unit and
        # huge values by bin, and subnormals and zeros in tiny bins
        from heracles_tpu_torch.ops import nufft

        vals = rng.normal(size=(nrows, npts))
        bins = nufft.bin_points_plain(torch.as_tensor(theta),
                                      torch.as_tensor(phi), lmax, w)[0]
        kind = bins.numpy() % 3
        vals[0] *= np.where(kind == 0, 1e-300, np.where(kind == 1, 1e300, 1.0))
        vals[0, np.flatnonzero(kind == 0)[:5]] = 5e-324, -1e-310, 0, 0, 1e-320
        return theta, phi, vals, lmax
    elif case.startswith("lmax"):
        lmax = int(case[4:])
    return theta, phi, rng.normal(size=(nrows, npts)), lmax


@pytest.mark.parametrize("case", ["one_tile", "poles_wrap", "empty", "rows3",
                                  "lmax8", "lmax20", "nonfinite", "scales"])
def test_spread_kernel_edge_cases(cuda, case):
    """The spreader against its plain version at 1e-12 of the grid's max:
    a heavy bin of many subproblems, points at the poles and across the
    phi wrap, no point, three rows, grids whose last tiles are clipped
    (ntheta 40 at lmax 8), NaN and inf values (the same cells not finite,
    the rest within tolerance) and values from 5e-324 to 1e300 (the
    fixed-point scale of each bin)."""
    from heracles_tpu_torch.ops import nufft

    for w, complex_vals in ((6, False), (13, True)):
        theta, phi, vals, lmax = _spread_cases(case, w)
        v = vals[:1] + 1j * vals[-1:] if complex_vals else vals
        pads = [nufft.alloc_padded(v.shape[0], lmax, w, complex_vals, cuda)
                for _ in range(2)]
        th_t, ph_t, v_t = nufft._spread_inputs(theta, phi, v, pads[0])
        nufft.spread_padded(th_t, ph_t, v_t, lmax, w, pads[0])
        torch.cuda.synchronize()
        nufft.spread_padded_plain(th_t, ph_t, v_t, pads[1], w)
        got, want = (nufft.fold_padded(p, lmax, w).cpu().numpy() for p in pads)
        # an infinite value: inf * 0 in the plain version's complex
        # product is NaN, the kernel's (and the host spreader's) inf
        ok = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), ok)
        # the huge values' bins set the scale of the comparison, as in the
        # plain version's own float64 sums
        scale = np.abs(want[ok]).max() if ok.any() else 0.0
        assert np.abs(got[ok] - want[ok]).max(initial=0.0) <= 1e-12 * scale
        if case == "scales":  # the tiny bins keep their own precision
            tiny = ok & (np.abs(want) < 1e-200) & (want != 0)
            assert tiny.any()
            assert np.all(np.abs(got[tiny] - want[tiny])
                          <= 1e-12 * np.abs(want[tiny]).max())


@pytest.mark.parametrize("lmax", [20, 100])
def test_bin_kernel_matches_plain(cuda, lmax):
    """The kernel's bin counts, offsets, subproblem prefix and subproblem
    -> bin map equal the plain versions' exactly, and each bin holds the
    same original points (their order inside a bin follows the atomics)."""
    from heracles_tpu_torch.ops import nufft

    rng = np.random.default_rng(13)
    theta = np.concatenate([[0.0, np.pi, np.pi / 2],
                            np.arccos(rng.uniform(-1, 1, 30000))])
    phi = np.concatenate([[0.0, 2 * np.pi - 1e-15, np.pi],
                          rng.uniform(0, 2 * np.pi, 30000)])
    # a heavy bin: 3000 points in one tile
    theta[3:3003] = np.pi / 2 + rng.uniform(0, 0.01, 3000)
    th_t, ph_t = (torch.as_tensor(a, device=cuda) for a in (theta, phi))
    for w in (4, 6, 16):
        counts, offsets, subs, sub_bin, order = nufft.bin_points(
            th_t, ph_t, lmax, w)
        bins, want_counts, want_offsets = nufft.bin_points_plain(th_t, ph_t,
                                                                 lmax, w)
        assert torch.equal(counts.long(), want_counts)
        assert torch.equal(offsets[:-1].long(), want_offsets)
        assert int(offsets[-1]) == theta.size
        want_subs, want_bin, _ = nufft.subproblems_plain(want_counts)
        assert torch.equal(subs.long(), want_subs)
        assert torch.equal(sub_bin.long(), want_bin)
        order = order.long()
        assert torch.equal(torch.sort(order).values,
                           torch.arange(theta.size, device=cuda))
        nbins = want_counts.shape[0]
        assert torch.equal(bins[order], torch.repeat_interleave(
            torch.arange(nbins, device=cuda), want_counts))


def test_discrete_mapper_on_the_card(cuda):
    """The exact and gridded paths launch B1, B2 and the spreader (exact:
    one launch per block of points; gridded: one spread per call and one
    analysis of the coarse grid), run no plain version, and agree with the
    CPU mapper."""
    import heracles_tpu_torch as th
    from heracles_tpu_torch.ops import nufft

    theta, phi, _ = _points(3001, 9, "cpu")
    lon, lat = np.degrees(phi), 90.0 - np.degrees(theta)
    rng = np.random.default_rng(10)
    v = rng.normal(size=(2, theta.size))
    lmax = 64
    expect = {"exact": ({"analysis_spin0_folded": 3,
                         "analysis_pair_folded": 3}, 0),
              "gridded": ({"analysis_spin0_folded": 1,
                           "analysis_pair_folded": 1}, 2)}
    out = {}
    for dev in (cuda, "cpu"):
        for method in ("exact", "gridded"):
            sht_kernels.reset_counts()
            nufft.reset_counts()
            mapper = th.DiscreteMapper(lmax, method=method, point_block=1024,
                                       device=dev)
            for spin in (0, 2):
                data = mapper.create(*((2,) if spin else ()), spin=spin)
                mapper.map_values(lon, lat, data, v if spin else v[0], spin=spin)
                out[method, str(dev), spin] = np.asarray(data)
            if dev == cuda:
                launches, spreads = expect[method]
                assert dict(sht_kernels.LAUNCHES) == launches
                assert nufft.LAUNCHES["spread"] == spreads
                assert not wigner.PLAIN_RUNS and not nufft.PLAIN_RUNS
    for (method, dev, spin), got in out.items():
        if dev == "cpu":
            continue
        want = out[method, "cpu", spin]
        assert np.abs(got - want).max() <= 1e-11 * np.abs(want).max()


def test_spectra_of_host_alms_run_on_the_card(cuda, monkeypatch):
    """``angular_power_spectra(device=)`` moves host alms (as read from a
    file) to the card and runs the pair grid there, with the host's result."""
    from heracles_tpu_torch import twopoint

    rng = np.random.default_rng(11)
    lmax = 24
    nlm = (lmax + 1) * (lmax + 2) // 2
    alms = {}
    for i in range(3):
        a = rng.normal(size=nlm) + 1j * rng.normal(size=nlm)
        alms["P", i] = np.asarray(a, dtype=np.dtype(complex, metadata={"spin": 0}))
    grids = []
    real = twopoint.rect_pair_grid

    def spy(a1, a2, ms):
        grids.append((a1.device.type, a2.device.type))
        return real(a1, a2, ms)

    monkeypatch.setattr(twopoint, "rect_pair_grid", spy)
    got = twopoint.angular_power_spectra(alms, device=cuda)
    assert grids and set(grids) == {("cuda", "cuda")}
    grids.clear()
    want = twopoint.angular_power_spectra(alms)
    assert set(grids) == {("cpu", "cpu")} and set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12, atol=0)


# -- a block of orders (the device mesh's "m" shards) ---------------------

_NAMES = ("analysis_spin0_folded", "analysis_pair_folded",
          "synthesis_spin0_folded", "synthesis_pair_folded")


def _kernel_operands(name, nside, lmax, cdtype, device, seed):
    """Full-width operands (nm = lmax + 1) of one kernel, its geometry and
    its extra arguments."""
    pair = name.endswith("pair_folded")
    if name.startswith("analysis"):
        ins, geom = _inputs(nside, lmax, 2, 4 if pair else 2, cdtype, device,
                            seed)
    else:
        ins, geom = _alms(nside, lmax, 2, 2 if pair else 1, cdtype, device,
                          seed)
    return ins, geom, (2,) if pair else ()


def _as_tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


@pytest.mark.parametrize("m0", [0, 64, 160, 192])
@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("name", _NAMES)
def test_kernels_on_a_block_of_orders(cuda, name, cdtype, m0):
    """A launch of the orders m0..m0+63 (at lmax 191: the first block, an
    inner one, one that straddles lmax, one wholly above it) gives the full
    launch's columns bit for bit, zeros for the orders above lmax, and
    agrees with the plain version on the same block."""
    nside, lmax, width = 64, 191, 64
    ins, geom, extra = _kernel_operands(name, nside, lmax, cdtype, cuda, 21)
    kernel = getattr(sht_kernels, name)
    plain = getattr(wigner, name + "_plain")
    full = _as_tuple(kernel(*ins, *geom, lmax, *extra))
    block = [torch.nn.functional.pad(t[..., m0:m0 + width],
                                     (0, max(0, m0 + width - lmax - 1)))
             for t in ins]
    before = sht_kernels.LAUNCHES[name]
    got = _as_tuple(kernel(*block, *geom, lmax, *extra, m0))
    torch.cuda.synchronize()
    assert sht_kernels.LAUNCHES[name] == before + 1
    want = _as_tuple(plain(*block, *geom, lmax, *extra, m0))
    real = max(0, min(width, lmax + 1 - m0))
    tol32 = (3e-5, 3e-4) if name == "synthesis_pair_folded" else (2e-5, 2e-4)
    for g, f, w in zip(got, full, want):
        assert g.shape == w.shape
        assert torch.equal(g[..., :real], f[..., m0:m0 + real])
        assert not g[..., real:].any()
        if real:
            _assert_close(g[..., :real], w[..., :real], cdtype, tol32)


@pytest.mark.parametrize("m0", [0, 64, 160])
@pytest.mark.parametrize("name", ["analysis_spin0_folded",
                                  "synthesis_spin0_folded",
                                  "synthesis_pair_folded"])
def test_path_counts_on_a_block_of_orders(cuda, name, m0):
    """The diagnostic launch on a block of orders counts the sub-chunks of
    the block's own columns (none for the orders above lmax)."""
    nside, lmax, width, batch = 256, 191, 64, 2
    ins, geom, extra = _kernel_operands(name, nside, lmax, torch.complex64,
                                        cuda, 22)
    block = [torch.nn.functional.pad(t[..., m0:m0 + width],
                                     (0, max(0, m0 + width - lmax - 1)))
             for t in ins]
    counts = sht_kernels.path_counts(name, *block, *geom, lmax, *extra, m0=m0)
    spin = 2 if extra else 0
    j0 = np.maximum(m0 + np.arange(width), spin)
    per = 16 if name == "analysis_spin0_folded" else 8
    subs = int((np.ceil(np.clip(lmax + 1 - j0, 0, None) / per)
                * (per // 8)).sum())
    assert sum(counts.values()) == batch * 4 * -(-2 * nside // 512) * subs


@pytest.mark.parametrize("cdtype", [torch.float32, torch.float64])
def test_mesh_of_one_card_matches_unsharded(cuda, cdtype):
    """A (2, 2) mesh of four shards on one card: the sharded analysis,
    synthesis and pipeline step against the unsharded transforms, with
    real orders in the second "m" block (lmax 160 > 128), and one launch
    of each kernel per shard."""
    from heracles_tpu_torch import parallel, twopoint
    from heracles_tpu_torch.ops import sht

    nside, lmax = 64, 160
    mesh = parallel.make_mesh(4, m_axis=2, devices=[cuda] * 4)
    rng = np.random.default_rng(23)
    maps = torch.as_tensor(rng.normal(size=(2, 12 * nside**2)), dtype=cdtype,
                           device=cuda)
    qu = torch.as_tensor(rng.normal(size=(2, 2, 12 * nside**2)), dtype=cdtype,
                         device=cuda)
    ctype = torch.complex64 if cdtype == torch.float32 else torch.complex128
    for spin, m in ((0, maps), (2, qu)):
        sht_kernels.reset_counts()
        alm = parallel.map2alm_sharded(mesh, m, lmax, spin=spin)
        name = "analysis_spin0_folded" if spin == 0 else "analysis_pair_folded"
        assert dict(sht_kernels.LAUNCHES) == {name: 4}
        assert not wigner.PLAIN_RUNS
        want = sht.map2alm(m, lmax, spin=spin, packed=False)
        _assert_close(alm[..., : lmax + 1], want, ctype)
        assert not alm[..., lmax + 1:].any()
        sht_kernels.reset_counts()
        back = parallel.alm2map_sharded(mesh, alm, nside, lmax=lmax, spin=spin)
        name = ("synthesis_spin0_folded" if spin == 0
                else "synthesis_pair_folded")
        assert dict(sht_kernels.LAUNCHES) == {name: 4}
        _assert_close(back, sht.alm2map(want, nside, lmax, spin=spin,
                                        packed=False), ctype)
    grid = parallel.pipeline_step(mesh, maps, lmax, qu)
    planes = torch.cat([sht.map2alm(maps, lmax, packed=False),
                        sht.map2alm(qu, lmax, spin=2, packed=False)
                        .reshape(-1, lmax + 1, lmax + 1)])
    want = twopoint.rect_pair_grid(planes, planes, torch.arange(lmax + 1))
    scale = want.abs().max().item()
    tol = 1e-6 if cdtype == torch.float32 else 1e-12
    assert (grid - want).abs().max().item() <= tol * scale


def test_mesh_of_distinct_cards(cuda):
    """``make_mesh()`` over every visible card (``torch.cuda.comm``
    between them) against the unsharded transforms on the first card:
    spin 0 and spin 2 alms and maps, the mixed pipeline grid, a mixing
    matrix and the point adjoint.  Needs two cards or more."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more")
    from heracles_tpu_torch import parallel, twopoint
    from heracles_tpu_torch.mappers import DiscreteMapper
    from heracles_tpu_torch.ops import sht

    nside, lmax = 64, 160
    mesh = parallel.make_mesh()
    assert len({str(d) for d in mesh.devices.flat}) == mesh.size
    rng = np.random.default_rng(31)
    maps = torch.as_tensor(rng.normal(size=(mesh.shape["batch"],
                                            12 * nside**2)), device=cuda)
    qu = torch.as_tensor(rng.normal(size=(mesh.shape["batch"], 2,
                                          12 * nside**2)), device=cuda)
    for spin, m in ((0, maps), (2, qu)):
        alm = parallel.map2alm_sharded(mesh, m, lmax, spin=spin)
        assert alm.device == mesh.devices.flat[0]
        want = sht.map2alm(m, lmax, spin=spin, packed=False)
        _assert_close(alm[..., : lmax + 1], want, torch.complex128)
        back = parallel.alm2map_sharded(mesh, alm, nside, lmax=lmax, spin=spin)
        _assert_close(back, sht.alm2map(want, nside, lmax, spin=spin,
                                        packed=False), torch.complex128)
    grid = parallel.pipeline_step(mesh, maps, lmax, qu)
    planes = torch.cat([sht.map2alm(maps, lmax, packed=False),
                        sht.map2alm(qu, lmax, spin=2, packed=False)
                        .reshape(-1, lmax + 1, lmax + 1)])
    want = twopoint.rect_pair_grid(planes, planes, torch.arange(lmax + 1))
    assert (grid - want).abs().max().item() <= 1e-12 * want.abs().max().item()
    cl = rng.uniform(size=lmax + 1) / (1.0 + np.arange(lmax + 1))
    mm = twopoint.mixmat(cl, mesh=mesh)
    ref = twopoint.mixmat(cl, device=cuda)
    np.testing.assert_allclose(mm, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    theta = np.arccos(rng.uniform(-1, 1, 1001))
    phi = rng.uniform(0, 2 * np.pi, 1001)
    v = rng.normal(size=(2, 1001))
    mapper = DiscreteMapper(40, device=cuda)
    got = mapper.adjoint_synthesis_sharded(mesh, theta, phi, v, spin=2)
    _assert_close(got, mapper._adjoint_synthesis(theta, phi, v, 2),
                  torch.complex128)


# -- the compensated (comp) float32 instantiations ------------------------------


def _x_lo(geom):
    """The float32 residual of the rings' float64 cos(theta)."""
    x = geom[0].double()
    return (x - x.float().double()).float()


@pytest.mark.parametrize("nside,lmax,batch", CASES)
@pytest.mark.parametrize("name", _NAMES)
def test_comp_kernels_match_plain(cuda, name, nside, lmax, batch):
    """Each comp kernel against its plain version (the comp recurrence of
    ``ops/wigner.py``) at the float32 bar, launched under "f32c", and
    repeated bit for bit."""
    ins, geom, extra = _kernel_operands(name, nside, lmax, torch.complex64,
                                        cuda, 31)
    ins = [t[:batch] for t in ins]
    x_lo = _x_lo(geom)
    kernel = getattr(sht_kernels, name)
    plain = getattr(wigner, name + "_plain")
    want = _as_tuple(plain(*ins, *geom, lmax, *extra, x_lo=x_lo))
    sht_kernels.reset_counts()
    got = _as_tuple(kernel(*ins, *geom, lmax, *extra, dd="comp", x_lo=x_lo))
    torch.cuda.synchronize()
    assert dict(sht_kernels.LAUNCHES_BY_PRECISION) == {(name, "f32c"): 1}
    tol32 = (3e-5, 3e-4) if name == "synthesis_pair_folded" else (2e-5, 2e-4)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.complex64
        _assert_close(g, w, torch.complex64, tol32)
    again = _as_tuple(kernel(*ins, *geom, lmax, *extra, dd="comp", x_lo=x_lo))
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.parametrize("name", _NAMES)
def test_comp_zero_stream_is_the_plain_kernel(cuda, name):
    """``dd="comp"`` without ``x_lo`` (a zero stream) launches the comp
    kernel and gives the plain float32 kernel's outputs bit for bit."""
    nside, lmax = 64, 191
    ins, geom, extra = _kernel_operands(name, nside, lmax, torch.complex64,
                                        cuda, 32)
    kernel = getattr(sht_kernels, name)
    plain = _as_tuple(kernel(*ins, *geom, lmax, *extra))
    sht_kernels.reset_counts()
    comp = _as_tuple(kernel(*ins, *geom, lmax, *extra, dd="comp"))
    torch.cuda.synchronize()
    assert dict(sht_kernels.LAUNCHES_BY_PRECISION) == {(name, "f32c"): 1}
    for c, p in zip(comp, plain, strict=True):
        assert torch.equal(c, p)


@pytest.mark.parametrize("m0", [0, 64, 160, 192])
@pytest.mark.parametrize("name", _NAMES)
def test_comp_kernels_on_a_block_of_orders(cuda, name, m0):
    """A comp launch of the orders m0..m0+63 gives the full comp launch's
    columns bit for bit and zeros above lmax."""
    nside, lmax, width = 64, 191, 64
    ins, geom, extra = _kernel_operands(name, nside, lmax, torch.complex64,
                                        cuda, 33)
    kernel = getattr(sht_kernels, name)
    kw = dict(dd="comp", x_lo=_x_lo(geom))
    full = _as_tuple(kernel(*ins, *geom, lmax, *extra, **kw))
    block = [torch.nn.functional.pad(t[..., m0:m0 + width],
                                     (0, max(0, m0 + width - lmax - 1)))
             for t in ins]
    got = _as_tuple(kernel(*block, *geom, lmax, *extra, m0, **kw))
    torch.cuda.synchronize()
    real = max(0, min(width, lmax + 1 - m0))
    for g, f in zip(got, full, strict=True):
        assert torch.equal(g[..., :real], f[..., m0:m0 + real])
        assert not g[..., real:].any()


@pytest.mark.parametrize("name", ["analysis_spin0_folded",
                                  "synthesis_spin0_folded",
                                  "synthesis_pair_folded"])
def test_comp_path_counts(cuda, name):
    """The comp kernels choose their paths by d alone, as the plain ones
    do: the same counts on the same inputs."""
    nside, lmax = 256, 191
    ins, geom, extra = _kernel_operands(name, nside, lmax, torch.complex64,
                                        cuda, 34)
    plain = sht_kernels.path_counts(name, *ins, *geom, lmax, *extra)
    comp = sht_kernels.path_counts(name, *ins, *geom, lmax, *extra,
                                   dd="comp", x_lo=_x_lo(geom))
    assert comp == plain and comp["steady"] > 0


def test_comp_transform_launches_the_comp_kernels(cuda):
    """``dd="comp"`` on float32 maps: the comp instantiations run (none of
    float64), complex64 comes back, and the result is the CPU's comp
    transform at the float32 bar."""
    from heracles_tpu_torch.ops import sht

    nside, lmax = 32, 48
    rng = np.random.default_rng(35)
    host = torch.as_tensor(rng.normal(size=(2, 12 * nside**2)),
                           dtype=torch.float32)
    maps = host.to(cuda)
    for spin, name in ((0, "spin0"), (2, "pair")):
        sht_kernels.reset_counts()
        got = sht.map2alm(maps, lmax, spin=spin, iterations=1, dd="comp")
        torch.cuda.synchronize()
        assert got.dtype == torch.complex64
        assert dict(sht_kernels.LAUNCHES_BY_PRECISION) == {
            (f"analysis_{name}_folded", "f32c"): 2,
            (f"synthesis_{name}_folded", "f32c"): 1}
        assert not wigner.PLAIN_RUNS
        want = sht.map2alm(host, lmax, spin=spin, iterations=1, dd="comp")
        _assert_close(got, want, torch.complex64)


def test_comp_blocks_per_sm(cuda):
    from heracles_tpu_torch.ops import _build

    kl = _build.load_library()
    for kernel in ("analysis_spin0", "analysis_pair", "synthesis_spin0",
                   "synthesis_pair"):
        assert kl.blocks_per_sm(kernel, False, comp=True) >= 1
