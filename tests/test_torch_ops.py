"""The port's SHT operations against heracles_tpu, on the CPU.

Same numpy-made inputs through each heracles_tpu function and its
heracles_tpu_torch counterpart.  The JAX side runs as its own CPU tests
run it: float64 through the jnp scans (tests/conftest.py enables x64),
which tests/test_pallas.py already holds the Pallas kernels against.  On
the CPU the port's kernel wrappers take their plain versions, so these
tests hold the plain versions to the JAX package.

Tolerances: float64 ``atol = 1e-10 * scale`` (the same algorithm with
another summation order; the measured gap is ~1e-14); float32
``atol = 2e-5 * scale, rtol = 2e-4``, the bar tests/test_pallas.py held
the float32 Pallas kernels to.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from heracles_tpu import healpix as jhp
from heracles_tpu.ops import ringfft as jrf
from heracles_tpu.ops import sht as jsht
from heracles_tpu.ops import wigner as jw
from heracles_tpu_torch import healpix as thp
from heracles_tpu_torch.ops import _build, ringfft, sht, sht_kernels, wigner

NSIDES = [8, 16, 32]


def _close64(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-10 * np.abs(want).max())


def _close32(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-5 * np.abs(want).max())


def _geometry(nside):
    nhalf = 2 * nside
    return [a[:nhalf] for a in jsht._geom_arrays(nside, "float64")]


def _cplx(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


@pytest.mark.parametrize("nside", NSIDES)
def test_ang2pix_ring(nside):
    rng = np.random.default_rng(nside)
    lon = rng.uniform(-360, 720, 5000)
    lat = np.degrees(np.arcsin(rng.uniform(-1, 1, 5000)))
    # poles, the equator and the cap/belt boundaries
    lat[:6] = [90.0, -90.0, 0.0, np.degrees(np.arcsin(2 / 3)),
               -np.degrees(np.arcsin(2 / 3)), 89.999]
    want = jhp.ang2pix_ring(nside, lon, lat, lonlat=True)
    got = thp.ang2pix_ring(nside, torch.as_tensor(lon), torch.as_tensor(lat),
                           lonlat=True)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("complex_in", [False, True])
@pytest.mark.parametrize("nside", NSIDES)
def test_ring_analysis(nside, complex_in):
    rng = np.random.default_rng(2 * nside + complex_in)
    npix = 12 * nside * nside
    maps = _cplx(rng, (2, npix)) if complex_in else rng.normal(size=(2, npix))
    nm = 2 * nside + 5  # past the belt ring length/2: aliased orders too
    w = jsht.ring_weights(nside)
    F, Fneg = jrf.ring_analysis(jnp.asarray(maps), nside, nm, weight=w)
    G, Gneg = ringfft.ring_analysis(torch.as_tensor(maps), nside, nm, weight=w)
    _close64(G, F)
    if complex_in:
        _close64(Gneg, Fneg)
    else:
        assert Gneg is None


@pytest.mark.parametrize("nside,lmax,batch", [(8, 16, 1), (16, 24, 2),
                                              (32, 48, 1)])
def test_analysis_spin0_plain(nside, lmax, batch):
    rng = np.random.default_rng(nside)
    shape = (batch, 2 * nside, lmax + 1)
    FN, FS = _cplx(rng, shape), _cplx(rng, shape)
    x, lch, lsh = _geometry(nside)
    ms = np.arange(lmax + 1)
    want = jw.lambda_analysis_scan_folded(
        jnp.asarray(ms), jnp.zeros_like(jnp.asarray(ms)), jnp.asarray(x),
        jnp.asarray(lch), jnp.asarray(lsh), lmax, jnp.asarray(FN),
        jnp.asarray(FS),
    )
    T = torch.as_tensor
    got = sht_kernels.analysis_spin0_folded(
        T(FN + FS), T(FN - FS), T(x), T(lch), T(lsh), lmax)
    _close64(got, want)


def test_analysis_spin0_plain_high_m():
    """High orders at small theta: the scaled seeds must not underflow."""
    nside, lmax, nm = 32, 48, 128
    rng = np.random.default_rng(1)
    Fe = rng.normal(size=(2 * nside, nm)).astype(np.complex128)
    x, lch, lsh = _geometry(nside)
    ms = np.arange(nm)
    want = jw.lambda_analysis_scan_folded(
        jnp.asarray(ms), jnp.zeros_like(jnp.asarray(ms)), jnp.asarray(x),
        jnp.asarray(lch), jnp.asarray(lsh), lmax, jnp.asarray(Fe / 2),
        jnp.asarray(Fe / 2),
    )
    T = torch.as_tensor
    got = sht_kernels.analysis_spin0_folded(T(Fe), T(np.zeros_like(Fe)), T(x),
                                            T(lch), T(lsh), lmax)
    _close64(got, want)
    assert np.all(got[:, lmax + 1:].numpy() == 0)


@pytest.mark.parametrize("nside,lmax,batch", [(8, 16, 1), (16, 24, 2),
                                              (32, 70, 1)])
def test_analysis_pair_plain(nside, lmax, batch):
    spin = 2
    rng = np.random.default_rng(nside + 1)
    shape = (batch, 2 * nside, lmax + 1)
    FNp, Sp, FNm, Sm = (_cplx(rng, shape) for _ in range(4))
    x, lch, lsh = _geometry(nside)
    nm = lmax + 1
    ms = np.tile(np.arange(nm), 2)
    ns = np.repeat([spin, -spin], nm)
    # the jnp cross scan's lanes: [+s block | -s block], southern rows of
    # each block contract into the partner block
    want = np.asarray(jw.lambda_analysis_scan_folded(
        jnp.asarray(ms), jnp.asarray(ns), jnp.asarray(x), jnp.asarray(lch),
        jnp.asarray(lsh), lmax, jnp.asarray(np.concatenate([FNp, FNm], -1)),
        jnp.asarray(np.concatenate([Sm, Sp], -1)), cross=True,
    ))
    T = torch.as_tensor
    got_p, got_m = sht_kernels.analysis_pair_folded(
        T(FNp), T(Sp), T(FNm), T(Sm), T(x), T(lch), T(lsh), lmax, spin)
    _close64(got_p, want[..., :nm])
    _close64(got_m, want[..., nm:])


@pytest.mark.parametrize("spin", [0, 2])
@pytest.mark.parametrize("nside", NSIDES)
def test_map2alm(nside, spin):
    lmax = 2 * nside
    rng = np.random.default_rng(3 * nside + spin)
    npix = 12 * nside * nside
    maps = rng.normal(size=(2, npix) if spin else (npix,))
    want = np.asarray(jsht.map2alm(jnp.asarray(maps), lmax, spin=spin,
                                   packed=False))
    rect = sht.map2alm(torch.as_tensor(maps), lmax, spin=spin, packed=False)
    _close64(rect, want)
    packed = sht.map2alm(torch.as_tensor(maps), lmax, spin=spin)
    _close64(packed, jsht.pack_alm(want, lmax, lmax))


@pytest.mark.parametrize("spin", [0, 2])
def test_map2alm_float32(spin):
    """One float32 case per kernel.

    On the CPU, heracles_tpu runs its own float32 path here: the jnp scan
    with host-f64 seeds.
    """
    nside, lmax = 16, 32
    rng = np.random.default_rng(7 + spin)
    npix = 12 * nside * nside
    maps = rng.normal(size=(2, npix) if spin else (npix,)).astype(np.float32)
    want = np.asarray(jsht.map2alm(jnp.asarray(maps), lmax, spin=spin))
    got = sht.map2alm(torch.as_tensor(maps), lmax, spin=spin)
    assert got.dtype == torch.complex64
    _close32(got, want)


@pytest.mark.parametrize("lmax,mmax", [(12, None), (12, 5)])
def test_pack_unpack(lmax, mmax):
    rng = np.random.default_rng(lmax)
    mm = lmax if mmax is None else mmax
    rect = _cplx(rng, (3, lmax + 1, mm + 1))
    rect[..., np.arange(lmax + 1)[:, None] < np.arange(mm + 1)[None, :]] = 0
    packed = sht.pack_alm(torch.as_tensor(rect), lmax, mmax)
    np.testing.assert_array_equal(packed.numpy(),
                                  jsht.pack_alm(rect, lmax, mmax))
    assert packed.shape[-1] == sht.alm_size(lmax, mmax)
    back = sht.unpack_alm(packed, lmax, mmax)
    np.testing.assert_array_equal(back.numpy(),
                                  jsht.unpack_alm(packed.numpy(), lmax, mmax))
    np.testing.assert_array_equal(back.numpy(), rect)


def test_ring_weights_shipped_table():
    np.testing.assert_array_equal(sht.ring_weights(512), jsht.ring_weights(512))


def test_ring_weights_solved():
    """No table at nside 16: the same host least-squares solve."""
    np.testing.assert_allclose(sht.ring_weights(16), jsht.ring_weights(16),
                               rtol=1e-12)


def test_pixel_window_shipped_table():
    np.testing.assert_array_equal(
        sht.pixel_window(512, 768, pol=True),
        jsht.pixel_window(512, 768, pol=True),
    )
    np.testing.assert_array_equal(sht.pixel_window(4096, 3000),
                                  jsht.pixel_window(4096, 3000))


def test_pixel_window_cap_and_unported():
    np.testing.assert_allclose(sht.pixel_window(64, 96, method="cap"),
                               jsht.pixel_window(64, 96, method="cap"),
                               rtol=1e-14)
    # heracles_tpu computes exact windows for small nside on the fly
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        sht.pixel_window(16, 24)


def test_wigner_seed_host():
    ms = np.arange(0, 40)
    ns = np.where(ms % 2 == 0, 2, -2)
    theta = np.linspace(0.05, 3.0, 17)
    mant, k = wigner.wigner_seed_host(ms, ns, theta)
    jmant, jk = jw.wigner_seed_host(ms, ns, theta)
    np.testing.assert_array_equal(k, jk)
    # heracles_tpu rounds the mantissa to float32
    np.testing.assert_allclose(mant, jmant, rtol=1e-7)


def test_kernel_module_on_cpu_uses_plain(monkeypatch):
    """CPU tensors take the plain version, launch nothing, build nothing."""
    sht_kernels.reset_counts()

    def no_build():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(_build, "load_library", no_build)
    nside, lmax = 8, 10
    x, lch, lsh = (torch.as_tensor(a) for a in _geometry(nside))
    F = torch.ones((2 * nside, lmax + 1), dtype=torch.complex128)
    sht_kernels.analysis_spin0_folded(F, F, x, lch, lsh, lmax)
    sht_kernels.analysis_pair_folded(F, F, F, F, x, lch, lsh, lmax, 2)
    assert sum(sht_kernels.LAUNCHES.values()) == 0
    assert wigner.PLAIN_RUNS == {"analysis_spin0_folded": 1,
                                 "analysis_pair_folded": 1}
    with pytest.raises(TypeError, match="complex64 or complex128"):
        sht_kernels.analysis_spin0_folded(F.real, F.real, x, lch, lsh, lmax)


def test_gram_and_probe_on_cpu_use_plain(monkeypatch):
    """CPU tensors take the plain Gram and probe, launch nothing, build nothing."""
    from heracles_tpu_torch.ops import fma_peak, gram

    def no_build():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(_build, "load_library", no_build)
    gram.reset_counts()
    fma_peak.reset_counts()
    rng = np.random.default_rng(4)
    A, B = (torch.as_tensor(rng.normal(size=s)) for s in ((9, 4), (9, 6)))
    u = torch.as_tensor(rng.normal(size=9))
    np.testing.assert_allclose(gram.gram(A, B, u).numpy(),
                               np.einsum("ka,k,kb->ab", A, u, B), rtol=1e-13)
    np.testing.assert_allclose(gram.gram(A, B).numpy(), A.numpy().T @ B.numpy(),
                               rtol=1e-13)
    a, b = fma_peak.inputs(1, torch.float32, "cpu")
    fma_peak.chains(a, b, "rec3", 64, 2)
    assert gram.LAUNCHES == {} and gram.PLAIN_RUNS == {"gram": 2}
    assert fma_peak.LAUNCHES == {} and fma_peak.PLAIN_RUNS == {"fma_peak": 1}


def test_build_without_nvcc(tmp_path, monkeypatch):
    # one library from every kernel source, each of which is in the checkout
    names = [src.name for src in _build.SOURCES]
    assert names == ["sht_analysis.cu", "sht_analysis_pair.cu",
                     "sht_synthesis.cu", "sht_synthesis_pair.cu", "gram.cu",
                     "fma_peak.cu"]
    assert all(src.is_file() for src in _build.SOURCES + _build.HEADERS)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if _build.find_nvcc() is not None:  # a toolkit at /usr/local/cuda
        pytest.skip("nvcc is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(nvcc=str(tmp_path / "nvcc"))


def _c_functions(source):
    """{name: (return type, [parameter types])} of the extern "C" block."""
    import re

    text = re.sub(r"/\*.*?\*/|//[^\n]*", "", source.read_text(), flags=re.S)
    block = text[text.index('extern "C" {'):]
    out = {}
    for ret, name, params in re.findall(
            r"(int|size_t|const char\s*\*)\s+(heracles_\w+)\s*\(([^)]*)\)",
            block):
        types = []
        for p in params.split(","):
            p = p.strip()
            types.append("ptr" if "*" in p else p.split()[0])
        out[name] = (ret.replace(" ", ""), types)
    return out


def test_c_interface_matches_signatures():
    """Every extern "C" function of every kernel source is declared in
    _build._SIGNATURES with its return type and arity, each parameter
    with the ctypes type its C type needs, and nothing else is declared:
    a changed launcher fails here before it fails on the card."""
    import ctypes

    ctype = {"ptr": ctypes.c_void_p, "int": ctypes.c_int,
             "size_t": ctypes.c_size_t, "constchar*": ctypes.c_char_p}
    found = {}
    for src in _build.SOURCES:
        funcs = _c_functions(src)
        assert funcs, f"no extern C function in {src.name}"
        assert not set(funcs) & set(found), f"{src.name} repeats a name"
        found.update(funcs)
    assert set(found) == set(_build._SIGNATURES)
    for name, (ret, params) in found.items():
        restype, argtypes = _build._SIGNATURES[name]
        assert restype is ctype[ret], name
        assert len(argtypes) == len(params), name
        assert all(a is ctype[p] for a, p in zip(argtypes, params)), name


def _recurrence_history(nside, spin, dtype):
    """(k, mant)[l, ring, lane] of the plain recurrence for every order
    m <= lmax (lanes [+spin | -spin] for a spin pair), lmax = 3 nside - 1;
    entries below a lane's j0 hold the padding exponent and zero."""
    lmax = 3 * nside - 1
    x, lch, lsh = (torch.as_tensor(a) for a in _geometry(nside))
    nm = lmax + 1
    if spin:
        ms, ns = np.tile(np.arange(nm), 2), np.repeat([spin, -spin], nm)
    else:
        ms, ns = np.arange(nm), np.zeros(nm, np.int64)
    ms, ns, j0, _ = wigner._sorted_lanes(ms, ns)
    hist = np.full((lmax + 1, 2 * nside, ms.size), wigner._NO_SEED, np.int64)
    mants = np.zeros(hist.shape)
    for ell, mant, k in wigner._recurrence_rows(ms, ns, j0, x, lch, lsh, lmax,
                                                dtype, "cpu"):
        hist[ell, :, :k.shape[1]] = k.numpy()
        mants[ell, :, :k.shape[1]] = mant.numpy()
    return hist, mants, ms, ns


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("spin", [0, 2])
@pytest.mark.parametrize("nside", [16, 32])
def test_recurrence_exponents_settle(nside, spin, dtype):
    """What the kernels' steady and dead paths rest on (csrc/sht_paths.cuh):
    an exponent never falls; a ring that has reached k = -1 stays there,
    except where a value rounds past 1 at m = s on the rings nearest the
    pole (sht_analysis_pair.cu); an exponent rises at most once in any 8
    consecutive multipoles; and while a ring does not emit yet (k <= -2)
    its |d| never falls and grows by less than sqrt(2 lmax) + 2 a step."""
    hist, mants, ms, ns = _recurrence_history(nside, spin, dtype)
    step = np.diff(hist, axis=0)
    seeded = hist[:-1] != wigner._NO_SEED
    assert np.all(step[seeded] >= 0) and np.all(step[seeded] <= 1)
    left = seeded & (hist[:-1] == -1) & (step != 0)
    _, rings, lanes = np.nonzero(left)
    assert np.all(ms[lanes] == np.abs(ns[lanes]))
    assert np.all(rings < 2)
    assert hist.max() <= 0
    rises = np.where(seeded, step, 0)
    window = sum(rises[i:rises.shape[0] - 7 + i] for i in range(8))
    assert window.max() <= 1
    quiet = seeded & (hist[:-1] <= -2)
    with np.errstate(all="ignore"):  # the padding entries
        growth = np.abs(mants[1:] / mants[:-1]) * 2.0 ** (60.0 * step)
    assert quiet.any()
    assert np.all(growth[quiet] >= 1.0)
    assert growth[quiet].max() < np.sqrt(2.0 * (hist.shape[0] - 1)) + 2.0


def _bulk_equal(got, want):
    """Bit for bit on the outputs within 1e-3 of the largest."""
    bulk = want.abs() >= 1e-3 * want.abs().max()
    return bool(bulk.any()) and torch.equal(got[bulk], want[bulk])


@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("kernel", ["synthesis_pair", "synthesis_spin0",
                                    "analysis_spin0"])
def test_plain_versions_commute_with_power_of_two_scale(kernel, cdtype):
    """The kernels hold one factor of every product times 2^-60
    (csrc/sht_paths.cuh).  A power-of-two scale commutes with every
    rounding while nothing underflows: the plain versions on inputs times
    2^-60 return their outputs times 2^-60 bit for bit, for inputs of
    magnitude 1 down to 1e-36, except that float32 first fails at inputs of
    1e-16 (the scaled outputs, ~1e-34, then have terms among the
    subnormals; the kernels' own products are not scaled down, so only
    their table entries, below ~1e-20, can get there)."""
    nside, lmax = 16, 32
    rng = np.random.default_rng(11)
    x, lch, lsh = (torch.as_tensor(a) for a in _geometry(nside))
    shape = (2 * nside, lmax + 1) if kernel == "analysis_spin0" \
        else (lmax + 1, lmax + 1)
    ins = [_cplx(rng, shape) for _ in range(1 if kernel == "synthesis_spin0"
                                            else 2)]

    def run(arrays):
        if kernel == "synthesis_pair":
            return wigner.synthesis_pair_folded_plain(*arrays, x, lch, lsh,
                                                      lmax, 2)
        if kernel == "synthesis_spin0":
            return wigner.synthesis_spin0_folded_plain(*arrays, x, lch, lsh,
                                                       lmax)
        return (wigner.analysis_spin0_folded_plain(*arrays, x, lch, lsh,
                                                   lmax),)

    failed = None
    for exp10 in range(0, -38, -2):
        base = [torch.as_tensor(a * 10.0**exp10, dtype=cdtype) for a in ins]
        want = [w * 2.0**-60 for w in run(base)]
        got = run([a * 2.0**-60 for a in base])
        if not all(_bulk_equal(g, w) for g, w in zip(got, want)):
            failed = exp10
            break
    if cdtype == torch.complex128:
        assert failed is None
    else:
        assert failed is not None and -20 <= failed <= -14, failed
