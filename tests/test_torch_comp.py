"""The compensated (``dd="comp"``) float32 recurrence of the port against
heracles_tpu, on the CPU.

The port's CPU path is each kernel's plain version (``ops/wigner.py``),
which repeats the compensated kernels' float32 arithmetic step by step:

* each plain comp version against the reference's Pallas comp kernel
  (``_kernel_comp``, ``_pair_kernel_comp``, ``_synth_kernel_comp``,
  ``_synth_pair_kernel_comp``) in interpret mode, at the sizes of
  ``tests/test_pallas_variants.py::test_pallas_comp_kernels_match_plain_small``;
* the reference's "comp beats plain" test on the port: the spin-0 comp
  analysis against the float64 scan;
* ``map2alm`` / ``alm2map(dd="comp")`` through ``sht``, ``parallel`` (a
  CPU mesh) and ``HealpixMapper``, against the reference's
  ``dd="comp"`` (on the CPU its jnp scans run comp as double-single);
* a zero stream (``x_lo=None``) gives the plain kernel's values bit for
  bit, and a block of orders the full call's columns.

Tolerances: the float32 bar the Pallas kernels are held to
(``tests/test_pallas.py``): ``atol = 2e-5 * scale, rtol = 2e-4``, and
``3e-5 / 3e-4`` for the pair synthesis.  The two packages' comp streams
differ in their order of operations (the reference forms c1 (x d) and
folds the pair's m s term into its forcing) by far less than that.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import heracles_tpu as jh
from heracles_tpu.ops import pallas_sht as jps
from heracles_tpu.ops import sht as jsht
from heracles_tpu.ops import wigner as jw
import heracles_tpu_torch as th
from heracles_tpu_torch import parallel as tpar
from heracles_tpu_torch.ops import sht, sht_kernels, wigner

T = torch.as_tensor
BAR = (2e-5, 2e-4)
PAIR_SYNTH_BAR = (3e-5, 3e-4)
NAMES = ("analysis_spin0_folded", "analysis_pair_folded",
         "synthesis_spin0_folded", "synthesis_pair_folded")


def _close(got, want, bar=BAR):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    atol, rtol = bar
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * np.abs(want).max())


def _geometry(nside):
    """float64 (x, logch, logsh) and the float32 x_lo of the northern
    rings, and the reference's float32 geometry with its lo residuals."""
    nhalf = 2 * nside
    x, lch, lsh = (a[:nhalf] for a in jsht._geom_arrays(nside, "float64"))
    x_lo = (x - x.astype(np.float32).astype(np.float64)).astype(np.float32)
    lch32, lsh32 = lch.astype(np.float32), lsh.astype(np.float32)
    ref = dict(
        geom=tuple(jnp.asarray(a) for a in (x.astype(np.float32), lch32,
                                           lsh32)),
        logch_lo=jnp.asarray((lch - lch32).astype(np.float32)),
        logsh_lo=jnp.asarray((lsh - lsh32).astype(np.float32)),
    )
    return (x, lch, lsh), x_lo, ref


def _cplx(rng, *shape):
    return (rng.normal(size=shape)
            + 1j * rng.normal(size=shape)).astype(np.complex64)


# -- (a) each plain comp version against the Pallas comp kernel ---------------


@pytest.mark.parametrize("name", NAMES)
def test_plain_comp_matches_the_pallas_comp_kernel(name):
    nside, lmax, spin, nm = 16, 24, 2, 128
    rng = np.random.default_rng(11)
    geom, x_lo, ref = _geometry(nside)
    nhalf = 2 * nside
    if name.startswith("analysis"):
        ops = [_cplx(rng, nhalf, nm) for _ in range(2 if "spin0" in name
                                                     else 4)]
    else:
        ops = [_cplx(rng, lmax + 1, nm) for _ in range(1 if "spin0" in name
                                                       else 2)]
    extra = (spin,) if "pair" in name else ()
    want = getattr(jps, name)(
        *map(jnp.asarray, ops), *ref["geom"], lmax, *extra,
        logch_lo=ref["logch_lo"], logsh_lo=ref["logsh_lo"], ring_block=16,
        interpret=True, dd="comp", x_lo=jnp.asarray(x_lo))
    sht_kernels.reset_counts()
    got = getattr(sht_kernels, name)(*map(T, ops), *map(T, geom), lmax,
                                     *extra, dd="comp", x_lo=T(x_lo))
    assert wigner.PLAIN_RUNS_BY_PRECISION == {(name, "f32c"): 1}
    assert not sht_kernels.LAUNCHES
    if name == "analysis_spin0_folded":
        got, want = (got,), (want,)
    bar = PAIR_SYNTH_BAR if name == "synthesis_pair_folded" else BAR
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.complex64
        _close(g, w, bar)


# -- (b) comp beats plain against the float64 scan ----------------------------


def test_comp_analysis_beats_plain():
    """The reference's measurement (tests/test_pallas_variants.py, plain
    4.7e-5 and comp 1.26e-5 of max there) on the port's plain versions:
    the comp stream removes the x-truncation dephasing of a long float32
    chain (lmax 420 on nside-8 rings)."""
    nside, lmax, nm = 8, 420, 128
    rng = np.random.default_rng(3)
    nhalf = 2 * nside
    Fe, Fo = _cplx(rng, nhalf, nm), _cplx(rng, nhalf, nm)
    (x, lch, lsh), x_lo, _ = _geometry(nside)
    args = (T(Fe), T(Fo), T(x), T(lch), T(lsh), lmax)
    plain = sht_kernels.analysis_spin0_folded(*args).numpy()
    comp = sht_kernels.analysis_spin0_folded(*args, dd="comp",
                                             x_lo=T(x_lo)).numpy()
    ms = jnp.arange(nm, dtype=jnp.int32)
    want = np.asarray(jw.lambda_analysis_scan_folded(
        ms, jnp.zeros_like(ms), jnp.asarray(x), jnp.asarray(lch),
        jnp.asarray(lsh), lmax,
        jnp.asarray(((Fe + Fo) / 2).astype(np.complex128)),
        jnp.asarray(((Fe - Fo) / 2).astype(np.complex128)), cross=False))
    sc = np.abs(want).max()
    err_plain = np.abs(plain - want).max() / sc
    err_comp = np.abs(comp - want).max() / sc
    assert err_comp < 2e-5, err_comp
    assert err_comp < err_plain / 2.5, (err_comp, err_plain)


# -- (c) the entry points ---------------------------------------------------------

NSIDE, LMAX = 16, 24
NPIX = 12 * NSIDE**2


def _maps32(spin, nbins=None):
    rng = np.random.default_rng(40 + spin)
    shape = ((nbins,) if nbins else ()) + ((2,) if spin else ()) + (NPIX,)
    return rng.normal(size=shape).astype(np.float32)


def _alms32(spin):
    rng = np.random.default_rng(50 + spin)
    shape = ((2,) if spin else ()) + (sht.alm_size(LMAX),)
    alm = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    alm[..., :LMAX + 1] = alm[..., :LMAX + 1].real  # a_{l0} of a real map
    return alm.astype(np.complex64)


# the reference compiles each of its transforms anew: run each once
_REFERENCE = {}


def _reference(kind, spin, nbins=None):
    """The reference's ``dd="comp"`` analysis of ``_maps32`` or synthesis
    of ``_alms32``, as numpy."""
    key = kind, spin, nbins
    if key not in _REFERENCE:
        if kind == "map2alm":
            out = jsht.map2alm(jnp.asarray(_maps32(spin, nbins)), LMAX,
                               spin=spin, dd="comp",
                               packed=nbins is None)
        else:
            out = jsht.alm2map(jnp.asarray(_alms32(spin)), NSIDE, LMAX,
                               spin=spin, dd="comp")
        _REFERENCE[key] = np.asarray(out)
    return _REFERENCE[key]


def _comp_runs(*names):
    """The comp plain runs since the last reset, by name."""
    return {n: wigner.PLAIN_RUNS_BY_PRECISION[n, "f32c"] for n in names}


@pytest.mark.parametrize("spin", [0, 2])
def test_sht_comp(spin):
    pair = "pair" if spin else "spin0"
    sht_kernels.reset_counts()
    got = sht.map2alm(T(_maps32(spin)), LMAX, spin=spin, dd="comp")
    assert got.dtype == torch.complex64
    _close(got, _reference("map2alm", spin))
    back = sht.alm2map(T(_alms32(spin)), NSIDE, LMAX, spin=spin, dd="comp")
    assert back.dtype == torch.float32
    _close(back, _reference("alm2map", spin),
           PAIR_SYNTH_BAR if spin else BAR)
    # comp is its own mode: the float32 comp recurrence, not the float64 one
    assert _comp_runs(f"analysis_{pair}_folded", f"synthesis_{pair}_folded") \
        == {f"analysis_{pair}_folded": 1, f"synthesis_{pair}_folded": 1}
    assert sum(wigner.PLAIN_RUNS_BY_PRECISION.values()) == 2
    # with iterations every synthesis and analysis runs comp
    sht_kernels.reset_counts()
    sht.map2alm(T(_maps32(spin)), LMAX, spin=spin, dd="comp", iterations=2)
    assert _comp_runs(f"analysis_{pair}_folded", f"synthesis_{pair}_folded") \
        == {f"analysis_{pair}_folded": 3, f"synthesis_{pair}_folded": 2}
    assert sum(wigner.PLAIN_RUNS_BY_PRECISION.values()) == 5


@pytest.mark.parametrize("spin", [0, 2])
def test_parallel_comp(spin):
    """The sharded analysis and synthesis on a (2, 2) CPU mesh, each
    shard's block of orders through the comp plain versions."""
    mesh = tpar.make_mesh(4, m_axis=2, devices=["cpu"] * 4)
    pair = "pair" if spin else "spin0"
    maps = _maps32(spin, nbins=2)
    sht_kernels.reset_counts()
    got = tpar.map2alm_sharded(mesh, T(maps), LMAX, spin=spin, dd="comp")
    assert got.dtype == torch.complex64
    want = _reference("map2alm", spin, nbins=2)
    _close(got[..., :LMAX + 1], want)
    assert not got[..., LMAX + 1:].any()
    assert _comp_runs(f"analysis_{pair}_folded") == {
        f"analysis_{pair}_folded": 4}
    # the unpadded layout: each shard synthesises its block of orders
    rect = sht.unpack_alm(T(_alms32(spin)), LMAX)[None]
    back = tpar.alm2map_sharded(mesh, rect, NSIDE, lmax=LMAX, spin=spin,
                                dd="comp")
    _close(back[0], _reference("alm2map", spin),
           PAIR_SYNTH_BAR if spin else BAR)
    assert _comp_runs(f"synthesis_{pair}_folded") == {
        f"synthesis_{pair}_folded": 4}
    if spin == 0:
        grid = tpar.pipeline_step(mesh, T(maps), LMAX, dd="comp")
        assert grid.shape == (2, 2, LMAX + 1)
        assert _comp_runs("analysis_spin0_folded") == {
            "analysis_spin0_folded": 8}


@pytest.mark.parametrize("spin", [0, 2])
def test_mapper_comp(spin):
    """``HealpixMapper(dd="comp")``: ``transform`` (also with Jacobi
    iterations and sharded) and ``synthesize``, against the reference's
    own mapper and transforms."""
    maps = _maps32(spin)
    mapper = th.HealpixMapper(NSIDE, LMAX, dtype=torch.float32, device="cpu",
                              deconvolve=False, dd="comp")
    sht_kernels.reset_counts()
    got = mapper.transform(T(maps), spin=spin)
    want = jh.HealpixMapper(NSIDE, LMAX, dtype=np.float32, deconvolve=False,
                            dd="comp").transform(maps.copy(), spin=spin)
    _close(got.array, want)
    back = mapper.synthesize(T(_alms32(spin)), spin=spin)
    assert back.array.dtype == torch.float32
    _close(back.array, _reference("alm2map", spin),
           PAIR_SYNTH_BAR if spin else BAR)
    pair = "pair" if spin else "spin0"
    assert _comp_runs(f"analysis_{pair}_folded", f"synthesis_{pair}_folded") \
        == {f"analysis_{pair}_folded": 1, f"synthesis_{pair}_folded": 1}
    iterated = th.HealpixMapper(NSIDE, LMAX, dtype=torch.float32,
                                device="cpu", deconvolve=False, dd="comp",
                                iterations=1)
    mesh = tpar.make_mesh(2, m_axis=2, devices=["cpu"] * 2)
    sharded = iterated.transform_sharded(mesh, T(maps)[None], spin=spin)
    _close(sharded.array[0], iterated.transform(T(maps), spin=spin).array)


# -- (d) a zero stream is the plain kernel; blocks of orders ----------------------


def _kernel_inputs(name, nside, lmax, nm, seed):
    rng = np.random.default_rng(seed)
    nhalf = 2 * nside
    if name.startswith("analysis"):
        ops = [_cplx(rng, nhalf, nm) for _ in range(2 if "spin0" in name
                                                     else 4)]
    else:
        ops = [_cplx(rng, lmax + 1, nm) for _ in range(1 if "spin0" in name
                                                       else 2)]
    return [T(a) for a in ops], ((2,) if "pair" in name else ())


@pytest.mark.parametrize("name", NAMES)
def test_zero_stream_is_plain(name):
    nside, lmax = 16, 40
    ops, extra = _kernel_inputs(name, nside, lmax, lmax + 1, 5)
    geom, _, _ = _geometry(nside)
    fn = getattr(sht_kernels, name)
    args = (*ops, *map(T, geom), lmax, *extra)
    plain = fn(*args)
    plain = plain if isinstance(plain, tuple) else (plain,)
    for x_lo in (None, torch.zeros(2 * nside)):
        comp = fn(*args, dd="comp", x_lo=x_lo)
        comp = comp if isinstance(comp, tuple) else (comp,)
        for c, p in zip(comp, plain, strict=True):
            assert torch.equal(c, p)
    # complex128 ignores comp
    wide = [a.to(torch.complex128) for a in ops]
    args64 = (*wide, *map(T, geom), lmax, *extra)
    got, want = fn(*args64, dd="comp", x_lo=T(_geometry(nside)[1])), \
        fn(*args64)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", NAMES)
def test_comp_block_of_orders(name):
    """Orders m0.. of a block (a device mesh's shard) give the full call's
    columns, in the comp recurrence too: bit for bit in the syntheses, and
    at float32 rounding in the analyses, whose plain sum over rings is a
    torch reduction whose order follows the width of the block."""
    nside, lmax, m0 = 16, 40, 24
    ops, extra = _kernel_inputs(name, nside, lmax, lmax + 1, 6)
    geom, x_lo, _ = _geometry(nside)
    fn = getattr(sht_kernels, name)
    kw = dict(dd="comp", x_lo=T(x_lo))
    full = fn(*ops, *map(T, geom), lmax, *extra, **kw)
    block = fn(*[a[..., m0:] for a in ops], *map(T, geom), lmax, *extra, m0,
               **kw)
    full = full if isinstance(full, tuple) else (full,)
    block = block if isinstance(block, tuple) else (block,)
    for f, b in zip(full, block, strict=True):
        if name.startswith("synthesis"):
            assert torch.equal(f[..., m0:], b)
        else:
            _close(b, f[..., m0:], (1e-6, 0.0))
