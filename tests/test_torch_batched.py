"""The analyses' groups of maps (``nb``) of the port against heracles_tpu,
on the CPU.

On the card a batch of B maps runs in groups of ``nb`` that share one
Wigner recurrence (``csrc/sht_analysis.cu``, ``sht_analysis_pair.cu``),
the twin of the reference's ``nb`` program; here the wrappers take the
plain versions, which check ``nb`` as the kernels do.  Held here:

* the port's ``analysis_spin0_folded`` / ``analysis_pair_folded`` at
  ``nb`` 1, 2 and None against the reference's Pallas kernels at the same
  ``nb``, in interpret mode with ``ring_block=16``, as
  ``tests/test_pallas.py::test_pallas_nb_grouped_maps_match_nb1`` runs
  them, in float32; in float64 against the reference's jnp scan;
* every ``nb`` gives the same numbers bit for bit; ``pick_nb``'s rule;
  ``ValueError`` for an ``nb`` without an instantiation or that does not
  divide the batch, from the wrappers and the plain versions alike;
* a batched ``HealpixMapper.transform`` (4 maps, spin 0 and spin 2)
  against the reference's, and a sharded analysis handing each shard's
  own batch to ``pick_nb``.

The card's side (every instantiated ``nb`` bit for bit its ``nb = 1``)
is in ``tests/test_torch_kernels.py`` under the ``cuda`` marker.

Tolerances: float32 at the bar the Pallas kernels are held to
(``tests/test_pallas.py``), ``atol = 2e-5 * scale, rtol = 2e-4`` (the
same algorithm, float32 sums in another order); float64
``atol = 1e-10 * scale`` (``tests/test_torch_ops.py``).
"""

import functools

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
NAMES = ("analysis_spin0_folded", "analysis_pair_folded")
NSIDE, LMAX, SPIN, NM, BATCH = 8, 16, 2, 128, 4
# the reference's compile in interpret mode grows with nb (~8 s a pair
# analysis at nb 1, ~19 s at nb 4): its batch is 2
PALLAS_BATCH = 2


def _close(got, want, bar=BAR):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    atol, rtol = bar
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * np.abs(want).max())


def _geometry(nside):
    """float64 (x, logch, logsh) of the northern rings, and the
    reference's float32 geometry with its lo residuals."""
    nhalf = 2 * nside
    x, lch, lsh = (a[:nhalf] for a in jsht._geom_arrays(nside, "float64"))
    lch32, lsh32 = lch.astype(np.float32), lsh.astype(np.float32)
    ref = dict(
        geom=tuple(jnp.asarray(a) for a in (x.astype(np.float32), lch32,
                                           lsh32)),
        logch_lo=jnp.asarray((lch - lch32).astype(np.float32)),
        logsh_lo=jnp.asarray((lsh - lsh32).astype(np.float32)),
    )
    return (x, lch, lsh), ref


def _spectra(name, batch, dtype=np.complex64, seed=11, nside=NSIDE, nm=NM):
    rng = np.random.default_rng(seed)
    shape = (batch, 2 * nside, nm)
    return [(rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(dtype)
            for _ in range(2 if "spin0" in name else 4)]


def _extra(name):
    return (SPIN,) if "pair" in name else ()


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _reference_nb(name, B, lmax):
    """The reference's own choice of nb (``pallas_sht.py:1601-1603``,
    ``:3122-3123``)."""
    if name == "analysis_pair_folded":
        return jps._pick_nb(B, lmax, limit=4 if lmax <= 1600 else 2)
    return jps._pick_nb(B, lmax)


@functools.lru_cache(maxsize=None)
def _pallas(name, nb):
    """The reference's Pallas kernel on the float32 inputs (interpret
    mode, compiled once per nb: the compile takes seconds per map of the
    group)."""
    _, ref = _geometry(NSIDE)
    ops = _spectra(name, PALLAS_BATCH)
    out = getattr(jps, name)(
        *map(jnp.asarray, ops), *ref["geom"], LMAX, *_extra(name),
        logch_lo=ref["logch_lo"], logsh_lo=ref["logsh_lo"], ring_block=16,
        nb=nb, interpret=True)
    return tuple(np.asarray(o) for o in _outputs(out))


@pytest.mark.parametrize("nb", [1, 2, None])
@pytest.mark.parametrize("name", NAMES)
def test_float32_matches_the_pallas_kernel_at_nb(name, nb):
    geom, _ = _geometry(NSIDE)
    ops = _spectra(name, PALLAS_BATCH)
    # None: each package's own choice, the reference's nb 2; the port's
    # follows the card's times (nb 2 where NB_SIZES allows it, else 1),
    # the same numbers on the plain path
    ref_nb = _reference_nb(name, PALLAS_BATCH, LMAX)
    assert ref_nb == 2
    assert sht_kernels.pick_nb(PALLAS_BATCH, LMAX, name) == (
        2 if 2 in sht_kernels.NB_SIZES[name]["f32"] else 1)
    want = _pallas(name, ref_nb if nb is None else nb)
    sht_kernels.reset_counts()
    got = getattr(sht_kernels, name)(*map(T, ops), *map(T, geom), LMAX,
                                     *_extra(name), nb=nb)
    assert wigner.PLAIN_RUNS == {name: 1}
    assert not sht_kernels.LAUNCHES
    for g, w in zip(_outputs(got), want, strict=True):
        assert g.dtype == torch.complex64
        _close(g, w)


@pytest.mark.parametrize("nb", [1, 2, None])
@pytest.mark.parametrize("name", NAMES)
def test_float64_matches_the_jnp_scan_at_nb(name, nb):
    geom, _ = _geometry(NSIDE)
    ops = _spectra(name, BATCH, np.complex128, seed=12)
    x, lch, lsh = (jnp.asarray(a) for a in geom)
    if name == "analysis_spin0_folded":
        Fe, Fo = ops
        ms = jnp.arange(NM)
        want = (jw.lambda_analysis_scan_folded(
            ms, jnp.zeros_like(ms), x, lch, lsh, LMAX,
            jnp.asarray((Fe + Fo) / 2), jnp.asarray((Fe - Fo) / 2)),)
    else:
        FNp, Sp, FNm, Sm = ops
        ms = jnp.asarray(np.tile(np.arange(NM), 2))
        ns = jnp.asarray(np.repeat([SPIN, -SPIN], NM))
        both = np.asarray(jw.lambda_analysis_scan_folded(
            ms, ns, x, lch, lsh, LMAX,
            jnp.asarray(np.concatenate([FNp, FNm], -1)),
            jnp.asarray(np.concatenate([Sm, Sp], -1)), cross=True))
        want = (both[..., :NM], both[..., NM:])
    got = getattr(sht_kernels, name)(*map(T, ops), *map(T, geom), LMAX,
                                     *_extra(name), nb=nb)
    for g, w in zip(_outputs(got), want, strict=True):
        assert g.dtype == torch.complex128
        _close(g, w, (1e-10, 0.0))


@pytest.mark.parametrize("mode", ["f32", "f64", "comp"])
@pytest.mark.parametrize("name", NAMES)
def test_every_nb_gives_the_same_bits(name, mode):
    geom, _ = _geometry(8)
    dtype = np.complex128 if mode == "f64" else np.complex64
    ops = [T(a) for a in _spectra(name, 8, dtype, seed=13, nside=8, nm=12)]
    kw = dict(dd="comp", x_lo=torch.zeros(16)) if mode == "comp" else {}
    outs = {nb: _outputs(getattr(sht_kernels, name)(
                *ops, *map(T, geom), 11, *_extra(name), nb=nb, **kw))
            for nb in (*wigner.GROUP_SIZES[name], None)}
    for nb, out in outs.items():
        for g, w in zip(out, outs[1], strict=True):
            assert torch.equal(g.view(torch.float32 if dtype == np.complex64
                                      else torch.float64),
                               w.view(torch.float32 if dtype == np.complex64
                                      else torch.float64)), nb


@pytest.mark.parametrize("precision", ["f32", "f64", "f32c"])
@pytest.mark.parametrize("name", NAMES)
def test_pick_nb_rule(name, precision):
    sizes = wigner.GROUP_SIZES[name]
    allowed = sht_kernels.NB_SIZES[name][precision]
    assert 1 in allowed and set(allowed) <= set(sizes)
    for B in range(1, 33):
        nb = sht_kernels.pick_nb(B, LMAX, name, precision)
        assert nb in allowed and B % nb == 0, (B, nb)
        assert all(B % c or c <= nb for c in allowed), (B, nb)
    assert sht_kernels.pick_nb(1, LMAX, name, precision) == 1
    for prime in (11, 13, 31):
        assert sht_kernels.pick_nb(prime, LMAX, name, precision) == 1
    # a batch of 2 runs in a group only where nb 2 is allowed
    assert sht_kernels.pick_nb(2, LMAX, name, precision) == (
        2 if 2 in allowed else 1)
    top = max(allowed)
    assert sht_kernels.pick_nb(2 * top, 3000, name, precision) == top


def test_pick_nb_skips_a_group_that_loses_to_nb1():
    """The spin-0 analysis' float64 nb 2 loses to nb 1 on the card
    (``pick_nb``'s table): a batch of 2 or 6 runs at nb 1, of 4 or 8 at
    nb 4; float32 and comp (their warp-specialised groups) take every
    group, nb 2 on 2 or 6 maps and nb 8 on 8."""
    name = "analysis_spin0_folded"
    assert [sht_kernels.pick_nb(B, LMAX, name, "f64")
            for B in (2, 4, 6, 8)] == [1, 4, 1, 4]
    for precision in ("f32", "f32c"):
        assert [sht_kernels.pick_nb(B, LMAX, name, precision)
                for B in (2, 4, 6, 8)] == [2, 4, 2, 8]


@pytest.mark.parametrize("name", NAMES)
def test_nb_that_does_not_fit_raises(name):
    geom, _ = _geometry(8)
    ops = [T(a) for a in _spectra(name, 6, seed=14, nside=8, nm=12)]
    kernel = getattr(sht_kernels, name)
    plain = getattr(wigner, name + "_plain")
    for nb, what in ((4, "does not divide"), (3, "no instantiation"),
                     (16, "no instantiation")):
        with pytest.raises(ValueError, match=what):
            kernel(*ops, *map(T, geom), 11, *_extra(name), nb=nb)
        with pytest.raises(ValueError, match=what):
            plain(*ops, *map(T, geom), 11, *_extra(name), nb=nb)
    # a spectrum without batch axes is a batch of one
    with pytest.raises(ValueError, match="does not divide"):
        kernel(*(a[0] for a in ops), *map(T, geom), 11, *_extra(name), nb=2)


@pytest.fixture
def picks(monkeypatch):
    """Every (B, name, precision, nb) that pick_nb answered."""
    seen = []
    pick = sht_kernels.pick_nb

    def spy(B, lmax, name, precision="f32"):
        nb = pick(B, lmax, name, precision)
        seen.append((B, name, precision, nb))
        return nb

    monkeypatch.setattr(sht_kernels, "pick_nb", spy)
    return seen


@pytest.mark.parametrize("spin", [0, 2])
def test_batched_mapper_transform(spin, picks):
    """4 maps through one ``HealpixMapper.transform`` against the
    reference's mapper: one analysis of the whole batch, in a group of 4."""
    nside, lmax = 16, 24
    rng = np.random.default_rng(15 + spin)
    npix = 12 * nside**2
    maps = rng.normal(size=(BATCH, 2, npix) if spin else (BATCH, npix))
    maps = maps.astype(np.float32)
    want = jh.HealpixMapper(nside, lmax, dtype=np.float32,
                            deconvolve=False).transform(maps.copy(), spin=spin)
    sht_kernels.reset_counts()
    got = th.HealpixMapper(nside, lmax, dtype=torch.float32, device="cpu",
                           deconvolve=False).transform(T(maps), spin=spin)
    _close(got.array, want)
    name = NAMES[1] if spin else NAMES[0]
    assert wigner.PLAIN_RUNS == {name: 1}
    assert picks == [(BATCH, name, "f32", 4)]


def test_each_shard_picks_for_its_own_batch(picks):
    """A mesh of two "batch" shards: each analysis sees its shard's 2
    maps, not the 4 of the call."""
    nside, lmax = 8, 12
    rng = np.random.default_rng(16)
    maps = T(rng.normal(size=(BATCH, 12 * nside**2)))
    mesh = tpar.make_mesh(2, m_axis=1, devices=["cpu"] * 2)
    got = tpar.map2alm_sharded(mesh, maps, lmax)
    nb = 2 if 2 in sht_kernels.NB_SIZES[NAMES[0]]["f64"] else 1
    assert picks == [(2, NAMES[0], "f64", nb)] * 2
    _close(got[..., :lmax + 1], sht.map2alm(maps, lmax, packed=False),
           (1e-10, 0.0))
