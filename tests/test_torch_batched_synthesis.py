"""The syntheses' groups of maps (``nb``) of the port against heracles_tpu,
on the CPU.

On the card a stack of B maps runs in groups of ``nb`` that share one
Wigner recurrence (``csrc/sht_synthesis.cu``, ``sht_synthesis_pair.cu``),
the twin of the reference's ``nb`` program; here the wrappers take the
plain versions, which check ``nb`` as the kernels do.  Held here:

* the port's ``synthesis_spin0_folded`` / ``synthesis_pair_folded`` at
  ``nb`` 1, 2 and None against the reference's Pallas kernels at the same
  ``nb``, in interpret mode with ``ring_block=16``, as
  ``tests/test_pallas.py::test_pallas_nb_grouped_maps_match_nb1`` runs
  them, in float32; in float64 against the reference's jnp scan;
* every ``nb`` gives the same numbers bit for bit; ``pick_nb``'s rule for
  the synthesis rows; ``ValueError`` for an ``nb`` without an
  instantiation or that does not divide the batch, from the wrappers and
  the plain versions alike;
* a stacked ``alm2map`` and a stacked ``map2alm(iterations=1)`` (its
  Jacobi step synthesises the stack) at nside 16 against the reference's,
  each synthesis of the stack in one automatic group.

The card's side (every instantiated ``nb`` bit for bit its ``nb = 1``,
``nb = 1`` bit for bit the kernels before the groups) is in
``tests/test_torch_kernels.py`` under the ``cuda`` marker.

Tolerances: float32 at the bar the Pallas kernels are held to
(``tests/test_pallas.py``), ``atol = 2e-5 * scale, rtol = 2e-4`` (the
same algorithm, float32 sums in another order); float64
``atol = 1e-11 * scale`` against the jnp scan, and ``1e-10 * scale``
for the transforms, as ``tests/test_torch_synthesis_maps.py`` holds
them (the same algorithm, float64 sums in another order).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from heracles_tpu.ops import pallas_sht as jps
from heracles_tpu.ops import sht as jsht
from heracles_tpu.ops import wigner as jw
from heracles_tpu_torch.ops import sht, sht_kernels, wigner

T = torch.as_tensor
BAR = (2e-5, 2e-4)
NAMES = ("synthesis_spin0_folded", "synthesis_pair_folded")
NSIDE, LMAX, SPIN, NM = 8, 16, 2, 128
# the reference's compile in interpret mode grows ~8 s a map of the group:
# its batch is 2
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


def _alms(name, batch, dtype=np.complex64, seed=21, lmax=LMAX, nm=NM):
    rng = np.random.default_rng(seed)
    shape = (batch, lmax + 1, nm)
    return [(rng.normal(size=shape)
             + 1j * rng.normal(size=shape)).astype(dtype)
            for _ in range(1 if "spin0" in name else 2)]


def _extra(name):
    return (SPIN,) if "pair" in name else ()


def _reference_nb(B, lmax):
    """The reference's own choice of nb for either synthesis
    (``pallas_sht.py:2060-2063``, ``:2851-2854``)."""
    return jps._pick_nb(B, lmax, limit=4 if lmax <= 1600 else 2)


@functools.lru_cache(maxsize=None)
def _pallas(name, nb):
    """The reference's Pallas kernel on the float32 inputs (interpret
    mode, compiled once per nb: the compile takes seconds per map of the
    group)."""
    _, ref = _geometry(NSIDE)
    alms = _alms(name, PALLAS_BATCH)
    out = getattr(jps, name)(
        *map(jnp.asarray, alms), *ref["geom"], LMAX, *_extra(name),
        logch_lo=ref["logch_lo"], logsh_lo=ref["logsh_lo"], ring_block=16,
        nb=nb, interpret=True)
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("nb", [1, 2, None])
@pytest.mark.parametrize("name", NAMES)
def test_float32_matches_the_pallas_kernel_at_nb(name, nb):
    geom, _ = _geometry(NSIDE)
    alms = _alms(name, PALLAS_BATCH)
    # None: each package's own choice, here the same group
    pick = sht_kernels.pick_nb(PALLAS_BATCH, LMAX, name)
    assert pick == _reference_nb(PALLAS_BATCH, LMAX) == 2
    want = _pallas(name, pick if nb is None else nb)
    sht_kernels.reset_counts()
    got = getattr(sht_kernels, name)(*map(T, alms), *map(T, geom), LMAX,
                                     *_extra(name), nb=nb)
    assert wigner.PLAIN_RUNS == {name: 1}
    assert not sht_kernels.LAUNCHES
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.complex64
        _close(g, w)


@pytest.mark.parametrize("nb", [1, 2, None])
@pytest.mark.parametrize("name", NAMES)
def test_float64_matches_the_jnp_scan_at_nb(name, nb):
    geom, _ = _geometry(NSIDE)
    alms = _alms(name, 4, np.complex128, seed=22)
    x, lch, lsh = (jnp.asarray(a) for a in geom)
    if name == "synthesis_spin0_folded":
        ms = jnp.arange(NM)
        want = jw.lambda_synthesis_scan_folded(
            ms, jnp.zeros_like(ms), x, lch, lsh, LMAX, jnp.asarray(alms[0]))
    else:
        ms = jnp.asarray(np.tile(np.arange(NM), 2))
        ns = jnp.asarray(np.repeat([SPIN, -SPIN], NM))
        GN, GS = (np.asarray(w) for w in jw.lambda_synthesis_scan_folded(
            ms, ns, x, lch, lsh, LMAX,
            jnp.asarray(np.concatenate(alms, -1)), cross=True))
        want = (GN[..., :NM], GS[..., :NM], GN[..., NM:], GS[..., NM:])
    got = getattr(sht_kernels, name)(*map(T, alms), *map(T, geom), LMAX,
                                     *_extra(name), nb=nb)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.complex128
        _close(g, w, (1e-11, 0.0))


@pytest.mark.parametrize("mode", ["f32", "f64", "comp"])
@pytest.mark.parametrize("name", NAMES)
def test_every_nb_gives_the_same_bits(name, mode):
    geom, _ = _geometry(8)
    dtype = np.complex128 if mode == "f64" else np.complex64
    alms = [T(a) for a in _alms(name, 8, dtype, seed=23, lmax=11, nm=12)]
    kw = dict(dd="comp", x_lo=torch.zeros(16)) if mode == "comp" else {}
    real = torch.float64 if mode == "f64" else torch.float32
    outs = {nb: getattr(sht_kernels, name)(*alms, *map(T, geom), 11,
                                           *_extra(name), nb=nb, **kw)
            for nb in (*wigner.GROUP_SIZES[name], None)}
    for nb, out in outs.items():
        for g, w in zip(out, outs[1], strict=True):
            assert torch.equal(g.view(real), w.view(real)), nb


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


@pytest.mark.parametrize("name", NAMES)
def test_nb_that_does_not_fit_raises(name):
    geom, _ = _geometry(8)
    alms = [T(a) for a in _alms(name, 6, seed=24, lmax=11, nm=12)]
    kernel = getattr(sht_kernels, name)
    plain = getattr(wigner, name + "_plain")
    for nb, what in ((4, "does not divide"), (3, "no instantiation"),
                     (16, "no instantiation")):
        with pytest.raises(ValueError, match=what):
            kernel(*alms, *map(T, geom), 11, *_extra(name), nb=nb)
        with pytest.raises(ValueError, match=what):
            plain(*alms, *map(T, geom), 11, *_extra(name), nb=nb)
    # alms without batch axes are a batch of one
    with pytest.raises(ValueError, match="does not divide"):
        kernel(*(a[0] for a in alms), *map(T, geom), 11, *_extra(name), nb=2)


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


def _synthesis_picks(picks):
    return [p for p in picks if p[1].startswith("synthesis")]


@pytest.mark.parametrize("spin", [0, 2])
def test_stacked_alm2map(spin, picks):
    """4 stacked alms through one ``alm2map`` against the reference's: one
    synthesis of the whole stack, in a group of 4."""
    nside, lmax, B = 16, 24, 4
    rng = np.random.default_rng(25 + spin)
    shape = (B, 2, sht.alm_size(lmax)) if spin else (B, sht.alm_size(lmax))
    alm = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    want = jsht.alm2map(jnp.asarray(alm), nside, lmax, spin=spin)
    sht_kernels.reset_counts()
    got = sht.alm2map(T(alm), nside, lmax, spin=spin)
    _close(got, want, (1e-10, 0.0))
    name = NAMES[1] if spin else NAMES[0]
    assert wigner.PLAIN_RUNS == {name: 1}
    assert _synthesis_picks(picks) == [(B, name, "f64", 4)]


@pytest.mark.parametrize("spin", [0, 2])
def test_stacked_map2alm_iteration(spin, picks):
    """A stack of 4 maps through ``map2alm(iterations=1)`` against the
    reference's: its Jacobi step synthesises the whole stack at once."""
    nside, lmax, B = 16, 24, 4
    rng = np.random.default_rng(27 + spin)
    npix = 12 * nside**2
    maps = rng.normal(size=(B, 2, npix) if spin else (B, npix))
    want = jsht.map2alm(jnp.asarray(maps), lmax, spin=spin, iterations=1)
    sht_kernels.reset_counts()
    got = sht.map2alm(T(maps), lmax, spin=spin, iterations=1)
    _close(got, want, (1e-10, 0.0))
    name = NAMES[1] if spin else NAMES[0]
    assert wigner.PLAIN_RUNS[name] == 1
    assert _synthesis_picks(picks) == [(B, name, "f64", 4)]
