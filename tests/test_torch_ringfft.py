"""The ring analysis' kernels (``csrc/ringfft.cu``) and their plan.

On the CPU: ``ring_analysis`` of a CPU tensor takes its plain version and
never loads the kernel library, and the card plan's chirp spectra and
bucket pairs are those the plain version builds.  The tests that need a
card carry the ``cuda`` marker and skip elsewhere; the file imports no
JAX, so on the card it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_ringfft.py

There the kernels are held to the plain version (``ring_analysis_plain``)
on the same card: in float64 within 1e-12 of the largest entry (the same
arithmetic, with cuFFT's sums on other buffers), and in float32 by their
error against the float64 plain run, at most 1.25 times the float32 plain
run's (both are float32 chirp transforms; the kernels take the belt's
aliased orders from the r2c half spectrum where the plain version takes a
c2c one).
"""

import numpy as np
import pytest
import torch

from heracles_tpu_torch import tracing
from heracles_tpu_torch.ops import _build, ringfft, sht


def _maps(nside, batch, complex_in, dtype, seed):
    rng = np.random.default_rng(seed)
    shape = (batch, 12 * nside * nside)
    x = rng.normal(size=shape)
    if complex_in:
        x = x + 1j * rng.normal(size=shape)
        dtype = ringfft._COMPLEX[dtype]
    return torch.as_tensor(x).to(dtype)


@pytest.mark.parametrize("complex_in", [False, True])
def test_cpu_ring_analysis_never_loads_the_kernels(monkeypatch, complex_in):
    def no_build():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(_build, "load_library", no_build)
    tracing.reset()
    nside, nm = 8, 20
    maps = _maps(nside, 2, complex_in, torch.float64, 1)
    w = sht.ring_weights(nside)
    F, Fneg = ringfft.ring_analysis(maps, nside, nm, weight=w, m0=3)
    want = ringfft.ring_analysis_plain(maps, nside, nm, weight=w, m0=3)
    assert torch.equal(F, want[0])
    assert (Fneg is None) == (not complex_in)
    if complex_in:
        assert torch.equal(Fneg, want[1])
    assert not ringfft.LAUNCHES


def test_ring_analysis_refuses_what_the_kernels_cannot_read():
    maps = torch.zeros(12 * 8 * 8)
    with pytest.raises(ValueError, match="nside 4"):
        ringfft.ring_analysis(maps, 4, 5)
    with pytest.raises(ValueError, match="m0=-1"):
        ringfft.ring_analysis(maps, 8, 5, m0=-1)


@pytest.mark.parametrize("cdt", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("nside,mext", [(8, 24), (16, 31), (33, 100)])
def test_card_plan_pairs_mirrors_and_chirp_spectra(nside, mext, cdt):
    """Each cap bucket pair is a north bucket and its southern mirror
    (the same ring lengths reversed, the same L), and its table is the
    FFT, scaled by 1/L, of the chirp b of the north rings, as the plain
    version builds it for each bucket."""
    plan = ringfft.ring_plan(nside, mext)
    card = ringfft._card_plan(nside, mext, cdt, torch.device("cpu"))
    nph, start = card["nph"].numpy(), card["start"].numpy()
    assert nph.dtype == np.int32 and start.dtype == np.int64
    np.testing.assert_array_equal(nph, np.concatenate([b["nph"] for b in plan]))
    np.testing.assert_array_equal(start[1:], np.cumsum(nph)[:-1])
    caps = [b for b in plan if not b["belt"]]
    assert 2 * len(card["caps"]) == len(caps)
    for cap in card["caps"]:
        L, R, rn0, rs0 = cap["L"], cap["R"], cap["rn0"], cap["rs0"]
        north = nph[rn0:rn0 + R]
        np.testing.assert_array_equal(nph[rs0:rs0 + R], north[::-1])
        assert {b["L"] for b in caps if b["rings"][0] in (rn0, rs0)} == {L}
        p = torch.arange(L)[None, :]
        j = torch.where(p < mext, p, L - p)
        b = ringfft._chirp(j, torch.as_tensor(north, dtype=torch.int64)[:, None],
                           +1, cdt)
        assert cap["table"].dtype == cdt
        assert torch.equal(cap["table"] * L, torch.fft.fft(b, dim=-1))
    belt = next(b for b in plan if b["belt"])
    assert card["belt"] == dict(L=belt["L"], rings=belt["rings"],
                                pix=belt["pix"])


# -- on the card --------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _build.load_library()
    return torch.device("cuda")


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


# (nside, nm, m0): orders aliasing past nph and past the belt's length
# (lmax 3 nside - 1), the cell's lmax at nside 1024, a block of orders
# m0 > 0 of a mesh's split, and an odd nside (a belt length 4 nside that
# is no power of two)
CARD_CASES = [(256, 768, 0), (1024, 3001, 0), (256, 384, 384), (33, 100, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("complex_in", [False, True])
@pytest.mark.parametrize("nside,nm,m0", CARD_CASES)
def test_kernels_match_plain(cuda, nside, nm, m0, complex_in):
    w = torch.as_tensor(sht.ring_weights(nside), device=cuda)
    maps64 = _maps(nside, 3, complex_in, torch.float64, nside + m0).to(cuda)
    maps32 = maps64.to(ringfft._COMPLEX[torch.float32] if complex_in
                       else torch.float32)
    truth = ringfft.ring_analysis_plain(maps64, nside, nm, weight=w, m0=m0)
    k64 = ringfft.ring_analysis(maps64, nside, nm, weight=w, m0=m0)
    plain32 = ringfft.ring_analysis_plain(maps32, nside, nm, weight=w, m0=m0)
    k32 = ringfft.ring_analysis(maps32, nside, nm, weight=w, m0=m0)
    torch.cuda.synchronize()
    outs = 2 if complex_in else 1
    assert (k64[1] is None) == (k32[1] is None) == (not complex_in)
    for i in range(outs):
        assert k64[i].dtype == truth[i].dtype and k32[i].dtype == plain32[i].dtype
        assert k64[i].shape == truth[i].shape == (3, 4 * nside - 1, nm)
        assert bool(torch.isfinite(k32[i]).all())
        assert _rel(k64[i], truth[i]) <= 1e-12
        err32 = _rel(k32[i].to(truth[i].dtype), truth[i])
        plain_err = _rel(plain32[i].to(truth[i].dtype), truth[i])
        assert err32 <= 1.25 * plain_err, (err32, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("complex_in", [False, True])
def test_warm_call_builds_and_uploads_nothing(cuda, complex_in):
    nside, nm = 256, 513
    w = torch.as_tensor(sht.ring_weights(nside), device=cuda)
    maps = _maps(nside, 2, complex_in, torch.float32, 5).to(cuda)
    first = ringfft.ring_analysis(maps, nside, nm, weight=w)
    tracing.reset()
    again = ringfft.ring_analysis(maps, nside, nm, weight=w)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert (a is None and b is None) or torch.equal(a, b)
    counts = tracing.counts()
    assert not [k for k in counts["table_builds"] if k.startswith("ringfft.")]
    assert not [k for k, _ in counts["host_copies"]
                if k.startswith("ringfft.")]
    caps = sum(not b["belt"] for b in ringfft.ring_plan(nside, nm)) // 2
    assert dict(ringfft.LAUNCHES) == {"ring_rows": caps, "ring_spectrum": caps,
                                      "ring_orders": caps + 1}


@pytest.mark.cuda
@pytest.mark.parametrize("spin", [0, 2])
def test_warm_map2alm_keeps_its_ring_tables_on_the_card(cuda, spin):
    nside, lmax = 128, 255
    maps = _maps(nside, 2, False, torch.float32, 7).to(cuda)
    if spin:
        maps = maps[None]  # one [Q, U] pair
    sht.map2alm(maps, lmax, spin=spin)
    tracing.reset()
    sht.map2alm(maps, lmax, spin=spin)
    torch.cuda.synchronize()
    counts = tracing.counts()
    ring_keys = [k for k in counts["table_builds"]
                 if k.startswith(("ringfft.", "sht.weights"))]
    ring_keys += [k for k, _ in counts["host_copies"]
                  if k.startswith(("ringfft.", "sht.weights"))]
    assert not ring_keys, ring_keys
    assert ringfft.LAUNCHES["ring_orders"] > 0
