"""The grouped analyses' ring contraction on the tensor cores, modelled on
the CPU by the plain torch functions below.

On the card the float32 and compensated groups of maps of the spin-0 and
spin-pair analyses (``csrc/sht_analysis.cu``, ``sht_analysis_pair.cu``)
contract the group's spectra with the shared recurrence's emitted values
in 3xTF32 (``csrc/tc_contract.cuh``): each operand x splits into
hi = x rounded to TF32 (a float32 with 10 explicit mantissa bits) and
lo = x - hi, exact in float32, which the tensor cores read as TF32 by
dropping its 13 low bits; a product is lo_a hi_b + hi_a lo_b + hi_a hi_b,
summed in float32.  The model's sums run in torch's order, not the
card's.  Held here, at nside 8 to 32:

* ``round_tf32`` rounds as ``cvt.rna.tf32.f32`` does (to nearest, ties
  away from zero) on hand-picked bit patterns: ties, carries into the
  exponent, subnormals, signed zeros, infinities, NaN; ``truncate_tf32``
  keeps the top 19 bits;
* the 3xTF32 contraction of the plain recurrence's float32 emitted values
  (``wigner._lambda_rows``), laid out as the kernels lay it out (rows of
  each map's (re, im) at both parities, or the pair's two products, a
  group of ``nb`` maps), passes the float32 bar against the float64 plain
  analysis, for spin 0 and the pair, at nb 2 and 4;
* the same contraction in TF32 alone (one product) fails that bar: the
  kernels need the three.

The card's side (each grouped launch against ``nb = 1`` and the plain
version) is in ``tests/test_torch_kernels.py`` under the ``cuda`` marker.

Tolerance: the float32 bar the Pallas kernels are held to
(``tests/test_pallas.py``), ``atol = 2e-5 * scale, rtol = 2e-4``.
"""

import math

import numpy as np
import pytest
import torch

from heracles_tpu_torch.ops import sht, wigner

BAR = (2e-5, 2e-4)
NSIDE, LMAX, SPIN = 32, 64, 2

# float32 bit pattern -> its cvt.rna.tf32.f32 (10 explicit mantissa bits,
# the 13 below cleared; to nearest, ties away from zero)
RNA_CASES = [
    (0x3F800000, 0x3F800000),  # 1.0: already TF32
    (0x3F800FFF, 0x3F800000),  # just below half an ulp: down
    (0x3F801000, 0x3F802000),  # a tie: away from zero
    (0x3F801001, 0x3F802000),  # just above: up
    (0x3F803000, 0x3F804000),  # a tie above an odd mantissa: away, not even
    (0xBF801000, 0xBF802000),  # a negative tie: away from zero
    (0xBF800FFF, 0xBF800000),  # negative, below half: towards zero
    (0x3FFFF000, 0x40000000),  # a tie that carries into the exponent
    (0x00001000, 0x00002000),  # a subnormal tie
    (0x00000FFF, 0x00000000),  # a subnormal below half: zero
    (0x80000000, 0x80000000),  # -0.0
    (0x7F7FF000, 0x7F800000),  # a tie at the largest binade: infinity
    (0x7F800000, 0x7F800000),  # +inf
    (0xFF800000, 0xFF800000),  # -inf
]


_DROPPED = 13  # float32's 23 mantissa bits less TF32's 10


def round_tf32(x):
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` (and
    ``tc::tf32_rna``) does: to the nearest value with 10 explicit mantissa
    bits, ties away from zero, returned as float32 (NaN stays NaN; a
    value that rounds past the largest float32 becomes infinity)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    bits = x.view(torch.int32)
    # the magnitude lies in the low 31 bits, so adding half of the dropped
    # bits' unit and clearing them rounds the magnitude, ties up
    half = 1 << (_DROPPED - 1)
    mask = ~((1 << _DROPPED) - 1)
    out = ((bits + half) & mask).view(torch.float32)
    return torch.where(torch.isnan(x), x, out)


def truncate_tf32(x):
    """float32 ``x`` as the tensor cores read a TF32 operand: its top 19
    bits, the 13 low mantissa bits dropped."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return (x.view(torch.int32) & ~((1 << _DROPPED) - 1)).view(torch.float32)


def split_tf32(x):
    """(hi, lo) as the tensor cores multiply them: hi = round_tf32(x) and
    lo = x - hi (exact in float32) read as TF32."""
    x = torch.as_tensor(x, dtype=torch.float32)
    hi = round_tf32(x)
    return hi, truncate_tf32(x - hi)


def contract_tf32(a, b, dim, passes=3):
    """sum over ``dim`` of the products of float32 ``a`` and ``b``
    (broadcast), each product formed from TF32 parts and the sum taken in
    float32: ``passes=3`` the three products of 3xTF32, ``passes=1`` the
    TF32 product hi_a hi_b alone.  A product of two TF32 values is exact
    in float32."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    prod = ah * bh
    if passes == 3:
        prod = al * bh + ah * bl + prod
    return prod.sum(dim)


def _f32(bits):
    return torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(
        torch.float32)


@pytest.mark.parametrize("bits,want", RNA_CASES,
                         ids=[f"{b:08x}" for b, _ in RNA_CASES])
def test_round_tf32_is_cvt_rna(bits, want):
    got = round_tf32(_f32(bits)).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    assert int(got) == want


def test_round_tf32_keeps_nan():
    assert torch.isnan(round_tf32(torch.tensor([float("nan")]))).all()


@pytest.mark.parametrize("bits,want", [
    (0x3F801FFF, 0x3F800000),  # the 13 low bits dropped, not rounded
    (0xBF803FFF, 0xBF802000),  # negative: towards zero
    (0x7F800000, 0x7F800000),  # +inf
    (0x80001FFF, 0x80000000),  # a negative subnormal: -0.0
], ids=lambda v: f"{v:08x}")
def test_truncate_tf32_keeps_the_top_19_bits(bits, want):
    got = truncate_tf32(_f32(bits)).view(torch.int32).to(torch.int64)
    assert int(got & 0xFFFFFFFF) == want


def test_split_tf32_is_exact_to_its_lo_rounding():
    """hi carries 11 significant bits, x - hi is exact and within half of
    hi's last unit, and lo, its top 11 bits, leaves less than 2^-21 of x
    out; both are TF32 values."""
    x = torch.as_tensor(np.random.default_rng(3).normal(size=10_000),
                        dtype=torch.float32)
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert torch.equal(truncate_tf32(part), part)
    rest = (x.double() - hi.double()).abs() / x.double().abs()
    assert float(rest.max()) <= 2.0**-11
    err = ((hi.double() + lo.double()) - x.double()).abs() / x.double().abs()
    assert float(err.max()) < 2.0**-21


def _close(got, want, bar=BAR):
    got, want = got.numpy(), want.numpy()
    np.testing.assert_allclose(got, want, rtol=bar[1],
                               atol=bar[0] * np.abs(want).max())


def _lam(spin, x, logch, logsh, lmax=LMAX):
    """The plain recurrence's float32 emitted values of the orders
    0..lmax at column n = spin, (lmax + 1, nhalf, nm); zero below j0."""
    nm = lmax + 1
    ms = np.arange(nm)
    ns = np.full(nm, spin)
    j0 = np.maximum(ms, abs(spin))  # non-decreasing: the lanes are in order
    lam = torch.zeros((lmax + 1, x.shape[0], nm), dtype=torch.float32)
    for ell, rows in wigner._lambda_rows(ms, ns, j0, x, logch, logsh, lmax,
                                         torch.float32, "cpu"):
        lam[ell, :, :rows.shape[1]] = rows
    return lam


def _norm(lmax=LMAX):
    ells = np.arange(lmax + 1)
    norm = np.sqrt((2.0 * ells + 1.0) / (4 * math.pi)).astype(np.float32)
    return torch.as_tensor(norm)[:, None]


def _spectra(nb, count, seed, nside=NSIDE, lmax=LMAX):
    rng = np.random.default_rng(seed)
    shape = (nb, 2 * nside, lmax + 1)
    return [torch.as_tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape),
                            dtype=torch.complex64) for _ in range(count)]


def _spin0_model(Fe, Fo, geom, passes):
    """The spin-0 group's contraction: rows (map, re / im) at j0's parity
    (here 0: every order's even l) and at the other, against the emitted
    values; each l keeps the rows of its parity."""
    lam = _lam(0, *geom)
    ells = torch.arange(LMAX + 1)
    F = torch.where((ells % 2 == 0)[None, :, None, None, None],
                    torch.view_as_real(Fe)[:, None],
                    torch.view_as_real(Fo)[:, None])  # (nb, l, ring, m, 2)
    d = contract_tf32(lam[None, ..., None], F, dim=2, passes=passes)
    return torch.view_as_complex((d * _norm()[..., None]).contiguous())


def _pair_model(FNp, Sp, FNm, Sm, geom, passes):
    """The pair group's two products, D0 = (FNp, Sm) lp and D1 = (Sp, FNm)
    lm, and a_p = D0[FNp] + (-1)^l D1[Sp], a_m = D1[FNm] + (-1)^l D0[Sm]."""
    lp, lm = _lam(SPIN, *geom), _lam(-SPIN, *geom)

    def dot(lam, F):
        return contract_tf32(lam[None, ..., None],
                             torch.view_as_real(F)[:, None], dim=2,
                             passes=passes)

    sign = torch.ones(LMAX + 1)
    sign[1::2] = -1.0
    sign = sign[:, None, None]
    ap = dot(lp, FNp) + sign * dot(lm, Sp)
    am = dot(lm, FNm) + sign * dot(lp, Sm)
    return tuple(torch.view_as_complex((a * _norm()[..., None]).contiguous())
                 for a in (ap, am))


def _case(name, nb, passes):
    """(model, float64 plain analysis) on nb seeded maps."""
    geom = sht._geometry(NSIDE, "cpu")
    if name == "spin0":
        ops = _spectra(nb, 2, 5)
        got = (_spin0_model(*ops, geom, passes),)
        want = (wigner.analysis_spin0_folded_plain(
            *(F.to(torch.complex128) for F in ops), *geom, LMAX),)
    else:
        ops = _spectra(nb, 4, 6)
        got = _pair_model(*ops, geom, passes)
        want = wigner.analysis_pair_folded_plain(
            *(F.to(torch.complex128) for F in ops), *geom, LMAX, SPIN)
    return got, want


@pytest.mark.parametrize("nb", [2, 4])
@pytest.mark.parametrize("name", ["spin0", "pair"])
def test_3xtf32_contraction_passes_the_float32_bar(name, nb):
    got, want = _case(name, nb, passes=3)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        _close(g, w)


@pytest.mark.parametrize("name", ["spin0", "pair"])
def test_1xtf32_contraction_fails_the_float32_bar(name):
    got, want = _case(name, 2, passes=1)
    with pytest.raises(AssertionError):
        for g, w in zip(got, want, strict=True):
            _close(g, w)


# -- the order of the warp-specialised B1 body (float32 and comp groups) ------

# 600 rings: two tiles of 512 (the second ragged), 8 producer slices of 64
# rings a tile, 8 k-steps of 8 rings a slice
WS_NSIDE, WS_LMAX = 300, 40


def _ws_tiles(a, b, dim, passes, one_chain):
    """The contraction over ``dim`` of float32 ``a`` and ``b`` in the card's
    order for the warp-specialised body, one sum per ring tile of 512
    (moved to the last axis): each mma sums its k-step's 8 products (here
    in float32) into a chain; per producer slice of 64 rings either two
    chains over the 8 k-steps, (lo hi, hi lo) and hi hi, added at the end
    (one column tile of maps), or one chain taking lo hi, hi lo and hi hi
    in turn (two column tiles); the 8 slices' sums added in order.
    ``passes=1``: the hi hi chain alone."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    terms = [ah * bh] if passes == 1 else [al * bh, ah * bl, ah * bh]
    terms = [t.movedim(dim, -1) for t in terms]
    rings = terms[0].shape[-1]
    pad = -rings % 512
    steps = [torch.nn.functional.pad(t, (0, pad)).unflatten(-1, (-1, 8, 8, 8))
             .sum(-1) for t in terms]  # (..., tile, slice, k-step)
    zero = torch.zeros_like(steps[0][..., 0])
    if passes == 1:
        acc = zero
        for k in range(8):
            acc = acc + steps[0][..., k]
    elif one_chain:
        acc = zero
        for k in range(8):
            for t in steps:
                acc = acc + t[..., k]
    else:
        small, big = zero, zero
        for k in range(8):
            small = (small + steps[0][..., k]) + steps[1][..., k]
            big = big + steps[2][..., k]
        acc = small + big
    out = torch.zeros_like(acc[..., 0])
    for v in range(8):
        out = out + acc[..., v]
    return out  # (..., tile)


def _spin0_ws_model(Fe, Fo, geom, passes, one_chain):
    """The spin-0 group's contraction in the warp-specialised body's order:
    each multipole's rows of its parity against the emitted values, a tile
    of 512 rings at a time, each tile's sum times the norm added to the
    earlier tiles' as the flush does."""
    lam = _lam(0, *geom, lmax=WS_LMAX)
    ells = torch.arange(WS_LMAX + 1)
    F = torch.where((ells % 2 == 0)[None, :, None, None, None],
                    torch.view_as_real(Fe)[:, None],
                    torch.view_as_real(Fo)[:, None])  # (nb, l, ring, m, 2)
    tiles = _ws_tiles(lam[None, ..., None], F, 2, passes, one_chain)
    norm = _norm(WS_LMAX)[..., None]
    out = torch.zeros_like(tiles[..., 0])
    for i in range(tiles.shape[-1]):
        out = out + tiles[..., i] * norm
    return torch.view_as_complex(out.contiguous())


def _ws_case(passes, one_chain):
    geom = sht._geometry(WS_NSIDE, "cpu")
    ops = _spectra(2, 2, 7, nside=WS_NSIDE, lmax=WS_LMAX)
    got = _spin0_ws_model(*ops, geom, passes, one_chain)
    want = wigner.analysis_spin0_folded_plain(
        *(F.to(torch.complex128) for F in ops), *geom, WS_LMAX)
    return got, want


@pytest.mark.parametrize("one_chain", [False, True],
                         ids=["two-chains", "one-chain"])
def test_ws_order_passes_the_float32_bar(one_chain):
    got, want = _ws_case(3, one_chain)
    assert got.shape == want.shape
    _close(got, want)


def test_ws_order_1xtf32_fails_the_float32_bar():
    got, want = _ws_case(1, False)
    with pytest.raises(AssertionError):
        _close(got, want)
