"""Batched Fourier analysis over HEALPix isolatitude rings, on torch.fft.

Counterpart of :mod:`heracles_tpu.ops.ringfft`, both directions.
HEALPix rings are ragged (ring *i* has ``nph = 4i`` pixels in the caps
and ``4*nside`` in the belt), so:

* the equatorial belt (2/3 of all pixels, every ring ``nph = 4*nside``)
  is one reshape and one batched FFT;
* polar-cap rings are grouped into buckets of similar transform length
  (:func:`ring_plan`), and each bucket is one batched Bluestein chirp-z
  transform at a common power-of-two length, whose modulus is the ring
  length and whose output extent is the order range, so orders m >= nph
  (aliased) come out directly.

Ring rows are extracted, and written back by the synthesis, by one index
operation per bucket whose index is built on the tensors' device.  Chirps
and phases are built in float64 and rounded to the working type.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["ring_analysis", "ring_synthesis", "ring_plan"]

_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128,
            torch.complex64: torch.complex64,
            torch.complex128: torch.complex128}


def _next_pow2(n):
    return 1 << max(0, int(math.ceil(math.log2(max(1, n)))))


@functools.lru_cache(maxsize=32)
def ring_plan(nside, mext):
    """Host-side static plan of ring buckets for a given nside.

    Returns a tuple of bucket dicts, in north-to-south ring order, each
    with ``rings`` and ``pix`` (start, stop) ranges, ``nph`` and ``phi0``
    arrays, the common FFT length ``L`` and ``belt``.  Cap rings are
    bucketed by the Bluestein length they need for ``mext`` harmonic
    orders, ``next_pow2(nph + mext + 1)``; south buckets mirror north.
    """
    nside, mext = int(nside), int(mext)
    nr = 4 * nside - 1
    i = np.arange(1, nr + 1)
    nph = np.where(
        i < nside, 4 * i, np.where(i <= 3 * nside, 4 * nside, 4 * (4 * nside - i))
    ).astype(np.int64)
    start = np.concatenate([[0], np.cumsum(nph)[:-1]])
    phi0 = np.empty(nr)
    north = i < nside
    south = i > 3 * nside
    eq = ~(north | south)
    phi0[north] = np.pi / nph[north]
    phi0[south] = np.pi / nph[south]
    phi0[eq] = np.where((i[eq] - nside) % 2 == 0, np.pi / (4 * nside), 0.0)

    buckets = []

    def add_bucket(r0, r1, belt):
        n_max = int(nph[r0:r1].max())
        buckets.append(
            {
                "rings": (int(r0), int(r1)),
                "pix": (int(start[r0]), int(start[r1 - 1] + nph[r1 - 1])),
                "nph": nph[r0:r1].copy(),
                "phi0": phi0[r0:r1].copy(),
                "L": 4 * nside if belt else _next_pow2(n_max + mext + 1),
                "belt": bool(belt),
            }
        )

    r = 0
    while r < nside - 1:
        g = _next_pow2(int(nph[r]) + mext + 1) - mext - 1
        r1 = r
        while r1 < nside - 1 and nph[r1] <= g:
            r1 += 1
        add_bucket(r, r1, belt=False)
        r = r1
    n_north = len(buckets)
    add_bucket(nside - 1, 3 * nside, belt=True)
    for b in range(n_north - 1, -1, -1):
        nr0, nr1 = buckets[b]["rings"]
        add_bucket(nr - nr1, nr - nr0, belt=False)
    return tuple(buckets)


def _chirp(q, nph, sign, cdt):
    """exp(sign * i pi q^2 / nph) for int64 q >= 0 (q^2 reduced mod 2 nph)."""
    ang = math.pi * ((q * q) % (2 * nph)).to(torch.float64) / nph
    return torch.polar(torch.ones_like(ang), sign * ang).to(cdt)


def _bluestein_dft(vals, nph, L, *, sign, out_extent):
    """Per-row chirp transform with per-row modulus ``nph``.

    ``vals``: (..., R, L) complex, zero beyond each row's data extent;
    ``nph``: (R,) int64 tensor.  Entry k < ``out_extent`` of the result
    holds sum_p vals[r, p] exp(sign 2 pi i k p / nph[r]), provided
    L >= data extent + out_extent - 1.
    """
    dev = vals.device
    nphc = nph[:, None]
    p = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    # e^{s 2 pi i k p / n} = w_k w_p b_{k-p}, w_x = e^{s i pi x^2 / n},
    # b_j = e^{-s i pi j^2 / n}; negative offsets j = idx - L (b is even)
    w = _chirp(p, nphc, sign, vals.dtype)
    j = torch.where(p < out_extent, p, L - p)
    fftb = torch.fft.fft(_chirp(j, nphc, -sign, vals.dtype), dim=-1)
    conv = torch.fft.ifft(torch.fft.fft(vals * w, dim=-1) * fftb, dim=-1)
    return conv * w


def _cap_rows(maps, pix0, nph, L):
    """Rings of a cap bucket from the flat pixel axis, zero-padded to L.

    ``nph``: (R,) int64 tensor of ring lengths; the rings are contiguous
    from pixel ``pix0``.  The row indices are built on the maps' device.
    """
    nmax = int(nph.max())
    starts = pix0 + torch.cumsum(nph, 0) - nph
    p = torch.arange(nmax, device=maps.device)
    inside = p < nph[:, None]
    idx = torch.where(inside, starts[:, None] + p, 0)
    rows = torch.where(inside, maps[..., idx], 0)
    out = rows.new_zeros(rows.shape[:-1] + (L,))
    out[..., :nmax] = rows
    return out


def ring_analysis(maps, nside, nm, *, weight=None):
    """Per-ring Fourier coefficients F[..., r, m] = sum_p v_p e^{-i m phi_p}.

    ``maps``: (..., npix) real or complex tensor, RING ordering; orders
    m = 0..nm-1.  ``weight``: optional (nrings,) real per-ring factor (the
    quadrature weights) folded into the phase.  Returns ``(F, Fneg)``
    complex (..., nrings, nm); ``Fneg`` (the orders -m) is None for real
    input, where F_{-m} = conj(F_m).
    """
    complex_in = maps.is_complex()
    cdt = _COMPLEX[maps.dtype]
    dev = maps.device
    plan = ring_plan(nside, nm)
    m = torch.arange(nm, dtype=torch.float64, device=dev)[None, :]
    w = None if weight is None else torch.as_tensor(
        weight, dtype=torch.float64, device=dev)

    out_pos, out_neg = [], []
    for b in plan:
        L = b["L"]
        r0, r1 = b["rings"]
        phi0 = torch.as_tensor(b["phi0"], device=dev)[:, None]
        phase = torch.polar(torch.ones_like(m * phi0), -m * phi0)
        if w is not None:
            phase = phase * w[r0:r1, None]
        phase = phase.to(cdt)
        if b["belt"]:
            p0, p1 = b["pix"]
            rows = maps[..., p0:p1].reshape(maps.shape[:-1] + (r1 - r0, L))
            if not complex_in and nm <= L // 2 + 1:
                # real input: the half spectrum covers every order
                out_pos.append(torch.fft.rfft(rows, dim=-1)[..., :nm] * phase)
                continue
            C = torch.fft.fft(rows.to(cdt), dim=-1)
            # orders beyond the ring length alias (m mod nph)
            k = torch.remainder(torch.arange(nm, device=dev), L)
            out_pos.append(C[..., k] * phase)
            if complex_in:
                out_neg.append(C[..., torch.remainder(-k, L)] * phase.conj())
            continue
        nph = torch.as_tensor(b["nph"], device=dev)
        rows = _cap_rows(maps, b["pix"][0], nph, L).to(cdt)
        C = _bluestein_dft(rows, nph, L, sign=-1, out_extent=nm)
        out_pos.append(C[..., :nm] * phase)
        if complex_in:
            Cn = _bluestein_dft(rows, nph, L, sign=+1, out_extent=nm)
            out_neg.append(Cn[..., :nm] * phase.conj())
    F = torch.cat(out_pos, dim=-2)
    if complex_in:
        return F, torch.cat(out_neg, dim=-2)
    return F, None


def _ring_pixels(nph, npix, L):
    """Flat index into (R, L) padded rows of each pixel of R contiguous rings.

    ``nph``: (R,) int64 tensor of ring lengths summing to ``npix``; the
    index is built on its device, in pixel order.
    """
    dev = nph.device
    row = torch.repeat_interleave(torch.arange(nph.numel(), device=dev), nph,
                                  output_size=npix)
    start = torch.cumsum(nph, 0) - nph
    return row * L + torch.arange(npix, device=dev) - start[row]


def _fold_orders(h, L):
    """(..., nm) -> (..., L): orders summed by their residue m mod L."""
    nm = h.shape[-1]
    q = -(-nm // L)
    pad = h.new_zeros(h.shape[:-1] + (q * L - nm,))
    return torch.cat([h, pad], dim=-1).reshape(h.shape[:-1] + (q, L)).sum(-2)


def ring_synthesis(h_pos, h_neg, nside, *, real_output=True):
    """Inverse of :func:`ring_analysis`: evaluate per-ring Fourier series.

    v_p = sum_{m=0}^{nm-1} h_pos[..., r, m] e^{+i m phi_p}
        + sum_{m=1}^{nm-1} h_neg[..., r, m] e^{-i m phi_p}

    ``h_pos``/``h_neg``: (..., nrings, nm) complex; ``h_neg=None`` stands
    for conj(h_pos) (a real map).  Returns (..., npix) maps, real if
    ``real_output``.  The belt is one batched inverse FFT; cap rings
    evaluate the +-m series with chirp transforms whose modulus is the ring
    length, so orders m >= nph alias exactly.
    """
    nm = h_pos.shape[-1]
    cdt = h_pos.dtype
    dev = h_pos.device
    plan = ring_plan(nside, nm)
    m = torch.arange(nm, dtype=torch.float64, device=dev)[None, :]
    pieces = []
    for b in plan:
        L = b["L"]
        r0, r1 = b["rings"]
        phi0 = torch.as_tensor(b["phi0"], device=dev)[:, None]
        phase = torch.polar(torch.ones_like(m * phi0), m * phi0).to(cdt)
        hp = h_pos[..., r0:r1, :] * phase
        if h_neg is None:
            hn = hp.conj()
        else:
            hn = h_neg[..., r0:r1, :] * phase.conj()
        # m = 0 enters once, through h_pos
        hn = torch.cat([torch.zeros_like(hn[..., :1]), hn[..., 1:]], dim=-1)
        if b["belt"]:
            if 2 * nm - 1 <= L:
                # no aliasing: the frequency rows by concatenation
                zeros = hp.new_zeros(hp.shape[:-1] + (L - 2 * nm + 1,))
                d = torch.cat([hp, zeros, torch.flip(hn[..., 1:], dims=(-1,))],
                              dim=-1)
            else:
                # orders beyond the ring length alias: +m lands on m mod L,
                # -m on -m mod L
                fn = _fold_orders(hn, L)
                d = _fold_orders(hp, L) + torch.roll(torch.flip(fn, dims=(-1,)),
                                                     1, dims=-1)
            v = torch.fft.ifft(d, dim=-1) * L
            if real_output:
                v = v.real
            pieces.append(v.reshape(v.shape[:-2] + ((r1 - r0) * L,)))
            continue
        nph = torch.as_tensor(b["nph"], device=dev)
        nmax = int(b["nph"].max())
        pad = hp.new_zeros(hp.shape[:-1] + (L - nm,))
        if h_neg is None:
            # v = h_0 + 2 Re B+(h, m > 0)
            hp_pos = torch.cat([torch.zeros_like(hp[..., :1]), hp[..., 1:], pad],
                               dim=-1)
            vb = 2.0 * _bluestein_dft(hp_pos, nph, L, sign=+1,
                                      out_extent=nmax).real
            v = vb + (hp[..., :1].real if real_output else hp[..., :1])
        else:
            v = (_bluestein_dft(torch.cat([hp, pad], dim=-1), nph, L, sign=+1,
                                out_extent=nmax)
                 + _bluestein_dft(torch.cat([hn, pad], dim=-1), nph, L,
                                  sign=-1, out_extent=nmax))
            if real_output:
                v = v.real
        p0, p1 = b["pix"]
        flat = v.reshape(v.shape[:-2] + (-1,))
        pieces.append(flat[..., _ring_pixels(nph, p1 - p0, L)])
    return torch.cat(pieces, dim=-1)
