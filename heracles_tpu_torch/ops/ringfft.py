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

The tensor's device picks the analysis' path.  On a CUDA card,
:func:`ring_analysis` runs the hand-written kernels of
``heracles_tpu_torch/csrc/ringfft.cu`` around cuFFT (``torch.fft``): the
cap rows read straight from the maps and chirped, the product with each
bucket's cached chirp spectrum, and the orders' chirp, phase and weight
written straight into F.  What depends only on the sizes (the rings'
starts, lengths and phi0, the chirp spectra) is built once per (nside,
order extent, dtype, card) and kept there (:func:`_card_plan`), so a
warm call uploads and rebuilds nothing.  ``LAUNCHES`` counts the kernels'
launches by kernel.  On the CPU it runs :func:`ring_analysis_plain`, which
builds every table in the call, in float64, and rounds it to the working
type; the kernels repeat its arithmetic in the same order.  The synthesis
is plain torch on every device.

Ring rows are written back by the synthesis by one index operation per
bucket whose index is built on the tensors' device.  The plan's host
arrays go to the card without waiting for the work queued there
(:func:`_upload`), and nothing is read back, so a transform queues its
work without waiting on the card (the loop over a device mesh's shards
relies on it).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import tracing

__all__ = ["LAUNCHES", "ring_analysis", "ring_analysis_plain",
           "ring_synthesis", "ring_plan"]

LAUNCHES = tracing.counter("ringfft.LAUNCHES")

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


def _upload(site, a, device, dtype=None):
    """Host array ``a`` on ``device``, a host copy counted at ``site``.
    Pageable host memory is staged at once, so the copy need not wait for
    the work queued on the card."""
    tracing.copied(site, "h2d", device)
    return torch.as_tensor(a, dtype=dtype).to(device, non_blocking=True)


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
    tracing.built("ringfft.chirp")
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


def _cap_rows(maps, pix0, nph, nmax, L):
    """Rings of a cap bucket from the flat pixel axis, zero-padded to L.

    ``nph``: (R,) int64 tensor of ring lengths, ``nmax`` the largest (an
    int); the rings are contiguous from pixel ``pix0``.  The row indices
    are built on the maps' device.
    """
    tracing.built("ringfft.cap_rows")
    starts = pix0 + torch.cumsum(nph, 0) - nph
    p = torch.arange(nmax, device=maps.device)
    inside = p < nph[:, None]
    idx = torch.where(inside, starts[:, None] + p, 0)
    rows = torch.where(inside, maps[..., idx], 0)
    out = rows.new_zeros(rows.shape[:-1] + (L,))
    out[..., :nmax] = rows
    return out


@tracing.spanned("ringfft.ring_analysis")
def ring_analysis(maps, nside, nm, *, weight=None, m0=0):
    """Per-ring Fourier coefficients F[..., r, m] = sum_p v_p e^{-i m phi_p}.

    ``maps``: (..., npix) real or complex tensor, RING ordering; orders
    m = m0..m0+nm-1 (a device mesh's block of orders).  The block is
    sliced out of the transform of the orders 0..m0+nm-1 (its FFTs and
    its ring plan are those of m0 + nm orders, and the phases are taken
    per order), so its columns are that transform's, bit for bit.
    ``weight``: optional (nrings,) real per-ring factor (the quadrature
    weights) folded into the phase; on a card, a float64 tensor already
    there is read in place, anything else is uploaded in the call.
    Returns ``(F, Fneg)`` complex (..., nrings, nm); ``Fneg`` (the orders
    -m) is None for real input, where F_{-m} = conj(F_m).

    A CPU tensor runs :func:`ring_analysis_plain`; a CUDA tensor the
    kernels of ``csrc/ringfft.cu`` around cuFFT, or raises.
    """
    m0, nm = int(m0), int(nm)
    if m0 < 0 or nm < 0:
        raise ValueError(f"ring_analysis: orders m0={m0}, nm={nm}")
    if maps.shape[-1] != 12 * int(nside) ** 2:
        raise ValueError(f"ring_analysis: {maps.shape[-1]} pixels are not "
                         f"a map of nside {nside}")
    if maps.device.type == "cpu":
        return ring_analysis_plain(maps, nside, nm, weight=weight, m0=m0)
    return _ring_analysis_card(maps, int(nside), nm, weight, m0)


def ring_analysis_plain(maps, nside, nm, *, weight=None, m0=0):
    """:func:`ring_analysis` in torch ops on any device, every table built
    in the call: the plain version of the kernels, which repeat its
    arithmetic."""
    complex_in = maps.is_complex()
    cdt = _COMPLEX[maps.dtype]
    dev = maps.device
    m0, nm = int(m0), int(nm)
    mext = m0 + nm
    plan = ring_plan(nside, mext)
    m = torch.arange(m0, mext, dtype=torch.float64, device=dev)[None, :]
    site = "ringfft.ring_analysis"
    w = None
    if weight is not None:
        tracing.built("ringfft.weights")
        w = _upload(site, weight, dev, torch.float64)

    out_pos, out_neg = [], []
    for b in plan:
        L = b["L"]
        r0, r1 = b["rings"]
        tracing.built("ringfft.phase")
        phi0 = _upload(site, b["phi0"], dev)[:, None]
        phase = torch.polar(torch.ones_like(m * phi0), -m * phi0)
        if w is not None:
            phase = phase * w[r0:r1, None]
        phase = phase.to(cdt)
        if b["belt"]:
            p0, p1 = b["pix"]
            rows = maps[..., p0:p1].reshape(maps.shape[:-1] + (r1 - r0, L))
            if not complex_in and mext <= L // 2 + 1:
                # real input: the half spectrum covers every order
                out_pos.append(torch.fft.rfft(rows, dim=-1)[..., m0:mext]
                               * phase)
                continue
            C = torch.fft.fft(rows.to(cdt), dim=-1)
            # orders beyond the ring length alias (m mod nph)
            k = torch.remainder(torch.arange(m0, mext, device=dev), L)
            out_pos.append(C[..., k] * phase)
            if complex_in:
                out_neg.append(C[..., torch.remainder(-k, L)] * phase.conj())
            continue
        nph = _upload(site, b["nph"], dev)
        rows = _cap_rows(maps, b["pix"][0], nph, int(b["nph"].max()),
                         L).to(cdt)
        C = _bluestein_dft(rows, nph, L, sign=-1, out_extent=mext)
        out_pos.append(C[..., m0:mext] * phase)
        if complex_in:
            Cn = _bluestein_dft(rows, nph, L, sign=+1, out_extent=mext)
            out_neg.append(Cn[..., m0:mext] * phase.conj())
    F = torch.cat(out_pos, dim=-2)
    if complex_in:
        return F, torch.cat(out_neg, dim=-2)
    return F, None


# orders kernel's source rows (csrc/ringfft.cu): a cap's inverse FFT, the
# belt's c2c spectrum, the belt's r2c half spectrum
_CAP, _BELT_FULL, _BELT_HALF = 0, 1, 2


@functools.lru_cache(maxsize=8)
def _card_plan(nside, mext, cdt, device):
    """What an analysis of ``mext`` orders in ``cdt`` needs that depends
    only on the sizes, built once and kept on ``device``: every ring's
    pixel start (int64), length (int32) and phi0 (float64); per cap
    bucket pair (a north bucket and its southern mirror, which has the
    same rings reversed and the same L) its rings and the FFT, scaled by
    1/L, of the chirp b of each northern ring in ``cdt``, as
    :func:`_bluestein_dft` builds it; the belt's rings and pixels.

    An LRU of 8 over every card of the process: a device mesh's order
    blocks each have their own ``mext``, so a mesh of 4 blocks and the
    unsharded transform of each of its cards fit.  Chirp spectra at
    nside 4096 in complex64: 0.54 GB for 3001 orders, 0.38-0.55 GB a
    block of a mesh."""
    tracing.built("ringfft.plan")
    site = "ringfft.plan"
    plan = ring_plan(nside, mext)
    nph = np.concatenate([b["nph"] for b in plan])
    start = np.concatenate([[0], np.cumsum(nph)[:-1]])
    card = dict(
        nph=_upload(site, nph.astype(np.int32), device),
        start=_upload(site, start.astype(np.int64), device),
        phi0=_upload(site, np.concatenate([b["phi0"] for b in plan]),
                     device),
        caps=[])
    n_north = (len(plan) - 1) // 2
    for north, south in zip(plan[:n_north], plan[::-1]):
        L = north["L"]
        r0, r1 = north["rings"]
        p = torch.arange(L, dtype=torch.int64, device=device)[None, :]
        j = torch.where(p < mext, p, L - p)
        b = _chirp(j, card["nph"][r0:r1, None].to(torch.int64), +1, cdt)
        card["caps"].append(dict(
            L=L, R=r1 - r0, rn0=r0, rs0=south["rings"][0],
            table=torch.fft.fft(b, dim=-1, norm="forward")))
    belt = plan[n_north]
    card["belt"] = dict(L=belt["L"], rings=belt["rings"], pix=belt["pix"])
    return card


def _card_weight(weight, nr, device):
    """The per-ring weights as a float64 tensor on ``device``: read in
    place when they lie there, else uploaded (and counted) here."""
    if isinstance(weight, torch.Tensor) and weight.device == device:
        w = weight.to(torch.float64)
    else:
        tracing.built("ringfft.weights")
        w = _upload("ringfft.ring_analysis", weight, device, torch.float64)
    if tuple(w.shape) != (nr,):
        raise ValueError(f"ring_analysis: weight must have shape ({nr},), "
                         f"got {tuple(w.shape)}")
    return w.contiguous()


def _ring_analysis_card(maps, nside, nm, weight, m0):
    """:func:`ring_analysis` on a CUDA tensor: per cap bucket pair the rows
    kernel, cuFFT forward, the spectrum kernel, cuFFT inverse and the
    orders kernel; the belt's FFT and the orders kernel (module
    docstring; ``csrc/ringfft.cu``)."""
    from . import _build

    kl = _build.load_library()
    complex_in = maps.is_complex()
    cdt = _COMPLEX[maps.dtype]
    dev = maps.device
    card = _card_plan(nside, m0 + nm, cdt, dev)
    nr = card["nph"].shape[0]
    batch, npix = maps.shape[:-1], maps.shape[-1]
    B = math.prod(batch)
    flat = maps.reshape(B, npix).contiguous()
    w = None if weight is None else _card_weight(weight, nr, dev)
    F = torch.empty((B, nr, nm), dtype=cdt, device=dev)
    Fneg = torch.empty_like(F) if complex_in else None
    dirs = 2 if complex_in else 1
    prec = "f64" if cdt == torch.complex128 else "f32"
    rows_fn = getattr(kl.lib, f"heracles_ring_rows_{prec}")
    spectrum_fn = getattr(kl.lib, f"heracles_ring_spectrum_{prec}")
    orders_fn = getattr(kl.lib, f"heracles_ring_orders_{prec}")
    tables = (card["nph"].data_ptr(), card["phi0"].data_ptr(),
              None if w is None else w.data_ptr())
    outs = (F.data_ptr(), None if Fneg is None else Fneg.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for cap in card["caps"]:
            L, R, rn0, rs0 = cap["L"], cap["R"], cap["rn0"], cap["rs0"]
            rows = torch.empty((B, dirs, 2 * R, L), dtype=cdt, device=dev)
            kl.check(rows_fn(flat.data_ptr(), npix, card["start"].data_ptr(),
                             card["nph"].data_ptr(), rows.data_ptr(), L,
                             2 * R, R, rn0, rs0, dirs, B, int(complex_in),
                             stream))
            LAUNCHES["ring_rows"] += 1
            y = torch.fft.fft(rows, dim=-1)
            del rows
            kl.check(spectrum_fn(y.data_ptr(), cap["table"].data_ptr(), L,
                                 2 * R, R, dirs, B, stream))
            LAUNCHES["ring_spectrum"] += 1
            z = torch.fft.ifft(y, dim=-1, norm="forward")
            del y
            kl.check(orders_fn(z.data_ptr(), L, _CAP, L, *outs, nr, m0, nm,
                               2 * R, R, rn0, rs0, dirs, B, *tables, stream))
            LAUNCHES["ring_orders"] += 1
            del z
        belt = card["belt"]
        L, (r0, r1), (p0, p1) = belt["L"], belt["rings"], belt["pix"]
        rows = flat[:, p0:p1].reshape(B, r1 - r0, L)
        if complex_in:
            spec, mode = torch.fft.fft(rows, dim=-1), _BELT_FULL
        else:
            spec, mode = torch.fft.rfft(rows, dim=-1), _BELT_HALF
        spec = spec.contiguous()
        kl.check(orders_fn(spec.data_ptr(), spec.shape[-1], mode, L, *outs,
                           nr, m0, nm, r1 - r0, r1 - r0, r0, 0, 1, B,
                           *tables, stream))
        LAUNCHES["ring_orders"] += 1
    F = F.reshape(batch + (nr, nm))
    return F, (None if Fneg is None else Fneg.reshape(F.shape))


def _ring_pixels(nph, npix, L):
    """Flat index into (R, L) padded rows of each pixel of R contiguous rings.

    ``nph``: (R,) int64 tensor of ring lengths summing to ``npix``; the
    index is built on its device, in pixel order.
    """
    tracing.built("ringfft.ring_pixels")
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


@tracing.spanned("ringfft.ring_synthesis")
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
    site = "ringfft.ring_synthesis"
    pieces = []
    for b in plan:
        L = b["L"]
        r0, r1 = b["rings"]
        tracing.built("ringfft.phase")
        phi0 = _upload(site, b["phi0"], dev)[:, None]
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
        nph = _upload(site, b["nph"], dev)
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
