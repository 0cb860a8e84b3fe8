"""Plain spherical harmonic analysis of HEALPix RING maps, in torch.

The yardstick of the benchmark's ``correct``: written from the HEALPix
and Wigner-d formulas, independent of the program under test (it imports
torch and numpy only).  Everything runs in float64 on the device of the
maps, order by order in a vectorised recurrence over the multipole l:

* the ring layout from the HEALPix paper (Gorski et al. 2005, eqs. 4-9);
* per-ring Fourier sums F_m(r) = w_r sum_p f_p exp(-i m phi_p): the belt
  by FFTs, the cap rings by Bluestein's chirp transform (orders past the
  ring length alias);
* sY_lm(theta, phi) = slm(l, m, s)(theta) exp(i m phi) with
  slm = (-1)^m sqrt((2l + 1) / 4pi) d^l_{-m,-s}(theta) (the HEALPix
  convention), d from Wigner's formula at l = max(m, |s|) and the
  three-term recurrence in l above it; values are kept as a mantissa and
  a power of 2^-256 so that nothing underflows near the poles;
* the northern and southern rings folded by
  slm(l, m, s)(pi - theta) = (-1)^(l + m) slm(l, m, -s)(theta);
* spin 2: a_{+-2,lm} from Q +- iU, a_E = -(a_2 + a_-2) / 2,
  a_B = i (a_2 - a_-2) / 2.

``precision="tf32"`` is the control: the ring sums take their two factors
rounded to TF32 (10 mantissa bits) and add in float32, as a tensor-core
contraction in TF32 would; everything else stays float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F64 = torch.float64
# mantissas are kept in [2^-SCALE_BITS, 2^(SCALE_BITS/2)) times a power
# 2^(-SCALE_BITS k); a rescale is looked for every RESCALE_EVERY steps
SCALE_BITS = 256
RESCALE_EVERY = 4


def ring_layout(nside):
    """(nph, start, z, sin theta, phi0) of the 4 nside - 1 rings, north to
    south, host numpy (float64 and int64)."""
    n = int(nside)
    i = np.arange(1, 4 * n)
    nph = np.where(i < n, 4 * i, np.where(i <= 3 * n, 4 * n, 4 * (4 * n - i)))
    start = np.concatenate([[0], np.cumsum(nph)[:-1]])
    # distance to the nearer pole in rings, and 1 - |z| in the caps
    ic = np.minimum(i, 4 * n - i)
    cap = ic < n
    one_minus = ic.astype(np.float64) ** 2 / (3.0 * n * n)
    hemi = np.where(i <= 2 * n, 1.0, -1.0)
    z = np.where(cap, hemi * (1.0 - one_minus), 4.0 / 3.0 - 2.0 * i / (3.0 * n))
    sin_theta = np.where(cap, np.sqrt(one_minus * (2.0 - one_minus)),
                         np.sqrt((1.0 - z) * (1.0 + z)))
    # first pixel's azimuth: caps (j - 1/2) pi / (2 i), belt shifted by half
    # a pixel on rings where i + nside is even
    belt_half = ((i + n) % 2 == 0)
    phi0 = np.where(cap, np.pi / (4.0 * ic),
                    np.where(belt_half, np.pi / (4.0 * n), 0.0))
    return nph.astype(np.int64), start.astype(np.int64), z, sin_theta, phi0


def tf32(t):
    """``t`` (float32) rounded to TF32: 10 mantissa bits, to nearest even."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _chirp(q, n, sign):
    """exp(sign i pi q^2 / n) for int64 q >= 0, q^2 reduced mod 2n first."""
    ang = math.pi * ((q * q) % (2 * n)).to(F64) / n
    return torch.polar(torch.ones_like(ang), sign * ang)


def chirp_dft(rows, n, M):
    """X[..., r, k] = sum_j rows[..., r, j] exp(-2 pi i j k / n[r]) for
    k < M (orders past n[r] alias), by Bluestein's identity
    jk = (j^2 + k^2 - (k - j)^2) / 2 as one circular convolution of the
    padded length L = rows.shape[-1] >= max(n) + M - 1.  ``rows``: complex128,
    zero past each row's n; ``n``: (R,) int64 tensor."""
    L = rows.shape[-1]
    t = torch.arange(L, device=rows.device)[None, :]
    nn = n[:, None]
    w = _chirp(t, nn, -1.0)
    u = torch.where(t < M, t, L - t)
    conv = torch.fft.ifft(torch.fft.fft(rows * w, dim=-1)
                          * torch.fft.fft(_chirp(u, nn, 1.0), dim=-1), dim=-1)
    return conv[..., :M] * w[:, :M]


def ring_sums(maps, nside, mmax, weights):
    """Per-ring Fourier sums: (F, Fneg), each (B, nrings, mmax + 1) complex128.

    ``maps``: (B, npix) real or complex tensor; F[b, r, m] = w_r sum_p
    f_p exp(-i m phi_p), Fneg the same at -m (None for real maps).  The
    belt's rings (all of length 4 nside) take one FFT; the cap rings go
    through :func:`chirp_dft` in buckets of one padded power-of-two length.
    """
    nph, start, _, _, phi0 = ring_layout(nside)
    dev = maps.device
    nr = nph.size
    nb = maps.shape[0]
    M = mmax + 1
    m = torch.arange(M, device=dev)
    w = torch.as_tensor(np.asarray(weights, np.float64), device=dev)
    F = torch.empty((nb, nr, M), dtype=torch.complex128, device=dev)
    Fn = torch.empty_like(F) if maps.is_complex() else None
    cdt = torch.complex128
    belt = np.flatnonzero(nph == 4 * nside)
    caps = np.flatnonzero(nph < 4 * nside)
    buckets = {}
    for r in caps:
        L = 1 << int(math.ceil(math.log2(int(nph[r]) + M - 1)))
        buckets.setdefault(L, []).append(int(r))
    groups = [(4 * nside, belt.tolist())] + sorted(buckets.items())
    for L, rings in groups:
        # rings in chunks of about 2^26 complex elements
        step = max(1, (1 << 26) // (nb * L))
        for c0 in range(0, len(rings), step):
            chunk = np.asarray(rings[c0:c0 + step])
            n_np = nph[chunk]
            n = torch.as_tensor(n_np, device=dev)
            p = torch.arange(int(n_np.max()), device=dev)[None, :]
            inside = p < n[:, None]
            idx = torch.where(inside, torch.as_tensor(start[chunk], device=dev)[:, None] + p, 0)
            rows = torch.where(inside, maps[:, idx], 0).to(cdt)
            if L > rows.shape[-1]:
                rows = torch.nn.functional.pad(rows, (0, L - rows.shape[-1]))
            ph0 = torch.as_tensor(phi0[chunk], device=dev)[:, None]
            ang = -m.to(F64)[None, :] * ph0
            phase = torch.polar(w[chunk][:, None].expand_as(ang).contiguous(),
                                ang)
            idx_r = torch.as_tensor(chunk, device=dev)
            if L == 4 * nside and n_np.min() == L:  # the belt: plain FFTs
                C = torch.fft.fft(rows, dim=-1)
                F[:, idx_r] = C[..., m % L] * phase
                if Fn is not None:
                    Fn[:, idx_r] = C[..., (-m) % L] * phase.conj()
                continue
            F[:, idx_r] = chirp_dft(rows, n, M) * phase
            if Fn is not None:
                Fn[:, idx_r] = chirp_dft(rows.conj(), n, M).conj() * phase.conj()
    return F, Fn


def _log_factorial(n):
    return math.lgamma(n + 1.0)


def _seed(ms, s, lc, ls):
    """Wigner's formula at l = j0 = max(m, |s|) for d^l_{-m,-s}: (j0, sign,
    log value (M, R)) with the (-1)^m of slm included in the sign."""
    rows = []
    j0s, signs = [], []
    for m in ms.tolist():
        a, b = -int(m), -int(s)  # d^j_{a b}
        j = max(abs(a), abs(b))
        k = max(0, b - a)
        assert k <= min(j + b, j - a)
        logc = 0.5 * (_log_factorial(j + a) + _log_factorial(j - a)
                      + _log_factorial(j + b) + _log_factorial(j - b)) - (
            _log_factorial(j + b - k) + _log_factorial(k)
            + _log_factorial(a - b + k) + _log_factorial(j - a - k))
        pc = 2 * j + b - a - 2 * k
        ps = a - b + 2 * k
        sign = (-1.0) ** ((a - b + k) % 2) * (-1.0) ** (int(m) % 2)
        rows.append((logc, pc, ps))
        j0s.append(j)
        signs.append(sign)
    dev = lc.device
    c = torch.tensor(rows, dtype=F64, device=dev)
    pc, ps = c[:, 1:2], c[:, 2:3]
    logv = (c[:, :1] + torch.where(pc == 0, 0.0, pc * lc[None, :])
            + torch.where(ps == 0, 0.0, ps * ls[None, :]))
    return j0s, torch.tensor(signs, dtype=F64, device=dev), logv


def slm_rows(lmax, mmax, spins, theta_x, sin_half, cos_half):
    """Yield (l, rows): rows[i] is slm(l, m, spins[i]) at the points, for
    m = 0..min(l, mmax), as an (S, e, R) float64 tensor; nothing while
    l < |s|.

    ``theta_x``: (R,) cos(theta); ``sin_half``, ``cos_half``: sin and cos
    of theta / 2, all float64 tensors on one device.  Every spin in
    ``spins`` has the same |s|.
    """
    dev = theta_x.device
    S = len(spins)
    sabs = abs(int(spins[0]))
    if any(abs(int(s)) != sabs for s in spins):
        raise ValueError("slm_rows takes spins of one |s|")
    M = mmax + 1
    R = theta_x.shape[0]
    x = theta_x[None, None, :]
    lc, ls = torch.log(cos_half), torch.log(sin_half)
    ms = torch.arange(M, dtype=F64, device=dev)
    sv = torch.tensor([float(s) for s in spins], dtype=F64, device=dev)[:, None]
    Y1 = torch.zeros((S, M, R), dtype=F64, device=dev)
    Y2 = torch.zeros_like(Y1)
    K = torch.zeros((S, M, R), dtype=torch.int64, device=dev)
    big = 2.0 ** (SCALE_BITS // 2)
    down = torch.tensor(2.0 ** -SCALE_BITS, dtype=F64, device=dev)
    one = torch.tensor(1.0, dtype=F64, device=dev)
    ln_scale = SCALE_BITS * math.log(2.0)
    table = None
    for ell in range(lmax + 1):
        lf = float(ell)
        a = min(ell, M) if ell > sabs else 0
        if a:
            m = ms[:a][None, :]
            A = torch.sqrt((lf * lf - m * m) * (lf * lf - sv * sv))
            Ap = torch.sqrt(torch.clamp(((lf - 1) ** 2 - m * m)
                                        * ((lf - 1) ** 2 - sv * sv), min=0.0))
            c1 = (2 * lf - 1) * lf / A
            c2 = torch.where(Ap > 0, lf * Ap / (max(lf - 1, 1.0) * A), 0.0)
            y1, y2 = Y1[:, :a], Y2[:, :a]
            if sabs:
                c0 = m * sv / max(lf * (lf - 1), 1.0)
                t = (x - c0[..., None]) * y1
            else:
                t = x * y1
            t *= c1[..., None]
            y2 *= -c2[..., None]
            y2 += t
            if ell % RESCALE_EVERY == 0:
                over = y2.abs() > big
                f = torch.where(over, down, one)
                y2 *= f
                y1 *= f
                K[:, :a] -= over.to(torch.int64)
            Y1, Y2 = Y2, Y1
        # seeds of the rows whose recurrence starts at this l
        if ell == sabs:
            new = list(range(min(sabs, M - 1) + 1))
        elif ell > sabs and ell < M:
            new = [ell]
        else:
            new = []
        if new:
            idx = torch.tensor(new, device=dev)
            seeds = [_seed(idx, s, lc, ls) for s in spins]
            for i, (_, sign, logv) in enumerate(seeds):
                k = torch.clamp(torch.floor(-logv / ln_scale), min=0.0)
                Y1[i, new] = sign[:, None] * torch.exp(logv + k * ln_scale)
                Y2[i, new] = 0.0
                K[i, new] = k.to(torch.int64)
            kmax = int(K.max())
            if table is None or kmax >= table.numel():
                table = torch.tensor([2.0 ** (-SCALE_BITS * q)
                                      for q in range(kmax + 8)],
                                     dtype=F64, device=dev)
        if ell < sabs:
            continue
        e = min(ell, mmax) + 1
        norm = math.sqrt((2 * lf + 1) / (4 * math.pi))
        vals = Y1[:, :e] * table[K[:, :e]]
        vals *= norm
        yield ell, vals


def _contract(v, X, precision):
    """sum_r v[m, r] X[m, r, k]: (e, k)."""
    if precision == "tf32":
        out = torch.bmm(tf32(v.to(torch.float32))[:, None, :],
                        tf32(X.to(torch.float32)))
        return out[:, 0].to(F64)
    return torch.bmm(v[:, None, :], X)[:, 0]


def _folded(F, nside):
    """(north, southern mirror) of (B, nrings, M) ring sums as real
    (M, nhalf, 2B) float64 arrays; the equator's mirror row is zero."""
    nhalf = 2 * nside
    north = F[:, :nhalf]
    south = torch.flip(F[:, nhalf:], dims=(1,))
    south = torch.cat([south, torch.zeros_like(south[:, :1])], dim=1)

    def real(a):
        r = torch.view_as_real(a.resolve_conj())  # (B, nhalf, M, 2)
        return r.permute(2, 1, 0, 3).reshape(a.shape[2], nhalf, -1).contiguous()

    return real(north), real(south)


def _analysis(Fs, nside, lmax, mmax, spins, precision):
    """Folded analysis: rect alms (B, S, lmax + 1, M) complex128 of the
    spin columns ``spins`` from their (north, south) ring sums ``Fs``."""
    nph, start, z, sin_theta, _ = ring_layout(nside)
    nhalf = 2 * nside
    dev = Fs[0][0].device
    zt = torch.as_tensor(z[:nhalf], device=dev)
    # half-angle functions from the exact sin(theta) and z
    cos_half = torch.sqrt((1.0 + zt) / 2.0)
    sin_half = torch.as_tensor(sin_theta[:nhalf], device=dev) / (2.0 * cos_half)
    M = mmax + 1
    nb = Fs[0][0].shape[-1] // 2
    S = len(spins)
    out = torch.zeros((lmax + 1, S, M, nb, 2), dtype=F64, device=dev)
    msign = torch.where(torch.arange(M, device=dev) % 2 == 0, 1.0, -1.0).to(F64)
    for ell, vals in slm_rows(lmax, mmax, spins, zt, sin_half, cos_half):
        e = vals.shape[1]
        sigma = (msign[:e] * (-1.0) ** ell)[:, None]
        for i in range(S):
            # the southern rows take the partner column -s (index S-1-i)
            north = _contract(vals[i], Fs[i][0][:e], precision)
            south = _contract(vals[S - 1 - i], Fs[i][1][:e], precision)
            out[ell, i, :e] = (north + sigma * south).reshape(e, nb, 2)
    alm = torch.view_as_complex(out.contiguous())  # (L, S, M, B)
    return alm.permute(3, 1, 0, 2)


def map2alm(maps, nside, lmax, mmax=None, *, spin=0, weights,
            precision="f64"):
    """Analysis of RING maps with per-ring quadrature ``weights``.

    ``maps``: (B, npix) for spin 0, (B, 2, npix) [Q, U] for spin 2.
    Returns rectangular alms (B, lmax + 1, mmax + 1) complex128, or
    (B, 2, lmax + 1, mmax + 1) [E, B] for spin 2.
    """
    mmax = lmax if mmax is None else int(mmax)
    if precision not in ("f64", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    if spin == 0:
        F, _ = ring_sums(maps, nside, mmax, weights)
        folded = [_folded(F, nside)]
        del F
        alm = _analysis(folded, nside, lmax, mmax, (0,), precision)
        return alm[:, 0]
    u = torch.complex(maps[:, 0].to(F64), maps[:, 1].to(F64))
    F, Fneg = ring_sums(u, nside, mmax, weights)
    del u
    folded = [_folded(F, nside), _folded(Fneg.conj(), nside)]
    del F, Fneg
    alm = _analysis(folded, nside, lmax, mmax, (spin, -spin), precision)
    a_p, a_m = alm[:, 0], alm[:, 1]
    return torch.stack([-(a_p + a_m) / 2, 1j * (a_p - a_m) / 2], dim=1)


# multipoles per band of the compared numbers' normalisation
BAND = 32


def band_mean(c, width=BAND):
    """``c`` (..., L) with each l replaced by the mean over its band of
    ``width`` multipoles (l // width): a spectrum's power without the
    scatter of the few modes at each low l."""
    c = np.asarray(c, np.float64)
    out = np.empty_like(c)
    for b0 in range(0, c.shape[-1], width):
        out[..., b0:b0 + width] = c[..., b0:b0 + width].mean(-1, keepdims=True)
    return out


def spectra(a, b):
    """Cross-spectrum of two rect alm arrays (..., L, M): float64 (..., L)."""
    L, M = a.shape[-2:]
    eps = torch.ones(M, dtype=F64, device=a.device) * 2.0
    eps[0] = 1.0
    ell = torch.arange(L, dtype=F64, device=a.device)
    s = (a.real * b.real + a.imag * b.imag) * eps
    return s.sum(-1) / (2 * ell + 1)
