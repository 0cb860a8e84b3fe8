"""The least time of a step's Wigner SHT work on one H100: the yardstick of
``sht_roofline``.

From ``chip_smoke.py``'s ``sht_triples`` and ``sht_bound`` (commit
bacb88b), corrected so that the count depends on the work the inputs
need and not on how a kernel groups it:

* per spin kind and step, the folded (ring, l, m) triples: the rings of
  one hemisphere (equator included) times the (l, m) with
  max(m, |s|) <= l <= lmax, m <= mmax;
* the Wigner recurrence once per step for all the maps of that spin
  (``FLOP_SHARED``: 5 FP32 operations a triple at spin 0, 11 for a spin
  pair), at the FP32 peak;
* the products once per map (``FLOP_PER_TRIPLE - FLOP_SHARED``: 4 a
  triple at spin 0, 16 for a pair), counted once at the TF32 tensor-core
  peak, the fastest unit that can take them;
* each map's folded ring coefficients read once and its alms written
  once, float32 (complex64), at the HBM3 bandwidth.

The least time is the largest of the three; a kernel's measured time can
only be longer, so the share never passes 100%.  Peaks: NVIDIA H100 SXM
data sheet, dense, at its 700 W power limit.
"""

from __future__ import annotations

FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
HBM_BYTES_PER_S = 3.35e12
# FP32 operations per folded triple, by spin kind (0: spin 0, 2: a +-2
# pair): all of them, and those of the recurrence and its emit
FLOP_PER_TRIPLE = {0: 9, 2: 27}
FLOP_SHARED = {0: 5, 2: 11}
COMPLEX64_BYTES = 8


def triples(nside, lmax, mmax, spin):
    """Folded (ring, l, m) triples of one analysis: 2 nside rings times
    the (l, m) pairs with l >= max(m, |spin|)."""
    pairs = sum(max(0, lmax + 1 - max(m, abs(spin))) for m in range(mmax + 1))
    return 2 * nside * pairs


def least_seconds(nside, lmax, mmax, maps_by_spin):
    """(seconds, bound) of a step that analyses ``maps_by_spin[s]`` maps of
    each spin kind s (0 or 2): the largest of the recurrence, product and
    byte times, named."""
    rec = prod = nbytes = 0.0
    for spin, n in maps_by_spin.items():
        if not n:
            continue
        t = triples(nside, lmax, mmax, spin)
        rec += FLOP_SHARED[spin] * t
        prod += (FLOP_PER_TRIPLE[spin] - FLOP_SHARED[spin]) * t * n
        cols = 2 if spin else 1  # ring spectra per map: one, or +-s
        nlm = (mmax + 1) * (lmax + 1) - mmax * (mmax + 1) // 2
        ring_bytes = 2 * cols * 2 * nside * (mmax + 1) * COMPLEX64_BYTES
        alm_bytes = cols * nlm * COMPLEX64_BYTES
        nbytes += n * (ring_bytes + alm_bytes)
    times = {"recurrence": rec / FP32_FLOP_PER_S,
             "products": prod / TF32_FLOP_PER_S,
             "bytes": nbytes / HBM_BYTES_PER_S}
    bound = max(times, key=times.get)
    return times[bound], bound
