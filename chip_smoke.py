"""Drive the PyTorch / H100 port of Heracles once on the card.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; fails (non-zero exit, no result line) on a
machine without a card, and on any failed check.  Phases, one line each
with its seconds:

0. the card (``nvidia-smi`` name and power limit), torch and CUDA;
1. build the Hopper kernels from ``heracles_tpu_torch/csrc`` (ptxas'
   registers and spills, none allowed in the spin-0 synthesis and in the
   four kernels' grouped instantiations; the Gram kernel's DMMA
   instruction count, the grouped analyses' HMMA (float32, comp) or DMMA
   (float64) counts, none zero, and SHFL counts, each below the parent
   commit's, and the spreader's shared atomics, compare-and-swap loops
   (none allowed) and global reductions from their SASS, the resident
   blocks per SM of the analysis and synthesis kernels and of each group
   of maps);
2. each kernel against its plain PyTorch version on the same CUDA
   tensors: the analysis and synthesis kernels in float32 and float64 at
   three shapes (all four and the Gram kernel also repeated bit for bit),
   the syntheses on alms of 1e-12, the spin-0 synthesis on a number of
   rings that is no multiple of a tile, the spin-0 analysis and synthesis
   at lmax 15000 (above what a whole column in shared memory would allow
   in float64), the Gram kernel at three ragged shapes
   weighted and unweighted, the probe kernels in float32 and float64 at
   full occupancy;
3. the ``pipeline_n4096_l3000`` configuration: positions + shear +
   visibility, 2 tomographic bins of 5e6 rows, nside 4096, lmax 3000,
   float32 maps, through ``map_catalogs`` -> ``transform`` ->
   ``angular_power_spectra`` -> ``mixing_matrices`` of the mask spectra,
   with the kernels' launch counts over that run (the maps' stacks, the
   analyses' groups and the ring analysis' kernels held to exact counts:
   one analysis a stack, the 4 spin-0 maps in one, the 2 spin-2 in one);
4. bin 0's POS and SHE analyses at full size through each kernel and its
   plain version (times, agreement), the share of the spin-0 analysis'
   work on each of its paths (a diagnostic launch), and float32 against
   float64 spectra per l-band;
5. the pseudo-inverses of the mixing matrices and their application to
   the data spectra; one Gram contraction of each spin kind at full size
   through the kernel and its plain version (times, agreement, FP64
   rate); the host seconds of the quadrature rule and tables;
6. the FMA-peak probe at full occupancy (FP32 and FP64 rates, with its
   launch count; the float32 fma rate run is the kernels line's row, its
   plain version timed at the same shape), the analysis kernels' issue
   rates as shares of it, and
   the Gram rate as a share of the FP64 tensor-core peak and against
   einsum's;
7. synthesis at full size: ``transform`` of phase 3's POS and SHE maps
   with a mapper of 3 Jacobi iterations (exact launch counts, finite
   spectra and their change against phase 3's) and ``synthesize`` of bin
   0's alms, each through the synthesis kernels; bin 0's synthesis through
   each kernel and its plain version (times, agreement) and the share of
   either synthesis' work on each of its paths; a round trip of
   random band-limited alms, ``alm2map`` -> ``map2alm`` with 0 and 3
   iterations, in float64 and float32;
8. the mapper's other entry points at full size: bin 0's float32 POS map
   through ``HealpixMapper(dd=True).transform`` (the float64 kernel must
   launch, the alms come back complex64 and lie closer to the float64
   transform's than the float32 ones, per l-band), ``resample`` from nside
   4096 to 2048 (a map of the pixels' z against the coarse pixels' z, the
   POS map's sum), ``map_values`` of one page against ``add``;
9. DICES at the configuration of ``dices_njk50_n1024`` (``bench.py``,
   ``build_dices_real``): POS, SHE and VIS float32 maps at nside 1024,
   lmax 1536, 50 regions of contiguous pixels, through
   ``compute_jk_alms`` in device mode (exact launch counts of the spin-0
   and spin-pair analyses over batches of 8 regions, no plain run),
   ``compute_jk_cls_from_alms`` and ``jackknife_covariance`` (one key
   against ``np.cov``), SHT linearity (full - region alms against the
   alms of the complement-masked map), two delete-1 samples against
   ``angular_power_spectra`` of alms subtracted by hand; then 8 regions in
   file mode twice (the second call launches no SHT kernel and returns the
   same spectra), delete-2 debiasing and shrinkage towards the Gaussian
   covariance; the two analysis kernels at the DICES batch against their
   plain versions, at every group of maps ``nb`` (each group, whose ring
   contraction runs on the tensor cores, repeating its bits from launch
   to launch and within the float32 bar of ``nb = 1`` and of the plain
   version, its float32 error per l-band against the float64 kernel at
   most 1.25 times ``nb = 1``'s; timed beside both bounds), and the pair
   analysis' groups' path shares; the region alms run with the automatic
   groups, whose launches are counted by ``nb``;
10. pixel-free alms (``DiscreteMapper``, ``ops.nufft``) at the
   configurations of ``discrete_alm_l1000`` (65536 points, lmax 1000,
   float32: the exact spin-0 and spin-2 paths through the analysis kernels
   with the points in place of rings) and ``discrete_gridded_1e7_l1000``
   (1e7 points, epsilon 1e-5, float32: the spreading kernel and the
   coarse-grid reduce), then a paged ``map_catalogs`` of 1e7 rows (POS and
   SHE through the gridded mapper), with exact launch counts and no plain
   run; the analysis kernels at point shapes against their plain versions
   (8192 points) and the spin-0 kernel's path shares on sorted and
   unsorted points; the spreader against its plain version (1e7 points,
   the same squeezed into a deep field's 0.4 x 0.4 rad, and 1e6 points at
   w 6 and 13), timed against ``index_add_`` of the precomputed stencil,
   on points sorted by theta and on one 1e6-point page, with its three
   stages (bin + scan, order, spread + flush) timed apart, its bin
   statistics, and its binning against ``nufft.bin_points_plain``
   exactly; gridded against exact in float64 at epsilon
   1e-12 and in float32 at 1e-5; the exact pixel window at nside 32 on
   the card against the CPU; ``python -m heracles_tpu_torch`` on a small
   FITS catalogue on the card against the same stages on the CPU;
11. the device mesh (``heracles_tpu_torch.parallel``): B1-B4 in float32
   and float64 at bin 0's shapes on the two blocks of orders of a
   two-shard "m" split (each block's columns bit for bit the full
   launch's, the padded orders zero, each block timed against the full
   launch); ``pipeline_step`` of phase 3's POS and SHE maps on
   ``make_mesh()`` (every visible card) against phase 3's alms; on a
   (2, 2) mesh of four shards on the card, ``pipeline_step`` (spin 0 and
   mixed) against it, ``map2alm_sharded`` / ``alm2map_sharded`` against
   the unsharded transforms, ``transform_sharded`` against ``transform``,
   ``mixmat(mesh=)`` against phase 3's matrix,
   ``adjoint_synthesis_sharded`` against phase 10's exact alms and
   ``compute_jk_alms(mesh=)`` of 8 regions against phase 9's, each with
   its exact launch counts, no plain run, its seconds and its peak memory
   (shards queued on one card: not a scaling measurement);
12. the compensated (``dd="comp"``) float32 kernels of B1-B4: bin 0's POS
   and SHE maps through ``HealpixMapper(dd="comp", iterations=1)
   .transform`` (exact comp launch counts, no plain run, no float64
   launch), then ``map2alm`` with ``dd=False``, ``"comp"`` and ``True``
   against the float64 transform per l-band (comp's top band below
   plain's); each comp kernel at bin 0's shapes against its plain version
   (times, agreement, bound) beside the plain float32 kernel's time on the
   same inputs, the path shares of the comp spin-0 analysis and of either
   comp synthesis (equal to the plain kernels' counts), and one comp block
   of orders (m0 = 1536) bit for bit the full comp launch's columns;
13. the device trace (``tools/torch_trace_capture.py``, torch.profiler):
   bin 0's spin-0 ``map2alm`` and phase 7's refined transform of bin 0's
   POS and SHE maps, each traced once, the port's own spans
   (``heracles_tpu_torch.tracing``) labelling its stages; the trace must
   hold device events, its launches of B1-B5 must equal the kernels'
   launch counts over the same window, B1's device time per launch must
   lie within 10% of phase 4's CUDA-event time, busy + idle must equal the
   window, and no span the op should enter may be missing; prints each
   trace's idle share, top 10 ops, top 5 idle gaps by the host work that
   made the card wait, and the host waits, copies and table builds the
   program counted;
14. the groups of maps at full width: B1 and B3 on a stack of 4 maps, B2
   and B4 on 2 (the reference's groups at lmax 3000), at every ``nb``
   dividing the stack, each timed beside its bound(s), the automatic group
   named; the syntheses bit for bit their ``nb = 1``, the analyses held
   as in phase 9 (the plain version at full width, the float64 kernel per
   l-band); float64 and comp at every ``nb`` of the four kernels at a
   small shape (600 rings, orders 7..46, 8 maps), held so against their
   ``nb = 1`` and the analyses' plain versions; then the stacked syntheses' own
   path: ``HealpixMapper(nside 1024, lmax 1536, iterations=3).transform``
   of 8 float32 maps, spin 0 and spin 2 (its Jacobi steps synthesise the
   stack), and ``synthesize`` of phase 3's four spin-0 alms stacked at
   n4096 / l3000, each with exact launch counts by (kernel, nb), no plain
   run, and bit for bit the same call with the syntheses' ``NB_SIZES``
   rows set to (1,); B3 and B4 at every ``nb`` on a stack of 8 at n1024 /
   l1536 against their plain versions, timed beside their bounds;
15. the ring analysis (``ringfft.ring_analysis``: the kernels of
   ``csrc/ringfft.cu`` around cuFFT) at the benchmark cell's shape, one
   float32 map at nside 4096 with 3001 orders and the ring weights, on
   one complex spin-2 map and on the second order block of a two-block
   mesh (m0 > 0): each against its plain version (``ring_analysis_plain``,
   the torch ops that ran on the card before the kernels) and their
   float64 run, the kernels' float32 error at most 1.25 times the plain
   version's; times (best of 3) beside the plain version's, the bound of
   the maps in and F out and that of the kernels' own passes; the complex
   map and the block no slower than their plain version; a warm call
   builds and uploads nothing, and its launches are counted.  (Phase 3
   holds the pipeline's launches of these kernels to exact counts.)

Then a JSON line of the kernels (with each one's bound: the least time
the card could take for the same work; the grouped launches of phase 9's
region alms and of phase 14's stacked syntheses as ``<kernel>_nb<n>``
rows, timed at the DICES batch and at the transform's stack of 8; the
grouped analyses' bound counts their contraction on the tensor cores,
``bound_fp32_ms`` on the FP32 pipe), the card line, and the result line.
"""

import collections
import functools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

NSIDE, LMAX, NROWS, NBINS = 4096, 3000, 5_000_000, 2

# kernel vs plain: float32 at the bar the Pallas kernels were held to
# (tests/test_pallas.py), float64 at the float64 rounding level; the pair
# synthesis in float32 at the bar of the Pallas pair synthesis
# (tests/test_pallas.py:325)
TOL = {torch.complex64: (2e-5, 2e-4), torch.complex128: (1e-11, 0.0)}
PAIR_SYNTH_TOL32 = (3e-5, 3e-4)
# Jacobi iterations of the synthesis phase
ITERATIONS = 3
# rows of the page that phase 8 scatters
PAGE_ROWS = 1_000_000
# phase 9: DICES at dices_njk50_n1024's configuration (bench.py), and the
# regions of its file-mode run
DICES_NSIDE, DICES_LMAX, DICES_NJK, DICES_FILE_NJK = 1024, 1536, 50, 8
DICES_BATCH = 8  # compute_jk_alms' region_batch
DICES_KERNELS = ("analysis_spin0_folded", "analysis_pair_folded")
# float64 host algebra on the same float32 alms: sums in another order
DICES_RTOL = 1e-10
# phase 10: the configurations of discrete_alm_l1000 (bench.py:231-248,
# seed 3) and discrete_gridded_1e7_l1000 (bench.py:251-269, seed 4); the
# plain versions of the analysis kernels at the bench's CPU size, and of
# the spreader at 1e6 points for two widths; a paged catalogue of 1e7 rows
DISCRETE_LMAX, DISCRETE_NPTS, DISCRETE_PLAIN_NPTS = 1000, 65536, 8192
GRIDDED_NPTS, GRIDDED_EPS = 10_000_000, 1e-5
SPREAD_CHECK_NPTS, SPREAD_CHECK_WIDTHS = 1_000_000, (6, 13)
PAGED_ROWS = 10_000_000
# the spreader against its plain version: float64 atomics add in an order
# that varies from run to run, so 1e-12 of the grid's max, not bit for bit
SPREAD_TOL = 1e-12
# gridded against exact in float64 at epsilon 1e-12: the bound of
# tests/test_nufft.py:34; the float32 paths (exact, and gridded at 1e-5)
# against the float64 exact alms: the float32 recurrence's own error, at
# phase 4's float32-against-float64 bar
GRIDDED_TOL, F32_TOL = 1e-11, 1e-3
# the exact pixel window on the card and on the CPU: float64 sums in
# another order; the CLI on the card and on the CPU: float64 throughout
PIXWIN_TOL, CLI_TOL = 1e-12, 1e-10
# FP64 outside the tensor cores (H100 SXM data sheet, dense): the
# spreader's arithmetic
FP64_VECTOR_PEAK = 34e12

# kernel name: (source, the TPU kernel it replaces)
KERNELS = {
    "analysis_spin0_folded": ("heracles_tpu_torch/csrc/sht_analysis.cu",
                              "heracles_tpu/ops/pallas_sht.py:713"),
    "analysis_pair_folded": ("heracles_tpu_torch/csrc/sht_analysis_pair.cu",
                             "heracles_tpu/ops/pallas_sht.py:1049"),
    "synthesis_spin0_folded": ("heracles_tpu_torch/csrc/sht_synthesis.cu",
                               "heracles_tpu/ops/pallas_sht.py:1704"),
    "synthesis_pair_folded": ("heracles_tpu_torch/csrc/sht_synthesis_pair.cu",
                              "heracles_tpu/ops/pallas_sht.py:2161"),
    "gram": ("heracles_tpu_torch/csrc/gram.cu", "heracles_tpu/ops/df32.py:93"),
    "fma_peak": ("heracles_tpu_torch/csrc/fma_peak.cu", "tools/vpu_peak.py:31"),
    "spread": ("heracles_tpu_torch/csrc/spread.cu",
               "heracles_tpu/ops/_spread.cpp:42"),
    # the compensated float32 instantiations (phase 12)
    "analysis_spin0_folded_comp": ("heracles_tpu_torch/csrc/sht_analysis.cu",
                                   "heracles_tpu/ops/pallas_sht.py:835"),
    "analysis_pair_folded_comp": (
        "heracles_tpu_torch/csrc/sht_analysis_pair.cu",
        "heracles_tpu/ops/pallas_sht.py:1218"),
    "synthesis_spin0_folded_comp": ("heracles_tpu_torch/csrc/sht_synthesis.cu",
                                    "heracles_tpu/ops/pallas_sht.py:1828"),
    "synthesis_pair_folded_comp": (
        "heracles_tpu_torch/csrc/sht_synthesis_pair.cu",
        "heracles_tpu/ops/pallas_sht.py:2501"),
    # no Pallas kernel: the glue around the ring FFTs, which the JAX package
    # leaves to XLA (its chirp spectra cached at heracles_tpu/ops/ringfft.py:220)
    "ring_analysis": ("heracles_tpu_torch/csrc/ringfft.cu",
                      "none (heracles_tpu/ops/ringfft.py:220, XLA)"),
}
SHT_NAMES = ("analysis_spin0_folded", "analysis_pair_folded",
             "synthesis_spin0_folded", "synthesis_pair_folded")
# the kernels of the pipeline path (phase 3); the probe has its own path
# (phase 6), synthesis its own (phase 7)
PIPELINE_KERNELS = ("analysis_spin0_folded", "analysis_pair_folded", "gram")
# the ring analysis' kernels (``ringfft.LAUNCHES``) on the pipeline path
RING_KERNELS = ("ring_rows", "ring_spectrum", "ring_orders")
SYNTHESIS_KERNELS = ("synthesis_spin0_folded", "synthesis_pair_folded")

# Gram kernel vs plain: float64 sums in another order
GRAM_TOL = 1e-12
# the probe: an FMA and a multiply-then-add round differently every step
PROBE_STEPS_CHECK, PROBE_STEPS_RATE, PROBE_NCHAIN = 256, 4096, 4
# vector instructions per (ring, l, m) triple of the SHT kernels, by
# count of the sources.  Per column the recurrence step is 4 (+ a0, x d,
# b d', -), the emit factor ~5 (two compares, two selects, a multiply), the
# rescale ~6 (compare, select, two multiplies, the exponent's add); a1 x
# is 1 per triple.  The pair analysis (sht_analysis_pair.cu) has two paths, (steady, full):
# ~21 on a warp whose rings all sit at k = -1 (a1 x, two steps, 8 FMAs, a
# quarter of the coefficient row read, and 124 instructions of warp
# butterfly per 32 triples of a chunk) and ~43 on the full step.  The
# spin-0 analysis (sht_analysis.cu) and the pair synthesis
# (sht_synthesis_pair.cu) have three, (steady, dead, full): the spin-0
# analysis 1 + 4 + 2 FMAs, ~2.4 of butterfly and zeroed sums per triple
# (124 + 32 per 64 triples of a chunk) and a quarter of a row read, ~10;
# 1 + 4 and a rescale of ~8 per 8 steps, ~6, where nothing emits yet; ~21
# on the full step.  The pair synthesis 1 + 8 + 8 FMAs, the negated a0 and
# two vector reads of the row per 4 rings, ~18; 1 + 8 + 2, ~11; ~40.  The
# spin-0 synthesis (sht_synthesis.cu), read from its SASS (every
# instruction of a sub-chunk's body over its 32 triples, plus the path
# choice and loop, ~1.1, or ~0.3 once the warp has settled on the steady
# path): 4 of recurrence (no a0) + 2 FMAs + a quarter of a row read, ~6.5;
# 4 + 0.25 and a rescale per 8 steps, ~6.9; ~18.4.  These are the nb = 1
# kernels.  The grouped analyses (nb > 1) contract on the tensor cores
# (csrc/tc_contract.cuh): per lane and sub-chunk of 8 multipoles of their
# 2 rings, ~88 instructions of shared recurrence (~176 for the pair's two
# columns), ~20 of path, staging and stores, and per k-step of 8 rings
# (8 a sub-chunk, 16 for the pair) a staged read, the split of its two
# values (~6) and per row tile of 4 maps a read of the spectra, their
# split (~12) and 3 HMMA (2 reads and 1 DMMA in float64): ~4.6 a
# map-triple for B1 at nb 4, ~9 for B2, no shuffle.  More than the FP32
# contraction's, yet faster where the tiles leave room for more blocks an
# SM: the groups are held back by latency, not by instruction rate.
INSTR_PER_TRIPLE = {"analysis_spin0_folded": (10, 6, 21),
                    "analysis_pair_folded": (21, 43),
                    "synthesis_spin0_folded": (6.5, 6.9, 18.4),
                    "synthesis_pair_folded": (18, 11, 40)}
PATHS = ("steady", "dead", "full")
# the FP64 tensor-core peak (H100 SXM data sheet, dense), the Gram
# kernel's yardstick
FP64_TENSOR_PEAK = 67e12

# The bound of a kernel: the larger of its bytes (each input read once,
# each output written once) over HBM3's 3.35 TB/s and its floating-point
# operations over the peak for their type: 67 TFLOP/s FP32 outside the
# tensor cores, 67 TFLOP/s FP64 on the tensor cores (H100 SXM data sheet,
# dense).  Operations per (ring, l, m) triple of the SHT kernels, counted
# from the sources: the recurrence a1 x, + a0, x d, b d', - (the pair's
# two columns share a1 x: 9; at spin 0 a0 is zero in every row, so the
# function needs 4, whether or not a kernel spends the addition), the emit
# multiply (1 per column) and the contraction: 2 FMAs (4) for either
# spin-0 kernel, 8 FMAs (16) for either pair (the synthesis sums even and
# odd l apart, so its (-1)^l costs nothing per triple).  The compensated
# kernels (wigner_recurrence.cuh, step_lo) add per column the lo stream's
# step, (a1 x + a0) lo, r (a1 x d), +, b lo', - (a1 x d is the spin-0
# step's own product, a new one in a pair: 5 at spin 0, 6 a pair column)
# and the emit's d + lo: 15 and 41.
# Of these, the recurrence and the emit are shared by the maps of a group
# (nb > 1, the grouped launches): 5 of B1's and B3's 9 (4 + 1), 11 of B2's
# and B4's 27 (9 + 2), 11 of the spin-0 comp kernels' 15, 25 of the pair
# comp kernels' 41; each map pays its contraction (the analyses) or its
# FMAs into its sums (the syntheses: sht_synthesis.cu and
# sht_synthesis_pair.cu form each emitted value once for the group).
# A grouped analysis (nb > 1) contracts on the tensor cores, so it has a
# second bound, sht_bound(..., tc=True): its shared recurrence and emit at
# the FP32 (or FP64) rate above, plus its contraction, FLOP_PER_TRIPLE -
# FLOP_SHARED a map-triple, at the tensor cores' rate: three TF32
# products (3xTF32) at 495 TFLOP/s in float32 and comp, one DMMA at 67
# TFLOP/s in float64 (H100 SXM data sheet, dense).  The two pipes are
# charged one after the other.  That kernel may beat the first bound, so
# neither is reported as a share alone.
TENSOR_PEAK = {torch.float32: 495e12, torch.float64: 67e12}
TF32_PASSES = 3
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.float32: 67e12, torch.float64: 67e12}
FLOP_PER_TRIPLE = {"analysis_spin0_folded": 9, "analysis_pair_folded": 27,
                   "synthesis_spin0_folded": 9, "synthesis_pair_folded": 27,
                   "analysis_spin0_folded_comp": 15,
                   "analysis_pair_folded_comp": 41,
                   "synthesis_spin0_folded_comp": 15,
                   "synthesis_pair_folded_comp": 41}
FLOP_SHARED = {"analysis_spin0_folded": 5, "analysis_pair_folded": 11,
               "synthesis_spin0_folded": 5, "synthesis_pair_folded": 11,
               "analysis_spin0_folded_comp": 11,
               "analysis_pair_folded_comp": 25,
               "synthesis_spin0_folded_comp": 11,
               "synthesis_pair_folded_comp": 25}


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sync_time(fn):
    """(result, seconds) of fn() between two device synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn):
    """(result, milliseconds) of fn() on the current stream (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def best_ms(fn, reps=3):
    """(result, least milliseconds of ``reps`` timed calls) after a warm-up
    call (CUDA events)."""
    fn()
    out, times = None, []
    for _ in range(reps):
        out, ms = event_ms(fn)
        times.append(ms)
    return out, min(times)


def same_bits(got, want):
    """Whether two tuples of tensors hold the same bits (signed zeros
    included)."""
    def bits(t):
        real = torch.view_as_real(t) if t.is_complex() else t
        return real.view(torch.int32 if real.element_size() == 4
                         else torch.int64)

    return len(got) == len(want) and all(
        g.shape == w.shape and torch.equal(bits(g), bits(w))
        for g, w in zip(got, want))


def compare(got, want, atol, rtol=0.0, what="kernel"):
    """(max |got - want|, that / max |want|); raises outside tolerance.

    The bound is atol * max |want| + rtol * |want|, elementwise.
    """
    got = got.to(torch.complex128)
    want = want.to(torch.complex128)
    scale = want.abs().max().item()
    diff = (got - want).abs()
    check(bool(torch.isfinite(got).all()), f"{what}: output not finite")
    bad = diff > atol * scale + rtol * want.abs()
    check(not bool(bad.any()), f"{what} differs from plain: max |d| "
          f"{diff.max().item():.3e}, scale {scale:.3e}")
    err = diff.max().item()
    return err, err / scale


def kernel_label(entry):
    """A short label for a mangled kernel name in ptxas' log."""
    def prec(c):
        return "f32" if c == "f" else "f64"

    def tail(comp, paths="0"):
        return f"{'/comp' if comp == '1' else ''}" \
               f"{'/paths' if paths == '1' else ''}"

    # template <typename T, bool kComp[, bool kCount]>: the compensated
    # instantiations carry a first Lb1, the diagnostic twins that count the
    # paths a second
    m = re.search(r"pair_analysis_kernelI([fd])Lb([01])E", entry)
    if m:
        return f"analy/pair/{prec(m.group(1))}{tail(m.group(2))}"
    # the kernels on groups of nb maps: template <typename T, bool kComp,
    # int NB> (the syntheses first: "synth_pair_group_kernel" holds the
    # pair analysis' name)
    m = re.search(r"synth_(pair_)?group_kernelI([fd])Lb([01])ELi(\d)E",
                  entry)
    if m:
        kind = "synth-pair" if m.group(1) else "synth-spin0"
        return (f"group/{kind}/{prec(m.group(2))}/nb{m.group(4)}"
                f"{tail(m.group(3))}")
    # (the pair analysis' groups add a bool kCount: their counting twins)
    m = re.search(r"(pair|analysis)_group_kernelI([fd])Lb([01])ELi(\d)E"
                  r"(?:Lb([01])E)?", entry)
    if m:
        kind = "pair" if m.group(1) == "pair" else "spin0"
        return (f"group/{kind}/{prec(m.group(2))}/nb{m.group(4)}"
                f"{tail(m.group(3), m.group(5) or '0')}")
    m = re.search(r"pair_synthesis_kernelI([fd])Lb([01])ELb([01])E", entry)
    if m:
        return f"synth/pair/{prec(m.group(1))}{tail(*m.group(2, 3))}"
    m = re.search(r"analysis_kernelI([fd])Lb([01])ELb([01])E", entry)
    if m:
        return f"analy/spin0/{prec(m.group(1))}{tail(*m.group(2, 3))}"
    m = re.search(r"synthesis_kernelI([fd])Lb([01])ELb([01])E", entry)
    if m:
        return f"synth/spin0/{prec(m.group(1))}{tail(*m.group(2, 3))}"
    m = re.search(r"probe_kernelI([fd])Li([01])ELi(\d)E", entry)
    if m:
        return f"{'rec3' if m.group(2) == '1' else 'fma'}/" \
               f"{prec(m.group(1))}/nchain{m.group(3)}"
    m = re.search(r"gram_kernelILb([01])E", entry)
    if m:
        return f"gram/f64/{'u' if m.group(1) == '1' else '1'}"
    # the spreader at the two widths of phase 10 (26 instantiations in all)
    m = re.search(r"spread_kernelILi(6|13)ELi([12])E", entry)
    if m:
        return f"spread/w{m.group(1)}/{'real' if m.group(2) == '1' else 'cplx'}"
    return None


@functools.lru_cache(maxsize=1)
def _sass(path):
    """``cuobjdump -sass`` of the built library (from the toolkit nvcc
    came from)."""
    from heracles_tpu_torch.ops import _build

    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout


def sass_opcodes(path, function):
    """Instruction counts by opcode (with its modifiers, e.g.
    ``ATOMS.CAST.SPIN.64``) in the SASS of the functions whose mangled
    name contains ``function`` (or matches it, a compiled pattern)."""
    ops, inside = collections.Counter(), False
    for line in _sass(path).splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            inside = (bool(function.search(m.group(1)))
                      if isinstance(function, re.Pattern)
                      else function in m.group(1))
            continue
        m = inside and re.search(
            r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m:
            ops[m.group(1)] += 1
    return ops


def sass_count(path, function, opcode):
    """Instructions ``opcode`` (any modifiers) in the SASS of the functions
    whose mangled name contains ``function``."""
    return sum(n for op, n in sass_opcodes(path, function).items()
               if op.split(".")[0] == opcode)


# the grouped analyses' instantiations: (kernel, mangled name with its
# length, group sizes), and each precision's template arguments
GROUP_SASS = (("spin0", "21analysis_group_kernel", (2, 4, 8)),
              ("pair", "17pair_group_kernel", (2, 4)))
GROUP_PRECISIONS = {"f32": ("f", "0"), "f64": ("d", "0"), "comp": ("f", "1")}
# SHFL instructions of each grouped analysis instantiation in the build of
# commit 947bff6 (the groups' per-map warp butterflies), as
# ``tools/sht_kernel_bench.py --root <that checkout> --nb 2 --sass``
# prints them on the card
PARENT_SHFL = {**{("spin0", p, nb): 32 if p == "f64" else 16
                  for p in GROUP_PRECISIONS for nb in (2, 4, 8)},
               **{("pair", p, nb): 32 if p == "f64" else 16
                  for p in GROUP_PRECISIONS for nb in (2, 4)}}


def group_sass(path):
    """{(kernel, precision, nb): Counter of SASS opcodes (no modifiers)} of
    the grouped analyses' instantiations in the library at ``path`` (the
    kernels proper, not the counting twins)."""
    out = {}
    for kernel, mangled, sizes in GROUP_SASS:
        for prec, (t, comp) in GROUP_PRECISIONS.items():
            for nb in sizes:
                name = re.compile(rf"{mangled}I{t}Lb{comp}ELi{nb}E(?:Lb0E)?E")
                ops = collections.Counter()
                for op, n in sass_opcodes(path, name).items():
                    ops[op.split(".")[0]] += n
                out[kernel, prec, nb] = ops
    return out


def ptxas_summary(log):
    out, current = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = kernel_label(m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m and current:
            frame, spill = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            out.append(f"{current} {m.group(1)} regs, {frame} B stack, "
                       f"{spill} B spill")
            current = None
    return "; ".join(out)


def catalog_arrays(rows=NROWS):
    """bench.py's pipeline catalogue recipe, one array of ``rows`` rows per
    bin."""
    rng = np.random.default_rng(8)
    dtype = [(n, "f8") for n in ("RA", "DEC", "G1", "G2", "W")]
    out = []
    for _ in range(NBINS):
        arr = np.empty(rows, dtype)
        arr["RA"] = rng.uniform(0, 360, rows)
        arr["DEC"] = np.degrees(np.arcsin(rng.uniform(-1, 1, rows)))
        arr["G1"] = rng.normal(0, 0.1, rows)
        arr["G2"] = rng.normal(0, 0.1, rows)
        arr["W"] = rng.uniform(0.5, 1.0, rows)
        out.append(arr)
    return out


def reset_counts():
    """Zero every counter of the port (``heracles_tpu_torch.tracing``): the
    kernels' launch counts, the plain-version run counts, the host waits,
    copies and table builds."""
    from heracles_tpu_torch import tracing

    tracing.reset()


def counts():
    """(kernel launches, plain-version runs), each by kernel name."""
    from heracles_tpu_torch.ops import (
        fma_peak, gram, nufft, sht_kernels, wigner)

    launches = {**sht_kernels.LAUNCHES, **gram.LAUNCHES, **fma_peak.LAUNCHES,
                **nufft.LAUNCHES}
    plain = {**wigner.PLAIN_RUNS, **gram.PLAIN_RUNS, **fma_peak.PLAIN_RUNS,
             **nufft.PLAIN_RUNS}
    return launches, plain


def ring_geometry_z(nside):
    """cos(theta) of the northern rings, float64 numpy."""
    from heracles_tpu_torch.healpix import ring_geometry

    return ring_geometry(nside)["z"][:2 * nside]


def ring_tensors(nside, dev):
    """cos(theta), log cos(theta/2), log sin(theta/2) of the northern rings."""
    z = ring_geometry_z(nside)
    return [torch.as_tensor(a, device=dev) for a in (
        z, 0.5 * np.log((1.0 + z) / 2.0), 0.5 * np.log((1.0 - z) / 2.0))]


def phase2(dev):
    from heracles_tpu_torch.ops import fma_peak, gram, sht_kernels, wigner

    rows = []
    # batched, lmax > 2 nside at high order (seeds near the poles), odd nside
    for nside, lmax, batch in [(256, 384, 3), (64, 191, 1), (33, 80, 1)]:
        nhalf = 2 * nside
        geom = ring_tensors(nside, dev)
        rng = np.random.default_rng(nside)
        shape = (batch, nhalf, lmax + 1)
        F64 = [rng.normal(size=shape) + 1j * rng.normal(size=shape)
               for _ in range(4)]
        ashape = (batch, lmax + 1, lmax + 1)
        A64 = [rng.normal(size=ashape) + 1j * rng.normal(size=ashape)
               for _ in range(2)]
        for cdtype in (torch.complex64, torch.complex128):
            F = [torch.as_tensor(a, dtype=cdtype, device=dev) for a in F64]
            want = wigner.analysis_spin0_folded_plain(F[0], F[1], *geom, lmax)
            got = sht_kernels.analysis_spin0_folded(F[0], F[1], *geom, lmax)
            _, rel = compare(got, want, *TOL[cdtype])
            again = sht_kernels.analysis_spin0_folded(F[0], F[1], *geom, lmax)
            check(torch.equal(got, again), f"spin-0 analysis n{nside} l{lmax} "
                  "does not repeat bit for bit")
            tag = "f32" if cdtype == torch.complex64 else "f64"
            rows.append(f"spin0/{tag}/n{nside}l{lmax} {rel:.2e}")
            want = wigner.analysis_pair_folded_plain(*F, *geom, lmax, 2)
            got = sht_kernels.analysis_pair_folded(*F, *geom, lmax, 2)
            rel = max(compare(g, w, *TOL[cdtype])[1] for g, w in zip(got, want))
            again = sht_kernels.analysis_pair_folded(*F, *geom, lmax, 2)
            check(all(torch.equal(g, a) for g, a in zip(got, again)),
                  f"pair analysis n{nside} l{lmax} does not repeat bit for bit")
            rows.append(f"pair/{tag}/n{nside}l{lmax} {rel:.2e}")
            A = [torch.as_tensor(a, dtype=cdtype, device=dev) for a in A64]
            want = wigner.synthesis_spin0_folded_plain(A[0], *geom, lmax)
            got = sht_kernels.synthesis_spin0_folded(A[0], *geom, lmax)
            rel = max(compare(g, w, *TOL[cdtype], what="spin-0 synthesis")[1]
                      for g, w in zip(got, want))
            again = sht_kernels.synthesis_spin0_folded(A[0], *geom, lmax)
            check(all(torch.equal(g, a) for g, a in zip(got, again)),
                  f"spin-0 synthesis n{nside} l{lmax} does not repeat bit "
                  "for bit")
            rows.append(f"synth0/{tag}/n{nside}l{lmax} {rel:.2e}")
            tol = PAIR_SYNTH_TOL32 if cdtype == torch.complex64 else TOL[cdtype]
            want = wigner.synthesis_pair_folded_plain(*A, *geom, lmax, 2)
            got = sht_kernels.synthesis_pair_folded(*A, *geom, lmax, 2)
            rel = max(compare(g, w, *tol, what="pair synthesis")[1]
                      for g, w in zip(got, want))
            again = sht_kernels.synthesis_pair_folded(*A, *geom, lmax, 2)
            check(all(torch.equal(g, a) for g, a in zip(got, again)),
                  f"pair synthesis n{nside} l{lmax} does not repeat bit for bit")
            rows.append(f"synthpair/{tag}/n{nside}l{lmax} {rel:.2e}")
            if cdtype == torch.complex64 and nside == 64:
                # the kernel holds the alms times 2^-60: tiny ones (Jacobi
                # residuals) must stay clear of the subnormals
                tiny = [a * 1e-12 for a in A]
                want = wigner.synthesis_spin0_folded_plain(tiny[0], *geom, lmax)
                got = sht_kernels.synthesis_spin0_folded(tiny[0], *geom, lmax)
                rel = max(compare(g, w, *TOL[cdtype],
                                  what="spin-0 synthesis of 1e-12")[1]
                          for g, w in zip(got, want))
                rows.append(f"synth0/{tag}/n{nside}l{lmax}x1e-12 {rel:.2e}")
                want = wigner.synthesis_pair_folded_plain(*tiny, *geom, lmax, 2)
                got = sht_kernels.synthesis_pair_folded(*tiny, *geom, lmax, 2)
                rel = max(compare(g, w, *tol, what="pair synthesis of 1e-12")[1]
                          for g, w in zip(got, want))
                rows.append(f"synthpair/{tag}/n{nside}l{lmax}x1e-12 {rel:.2e}")

    # the spin-0 synthesis where the rings are no multiple of a tile of 512
    # (padding rings beside seeded ones in a warp), batched
    nside, lmax, batch = 300, 200, 2
    geom = ring_tensors(nside, dev)
    rng = np.random.default_rng(nside)
    ashape = (batch, lmax + 1, lmax + 1)
    a64 = rng.normal(size=ashape) + 1j * rng.normal(size=ashape)
    for cdtype in (torch.complex64, torch.complex128):
        A = torch.as_tensor(a64, dtype=cdtype, device=dev)
        want = wigner.synthesis_spin0_folded_plain(A, *geom, lmax)
        got = sht_kernels.synthesis_spin0_folded(A, *geom, lmax)
        rel = max(compare(g, w, *TOL[cdtype], what="spin-0 synthesis")[1]
                  for g, w in zip(got, want))
        tag = "f32" if cdtype == torch.complex64 else "f64"
        rows.append(f"synth0/{tag}/n{nside}l{lmax}b{batch} {rel:.2e}")

    # no kernel's shared memory grows with lmax: a whole column at lmax
    # 15000 would pass a block's 227 KB in float64
    nside, lmax, nm = 8, 15000, 8
    nhalf = 2 * nside
    geom = ring_tensors(nside, dev)
    rng = np.random.default_rng(lmax)
    F64 = [rng.normal(size=(nhalf, nm)) + 1j * rng.normal(size=(nhalf, nm))
           for _ in range(2)]
    a64 = rng.normal(size=(lmax + 1, nm)) + 1j * rng.normal(size=(lmax + 1, nm))
    for cdtype in (torch.complex64, torch.complex128):
        F = [torch.as_tensor(a, dtype=cdtype, device=dev) for a in F64]
        want = wigner.analysis_spin0_folded_plain(*F, *geom, lmax)
        got = sht_kernels.analysis_spin0_folded(*F, *geom, lmax)
        _, rel = compare(got, want, *TOL[cdtype])
        tag = "f32" if cdtype == torch.complex64 else "f64"
        rows.append(f"spin0/{tag}/n{nside}l{lmax}m{nm} {rel:.2e}")
        A = torch.as_tensor(a64, dtype=cdtype, device=dev)
        want = wigner.synthesis_spin0_folded_plain(A, *geom, lmax)
        got = sht_kernels.synthesis_spin0_folded(A, *geom, lmax)
        rel = max(compare(g, w, *TOL[cdtype], what="spin-0 synthesis")[1]
                  for g, w in zip(got, want))
        rows.append(f"synth0/{tag}/n{nside}l{lmax}m{nm} {rel:.2e}")

    # ragged: K not a multiple of the chunk, L1 = 1, L2 not of the tile
    for K, L1, L2 in [(37, 1, 70), (500, 65, 129), (4501, 130, 3)]:
        rng = np.random.default_rng(K)
        A = torch.as_tensor(rng.normal(size=(K, L1)), device=dev)
        B = torch.as_tensor(rng.normal(size=(K, L2)), device=dev)
        u = torch.as_tensor(rng.normal(size=K), device=dev)
        for tag, w in (("u", u), ("1", None)):
            got = gram.gram(A, B, w)
            _, rel = compare(got, gram.gram_plain(A, B, w), GRAM_TOL,
                             what=f"gram K{K} {L1}x{L2}")
            check(torch.equal(got, gram.gram(A, B, w)),
                  f"gram K{K} {L1}x{L2} does not repeat bit for bit")
            rows.append(f"gram/{tag}/K{K}x{L1}x{L2} {rel:.2e}")

    # the probe at full occupancy, few steps: a correctness check (the
    # kernels line times the probe at phase 6's shape)
    rows_full = fma_peak.default_rows(dev)
    for dtype in (torch.float32, torch.float64):
        a, b = fma_peak.inputs(rows_full, dtype, dev)
        for kind in ("fma", "rec3"):
            args = (a, b, kind, PROBE_STEPS_CHECK, PROBE_NCHAIN)
            got = fma_peak.chains(*args)
            want = fma_peak.chains_plain(*args)
            tol = PROBE_STEPS_CHECK * torch.finfo(dtype).eps
            _, rel = compare(got, want, tol, what=f"{kind} probe {dtype}")
            tag = f"{kind}/{'f32' if dtype == torch.float32 else 'f64'}"
            rows.append(f"{tag}/{rows_full}x128x{PROBE_STEPS_CHECK} {rel:.2e}")
    return rows


def probe_row(dev, seconds):
    """The kernels line's B6 row: the float32 fma probe at the rate run's
    shape (full occupancy, PROBE_STEPS_RATE steps) with that run's time
    (``seconds``, the best of fma_peak.run's launches), its plain version
    timed and compared on the same inputs, and its bound (a and b read
    once, the chains' sum written once)."""
    from heracles_tpu_torch.ops import fma_peak

    a, b = fma_peak.inputs(fma_peak.default_rows(dev), torch.float32, dev)
    args = (a, b, "fma", PROBE_STEPS_RATE, PROBE_NCHAIN)
    got = fma_peak.chains(*args)
    want, plain_ms = event_ms(lambda: fma_peak.chains_plain(*args))
    ms = seconds * 1e3
    err, _ = compare(got, want, PROBE_STEPS_RATE * torch.finfo(torch.float32).eps,
                     what="fma probe at the rate shape")
    n = a.numel()
    flops = (n * fma_peak.executed_steps(PROBE_STEPS_RATE) * PROBE_NCHAIN
             * fma_peak.OPS_PER_STEP["fma"])
    bound_ms, bound_by = bound(3.0 * n * a.element_size(), flops, torch.float32)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def band_max_rel(cl32, cl64, lmin, nbands=10):
    """Largest |cl32/cl64 - 1| in each of ``nbands`` l-bands from lmin."""
    cl32 = cl32.cpu().numpy()[lmin:]
    cl64 = cl64.cpu().numpy()[lmin:]
    edges = np.linspace(0, cl64.shape[-1], nbands + 1).astype(int)
    rel = np.abs(cl32 - cl64) / np.abs(cl64)
    return [float(rel[a:b].max()) for a, b in zip(edges[:-1], edges[1:])]


def bound(nbytes, flops, dtype, peak=None):
    """(bound_ms, bound_by): the larger of bytes / HBM rate, flops / peak
    (by default the peak of ``dtype``'s operations)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (PEAK_FLOP_PER_S[dtype] if peak is None else peak) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sht_triples(batch, nhalf, nm, lmax, spin, m0=0):
    """(ring, l, m) triples with l >= j0 = max(m, spin) of one launch of
    the orders m0..m0+nm-1."""
    j0 = np.maximum(m0 + np.arange(nm), spin)
    return float(batch) * nhalf * float(np.clip(lmax + 1 - j0, 0, None).sum())


def sht_bound(name, batch, nhalf, nm, lmax, cdtype, m0=0, nb=1, tc=False):
    """The bound of one SHT kernel launch of the orders m0..m0+nm-1: ring
    spectra and alms moved once (a ``*_comp`` name: the compensated
    kernel, which also reads each ring's r); a launch on groups of ``nb``
    maps runs its shared operations once per group.  ``tc``: the
    contraction on the tensor cores (a grouped analysis), charged at
    their rate after the shared operations at the vector rate."""
    pair = "pair_folded" in name
    nring, nalm = (4, 2) if pair else (2, 1)
    item = torch.empty((), dtype=cdtype).element_size()
    nbytes = (float(batch) * nm * item * (nring * nhalf + nalm * (lmax + 1))
              + nhalf * (item // 2 + 16))  # x, log cos, log sin
    if name.endswith("_comp"):
        nbytes += nhalf * 4
    shared = FLOP_SHARED.get(name, 0) if nb > 1 else 0
    triples = sht_triples(batch, nhalf, nm, lmax, 2 if pair else 0, m0)
    real = torch.float32 if cdtype == torch.complex64 else torch.float64
    if not tc:
        flops = (shared / nb + FLOP_PER_TRIPLE[name] - shared) * triples
        return bound(nbytes, flops, real)
    contraction = (FLOP_PER_TRIPLE[name] - shared) * triples * (
        TF32_PASSES if real == torch.float32 else 1)
    t_ops = (shared / nb * triples / PEAK_FLOP_PER_S[real]
             + contraction / TENSOR_PEAK[real]) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def group_bounds(name, batch, nhalf, nm, lmax, cdtype, nb):
    """{bound_ms, bound_by, bound_fp32_ms} of one launch at ``nb``: a
    grouped analysis' bound with its contraction on the tensor cores, and
    the bound with it on the FP32 pipe; any other launch's one bound
    twice."""
    fp32, by = sht_bound(name, batch, nhalf, nm, lmax, cdtype, nb=nb)
    tc = nb > 1 and name.startswith("analysis")
    ms, by = (sht_bound(name, batch, nhalf, nm, lmax, cdtype, nb=nb, tc=True)
              if tc else (fp32, by))
    return dict(bound_ms=ms, bound_by=by, bound_fp32_ms=fp32)


def bounds_txt(row):
    """A launch's bounds as the lines print them."""
    txt = f"bound {row['bound_ms']:.2f} ms ({row['bound_by']})"
    if row["bound_fp32_ms"] != row["bound_ms"]:
        txt += f", {row['bound_fp32_ms']:.2f} ms with the contraction on FP32"
    return txt


def issue_share(name, dims, ms, fma32, paths=None):
    """The vector instruction rate of one SHT launch as a share of FP32 FMA.

    A kernel with several paths has a count for each; with ``paths`` (the
    launch's sub-chunks on each path) the counts are weighted by them.
    """
    batch, nhalf, nm = dims
    spin = 2 if name.endswith("pair_folded") else 0
    triples = sht_triples(batch, nhalf, nm, LMAX, spin)
    counts = INSTR_PER_TRIPLE[name]
    counts = counts if isinstance(counts, tuple) else (counts,)
    rates = [c * triples / (ms / 1e3) for c in counts]
    # an FMA instruction is 2 of the probe's operations
    txt = (f"{name} ~{'-'.join(map(str, counts))} instr/triple x "
           f"{triples:.3g} triples in {ms:.1f} ms = "
           f"{'-'.join(f'{r / 1e12:.2f}' for r in rates)} Tinstr/s = "
           f"{'-'.join(f'{100 * r / (fma32 / 2):.1f}' for r in rates)}% of "
           f"the FP32 fma issue rate")
    if paths:
        total = sum(paths.values())
        mean = sum(c * paths[p] for c, p in zip(counts, PATHS)) / total
        rate = mean * triples / (ms / 1e3)
        txt += (f"; by its paths' shares ~{mean:.1f} instr/triple = "
                f"{rate / 1e12:.2f} Tinstr/s = {100 * rate / (fma32 / 2):.1f}%")
    return txt


def path_shares(name, *args, **kw):
    """(counts, text): the sub-chunks of one diagnostic launch by path."""
    from heracles_tpu_torch.ops import sht_kernels

    counts = sht_kernels.path_counts(name, *args, **kw)
    total = sum(counts.values())
    check(counts["steady"] > 0, f"{name} never took its steady path: {counts}")
    txt = ", ".join(f"{p} {100 * counts[p] / total:.1f}%" for p in PATHS)
    return counts, f"{name} paths (warp sub-chunks of 8 l): {txt}"


def rect_band_rel(got, want, nbands=10):
    """max |got - want| / max |want| over each l-band of rectangular
    (..., lmax + 1, nm) alms."""
    edges = np.linspace(0, want.shape[-2], nbands + 1).astype(int)
    diff = (got.to(want.dtype) - want).abs()
    return [diff[..., a:b, :].max().item() / want[..., a:b, :].abs().max().item()
            for a, b in zip(edges[:-1], edges[1:])]


def l_band_rel(got, want, ls, nbands=10):
    """max |got - want| / max |want| over the packed alms of each l-band."""
    edges = np.linspace(0, int(ls.max()) + 1, nbands + 1).astype(int)
    diff = (got.to(want.dtype) - want).abs()
    out = []
    for a, b in zip(edges[:-1], edges[1:]):
        band = (ls >= a) & (ls < b)
        out.append(diff[..., band].max().item() / want[..., band].abs().max().item())
    return out


def phase7(dev, maps, cls, fma32, smi):
    """Synthesis at full size; returns (kernel reports, launches)."""
    import heracles_tpu_torch as th
    from heracles_tpu_torch import tracing
    from heracles_tpu_torch.ops import sht, sht_kernels, wigner

    t = time.perf_counter()
    mapper = th.HealpixMapper(NSIDE, LMAX, dtype=torch.float32, device=dev,
                              iterations=ITERATIONS)
    fields = {
        "POS": th.Positions(mapper, "RA", "DEC", mask="VIS", overdensity=False),
        "SHE": th.Shears(mapper, "RA", "DEC", "G1", "G2", "W", mask="VIS"),
    }
    data = {k: v for k, v in maps.items() if k[0] in fields}
    reset_counts()
    alms, t_alms = sync_time(lambda: th.transform(fields, data))
    launches, plain_runs = counts()
    # the bins' maps of a field transform in one stack
    # (``mapping._STACK_BYTES``): per stack one analysis per iteration and
    # the first, one synthesis per iteration
    check(tracing.TRANSFORM_STACKS == {NBINS: 2},
          f"transform stacks {dict(tracing.TRANSFORM_STACKS)}, expected "
          f"{{{NBINS}: 2}}")
    want = {"analysis_spin0_folded": ITERATIONS + 1,
            "analysis_pair_folded": ITERATIONS + 1,
            "synthesis_spin0_folded": ITERATIONS,
            "synthesis_pair_folded": ITERATIONS}
    check(dict(launches) == want, f"transform launches {dict(launches)}, "
          f"expected {want}")
    check(sum(plain_runs.values()) == 0, f"plain versions ran: {plain_runs}")
    cls_it, t_cls = sync_time(lambda: th.angular_power_spectra(alms))
    change = {}
    for key, cl in cls_it.items():
        arr = np.asarray(cl, np.float64)
        check(bool(np.all(np.isfinite(arr))), f"refined {key} not finite")
        ref = np.asarray(cls[key], np.float64)
        # l >= 2: the spin-2 rows below are zero
        edges = np.linspace(2, LMAX + 1, 11).astype(int)
        change[key] = max(
            float(np.abs(arr[..., a:b] - ref[..., a:b]).max()
                  / np.abs(ref[..., a:b]).max())
            for a, b in zip(edges[:-1], edges[1:]))

    pos, she = alms["POS", 0], alms["SHE", 0]
    m_pos, t_syn0 = sync_time(lambda: mapper.synthesize(pos, spin=0))
    m_she, t_syn2 = sync_time(lambda: mapper.synthesize(she, spin=2))
    launches, plain_runs = counts()
    for name in SYNTHESIS_KERNELS:
        check(launches.get(name, 0) == want[name] + 1,
              f"{name}: {launches.get(name, 0)} launches after synthesize")
    check(sum(plain_runs.values()) == 0, f"plain versions ran: {plain_runs}")
    npix = 12 * NSIDE**2
    check(tuple(m_pos.shape) == (npix,) and tuple(m_she.shape) == (2, npix),
          f"synthesized shapes {tuple(m_pos.shape)}, {tuple(m_she.shape)}")
    for label, m in (("POS", m_pos), ("SHE", m_she)):
        check(m.array.dtype == torch.float32, f"{label} map {m.array.dtype}")
        check(bool(torch.isfinite(m.array).all()), f"{label} map not finite")
    del m_pos, m_she

    # bin 0 through each kernel and its plain version
    x, lch, lsh = sht._geometry(NSIDE, dev)
    a0 = sht.unpack_alm(pos.array, LMAX)
    eb = sht.unpack_alm(she.array, LMAX)
    a_p = -(eb[0] + 1j * eb[1])
    a_m = (-(eb[0] - 1j * eb[1])).conj().resolve_conj()
    report = {}
    for name, args, extra, tol in (
        ("synthesis_spin0_folded", (a0,), (), TOL[torch.complex64]),
        ("synthesis_pair_folded", (a_p, a_m), (2,), PAIR_SYNTH_TOL32),
    ):
        kernel = getattr(sht_kernels, name)
        plain = getattr(wigner, name + "_plain")
        event_ms(lambda: kernel(*args, x, lch, lsh, LMAX, *extra))  # warm
        got, ms = event_ms(lambda: kernel(*args, x, lch, lsh, LMAX, *extra))
        want_g, plain_ms = event_ms(lambda: plain(*args, x, lch, lsh, LMAX,
                                                  *extra))
        errs = [compare(g, w, *tol, what=name) for g, w in zip(got, want_g)]
        dims = (1, x.shape[0], LMAX + 1)
        bound_ms, bound_by = sht_bound(name, *dims, LMAX, torch.complex64)
        report[name] = dict(max_abs_err=max(e[0] for e in errs),
                            rel=max(e[1] for e in errs), ms=ms,
                            plain_ms=plain_ms, dims=dims, bound_ms=bound_ms,
                            bound_by=bound_by)
        del got, want_g
    spin0_paths, spin0_paths_txt = path_shares(
        "synthesis_spin0_folded", a0, x, lch, lsh, LMAX)
    pair_paths, pair_paths_txt = path_shares(
        "synthesis_pair_folded", a_p, a_m, x, lch, lsh, LMAX, 2)
    paths = {"synthesis_spin0_folded": spin0_paths,
             "synthesis_pair_folded": pair_paths}
    del a0, eb, a_p, a_m

    # round trip of random band-limited alms
    ls, ms_ = sht._pack_index(LMAX, LMAX, dev)
    rng = np.random.default_rng(3)
    a_np = rng.normal(size=ls.numel()) + 1j * rng.normal(size=ls.numel())
    a_np[ms_.cpu().numpy() == 0] = a_np[ms_.cpu().numpy() == 0].real
    trip = {}
    for cdtype, bar in ((torch.complex128, 1e-8), (torch.complex64, 1e-3)):
        alm = torch.as_tensor(a_np, dtype=cdtype, device=dev)
        m = sht.alm2map(alm, NSIDE, LMAX)
        for it in (0, ITERATIONS):
            (back, sec) = sync_time(lambda: sht.map2alm(m, LMAX, iterations=it))
            rel = l_band_rel(back, alm, ls)
            trip[cdtype, it] = (rel, sec)
        tag = "f64" if cdtype == torch.complex128 else "f32"
        worst = max(trip[cdtype, ITERATIONS][0])
        check(worst <= bar, f"round trip {tag} after {ITERATIONS} iterations: "
              f"{worst:.2e} > {bar:.0e}")
        del m, alm

    parts = [f"{n}: kernel {r['ms']:.1f} ms, plain {r['plain_ms']:.1f} ms, "
             f"bound {r['bound_ms']:.2f} ms ({r['bound_by']}), max|d| "
             f"{r['max_abs_err']:.3e} ({r['rel']:.2e} of max); "
             f"{issue_share(n, r['dims'], r['ms'], fma32, paths.get(n))}"
             for n, r in report.items()] + [spin0_paths_txt, pair_paths_txt]
    trip_txt = "; ".join(
        f"{'f64' if c == torch.complex128 else 'f32'} iter {it} "
        f"({sec:.2f} s): " + " ".join(f"{v:.1e}" for v in rel)
        for (c, it), (rel, sec) in trip.items())
    change_txt = ", ".join(f"{k}: {v:.2e}" for k, v in change.items())
    print(f"phase 7 synthesis n{NSIDE} l{LMAX} f32, {ITERATIONS} iterations: "
          f"transform {t_alms:.2f} s (POS+SHE x {NBINS} bins), spectra "
          f"{t_cls:.2f} s, synthesize spin 0 {t_syn0:.2f} s, spin 2 "
          f"{t_syn2:.2f} s; launches {dict(launches)}; no plain run; "
          f"band-max change of the refined spectra against phase 3's: "
          f"{change_txt}; {'; '.join(parts)}; round trip alm2map -> map2alm, "
          f"max|da|/max|a| per l-band (10 bands): {trip_txt}; card {smi} "
          f"({time.perf_counter() - t:.1f} s)", flush=True)
    return report, launches


def phase8(dev, maps, page, a32, a64, smi):
    """The mapper's ``dd=``, ``resample`` and ``map_values`` at full size.

    ``maps``: phase 3's maps; ``page``: rows of bin 0's catalogue; ``a32``,
    ``a64``: phase 4's float32 and float64 alms of bin 0's POS map.
    """
    import heracles_tpu_torch as th
    from heracles_tpu_torch.healpix import ring_geometry
    from heracles_tpu_torch.ops import sht, sht_kernels

    t = time.perf_counter()
    pos = maps["POS", 0]
    check(pos.array.dtype == torch.float32, f"POS map {pos.array.dtype}")

    # dd=True: the float64 kernel on a float32 map, complex64 alms back
    plain32 = th.HealpixMapper(NSIDE, LMAX, dtype=torch.float32, device=dev,
                               deconvolve=False)
    wide = th.HealpixMapper(NSIDE, LMAX, dtype=torch.float32, device=dev,
                            deconvolve=False, dd=True)
    _, t32 = sync_time(lambda: plain32.transform(pos))
    reset_counts()
    alm_dd, t_dd = sync_time(lambda: wide.transform(pos))
    by_precision = dict(sht_kernels.LAUNCHES_BY_PRECISION)
    _, plain_runs = counts()
    check(by_precision == {("analysis_spin0_folded", "f64"): 1},
          f"dd=True transform launched {by_precision}")
    check(sum(plain_runs.values()) == 0, f"plain versions ran: {plain_runs}")
    check(alm_dd.array.dtype == torch.complex64,
          f"dd=True alms are {alm_dd.array.dtype}")
    ls, _ = sht._pack_index(LMAX, LMAX, dev)
    rel32 = l_band_rel(a32, a64, ls)
    rel_dd = l_band_rel(alm_dd.array, a64, ls)
    # the lowest band is the float32 ring FFT's error in both: the worst
    # band and the bands together must be lower with dd
    check(max(rel_dd) < max(rel32) and sum(rel_dd) < sum(rel32),
          f"dd=True alms are no closer to float64's: {rel_dd} against {rel32}")
    del alm_dd

    # resample 4096 -> 2048: the pixels' own z must land on the coarse
    # pixels' z (any misordering of the children shows as O(1)), and the
    # mean of children keeps the map's sum
    coarse = th.HealpixMapper(NSIDE // 2, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    th.healpix._udgrade_gather(NSIDE, NSIDE // 2)
    t_table = time.perf_counter() - t0

    def z_map(nside):
        g = ring_geometry(nside)
        return torch.repeat_interleave(
            torch.as_tensor(g["z"], dtype=torch.float32, device=dev),
            torch.as_tensor(g["npix"], device=dev))

    got_z, t_resample = sync_time(lambda: coarse.resample(z_map(NSIDE)))
    z_err = (got_z.array - z_map(NSIDE // 2)).abs().max().item()
    # a coarse pixel spans less than 2 rings of its own resolution in z
    check(z_err < 4.0 / (3.0 * (NSIDE // 2)), f"resample moved z by {z_err:.3e}")
    low = coarse.resample(pos)
    npix_low = 12 * (NSIDE // 2) ** 2
    check(tuple(low.shape) == (npix_low,) and low.array.dtype == torch.float32,
          f"resampled map {tuple(low.shape)} {low.array.dtype}")
    check(low.metadata == {**pos.metadata, "nside": NSIDE // 2},
          f"resampled metadata {low.metadata}")
    sums = (4.0 * low.array.double().sum().item(), pos.array.double().sum().item())
    check(abs(sums[0] - sums[1]) <= 1e-6 * abs(sums[1]),
          f"resample changed the map's sum: {sums}")
    del got_z, low

    # map_values against add: one page, one row and two
    mapper = th.HealpixMapper(NSIDE, LMAX, dtype=torch.float32, device=dev)
    lon, lat, w = page["RA"], page["DEC"], page["W"]
    scatter = {}
    for label, dims, values in (("(npix)", (), w),
                                ("(2, npix)", (2,), np.stack([w, -2.0 * w]))):
        want = mapper.add(mapper.begin(*dims), lon, lat, values)
        data = mapper.create(*dims)
        _, sec = sync_time(lambda: mapper.map_values(lon, lat, data, values))
        # float32 atomics: a pixel's few values may add in another order
        err = (data.array - want).abs().max().item()
        check(err <= 1e-6 * want.abs().max().item() and
              bool(data.array.abs().sum() > 0),
              f"map_values {label} differs from add by {err:.3e}")
        scatter[label] = (err, sec)
    scatter_txt = ", ".join(f"{k} max|d| {e:.1e} ({sec * 1e3:.1f} ms)"
                            for k, (e, sec) in scatter.items())
    print(f"phase 8 dd=True transform of bin 0's f32 POS map: {t_dd:.3f} s "
          f"against {t32:.3f} s without, launches {by_precision}, alms "
          f"complex64; max|da|/max|a| per l-band (10 "
          f"bands) against the float64 transform: f32 "
          f"{' '.join(f'{v:.1e}' for v in rel32)}; dd "
          f"{' '.join(f'{v:.1e}' for v in rel_dd)}; resample n{NSIDE} -> "
          f"n{NSIDE // 2}: host table {t_table:.1f} s, z map {t_resample:.2f} s, "
          f"max |dz| {z_err:.2e}, sum kept to "
          f"{abs(sums[0] - sums[1]) / abs(sums[1]):.1e}; map_values against add, "
          f"{len(lon)} rows: {scatter_txt}; card {smi} "
          f"({time.perf_counter() - t:.1f} s)", flush=True)


def _dices_inputs(dev, nside=DICES_NSIDE, lmax=DICES_LMAX):
    """bench.py's ``build_dices_real`` maps (seed 9) as float32 DeviceMaps
    on ``dev``, its fields, and a function of the region map."""
    import heracles_tpu_torch as th

    npix = 12 * nside**2
    rng = np.random.default_rng(9)
    mapper = th.HealpixMapper(nside, lmax, deconvolve=False,
                              dtype=torch.float32, device=dev)
    fields = {
        "POS": th.Positions(mapper, "RA", "DEC", mask="VIS"),
        "SHE": th.Spin2Field(mapper, "RA", "DEC", "G1", "G2", mask="VIS"),
        "VIS": th.Visibility(mapper),
    }
    pos = mapper.create(spin=0)
    pos[:] = rng.normal(size=npix)
    th.update_metadata(pos, fsky=1.0, musq=1.0, dens=100.0)
    she = mapper.create(2, spin=2)
    she[:] = rng.normal(size=(2, npix))
    th.update_metadata(she, fsky=1.0, musq=1.0, dens=100.0)
    vis = mapper.create(spin=0)
    vis[:] = 1.0
    th.update_metadata(vis, fsky=1.0)

    def regions(njk):
        jk = np.zeros(npix)
        edges = np.linspace(0, npix, njk + 1).astype(int)
        for k in range(njk):
            jk[edges[k] : edges[k + 1]] = k + 1
        return jk

    return mapper, fields, {("POS", 0): pos, ("SHE", 0): she}, \
        {("VIS", 0): vis}, regions


def _same_cls(got, want, what, rtol=DICES_RTOL):
    """Largest |got - want| / max |want| over two spectra dicts; raises
    above ``rtol``."""
    check(set(got) == set(want), f"{what}: keys {set(got)} != {set(want)}")
    worst = 0.0
    for key, w in want.items():
        g = np.asarray(got[key], np.float64)
        w = np.asarray(w, np.float64)
        check(bool(np.all(np.isfinite(g))), f"{what} {key} not finite")
        worst = max(worst, float(np.abs(g - w).max() / np.abs(w).max()))
    check(worst <= rtol, f"{what}: {worst:.2e} of max")
    return worst


def phase9(dev, smi):
    """DICES at full width: the path, its checks, and the two analysis
    kernels at the DICES batch against their plain versions, at every
    group of maps.  Returns the file-mode run's host alms of 8 regions
    (for phase 11), the kernels' reports at the DICES batch (by nb under
    ``by_nb``) and the device-mode run's launches by (kernel, nb)."""
    import shutil

    import heracles_tpu_torch as th
    from heracles_tpu_torch import dices
    from heracles_tpu_torch.dices import jackknife as jk_mod
    from heracles_tpu_torch.ops import ringfft, sht, sht_kernels, wigner

    t = time.perf_counter()
    nside, lmax, njk = DICES_NSIDE, DICES_LMAX, DICES_NJK
    mapper, fields, data, vmaps, regions = _dices_inputs(dev)
    jk = regions(njk)
    setup = time.perf_counter() - t
    need = jk_mod._estimate_alm_bytes(data, vmaps, fields, njk)
    budget = jk_mod._device_cache_budget()
    check(need <= budget, f"alm cache {need} B over the budget {budget} B")
    secs = {}

    # device mode: the cache on the card, the samples assembled there
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    cache, secs["alms"] = sync_time(lambda: dices.compute_jk_alms(
        data, vmaps, jk, fields, dir=None, region_batch=DICES_BATCH))
    launches, plain_runs = counts()
    # the automatic groups of maps (sht_kernels.pick_nb) of that run
    by_nb = dict(sht_kernels.LAUNCHES_BY_NB)
    for name in DICES_KERNELS:
        check(any(nb > 1 for (n, nb) in by_nb if n == name),
              f"{name} ran no grouped launch in DICES: {by_nb}")
    nbatch = -(-njk // DICES_BATCH)
    # k = 0: one launch per map; then one per map key and batch of regions
    want = {"analysis_spin0_folded": 2 + 2 * nbatch,
            "analysis_pair_folded": 1 + nbatch}
    check(dict(launches) == want, f"DICES alms launches {dict(launches)}, "
          f"expected {want}")
    check(sum(plain_runs.values()) == 0, f"plain versions ran: {plain_runs}")
    check(len(cache) == 2 * (njk + 1) and all(
        isinstance(a, th.DeviceMap) and a.device.type == dev.type
        for alms in cache.values() for a in alms.values()),
        "the alm cache is not resident on the card")
    cls1, secs["cls"] = sync_time(lambda: jk_mod.compute_jk_cls_from_alms(
        jk, fields, nd=1, dir=None, alms_cache=cache))
    after, plain_runs = counts()
    check(dict(after) == want, f"the spectra stage launched {dict(after)}")
    check(sum(plain_runs.values()) == 0, f"plain versions ran: {plain_runs}")
    peak = torch.cuda.max_memory_allocated()
    check(len(cls1) == njk, f"{len(cls1)} delete-1 samples")
    for regions_k, cls in cls1.items():
        for key, cl in cls.items():
            check(bool(np.all(np.isfinite(np.asarray(cl)))),
                  f"sample {regions_k} {key} not finite")
    cov, secs["covariance"] = sync_time(
        lambda: dices.jackknife_covariance(cls1, nd=1))
    check(len(cov) == 6, f"{len(cov)} covariance blocks")
    key = ("POS", "POS", "POS", "POS", 0, 0, 0, 0)
    samples = np.stack([np.asarray(c["POS", "POS", 0, 0]) for c in cls1.values()])
    oracle = np.cov(samples.T, bias=False) * (njk - 1) ** 2 / njk
    cov_err = float(np.abs(np.asarray(cov[key]) - oracle).max()
                    / np.abs(oracle).max())
    check(cov_err <= DICES_RTOL, f"covariance against np.cov: {cov_err:.2e}")

    # SHT linearity: full - region k against the complement-masked map
    jk_t = torch.as_tensor(jk, dtype=torch.float32, device=dev)
    lin = []
    for (name, k), maps in ((("data", 1), data), (("data", njk), data),
                            (("vis", 7), vmaps)):
        for mkey, m in maps.items():
            spin = fields[mkey[0]].spin
            full, part = cache[name, 0][mkey].array, cache[name, k][mkey].array
            direct = mapper.transform(m.array * (jk_t != k), spin=spin).array
            lin.append(compare(full - part, direct, *TOL[torch.complex64],
                               what=f"SHT linearity {mkey} region {k}")[1])
            del direct

    # where the spectra stage's seconds go: one batch of sample grids (the
    # device contraction and the host Results), and the host scans of the
    # region map (jackknife_fsky twice a sample, _n_regions once a call)
    from heracles_tpu_torch.twopoint import angular_power_spectra_sample_stacks

    R = {mkey: torch.stack([cache["data", r][mkey].array
                            for r in range(1, njk + 1)])
         for mkey in cache["data", 0]}
    nsample = min(16, njk)  # compute_jk_cls_from_alms' sample_batch
    idx = torch.arange(nsample, device=dev)[:, None]
    stacks = {mkey: jk_mod._assemble_deletek(cache["data", 0][mkey].array,
                                             R[mkey], idx) for mkey in R}
    md = {mkey: cache["data", 0][mkey].metadata for mkey in R}
    _, t_grids = sync_time(lambda: angular_power_spectra_sample_stacks(
        stacks, md, nsample))
    del R, stacks
    t0 = time.perf_counter()
    jk_mod.jackknife_fsky(jk, 1)
    t_fsky = time.perf_counter() - t0
    t0 = time.perf_counter()
    jk_mod._n_regions(jk)
    t_unique = time.perf_counter() - t0

    # two delete-1 samples against alms subtracted by hand
    by_hand = []
    for k in (1, njk):
        alms = {mkey: th.DeviceMap(a.array - cache["data", k][mkey].array,
                                   dtype=a.dtype)
                for mkey, a in cache["data", 0].items()}
        cls = dices.correct_footprint_fsky(
            dices.correct_bias(th.angular_power_spectra(alms), jk, fields, k),
            jk, k)
        by_hand.append(_same_cls(cls, cls1[(k,)], f"delete-1 sample {k}"))
    del cache

    # file mode at 8 regions, then the same directory again
    fdir = Path(__file__).resolve().parent / "build" / "dices_phase9"
    shutil.rmtree(fdir, ignore_errors=True)
    jk8 = regions(DICES_FILE_NJK)
    reset_counts()
    alms8, secs["file alms"] = sync_time(lambda: dices.compute_jk_alms(
        data, vmaps, jk8, fields, dir=str(fdir), region_batch=DICES_BATCH))
    file_launches, plain_runs = counts()
    nbatch8 = -(-DICES_FILE_NJK // DICES_BATCH)
    want8 = {"analysis_spin0_folded": 2 + 2 * nbatch8,
             "analysis_pair_folded": 1 + nbatch8}
    check(dict(file_launches) == want8, f"file-mode launches "
          f"{dict(file_launches)}, expected {want8}")
    check(sum(plain_runs.values()) == 0, f"plain versions ran: {plain_runs}")
    cls8, secs["file cls"] = sync_time(lambda: jk_mod.compute_jk_cls_from_alms(
        jk8, fields, nd=1, dir=str(fdir)))
    reset_counts()
    again, secs["file alms again"] = sync_time(lambda: dices.compute_jk_alms(
        data, vmaps, jk8, fields, dir=str(fdir), region_batch=DICES_BATCH))
    cls8_again, secs["file cls again"] = sync_time(
        lambda: jk_mod.compute_jk_cls_from_alms(jk8, fields, nd=1,
                                                dir=str(fdir)))
    relaunch, _ = counts()
    check(not again and sum(relaunch.values()) == 0,
          f"the second call launched {dict(relaunch)}")
    for k, cls in cls8.items():
        _same_cls(cls8_again[k], cls, f"file-mode sample {k} read back",
                  rtol=0.0)
    # delete-2 debiasing and shrinkage at 8 regions
    cls8_0 = jk_mod.compute_jk_cls_from_alms(jk8, fields, nd=0,
                                             dir=str(fdir))[()]
    cls8_2, secs["file delete-2 cls"] = sync_time(
        lambda: jk_mod.compute_jk_cls_from_alms(jk8, fields, nd=2,
                                                dir=str(fdir)))
    check(len(cls8_2) == DICES_FILE_NJK * (DICES_FILE_NJK - 1) // 2,
          f"{len(cls8_2)} delete-2 samples")
    shutil.rmtree(fdir, ignore_errors=True)
    t0 = time.perf_counter()
    cov8 = dices.jackknife_covariance(cls8)
    q = dices.delete2_correction(cls8_0, cls8, cls8_2)
    deb = dices.debias_covariance(cov8, cls8_0, cls8, cls8_2)
    secs["delete-2 debiasing"] = time.perf_counter() - t0
    for ckey, block in q.items():
        arr = np.asarray(block)
        off = ~np.eye(arr.shape[-1], dtype=bool)
        check(not arr[..., off].any(), f"delete-2 correction {ckey} is not "
              "diagonal")
        check(bool(np.isfinite(arr).all()), f"delete-2 correction {ckey}")
        check(np.array_equal(np.asarray(deb[ckey]),
                             np.asarray(cov8[ckey]) - arr),
              f"debias_covariance {ckey}")
    # shrinkage of the POS auto-covariance from l = 2 towards the Gaussian
    t0 = time.perf_counter()
    target_all = dices.gaussian_covariance(cls8_0)
    check(all(bool(np.isfinite(np.asarray(b)).all()) for b in
              target_all.values()), "gaussian covariance not finite")
    pp = ("POS", "POS", 0, 0)

    def cut(cl):
        return th.Result(np.asarray(cl.array)[..., 2:], spin=cl.spin,
                         ell=np.arange(2, lmax + 1))

    samples8 = {r: {pp: cut(c[pp])} for r, c in cls8.items()}
    target = dices.gaussian_covariance({pp: cut(cls8_0[pp])})
    lam = dices.shrinkage_factor(samples8, target)
    cov_pp = dices.jackknife_covariance(samples8)
    shrunk = dices.shrink(cov_pp, target, lam)
    secs["shrinkage"] = time.perf_counter() - t0
    check(bool(np.isfinite(lam)), f"shrinkage factor {lam}")
    dg = [np.diag(np.asarray(b)) for b in (shrunk[key], cov_pp[key])]
    shrink_err = float(np.abs(dg[0] - dg[1]).max() / np.abs(dg[1]).max())
    check(shrink_err <= DICES_RTOL, f"shrink moved the variances by "
          f"{shrink_err:.2e}")

    # the two analysis kernels at the DICES batch against their plain
    # versions: bin 0's maps masked to regions 1..8, as the path builds them
    x, lch, lsh = sht._geometry(nside, dev)
    w = sht.ring_weights(nside)
    ks = torch.arange(1, DICES_BATCH + 1, dtype=torch.float32, device=dev)
    pos = jk_mod._masked_stack(data["POS", 0].array, jk_t, ks)
    F, _ = ringfft.ring_analysis(pos, nside, lmax + 1, weight=w)
    spin0_args = sht._folded_inputs((F,), (0,))
    she = jk_mod._masked_stack(data["SHE", 0].array, jk_t, ks)
    Fp, Fn = ringfft.ring_analysis(torch.complex(she[:, 0], she[:, 1]), nside,
                                   lmax + 1, weight=w)
    pair_args = sht._folded_inputs((Fp, Fn.conj()), (2, -2))
    del F, Fp, Fn, pos, she
    # (each nb the kernel has: nb = 1 held against the plain version, each
    # group repeating its bits and within the float32 bar of nb = 1 and of
    # the plain version, its float32 error per l-band against the float64
    # kernel at most 1.25 times nb = 1's; CUDA-event time, best of 3; the
    # bounds at that nb)
    report = {}
    dims = (DICES_BATCH, x.shape[0], lmax + 1)
    for name, args, extra in (("analysis_spin0_folded", spin0_args, ()),
                              ("analysis_pair_folded", pair_args, (2,))):
        kernel = getattr(sht_kernels, name)
        plain = getattr(wigner, name + "_plain")
        want_k, plain_ms = event_ms(lambda: plain(*args, x, lch, lsh, lmax,
                                                  *extra))
        want_k = _as_tuple(want_k)
        ref64 = _as_tuple(kernel(*(a.to(torch.complex128) for a in args), x,
                                 lch, lsh, lmax, *extra, nb=1))
        rows, base, bands = {}, None, {}
        for nb in wigner.GROUP_SIZES[name]:
            def call():
                return kernel(*args, x, lch, lsh, lmax, *extra, nb=nb)

            got, ms = best_ms(call)
            got = _as_tuple(got)
            if base is None:
                errs = [compare(g, p, *TOL[torch.complex64],
                                what=f"{name} DICES batch")
                        for g, p in zip(got, want_k)]
                base = got
            else:
                errs = check_grouped(call, name, nb, got, base, want_k,
                                     TOL[torch.complex64],
                                     f"{name} DICES batch")
            bands[nb] = grouped_bands(got, ref64, bands.get(1),
                                      f"{name} nb={nb} DICES batch")
            rows[nb] = dict(ms=ms, bands=bands[nb],
                            max_abs_err=max(e[0] for e in errs),
                            rel=max(e[1] for e in errs), **group_bounds(
                                name, *dims, lmax, torch.complex64, nb))
            del got
        report[name] = dict(plain_ms=plain_ms, by_nb=rows, **rows[1])
        del want_k, base, ref64
    # the pair analysis' groups by path (a diagnostic launch each)
    pair_paths = "; ".join(
        path_shares("analysis_pair_folded", *pair_args, x, lch, lsh, lmax, 2,
                    nb=nb)[1] + f" at nb={nb}"
        for nb in wigner.GROUP_SIZES["analysis_pair_folded"][1:])

    stage_txt = ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
    kern_txt = "; ".join(
        f"{n} at batch {DICES_BATCH}: plain {r['plain_ms']:.1f} ms, nb=1 "
        f"max|d| {r['max_abs_err']:.2e} ({r['rel']:.1e} of max), every nb "
        f"repeating its bits within the float32 bar of nb=1 and the plain "
        f"version; " + ", ".join(
            f"nb={nb} {row['ms']:.2f} ms (max|d| {row['max_abs_err']:.2e}, "
            f"{row['rel']:.1e} of max; {bounds_txt(row)}; f32 vs f64 "
            f"kernel per l-band {bands_txt(row['bands'])})"
            for nb, row in r["by_nb"].items())
        for n, r in report.items())
    print(f"phase 9 DICES n{nside} l{lmax} f32, {njk} regions in batches of "
          f"{DICES_BATCH}, device mode (alm cache {need / 1e9:.2f} GB <= "
          f"budget {budget / 2**30:.0f} GiB, so dir=None keeps it on the "
          f"card): {stage_txt}; setup {setup:.1f} s; launches {dict(launches)} "
          f"(k = 0 and {nbatch} batches; by (kernel, nb) {by_nb}), none in "
          f"the spectra stage, no plain run; peak {peak / 2**30:.2f} GiB; "
          f"spectra stage split: one batch of {nsample} samples' grids and "
          f"Results {t_grids:.2f} s, one "
          f"jackknife_fsky on the host {t_fsky * 1e3:.0f} ms (2 a sample), "
          f"one _n_regions {t_unique:.2f} s (1 a call); {len(cls1)} finite delete-1 "
          f"samples, {len(cov)} covariance blocks, POS auto against np.cov "
          f"{cov_err:.1e}; SHT linearity max|d|/max "
          f"{' '.join(f'{v:.1e}' for v in lin)}; samples 1 and {njk} against "
          f"alms subtracted by hand {' '.join(f'{v:.1e}' for v in by_hand)}; "
          f"file mode at {DICES_FILE_NJK} regions: launches "
          f"{dict(file_launches)}, the second call none, the same spectra; "
          f"delete-2: {len(cls8_2)} samples, diagonal correction; shrinkage "
          f"factor {lam:.4f}, variances kept to {shrink_err:.1e}; {kern_txt}; "
          f"{pair_paths}; card {smi} ({time.perf_counter() - t:.1f} s)",
          flush=True)
    return alms8, report, by_nb


def point_bound(name, npts, lmax, cdtype):
    """The bound of one analysis launch over points: the spectra read once
    (F; F and conj-F for the pair: the zero southern operands carry no
    data), the alms written once; per triple the recurrence, the emit and
    the contraction of the columns that have data (spin 0: 4 + 1 + 4; the
    pair: 9 + 2 + 2 x 4, its southern FMAs multiply zeros)."""
    pair = name.endswith("pair_folded")
    nin, nalm, flop = (2, 2, 19) if pair else (1, 1, 9)
    nm = lmax + 1
    item = torch.empty((), dtype=cdtype).element_size()
    nbytes = (float(npts) * nm * item * nin + nalm * (lmax + 1) * nm * item
              + npts * (item // 2 + 16))
    triples = sht_triples(1, npts, nm, lmax, 2 if pair else 0)
    real = torch.float32 if cdtype == torch.complex64 else torch.float64
    return bound(nbytes, flop * triples, real)


def spread_bound(npts, nrows, ncomp, w, grid_cells):
    """The spreader's bound: angles and values read once, the padded grid
    written once; per (point, row) 2 w weights of ~8 operations (offset,
    scale, square, subtract, sqrt, subtract, scale, exp) and per stencil
    cell the weight product, the value product and the addition per
    component, in FP64 outside the tensor cores."""
    nbytes = 8.0 * (2 * npts + nrows * npts * ncomp + nrows * grid_cells * ncomp)
    flops = float(npts) * nrows * (16 * w + (1 + 2 * ncomp) * w * w)
    return bound(nbytes, flops, torch.float64, peak=FP64_VECTOR_PEAK)


def _restore_env(name, value):
    import os

    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


def _phase10_cli(root, rows):
    """``python -m heracles_tpu_torch`` alms and spectra on the card, the
    spectra stage again in this process to see its pair grid run on the
    card, and the same stages in this process on the CPU: (seconds, worst
    relative difference, outputs compared)."""
    import logging
    import os

    import heracles_tpu_torch.cli as cli
    from heracles_tpu_torch import twopoint
    from heracles_tpu_torch.fits import FitsFile
    from heracles_tpu_torch.io import read, read_alms

    rng = np.random.default_rng(6)
    cat = root / "catalog.fits"
    FitsFile(str(cat), mode="rw", clobber=True).write_table({
        "RA": rng.uniform(0, 360, rows),
        "DEC": np.degrees(np.arcsin(rng.uniform(-1, 1, rows))),
        "W": rng.uniform(0.5, 1.5, rows),
        "G1": rng.normal(0, 0.1, rows), "G2": rng.normal(0, 0.1, rows),
    }, extname="CATALOG")
    cfg = root / "heracles.cfg"
    cfg.write_text(
        "[defaults]\nnside = 32\nlmax = 48\n"
        "[fields:WHT]\ntype = weights\ncolumns = RA\n\tDEC\n\tW\n"
        "[fields:SHE]\ntype = shears\ncolumns = RA\n\tDEC\n\tG1\n\t-G2\n\tW\n"
        "[fields:DSHE]\ntype = shears\nmapper = discrete\n"
        "columns = RA\n\tDEC\n\tG1\n\t-G2\n\tW\n"
        f"[catalogs:cat]\nsource = {cat}\nselections = 0 =\n"
    )
    # the HEALPix fields deconvolve with the exact window at nside 32,
    # computed on the card in the subprocess and on the CPU here
    env = dict(os.environ, HERACLES_TPU_CACHE=str(root / "cache_cli"),
               PYTHONPATH=str(Path(__file__).resolve().parent))
    out = {}
    t0 = time.perf_counter()
    for stage, args in (("alms", [str(root / "card_alms.fits")]),
                        ("spectra", [str(root / "card_cls.fits"),
                                     str(root / "card_alms.fits")])):
        proc = subprocess.run(
            [sys.executable, "-m", "heracles_tpu_torch", stage, "-c", str(cfg),
             "--no-progress", *args],
            capture_output=True, text=True, env=env, timeout=600)
        check(proc.returncode == 0, f"python -m heracles_tpu_torch {stage} "
              f"exited {proc.returncode}: {proc.stderr[-2000:]}")
    seconds = time.perf_counter() - t0
    out["card"] = (read_alms(str(root / "card_alms.fits")),
                   read(str(root / "card_cls.fits")))
    logger = logging.getLogger("chip_smoke.cli")
    # the spectra stage reads its alms from a file, as host arrays: every
    # pair grid of the stage runs on the card all the same
    grid_devices = []
    real_grid = twopoint.rect_pair_grid

    def spy(a1, a2, ms):
        grid_devices.append((a1.device.type, a2.device.type))
        return real_grid(a1, a2, ms)

    twopoint.rect_pair_grid = spy
    try:
        cli.spectra(str(root / "card_cls_again.fits"), files=[str(cfg)],
                    alms=[str(root / "card_alms.fits")], logger=logger,
                    progress=False, device="cuda")
    finally:
        twopoint.rect_pair_grid = real_grid
    check(grid_devices and set(grid_devices) == {("cuda", "cuda")},
          f"CLI spectra on the card ran its pair grids on {set(grid_devices)}")
    again = read(str(root / "card_cls_again.fits"))
    check(set(again) == set(out["card"][1]) and all(
        np.abs(np.asarray(again[k]) - np.asarray(out["card"][1][k])).max()
        <= CLI_TOL * np.abs(np.asarray(out["card"][1][k])).max()
        for k in again), "CLI spectra in this process differ from the "
          "subprocess's")
    cache_env = os.environ.get("HERACLES_TPU_CACHE")
    os.environ["HERACLES_TPU_CACHE"] = str(root / "cache_cli_cpu")
    try:
        cli.alms(str(root / "cpu_alms.fits"), files=[str(cfg)], logger=logger,
                 progress=False, device="cpu")
        cli.spectra(str(root / "cpu_cls.fits"), files=[str(cfg)],
                    alms=[str(root / "cpu_alms.fits")], logger=logger,
                    progress=False, device="cpu")
    finally:
        _restore_env("HERACLES_TPU_CACHE", cache_env)
    out["cpu"] = (read_alms(str(root / "cpu_alms.fits")),
                  read(str(root / "cpu_cls.fits")))
    worst, n = 0.0, 0
    for got, want in zip(out["card"], out["cpu"]):
        check(set(got) == set(want) and len(want) > 0,
              f"CLI outputs differ in keys: {sorted(got)} {sorted(want)}")
        for key in want:
            g, w = np.asarray(got[key]), np.asarray(want[key])
            check(g.shape == w.shape and bool(np.isfinite(g).all()),
                  f"CLI output {key}: shape {g.shape}, finite")
            rel = float(np.abs(g - w).max() / np.abs(w).max())
            check(rel <= CLI_TOL, f"CLI output {key} card vs cpu {rel:.2e}")
            worst, n = max(worst, rel), n + 1
    return seconds, worst, n


def phase10(dev, smi):
    """Pixel-free alms at full size: the path, its checks, the analysis
    kernels at point shapes and the spreader against their plain versions,
    the exact pixel window and the CLI on the card.  Returns the spreader's
    kernels-line row, the launches, and the exact path's points and alms
    (for phase 11)."""
    import os
    import shutil

    import heracles_tpu_torch as th
    from heracles_tpu_torch.mappers import _phases
    from heracles_tpu_torch.ops import nufft, pixwin, sht, sht_kernels, wigner

    t = time.perf_counter()
    lmax, nlm = DISCRETE_LMAX, (DISCRETE_LMAX + 1) * (DISCRETE_LMAX + 2) // 2
    # discrete_alm_l1000's points and values (bench.py:236-246); spin 2
    # takes two more rows of the same generator
    rng = np.random.default_rng(3)
    theta = np.arccos(rng.uniform(-1, 1, size=DISCRETE_NPTS))
    phi = rng.uniform(0, 2 * np.pi, size=DISCRETE_NPTS)
    vals = rng.normal(size=(1, DISCRETE_NPTS)).astype(np.float32)
    vals2 = rng.normal(size=(2, DISCRETE_NPTS)).astype(np.float32)
    # discrete_gridded_1e7_l1000's (bench.py:262-265)
    rng = np.random.default_rng(4)
    gtheta = np.arccos(rng.uniform(-1, 1, size=GRIDDED_NPTS))
    gphi = rng.uniform(0, 2 * np.pi, size=GRIDDED_NPTS)
    gvals = rng.normal(size=(1, GRIDDED_NPTS))
    # the paged catalogue, pipeline_n4096_l3000's recipe (catalog_arrays)
    rng = np.random.default_rng(5)
    arr = np.empty(PAGED_ROWS, [(n, "f8") for n in ("RA", "DEC", "G1", "G2",
                                                    "W")])
    arr["RA"] = rng.uniform(0, 360, PAGED_ROWS)
    arr["DEC"] = np.degrees(np.arcsin(rng.uniform(-1, 1, PAGED_ROWS)))
    arr["G1"] = rng.normal(0, 0.1, PAGED_ROWS)
    arr["G2"] = rng.normal(0, 0.1, PAGED_ROWS)
    arr["W"] = rng.uniform(0.5, 1.0, PAGED_ROWS)
    catalog = th.ArrayCatalog(arr)
    mapper = th.DiscreteMapper(lmax, dtype=torch.complex64, device=dev)
    paged = th.DiscreteMapper(lmax, dtype=torch.complex64, method="gridded",
                              device=dev)
    fields = {"POS": th.Positions(paged, "RA", "DEC", overdensity=False),
              "SHE": th.Spin2Field(paged, "RA", "DEC", "G1", "G2", "W")}
    w = nufft.kernel_width(GRIDDED_EPS)
    setup = time.perf_counter() - t
    secs = {}

    # the path: exact spin 0 and spin 2, the gridded cell, the paged mapping
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    exact0, secs["exact spin 0"] = sync_time(
        lambda: mapper._adjoint_synthesis(theta, phi, vals, 0))
    exact2, secs["exact spin 2"] = sync_time(
        lambda: mapper._adjoint_synthesis(theta, phi, vals2, 2))
    galm, secs["gridded 1e7"] = sync_time(lambda: nufft.adjoint_gridded(
        gtheta, gphi, gvals, lmax, spin=0, epsilon=GRIDDED_EPS, f32=True,
        device=dev))
    maps, secs["paged map_catalogs 1e7"] = sync_time(
        lambda: th.map_catalogs(fields, {0: catalog}))
    launches, plain_runs = counts()
    peak = torch.cuda.max_memory_allocated()
    npages = -(-PAGED_ROWS // catalog.page_size)
    want = {"analysis_spin0_folded": 3, "analysis_pair_folded": 2,
            "spread": 1 + 2 * npages}
    check(dict(launches) == want, f"phase 10 launches {dict(launches)}, "
          f"expected {want}")
    check(sum(plain_runs.values()) == 0, f"plain versions ran: {plain_runs}")
    for what, a, shape in (("exact spin 0", exact0, (1, nlm)),
                           ("exact spin 2", exact2, (2, nlm)),
                           ("gridded", galm, (1, nlm)),
                           ("paged POS", maps["POS", 0], (nlm,)),
                           ("paged SHE", maps["SHE", 0], (2, nlm))):
        a = a.array if isinstance(a, th.DeviceMap) else a
        check(tuple(a.shape) == shape and a.dtype == torch.complex64
              and a.device.type == "cuda", f"{what}: {tuple(a.shape)} "
              f"{a.dtype} on {a.device}")
        check(bool(torch.isfinite(a).all()), f"{what} not finite")
    for key, spin in ((("POS", 0), 0), (("SHE", 0), 2)):
        md = maps[key].metadata
        check(md["geometry"] == "discrete" and md["spin"] == spin
              and md["lmax"] == lmax, f"paged {key} metadata {md}")
    # paging: the paged POS map against one gridded pass over all rows
    th_all, ph_all = (np.radians(90.0 - arr["DEC"]),
                      np.radians(arr["RA"] % 360.0))
    one = nufft.adjoint_gridded(th_all, ph_all, np.ones((1, PAGED_ROWS)), lmax,
                                epsilon=1e-5, f32=True, device=dev)[0]
    nbar = maps["POS", 0].metadata["nbar"]
    _, paging_rel = compare(maps["POS", 0].array * nbar, one,
                            *TOL[torch.complex64], what="paged POS vs one pass")
    del maps, one

    # the gridded cell once more: its first call above also planned the
    # FFTs of the torus grid
    _, secs["gridded 1e7 again"] = sync_time(lambda: nufft.adjoint_gridded(
        gtheta, gphi, gvals, lmax, spin=0, epsilon=GRIDDED_EPS, f32=True,
        device=dev))
    # the gridded cell's stages, timed apart
    th_t, ph_t, v_t = (torch.as_tensor(a, device=dev)
                       for a in (gtheta, gphi, gvals))
    ntheta, nphi = nufft.grid_shape(lmax)
    pads = [nufft.alloc_padded(1, lmax, w, False, dev) for _ in range(2)]
    event_ms(lambda: nufft.spread_padded(th_t, ph_t, v_t, lmax, w, pads[0]))
    pads[0].zero_()
    _, spread_ms = event_ms(
        lambda: nufft.spread_padded(th_t, ph_t, v_t, lmax, w, pads[0]))
    _, spread_plain_ms = event_ms(
        lambda: nufft.spread_padded_plain(th_t, ph_t, v_t, pads[1], w))
    grids = [nufft.fold_padded(p, lmax, w) for p in pads]
    spread_err, spread_rel = compare(grids[0], grids[1], SPREAD_TOL,
                                     what="spread 1e7")
    _, reduce_ms = event_ms(
        lambda: nufft._reduce_grid(grids[0], lmax, w, 0, torch.complex64))
    # the yardstick: index_add_ of the precomputed stencil (one PyTorch
    # call for the scatter; the weights are made before it, untimed)
    idx, coef = nufft._stencil(th_t, ph_t, w, ntheta, nphi)
    contrib = (v_t[0, :, None, None] * coef).reshape(-1)
    idx = idx.reshape(-1)
    del coef
    flat = torch.zeros((ntheta + w) * (nphi + w), dtype=torch.float64,
                       device=dev)
    event_ms(lambda: flat.index_add_(0, idx, contrib))
    _, library_ms = event_ms(lambda: flat.index_add_(0, idx, contrib))
    del idx, contrib, flat, pads, grids
    # sorted by theta row: what a sort would give the atomics (timed only)
    order = torch.argsort(th_t)
    th_s, ph_s, v_s = th_t[order], ph_t[order], v_t[:, order]
    pad = nufft.alloc_padded(1, lmax, w, False, dev)
    event_ms(lambda: nufft.spread_padded(th_s, ph_s, v_s, lmax, w, pad))
    _, spread_sorted_ms = event_ms(
        lambda: nufft.spread_padded(th_s, ph_s, v_s, lmax, w, pad))
    del th_s, ph_s, v_s, order
    # one call's stages timed apart: bin + scan, order, spread + flush;
    # then the bin statistics, read back after the timed window
    scratch = nufft._launch(th_t, ph_t, v_t, pad, w)
    stage_ms = {}
    for stage, mask in (("bin + scan", nufft.STAGE_BIN),
                        ("order", nufft.STAGE_ORDER),
                        ("spread + flush", nufft.STAGE_SPREAD)):
        _, stage_ms[stage] = event_ms(lambda: nufft._launch(
            th_t, ph_t, v_t, pad, w, stages=mask, scratch=scratch))
    counts_k = scratch["counts"]
    bin_stats = (f"{counts_k.numel()} bins ({int((counts_k > 0).sum())} with "
                 f"points), {int(scratch['subs'][-1])} subproblems, largest "
                 f"bin {int(counts_k.max())} points")
    del scratch, counts_k, pad
    # the kernel's binning against its plain version, exactly
    counts_k, offsets_k, subs_k, sub_bin_k, order_k = nufft.bin_points(
        th_t, ph_t, lmax, w)
    bins_p, counts_p, offsets_p = nufft.bin_points_plain(th_t, ph_t, lmax, w)
    subs_p, sub_bin_p, _ = nufft.subproblems_plain(counts_p)
    order_k = order_k.long()
    check(torch.equal(counts_k.long(), counts_p)
          and torch.equal(offsets_k[:-1].long(), offsets_p)
          and int(offsets_k[-1]) == GRIDDED_NPTS
          and torch.equal(subs_k.long(), subs_p)
          and torch.equal(sub_bin_k.long(), sub_bin_p)
          and torch.equal(torch.sort(order_k).values,
                          torch.arange(GRIDDED_NPTS, device=dev))
          and torch.equal(bins_p[order_k], torch.repeat_interleave(
              torch.arange(counts_p.numel(), device=dev), counts_p)),
          "the kernel's binning of the 1e7 points differs from "
          "bin_points_plain")
    del counts_k, offsets_k, subs_k, sub_bin_k, order_k, bins_p, counts_p
    del offsets_p, subs_p, sub_bin_p
    # the cell's points squeezed into theta in pi/2 -+ 0.2, phi in [0, 0.4]
    # (a deep field: ~90 bins, ~10k subproblems), timed and against plain
    c_t = np.pi / 2 - 0.2 + th_t * (0.4 / np.pi)
    c_p = ph_t * (0.4 / (2 * np.pi))
    pads = [nufft.alloc_padded(1, lmax, w, False, dev) for _ in range(2)]
    event_ms(lambda: nufft.spread_padded(c_t, c_p, v_t, lmax, w, pads[0]))
    pads[0].zero_()
    _, clustered_ms = event_ms(
        lambda: nufft.spread_padded(c_t, c_p, v_t, lmax, w, pads[0]))
    nufft.spread_padded_plain(c_t, c_p, v_t, pads[1], w)
    _, clustered_rel = compare(*(nufft.fold_padded(p, lmax, w) for p in pads),
                               SPREAD_TOL, what="spread 1e7 clustered")
    del pads, c_t, c_p, th_t, ph_t, v_t
    spread_bound_ms, spread_bound_by = spread_bound(
        GRIDDED_NPTS, 1, 1, w, (ntheta + w) * (nphi + w))
    # the spreader at 1e6 points, w 6 and 13, real and complex values
    checks, page_ms = [], {}
    n = SPREAD_CHECK_NPTS
    c_t = torch.as_tensor(gtheta[:n], device=dev)
    c_p = torch.as_tensor(gphi[:n], device=dev)
    for cw in SPREAD_CHECK_WIDTHS:
        for cplx in (False, True):
            v = torch.as_tensor(gvals[:, :n], device=dev)
            if cplx:
                v = torch.complex(v, torch.flip(v, dims=(-1,)))
            pads = [nufft.alloc_padded(1, lmax, cw, cplx, dev) for _ in range(2)]
            nufft.spread_padded(c_t, c_p, v, lmax, cw, pads[0])
            nufft.spread_padded_plain(c_t, c_p, v, pads[1], cw)
            _, rel = compare(*(nufft.fold_padded(p, lmax, cw) for p in pads),
                             SPREAD_TOL, what=f"spread w{cw} 1e6")
            tag = f"w{cw}/{'cplx' if cplx else 'real'}"
            checks.append(f"{tag} {rel:.1e}")
            if cw == w:  # one catalogue page at the cell's width, timed
                def page():
                    return nufft.spread_padded(c_t, c_p, v, lmax, cw, pads[0])
                event_ms(page)  # warm: the allocator holds the scratch
                _, page_ms[tag] = event_ms(page)
            del pads

    # the analysis kernels at the point shapes of discrete_alm_l1000
    order = np.argsort(theta, kind="stable")
    geom = [torch.as_tensor(a, device=dev)
            for a in sht._point_geometry(theta[order])]
    ph_t = torch.as_tensor(phi[order], device=dev)
    phase = _phases(ph_t, lmax, torch.float32)
    F = torch.as_tensor(vals[:, order], device=dev)[..., None] * phase
    u = torch.complex(*(torch.as_tensor(vals2[i, order], device=dev)
                        for i in range(2)))[None]
    Fp = u[..., None] * phase
    Fm = u.conj()[..., None] * phase
    zero = torch.zeros_like(F)
    del phase
    report = {}
    for name, args, extra in (
        ("analysis_spin0_folded", (F, F), ()),
        ("analysis_pair_folded", (Fp, zero, Fm, zero), (2,)),
    ):
        kernel = getattr(sht_kernels, name)
        plain = getattr(wigner, name + "_plain")
        event_ms(lambda: kernel(*args, *geom, lmax, *extra))  # warm
        _, ms = event_ms(lambda: kernel(*args, *geom, lmax, *extra))
        # against the plain version at the bench's CPU size: every eighth
        # point, so that the sorted spread of colatitudes is kept
        sub = [a[:, ::DISCRETE_NPTS // DISCRETE_PLAIN_NPTS].contiguous()
               for a in args]
        gsub = [g[::DISCRETE_NPTS // DISCRETE_PLAIN_NPTS].contiguous()
                for g in geom]
        got = kernel(*sub, *gsub, lmax, *extra)
        want_k, plain_ms = event_ms(lambda: plain(*sub, *gsub, lmax, *extra))
        if name == "analysis_spin0_folded":
            got, want_k = (got,), (want_k,)
        errs = [compare(g, p, *TOL[torch.complex64], what=f"{name} points")
                for g, p in zip(got, want_k)]
        bound_ms, bound_by = point_bound(name, DISCRETE_NPTS, lmax,
                                         torch.complex64)
        report[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by,
                            rel=max(e[1] for e in errs))
    counts_sorted = sht_kernels.path_counts("analysis_spin0_folded", F, F,
                                            *geom, lmax)
    # the same launch on the points in their drawn order
    inv = torch.as_tensor(np.argsort(order), device=dev)
    gun = [g[inv].contiguous() for g in geom]
    Fun = F[:, inv].contiguous()
    counts_unsorted = sht_kernels.path_counts("analysis_spin0_folded", Fun, Fun,
                                              *gun, lmax)
    event_ms(lambda: sht_kernels.analysis_spin0_folded(Fun, Fun, *gun, lmax))
    _, unsorted_ms = event_ms(
        lambda: sht_kernels.analysis_spin0_folded(Fun, Fun, *gun, lmax))
    check(counts_sorted["steady"] > 0, f"B1 on points never took its steady "
          f"path: {counts_sorted}")
    del F, Fp, Fm, zero, u, Fun, gun

    def shares(c):
        total = sum(c.values())
        return "/".join(f"{100 * c[p] / total:.1f}" for p in PATHS)

    # gridded against exact on one block in float64 at epsilon 1e-12; the
    # float32 exact and gridded (epsilon 1e-5) alms against the float64
    # exact ones
    accuracy = []
    exact64 = th.DiscreteMapper(lmax, device=dev)
    g32 = {0: nufft.adjoint_gridded(theta, phi, vals, lmax, epsilon=1e-5,
                                    f32=True, device=dev),
           2: nufft.adjoint_gridded(theta, phi, vals2, lmax, spin=2,
                                    epsilon=1e-5, f32=True, device=dev)}
    for spin, v, e32 in ((0, vals.astype(np.float64), exact0),
                         (2, vals2.astype(np.float64), exact2)):
        ex, t_ex = sync_time(lambda: exact64._adjoint_synthesis(theta, phi, v,
                                                                spin))
        gr, t_gr = sync_time(lambda: nufft.adjoint_gridded(
            theta, phi, v, lmax, spin=spin, epsilon=1e-12, device=dev))
        _, rel = compare(gr.reshape(ex.shape), ex, GRIDDED_TOL,
                         what=f"gridded f64 vs exact spin {spin}")
        _, rel_e = compare(e32, ex, F32_TOL, what=f"exact f32 spin {spin}")
        _, rel_g = compare(g32[spin].reshape(ex.shape), ex, F32_TOL,
                           what=f"gridded f32 spin {spin}")
        accuracy.append(f"spin {spin}: f64 gridded eps 1e-12 {rel:.1e} (exact "
                        f"{t_ex:.2f} s, gridded {t_gr:.2f} s), f32 exact "
                        f"{rel_e:.1e}, f32 gridded eps 1e-5 {rel_g:.1e}")
    discrete = dict(theta=theta, phi=phi, vals=vals, vals2=vals2,
                    exact0=exact0, exact2=exact2)
    del exact0, exact2, galm, g32, ex, gr

    # the exact pixel window at nside 32 on the card and on the CPU
    root = Path(__file__).resolve().parent / "build" / "phase10"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cache_env = os.environ.get("HERACLES_TPU_CACHE")
    pw = {}
    try:
        # the card twice, so that a mismatch says whether the card
        # repeats its own result
        for name, where in (("card", dev), ("cpu", torch.device("cpu")),
                            ("card2", dev)):
            os.environ["HERACLES_TPU_CACHE"] = str(root / f"cache_{name}")
            pw[name], pw[name + "_s"] = sync_time(
                lambda: pixwin.pixel_window_exact.__wrapped__(
                    32, 48, pol=True, device=where))
    finally:
        _restore_env("HERACLES_TPU_CACHE", cache_env)
    pw_d = np.abs(pw["card"] - pw["cpu"])
    pw_err = float(pw_d.max())
    at = np.unravel_index(pw_d.argmax(), pw_d.shape)
    check(pw["card"].shape == (2, 49) and pw_err <= PIXWIN_TOL,
          f"pixel window card vs cpu {pw_err:.2e} at (row, l) = "
          f"{tuple(int(i) for i in at)}: card {pw['card'][at]!r}, cpu "
          f"{pw['cpu'][at]!r}; the card's second run differs from its first "
          f"by {np.abs(pw['card2'] - pw['card']).max():.2e}")
    cli_s, cli_err, cli_n = _phase10_cli(root, 20_000)
    shutil.rmtree(root, ignore_errors=True)

    stage_txt = ", ".join(f"{k} {v:.3f} s" for k, v in secs.items())
    kern_txt = "; ".join(
        f"{n} at {DISCRETE_NPTS} points: kernel {r['ms']:.2f} ms, bound "
        f"{r['bound_ms']:.2f} ms ({r['bound_by']}), plain at "
        f"{DISCRETE_PLAIN_NPTS} points {r['plain_ms']:.1f} ms, max|d|/max "
        f"{r['rel']:.1e}" for n, r in report.items())
    print(f"phase 10 pixel-free alms l{lmax} f32: {stage_txt}; setup "
          f"{setup:.1f} s; launches {dict(launches)} ({npages} pages x 2 "
          f"fields + 1 spreads), no plain run; peak {peak / 2**30:.2f} GiB; "
          f"paged POS vs one pass max|d|/max {paging_rel:.1e}; gridded 1e7 w{w}: spread "
          f"{spread_ms:.3f} ms (sorted by theta {spread_sorted_ms:.3f} ms; "
          f"stages {', '.join(f'{k} {v:.3f}' for k, v in stage_ms.items())} "
          f"ms; {bin_stats}; binning equal to bin_points_plain), "
          f"plain {spread_plain_ms:.1f} ms, index_add_ of the stencil "
          f"{library_ms:.3f} ms, bound {spread_bound_ms:.3f} ms "
          f"({spread_bound_by}), max|d|/max {spread_rel:.1e}; clustered "
          f"1e7 {clustered_ms:.3f} ms, max|d|/max {clustered_rel:.1e}; one "
          f"1e6 page w{w} {', '.join(f'{k} {v:.3f} ms' for k, v in page_ms.items())}; "
          f"reduce {reduce_ms:.2f} ms; spread at 1e6 vs plain {', '.join(checks)}; "
          f"{kern_txt}; B1 path shares steady/dead/full sorted {shares(counts_sorted)}%, "
          f"unsorted {shares(counts_unsorted)}% (B1 unsorted {unsorted_ms:.2f} "
          f"ms); against the float64 exact alms: {'; '.join(accuracy)}; "
          f"pixel window n32 "
          f"l48 pol card {pw['card_s']:.2f} s vs cpu {pw['cpu_s']:.2f} s, "
          f"max|d| {pw_err:.1e} (the card's second run vs its first "
          f"{np.abs(pw['card2'] - pw['card']).max():.1e}); CLI alms + spectra on the card {cli_s:.1f} s, "
          f"{cli_n} outputs vs cpu {cli_err:.1e}; card {smi} "
          f"({time.perf_counter() - t:.1f} s)", flush=True)
    spread = dict(max_abs_err=spread_err, ms=spread_ms,
                  plain_ms=spread_plain_ms, library_ms=library_ms,
                  bound_ms=spread_bound_ms, bound_by=spread_bound_by)
    return spread, launches, discrete


def grid_rel(got, want, lmin=2):
    """max over pairs and l >= lmin of |got - want| / sqrt(want_ii want_jj):
    the difference of two (n, n, l) spectra grids in units of the auto
    spectra (cross spectra may pass through zero)."""
    got = got.to(torch.float64).cpu()
    want = want.to(torch.float64).cpu()
    auto = torch.diagonal(want, dim1=0, dim2=1).T  # (n, l)
    denom = torch.sqrt(auto[:, None, :] * auto[None, :, :])[..., lmin:]
    return float(((got - want)[..., lmin:].abs() / denom).max())


def m0_blocks(dev, per):
    """B1-B4 in float32 and float64 at bin 0's shapes on the two blocks of
    a two-shard "m" split: each block's columns bit for bit the full
    launch's, the padded orders zero, and each block's time against the
    full launch's.  Returns the text of phase 11's line."""
    from heracles_tpu_torch.ops import sht, sht_kernels

    x, lch, lsh = sht._geometry(NSIDE, dev)
    nhalf, nm = x.shape[0], LMAX + 1
    g = torch.Generator(device=dev).manual_seed(11)
    parts = []
    for cdtype in (torch.complex64, torch.complex128):
        prec = "f32" if cdtype == torch.complex64 else "f64"
        for name in ("analysis_spin0_folded", "analysis_pair_folded",
                     "synthesis_spin0_folded", "synthesis_pair_folded"):
            pair = name.endswith("pair_folded")
            rows_in = nhalf if name.startswith("analysis") else LMAX + 1
            nin = (4 if pair else 2) if name.startswith("analysis") else (
                2 if pair else 1)
            ins = [torch.randn((1, rows_in, nm), dtype=cdtype, device=dev,
                               generator=g) for _ in range(nin)]
            extra = (2,) if pair else ()
            kernel = getattr(sht_kernels, name)

            def run(args, m0=0):
                out = kernel(*args, x, lch, lsh, LMAX, *extra, m0)
                return out if isinstance(out, (tuple, list)) else (out,)

            run(ins)  # warm
            full, full_ms = event_ms(lambda: run(ins))
            blocks = []
            for mi in range(2):
                m0 = mi * per
                blk = [torch.nn.functional.pad(t[..., m0:m0 + per],
                                               (0, max(0, m0 + per - nm)))
                       for t in ins]
                run(blk, m0)  # warm
                out, ms = event_ms(lambda: run(blk, m0))
                real = max(0, min(per, nm - m0))
                for o, f in zip(out, full):
                    check(torch.equal(o[..., :real], f[..., m0:m0 + real]),
                          f"{name} {prec} block m0={m0}: columns differ from "
                          "the full launch's")
                    check(not bool(o[..., real:].any()),
                          f"{name} {prec} block m0={m0}: padded orders not "
                          "zero")
                bms, by = sht_bound(name, 1, nhalf, per, LMAX, cdtype, m0=m0)
                blocks.append(dict(m0=m0, ms=ms, share=ms / full_ms,
                                   bound_ms=bms, bound_by=by))
                del out, blk
            fb, _ = sht_bound(name, 1, nhalf, nm, LMAX, cdtype)
            parts.append(
                f"{name} {prec}: full {full_ms:.2f} ms (bound {fb:.2f}); "
                + ", ".join(f"m0 {b['m0']} {b['ms']:.2f} ms = "
                            f"{100 * b['share']:.1f}% (bound "
                            f"{b['bound_ms']:.2f} ms, {b['bound_by']})"
                            for b in blocks))
            del ins, full
    # the (l, m) pairs of each block: the load balance of contiguous blocks
    pairs = [float(np.clip(LMAX + 1 - np.arange(m0, m0 + per), 0, None).sum())
             for m0 in (0, per)]
    share = pairs[0] / sum(pairs)
    return (f"m0 blocks of {per} orders at n{NSIDE} l{LMAX} (bit for bit the "
            f"full launch's columns, padded orders zero; block 0 holds "
            f"{100 * share:.1f}% of the (l, m) pairs): " + "; ".join(parts))


def phase11(dev, smi, p3, dices_alms, discrete):
    """The device mesh at full width: the kernels on blocks of orders, then
    the sharded entry points on make_mesh() over the visible cards and on a
    (2, 2) mesh of four shards on one card.  ``p3``: phase 3's POS and SHE
    maps, alms, mask spectrum and POS x POS mixing matrix; ``dices_alms``:
    phase 9's file-mode alms of 8 regions; ``discrete``: phase 10's points
    and exact alms."""
    import heracles_tpu_torch as th
    from heracles_tpu_torch import dices, parallel, twopoint
    from heracles_tpu_torch.ops import gram, sht

    t = time.perf_counter()
    torch.cuda.synchronize()
    card_mesh = parallel.make_mesh()
    mesh = parallel.make_mesh(4, m_axis=2, devices=[dev] * 4)
    per = parallel._m_block(LMAX, 2)
    block_txt = m0_blocks(dev, per)
    t_blocks = time.perf_counter() - t

    pos, she = p3["pos"], p3["she"]  # (2, npix), (2, 2, npix) float32
    runs = {}

    def entry(label, fn):
        """fn() with the counts and the peak memory zeroed before it and
        read after it."""
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        out, secs = sync_time(fn)
        launches, plain = counts()
        check(sum(plain.values()) == 0, f"{label}: plain versions ran: {plain}")
        runs[label] = (secs, {k: v for k, v in launches.items() if v},
                       torch.cuda.max_memory_allocated())
        return out

    def compare_rows(got, want, what):
        """compare() row by row of the leading axes (a map at a time)."""
        n = got.shape[-1]
        return max(compare(g, w, *TOL[torch.complex64], what=what)[1]
                   for g, w in zip(got.reshape(-1, n), want.reshape(-1, n)))

    def want_launches(label, want):
        got = runs[label][1]
        check(got == want, f"{label}: launches {got}, expected {want}")

    nshard, ncard = mesh.size, card_mesh.size
    # the pipeline step on the visible cards, against phase 3's alms
    grid1 = entry("pipeline_step make_mesh() mixed",
                  lambda: parallel.pipeline_step(card_mesh, pos, LMAX, she))
    want_launches("pipeline_step make_mesh() mixed",
                  {"analysis_spin0_folded": ncard,
                   "analysis_pair_folded": ncard})
    fl = {}
    for s in (0, 2):
        pw = sht.pixel_window(NSIDE, LMAX, pol=(s == 2), device=dev)
        pw = pw[1] if s == 2 else pw
        f = np.ones(LMAX + 1)
        f[s:] /= pw[s:]
        fl[s] = torch.as_tensor(f)
    planes, fls = [], []
    for key, s in ((("POS", 0), 0), (("POS", 1), 0), (("SHE", 0), 2),
                   (("SHE", 1), 2)):
        a = p3["alms"][key].array
        rect = sht.unpack_alm(a.reshape(-1, a.shape[-1]), LMAX)
        planes.append(rect)
        fls += [fl[s]] * rect.shape[0]
    planes = torch.cat(planes)
    want_grid = twopoint.rect_pair_grid(planes, planes,
                                        torch.arange(LMAX + 1)).cpu()
    del planes
    fls = torch.stack(fls)
    deconv = grid1.cpu() * fls[:, None, :] * fls[None, :, :]
    err_card = grid_rel(deconv, want_grid)
    check(tuple(grid1.shape) == (6, 6, LMAX + 1) and err_card <= F32_TOL,
          f"pipeline_step make_mesh() against phase 3: {err_card:.2e}")

    # the (2, 2) mesh of one card
    grid0 = entry("pipeline_step (2,2) spin 0",
                  lambda: parallel.pipeline_step(mesh, pos, LMAX))
    want_launches("pipeline_step (2,2) spin 0",
                  {"analysis_spin0_folded": nshard})
    grid2 = entry("pipeline_step (2,2) mixed",
                  lambda: parallel.pipeline_step(mesh, pos, LMAX, she))
    want_launches("pipeline_step (2,2) mixed",
                  {"analysis_spin0_folded": nshard,
                   "analysis_pair_folded": nshard})
    err_ps0 = grid_rel(grid0, grid1[:2, :2])
    err_ps2 = grid_rel(grid2, grid1)
    check(err_ps0 <= F32_TOL and err_ps2 <= F32_TOL,
          f"pipeline_step (2,2) against make_mesh(): {err_ps0:.2e}, "
          f"{err_ps2:.2e}")
    del grid0, grid1, grid2

    errs = {}
    for spin, m in ((0, pos), (2, she)):
        a = entry(f"map2alm_sharded spin {spin}",
                  lambda: parallel.map2alm_sharded(mesh, m, LMAX, spin=spin))
        kern = "analysis_spin0_folded" if spin == 0 else "analysis_pair_folded"
        want_launches(f"map2alm_sharded spin {spin}", {kern: nshard})
        check(tuple(a.shape) == tuple(m.shape[:-1]) + (LMAX + 1, 2 * per),
              f"map2alm_sharded spin {spin}: shape {tuple(a.shape)}")
        check(not bool(a[..., LMAX + 1:].any()),
              f"map2alm_sharded spin {spin}: padded orders not zero")
        ref = sht.map2alm(m, LMAX, spin=spin, packed=False)
        errs[f"map2alm spin {spin}"] = compare(
            a[..., :LMAX + 1], ref, *TOL[torch.complex64],
            what=f"map2alm_sharded spin {spin}")[1]
        back = entry(f"alm2map_sharded spin {spin}",
                     lambda: parallel.alm2map_sharded(mesh, a, NSIDE,
                                                      lmax=LMAX, spin=spin))
        kern = "synthesis_spin0_folded" if spin == 0 else \
            "synthesis_pair_folded"
        want_launches(f"alm2map_sharded spin {spin}", {kern: nshard})
        ref_m = sht.alm2map(a[..., :LMAX + 1], NSIDE, LMAX, spin=spin,
                            packed=False)
        errs[f"alm2map spin {spin}"] = compare_rows(
            back, ref_m, f"alm2map_sharded spin {spin}")
        del a, ref, back, ref_m

    mapper = th.HealpixMapper(NSIDE, LMAX, dtype=torch.float32, device=dev)
    got = entry("transform_sharded POS",
                lambda: mapper.transform_sharded(mesh, pos))
    want_launches("transform_sharded POS", {"analysis_spin0_folded": nshard})
    errs["transform_sharded"] = compare(
        got.array, mapper.transform(pos).array, *TOL[torch.complex64],
        what="transform_sharded POS")[1]
    del got

    mm = entry("mixmat(mesh=)", lambda: twopoint.mixmat(
        p3["cl3"], l1max=LMAX, l2max=LMAX, l3max=LMAX, mesh=mesh))
    want_launches("mixmat(mesh=)", {"gram": nshard})
    mm_err = float(np.abs(mm - p3["mm"]).max() / np.abs(p3["mm"]).max())
    check(mm_err <= GRAM_TOL, f"mixmat(mesh=) against phase 3: {mm_err:.2e}")
    # one Gram launch on a node block against the whole rule's
    A, B, us = twopoint._mixmat_operands(p3["cl3"], LMAX, LMAX, 0, 0, False,
                                         dev, (0, nshard))
    event_ms(lambda: gram.gram(A, B, us[0]))  # warm
    _, gram_block_ms = event_ms(lambda: gram.gram(A, B, us[0]))
    K, L1 = A.shape
    gram_block_bound = bound(8.0 * (2 * K * L1 + K + L1 * L1),
                             2.0 * L1 * L1 * K + K * L1, torch.float64)
    del A, B, us

    dmapper = th.DiscreteMapper(DISCRETE_LMAX, dtype=torch.complex64,
                                device=dev)
    for spin, v, want in ((0, discrete["vals"], discrete["exact0"]),
                          (2, discrete["vals2"], discrete["exact2"])):
        a = entry(f"adjoint_synthesis_sharded spin {spin}",
                  lambda: dmapper.adjoint_synthesis_sharded(
                      mesh, discrete["theta"], discrete["phi"], v, spin))
        kern = "analysis_spin0_folded" if spin == 0 else "analysis_pair_folded"
        want_launches(f"adjoint_synthesis_sharded spin {spin}",
                      {kern: nshard})
        errs[f"adjoint spin {spin}"] = compare(
            a.reshape(want.shape), want, *TOL[torch.complex64],
            what=f"adjoint_synthesis_sharded spin {spin}")[1]

    _, fields, data, vmaps, regions = _dices_inputs(dev)
    jk8 = regions(DICES_FILE_NJK)
    got = entry("compute_jk_alms(mesh=)", lambda: dices.compute_jk_alms(
        data, vmaps, jk8, fields, dir=None, region_batch=DICES_BATCH,
        mesh=mesh))
    # k = 0 and one batch of 8, each map key through transform_sharded
    want_launches("compute_jk_alms(mesh=)",
                  {"analysis_spin0_folded": 4 * nshard,
                   "analysis_pair_folded": 2 * nshard})
    check(set(got) == set(dices_alms), f"DICES mesh alms keys {set(got)}")
    worst = 0.0
    for ck, alms in dices_alms.items():
        for key, want in alms.items():
            worst = max(worst, compare(
                torch.as_tensor(np.asarray(got[ck][key])),
                torch.as_tensor(np.asarray(want)), *TOL[torch.complex64],
                what=f"DICES mesh alms {ck} {key}")[1])
    errs["DICES alms"] = worst

    run_txt = "; ".join(f"{k} {s:.2f} s {l} peak {p / 2**30:.2f} GiB"
                        for k, (s, l, p) in runs.items())
    err_txt = ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
    print(f"phase 11 mesh: {block_txt} ({t_blocks:.1f} s); make_mesh() "
          f"{card_mesh.shape} over {ncard} card(s) and a (2, 2) mesh of "
          f"{nshard} shards on {dev} (shards queued on one card's stream: "
          f"not a scaling measurement): {run_txt}; pipeline_step make_mesh() "
          f"against phase 3's alms (windows applied) {err_card:.1e} of the "
          f"autos, (2,2) against make_mesh() spin 0 {err_ps0:.1e}, mixed "
          f"{err_ps2:.1e}; max|d|/max {err_txt}; mixmat(mesh=) against "
          f"phase 3 {mm_err:.1e}; one gram launch on a node block of "
          f"{K} nodes {gram_block_ms:.3f} ms (bound "
          f"{gram_block_bound[0]:.3f} ms, {gram_block_bound[1]}); card {smi} "
          f"({time.perf_counter() - t:.1f} s)", flush=True)


def phase12(dev, smi, p3):
    """The compensated float32 kernels at full size; returns (kernel
    reports, launches on their main path), keyed ``<kernel>_comp``."""
    import heracles_tpu_torch as th
    from heracles_tpu_torch.ops import ringfft, sht, sht_kernels, wigner

    t = time.perf_counter()
    pos, she = p3["pos"][0], p3["she"][0]
    mapper = th.HealpixMapper(NSIDE, LMAX, dtype=torch.float32, device=dev,
                              dd="comp", iterations=1)
    # the main path: the mapper's comp transform of bin 0's maps, counts
    # set to 0 just before and read just after
    reset_counts()
    (a_pos, a_she), t_tr = sync_time(lambda: (mapper.transform(pos, spin=0),
                                              mapper.transform(she, spin=2)))
    by_prec = dict(sht_kernels.LAUNCHES_BY_PRECISION)
    _, plain_runs = counts()
    want = {(name, "f32c"): n for name, n in zip(SHT_NAMES, (2, 2, 1, 1))}
    check(by_prec == want, f"comp transform launches {by_prec}, expected "
          f"{want}")
    check(sum(plain_runs.values()) == 0, f"plain versions ran: {plain_runs}")
    comp_launches = {f"{name}_comp": n for (name, _), n in want.items()}
    for label, a in (("POS", a_pos), ("SHE", a_she)):
        check(a.array.dtype == torch.complex64, f"{label} comp alms "
              f"{a.array.dtype}")
        check(bool(torch.isfinite(a.array).all()), f"{label} comp alms not "
              "finite")

    # map2alm in each mode against the float64 transform, per l-band
    ls, _ = sht._pack_index(LMAX, LMAX, dev)
    bands, top = {}, {}
    for key, spin, m32 in (("POS", 0, pos), ("SHE", 2, she)):
        a64 = sht.map2alm(m32.double(), LMAX, spin=spin)
        for mode, dd in (("f32", False), ("comp", "comp"), ("dd", True)):
            rel = l_band_rel(sht.map2alm(m32, LMAX, spin=spin, dd=dd), a64, ls)
            bands[key, mode] = rel
            top[key, mode] = rel[-1]
        del a64
        check(top[key, "comp"] < top[key, "f32"],
              f"{key}: comp's top-band error {top[key, 'comp']:.2e} is not "
              f"below plain's {top[key, 'f32']:.2e}")
    band_txt = "; ".join(f"{k} {m} " + " ".join(f"{v:.1e}" for v in rel)
                         for (k, m), rel in bands.items())

    # each comp kernel at bin 0's shapes against its plain version
    x, lch, lsh = sht._geometry(NSIDE, dev)
    x_lo = sht._x_lo(NSIDE, "comp", dev)
    w = sht.ring_weights(NSIDE)
    F, _ = ringfft.ring_analysis(pos, NSIDE, LMAX + 1, weight=w)
    spin0_in = sht._folded_inputs((F,), (0,))
    Fp, Fn = ringfft.ring_analysis(torch.complex(she[0], she[1]), NSIDE,
                                   LMAX + 1, weight=w)
    pair_in = sht._folded_inputs((Fp, Fn.conj()), (2, -2))
    del F, Fp, Fn
    a0 = sht.unpack_alm(a_pos.array, LMAX)
    eb = sht.unpack_alm(a_she.array, LMAX)
    a_p = -(eb[0] + 1j * eb[1])
    a_m = (-(eb[0] - 1j * eb[1])).conj().resolve_conj()
    del eb, a_pos, a_she
    inputs = {"analysis_spin0_folded": (spin0_in, ()),
              "analysis_pair_folded": (pair_in, (2,)),
              "synthesis_spin0_folded": ((a0,), ()),
              "synthesis_pair_folded": ((a_p, a_m), (2,))}
    nhalf = x.shape[0]
    per = 1536
    report, parts, shares = {}, [], []
    for name in SHT_NAMES:
        ins, extra = inputs[name]
        kernel = getattr(sht_kernels, name)
        plain = getattr(wigner, name + "_plain")

        def run(args=ins, m0=0, **kw):
            out = kernel(*args, x, lch, lsh, LMAX, *extra, m0, **kw)
            return out if isinstance(out, (tuple, list)) else (out,)

        run(dd="comp", x_lo=x_lo)  # warm
        got, ms = event_ms(lambda: run(dd="comp", x_lo=x_lo))
        run()  # warm
        _, f32_ms = event_ms(lambda: run())
        want_, plain_ms = event_ms(lambda: plain(*ins, x, lch, lsh, LMAX,
                                                 *extra, x_lo=x_lo))
        want_ = want_ if isinstance(want_, (tuple, list)) else (want_,)
        tol = PAIR_SYNTH_TOL32 if name == "synthesis_pair_folded" else \
            TOL[torch.complex64]
        errs = [compare(g, p, *tol, what=f"{name} comp")
                for g, p in zip(got, want_)]
        del want_
        # one block of orders, bit for bit the full launch's columns
        blk = [torch.nn.functional.pad(a[..., per:], (0, 2 * per - LMAX - 1))
               for a in ins]
        out = run(blk, per, dd="comp", x_lo=x_lo)
        real = LMAX + 1 - per
        for o, f in zip(out, got):
            check(torch.equal(o[..., :real], f[..., per:]),
                  f"{name} comp block m0={per}: columns differ from the full "
                  "launch's")
            check(not bool(o[..., real:].any()),
                  f"{name} comp block m0={per}: padded orders not zero")
        del out, blk, got
        cname = f"{name}_comp"
        bms, by = sht_bound(cname, 1, nhalf, LMAX + 1, LMAX, torch.complex64)
        report[cname] = dict(max_abs_err=max(e[0] for e in errs),
                             rel=max(e[1] for e in errs), ms=ms,
                             plain_ms=plain_ms, bound_ms=bms, bound_by=by)
        parts.append(f"{cname}: kernel {ms:.2f} ms ({ms / f32_ms:.2f}x the "
                     f"float32 kernel's {f32_ms:.2f} ms), plain "
                     f"{plain_ms:.1f} ms, bound {bms:.2f} ms ({by}), max|d| "
                     f"{report[cname]['max_abs_err']:.3e} "
                     f"({report[cname]['rel']:.2e} of max)")
        if name != "analysis_pair_folded":
            args = (*ins, x, lch, lsh, LMAX, *extra)
            c_comp = sht_kernels.path_counts(name, *args, dd="comp",
                                             x_lo=x_lo)
            c_plain = sht_kernels.path_counts(name, *args)
            check(c_comp == c_plain, f"{name}: comp paths {c_comp} differ "
                  f"from plain's {c_plain}")
            total = sum(c_comp.values())
            shares.append(f"{cname} " + ", ".join(
                f"{p} {100 * c_comp[p] / total:.1f}%" for p in PATHS))
    torch.cuda.synchronize()
    print(f"phase 12 comp n{NSIDE} l{LMAX} f32: HealpixMapper(dd=\"comp\", "
          f"iterations=1).transform of bin 0's POS and SHE {t_tr:.2f} s, "
          f"launches {comp_launches}, no plain run; map2alm against the "
          f"float64 transform, max|da|/max|a| per l-band (10 bands): "
          f"{band_txt}; {'; '.join(parts)}; paths (equal to the plain "
          f"kernels'): {'; '.join(shares)}; comp blocks m0={per} bit for bit "
          f"the full launch's columns; card {smi} "
          f"({time.perf_counter() - t:.1f} s)", flush=True)
    return report, comp_launches


# phase 13: the trace's B1 time per launch against phase 4's CUDA events
TRACE_B1_TOL = 0.10
# the trace's table labels of the kernels that count their launches
TRACE_TAGS = {"B1": "analysis_spin0_folded", "B2": "analysis_pair_folded",
              "B3": "synthesis_spin0_folded", "B4": "synthesis_pair_folded",
              "B5": "gram"}


def _trace_tool():
    """``tools/torch_trace_capture.py`` of this checkout, as a module."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tools" / "torch_trace_capture.py"
    spec = importlib.util.spec_from_file_location("torch_trace_capture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase13(dev, smi, p3, b1_ms):
    """The device trace of bin 0's spin-0 map2alm and of phase 7's refined
    transform of bin 0's POS and SHE maps, held against the launch counts
    and phase 4's B1 time ``b1_ms``."""
    import tempfile

    import heracles_tpu_torch as th
    from heracles_tpu_torch import tracing
    from heracles_tpu_torch.ops import sht

    ttc = _trace_tool()
    t = time.perf_counter()
    pos, she = p3["pos"][0], p3["she"][0]
    mapper = th.HealpixMapper(NSIDE, LMAX, dtype=torch.float32, device=dev,
                              iterations=ITERATIONS)
    cases = {
        "spin0 map2alm": (lambda: sht.map2alm(pos, LMAX), "spin0"),
        f"transform ({ITERATIONS} iterations) POS+SHE": (
            lambda: (mapper.transform(pos, spin=0),
                     mapper.transform(she, spin=2)), "transform"),
    }
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        for case, (fn, op) in cases.items():
            fn()  # warm
            torch.cuda.synchronize()
            path = Path(tmp) / f"{op}.trace.json"
            reset_counts()
            ttc.capture(fn, 1, dev, path)
            launches, plain_runs = counts()
            host = {name: sum(tracing.counts()[name].values())
                    for name in ("host_syncs", "host_copies", "table_builds")}
            nbytes = path.stat().st_size
            trace = ttc.load_trace(path)
            summary = ttc.summarise(trace)  # raises on none
            spans = ttc.spans_in(trace)
            del trace
            path.unlink()
            by_tag = ttc.launches_by_table(summary)
            got = {TRACE_TAGS[k]: int(v) for k, v in by_tag.items()
                   if k in TRACE_TAGS}
            want = {k: v for k, v in launches.items()
                    if k in TRACE_TAGS.values() and v}
            check(got == want, f"phase 13 {case}: trace launches {got}, "
                  f"launch counts {want}")
            check(sum(plain_runs.values()) == 0, f"plain versions ran: "
                  f"{plain_runs}")
            window = summary["window_ms"]
            check(abs(summary["busy_ms"] + summary["idle_ms"] - window)
                  <= 1e-9 * window, f"phase 13 {case}: busy "
                  f"{summary['busy_ms']} + idle {summary['idle_ms']} != "
                  f"window {window}")
            dead = ttc.dead(spans, ttc.OP_LABELS[op])
            check(not dead, f"phase 13 {case}: dead spans {dead}")
            b1 = ttc.device_ms_by_table(summary)["B1"] / by_tag["B1"]
            check(abs(b1 - b1_ms) <= TRACE_B1_TOL * b1_ms,
                  f"phase 13 {case}: B1 {b1:.3f} ms a launch in the trace, "
                  f"{b1_ms:.3f} ms by CUDA events (phase 4)")
            top = "; ".join(f"{ms:.2f} {name[:70]}" for name, ms in
                            list(summary["device_ms"].items())[:10])
            gaps = "; ".join(f"{g['ms']:.2f} ({g['n']:g}) {lab[:70]}"
                             for lab, g in list(summary["gaps"].items())[:5])
            stage_ms = "; ".join(f"{ms:.2f} {lab}" for lab, ms in
                                 summary["device_ms_by_label"].items())
            host_ms = "; ".join(f"{ms:.2f} {lab}" for lab, ms in list(
                summary["idle_ms_by_host_label"].items())[:5])
            lines.append(
                f"phase 13 trace {case}: window {window:.2f} ms, busy "
                f"{summary['busy_ms']:.2f} ms, idle {summary['idle_ms']:.2f} "
                f"ms, idle share {summary['idle_share']:.4f}; launches "
                f"{got} equal the launch counts; B1 {b1:.3f} ms a launch "
                f"against phase 4's {b1_ms:.3f} ms; no dead span of "
                f"{len(ttc.OP_LABELS[op])}; {host}; launch-to-start skew "
                f"{summary['launch_skew_us']:.1f} us as recorded (device "
                f"clock moved {summary['clock_shift_us']:.1f} us); "
                f"{summary['events']} events, {nbytes} bytes")
            lines.append(f"phase 13 {case} top ops (ms): {top}")
            lines.append(f"phase 13 {case} device ms by stage: {stage_ms}")
            lines.append(f"phase 13 {case} top idle gaps (ms, count, host "
                         f"work): {gaps}; idle ms by the host's stage: "
                         f"{host_ms}")
    for line in lines:
        print(line)
    print(f"phase 13 card {smi} ({time.perf_counter() - t:.1f} s)", flush=True)


# phase 14: the groups of maps at full width (stacks of the reference's
# limits at lmax 3000, pallas_sht.py:3081-3090, :2060-2063, :2851-2854: 4
# spin-0 maps, 2 spin pairs, for the analyses and the syntheses), and
# float64 and comp at every nb at a small shape: 600 rings (a tile of 512
# and a ragged one), orders 7..46, a batch of 8
GROUPED = DICES_KERNELS + SYNTHESIS_KERNELS
GROUP_STACK = {"analysis_spin0_folded": 4, "analysis_pair_folded": 2,
               "synthesis_spin0_folded": 4, "synthesis_pair_folded": 2}
GROUP_SMALL = dict(nside=300, lmax=200, nm=40, m0=7, batch=8)
# the stacked syntheses' path: HealpixMapper(nside 1024, lmax 1536,
# 3 iterations).transform of 8 float32 maps, whose Jacobi steps synthesise
# the stack (mapping.transform's stack of 8 at nside <= 2048)
STACK_NSIDE, STACK_LMAX, STACK_MAPS = 1024, 1536, 8


def _group_inputs(name, B, nhalf, lmax, nm, cdtype, gen, dev):
    """Random operands of one kernel on a stack of B maps: spectra
    (B, nhalf, nm) of an analysis, alms (B, lmax + 1, nm) of a synthesis."""
    rows = nhalf if name.startswith("analysis") else lmax + 1
    count = {"analysis_spin0_folded": 2, "analysis_pair_folded": 4,
             "synthesis_spin0_folded": 1, "synthesis_pair_folded": 2}[name]
    return [torch.randn((B, rows, nm), generator=gen, device=dev,
                        dtype=cdtype) for _ in range(count)]


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def check_grouped(call, name, nb, got, base, want, tol, what):
    """The checks of one grouped launch (nb > 1) whose outputs are ``got``:
    a synthesis bit for bit its nb = 1 outputs ``base``; an analysis (its
    ring contraction on the tensor cores, summed in another order) the
    same bits again from a second ``call()``, and within ``tol`` of
    ``base`` and of the plain version's outputs ``want`` (None: not run
    at this shape).  Returns this launch's (max |d|, relative) of each
    output against the plain version (against nb = 1 where it did not
    run; a synthesis: nb = 1's bits, so nothing of its own)."""
    if name.startswith("synthesis"):
        check(same_bits(got, base), f"{what} nb={nb} is not nb=1 bit for bit")
        return []
    check(same_bits(_as_tuple(call()), got),
          f"{what} nb={nb} does not repeat bit for bit")
    errs = []
    for ref, label in ((base, "nb=1"), (want, "the plain version")):
        if ref is not None:
            errs = [compare(g, r, *tol, what=f"{what} nb={nb} against {label}")
                    for g, r in zip(got, ref)]
    return errs


def grouped_bands(got, ref64, bands1=None, what=""):
    """The per-l-band error of float32 outputs ``got`` against the float64
    kernel's ``ref64`` (the larger of a pair's two); with ``bands1`` (the
    nb = 1 kernel's), checked to be at most 1.25 times it in every band."""
    bands = [max(v) for v in zip(*(rect_band_rel(g, r)
                                   for g, r in zip(got, ref64)))]
    if bands1 is not None:
        check(all(b <= 1.25 * b1 for b, b1 in zip(bands, bands1)),
              f"{what}: float32 error per l-band {bands} against nb=1's "
              f"{bands1}")
    return bands


def bands_txt(bands):
    return "/".join(f"{v:.1e}" for v in bands)


def _stacked_path(dev, stack0, gen):
    """The stacked syntheses' own path, each case with the counts zeroed
    just before it and read just after: the exact launches by (kernel, nb),
    no plain run, and the outputs bit for bit the same call with the
    syntheses' NB_SIZES rows set to (1,).  Returns (launches by (kernel, nb)
    over the path, text)."""
    import heracles_tpu_torch as th
    from heracles_tpu_torch.ops import sht_kernels

    small = th.HealpixMapper(STACK_NSIDE, STACK_LMAX, dtype=torch.float32,
                             device=dev, iterations=ITERATIONS)
    full = th.HealpixMapper(NSIDE, LMAX, dtype=torch.float32, device=dev)
    npix = 12 * STACK_NSIDE**2
    maps0 = torch.randn((STACK_MAPS, npix), generator=gen, device=dev)
    maps2 = torch.randn((STACK_MAPS, 2, npix), generator=gen, device=dev)

    def pick(name, B):
        return sht_kernels.pick_nb(B, STACK_LMAX, name)

    B1, B2, B3, B4 = ("analysis_spin0_folded", "analysis_pair_folded",
                      "synthesis_spin0_folded", "synthesis_pair_folded")
    cases = (
        ("transform spin 0", lambda: small.transform(maps0, spin=0),
         B3, STACK_MAPS, {(B1, pick(B1, STACK_MAPS)): ITERATIONS + 1}),
        ("transform spin 2", lambda: small.transform(maps2, spin=2),
         B4, STACK_MAPS, {(B2, pick(B2, STACK_MAPS)): ITERATIONS + 1}),
        ("synthesize", lambda: full.synthesize(stack0, spin=0), B3,
         stack0.shape[0], {}),
    )
    total, parts = collections.Counter(), []
    for label, fn, synth, B, want in cases:
        nb = pick(synth, B)
        check(nb > 1, f"phase 14 {label}: {synth} picks no group on {B} maps")
        runs = {}
        for limit in (None, 1):
            saved = {n: dict(sht_kernels.NB_SIZES[n])
                     for n in SYNTHESIS_KERNELS}
            try:
                if limit:
                    for n in SYNTHESIS_KERNELS:
                        sht_kernels.NB_SIZES[n].update(
                            dict.fromkeys(saved[n], (limit,)))
                reset_counts()
                out, sec = sync_time(fn)
                _, plain_runs = counts()
                by_nb = dict(sht_kernels.LAUNCHES_BY_NB)
            finally:
                for n in SYNTHESIS_KERNELS:
                    sht_kernels.NB_SIZES[n].update(saved[n])
            expect = {**want, (synth, limit or nb): ITERATIONS
                      if label.startswith("transform") else 1}
            check(by_nb == expect, f"phase 14 {label} (synthesis nb limit "
                  f"{limit}): launches by (kernel, nb) {by_nb}, expected "
                  f"{expect}")
            check(sum(plain_runs.values()) == 0,
                  f"phase 14 {label}: plain versions ran: {plain_runs}")
            check(bool(torch.isfinite(out.array).all()),
                  f"phase 14 {label}: not finite")
            runs[limit] = (out.array, sec, by_nb)
            del out
        check(same_bits((runs[None][0],), (runs[1][0],)),
              f"phase 14 {label}: the automatic groups are not nb=1 bit for "
              "bit")
        total.update(runs[None][2])
        shape = tuple(runs[None][0].shape)
        parts.append(f"{label} {shape}: {runs[None][1]:.2f} s with the "
                     f"automatic groups {runs[None][2]}, {runs[1][1]:.2f} s "
                     f"at nb=1, bit for bit")
        del runs
    return dict(total), "; ".join(parts)


def phase14(dev, smi, stack0):
    """The four kernels on groups of maps at full width: each nb that
    divides the stack bit for bit its nb = 1, timed (best of 3) beside its
    bound; the automatic group named.  Then float64 and comp at every nb
    at a small shape, bit for bit their nb = 1.  Then the stacked
    syntheses' own path (:func:`_stacked_path`, ``stack0``: phase 3's four
    spin-0 alms) and the syntheses at every nb at its transform's stack
    against their plain versions.  Returns (the path's launches by
    (kernel, nb), the syntheses' reports at that stack by nb)."""
    from heracles_tpu_torch.ops import sht, sht_kernels, wigner

    t = time.perf_counter()
    x, lch, lsh = sht._geometry(NSIDE, dev)
    nhalf, nm = x.shape[0], LMAX + 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    parts = []
    for name, B in GROUP_STACK.items():
        ops = _group_inputs(name, B, nhalf, LMAX, nm, torch.complex64, gen,
                            dev)
        extra = (2,) if name.endswith("pair_folded") else ()
        kernel = getattr(sht_kernels, name)
        auto = sht_kernels.pick_nb(B, LMAX, name)
        analysis = name.startswith("analysis")
        want = ref64 = bands1 = None
        if analysis:
            # the plain version and the float64 kernel on the same spectra
            want = _as_tuple(getattr(wigner, name + "_plain")(
                *ops, x, lch, lsh, LMAX, *extra))
            ref64 = _as_tuple(kernel(*(a.to(torch.complex128) for a in ops),
                                     x, lch, lsh, LMAX, *extra, nb=1))
        base, row = None, []
        for nb in (n for n in wigner.GROUP_SIZES[name] if B % n == 0):
            def call():
                return kernel(*ops, x, lch, lsh, LMAX, *extra, nb=nb)

            got, ms = best_ms(call)
            got = _as_tuple(got)
            check(all(bool(torch.isfinite(g).all()) for g in got),
                  f"{name} nb={nb} at full width: not finite")
            if base is None:
                if analysis:
                    for g, w in zip(got, want):
                        compare(g, w, *TOL[torch.complex64],
                                what=f"{name} at full width")
                base = got
            else:
                check_grouped(call, name, nb, got, base, want,
                              TOL[torch.complex64], f"{name} at full width")
            txt = ""
            if analysis:
                bands = grouped_bands(got, ref64, bands1,
                                      f"{name} nb={nb} at full width")
                bands1 = bands1 or bands
                txt = f"; f32 vs f64 kernel per l-band {bands_txt(bands)}"
            del got
            b = group_bounds(name, B, nhalf, nm, LMAX, torch.complex64, nb)
            row.append(f"nb={nb}{' (auto)' if nb == auto else ''} {ms:.2f} "
                       f"ms ({bounds_txt(b)}{txt})")
        parts.append(f"{name} on {B} maps: " + ", ".join(row))
        del ops, base, want, ref64
    peak = torch.cuda.max_memory_allocated()

    c = GROUP_SMALL
    z = torch.as_tensor(ring_geometry_z(c["nside"]))
    x_lo = (z - z.float().double()).float()
    geom = ring_tensors(c["nside"], dev)
    small = []
    for name in GROUPED:
        kernel = getattr(sht_kernels, name)
        for mode in ("f64", "comp"):
            cdtype = torch.complex128 if mode == "f64" else torch.complex64
            ops = _group_inputs(name, c["batch"], 2 * c["nside"], c["lmax"],
                                c["nm"], cdtype, gen, dev)
            kw = dict(m0=c["m0"])
            if mode == "comp":
                kw.update(dd="comp", x_lo=x_lo)
            args = (*ops, *geom, c["lmax"],
                    *((2,) if name.endswith("pair_folded") else ()))
            want = None
            if name.startswith("analysis"):
                pkw = dict(m0=c["m0"], x_lo=kw.get("x_lo"))
                want = _as_tuple(getattr(wigner, name + "_plain")(*args,
                                                                  **pkw))
            base = None
            for nb in wigner.GROUP_SIZES[name]:
                def call():
                    return kernel(*args, nb=nb, **kw)

                got = _as_tuple(call())
                if base is None:
                    base = got
                else:
                    check_grouped(call, name, nb, got, base, want, TOL[cdtype],
                                  f"{name} {mode}")
            sizes = ",".join(map(str, wigner.GROUP_SIZES[name]))
            small.append(f"{name} {mode} nb={sizes}")
            del want, base
    torch.cuda.synchronize()

    path_by_nb, path_txt = _stacked_path(dev, stack0, gen)

    # the syntheses at the transform's stack, every nb (bit for bit nb = 1,
    # which is held against the plain version; CUDA-event time, best of 3;
    # the bound at that nb)
    x, lch, lsh = sht._geometry(STACK_NSIDE, dev)
    nm = STACK_LMAX + 1
    dims = (STACK_MAPS, x.shape[0], nm)
    report = {}
    for name, tol in (("synthesis_spin0_folded", TOL[torch.complex64]),
                      ("synthesis_pair_folded", PAIR_SYNTH_TOL32)):
        ops = _group_inputs(name, STACK_MAPS, x.shape[0], STACK_LMAX, nm,
                            torch.complex64, gen, dev)
        extra = (2,) if name.endswith("pair_folded") else ()
        kernel = getattr(sht_kernels, name)
        plain = getattr(wigner, name + "_plain")
        want, plain_ms = event_ms(lambda: plain(*ops, x, lch, lsh, STACK_LMAX,
                                                *extra))
        rows, base = {}, None
        for nb in wigner.GROUP_SIZES[name]:
            got, ms = best_ms(lambda: kernel(*ops, x, lch, lsh, STACK_LMAX,
                                             *extra, nb=nb))
            if base is None:
                errs = [compare(g, p, *tol, what=f"{name} stack")
                        for g, p in zip(got, want)]
                base = got
            else:
                check(same_bits(got, base), f"{name} nb={nb} is not nb=1 bit "
                      "for bit at the transform's stack")
            bound_ms, bound_by = sht_bound(name, *dims, STACK_LMAX,
                                           torch.complex64, nb=nb)
            rows[nb] = dict(ms=ms, bound_ms=bound_ms, bound_by=bound_by)
            del got
        report[name] = dict(max_abs_err=max(e[0] for e in errs),
                            rel=max(e[1] for e in errs), plain_ms=plain_ms,
                            by_nb=rows)
        del ops, want, base
    auto = {n: sht_kernels.pick_nb(STACK_MAPS, STACK_LMAX, n) for n in report}
    kern_txt = "; ".join(
        f"{n} at {STACK_MAPS} maps n{STACK_NSIDE} l{STACK_LMAX}: plain "
        f"{r['plain_ms']:.1f} ms, nb=1 max|d| {r['max_abs_err']:.2e} "
        f"({r['rel']:.1e} of max), every nb bit for bit nb=1; " + ", ".join(
            f"nb={nb}{' (auto)' if nb == auto[n] else ''} {row['ms']:.2f} ms "
            f"(bound {row['bound_ms']:.2f} ms, {row['bound_by']})"
            for nb, row in r["by_nb"].items())
        for n, r in report.items())
    torch.cuda.synchronize()
    print(f"phase 14 groups of maps at n{NSIDE} l{LMAX} f32 (the syntheses "
          f"bit for bit nb=1, the analyses repeating their bits within the "
          f"float32 bar of nb=1 and the plain version): {'; '.join(parts)}; "
          f"peak {peak / 2**30:.2f} GiB above what earlier phases hold; "
          f"each nb checked so at nside {c['nside']} l{c['lmax']} orders "
          f"{c['m0']}..{c['m0'] + c['nm'] - 1} batch {c['batch']}: "
          f"{'; '.join(small)}; the stacked syntheses' path (n{STACK_NSIDE} "
          f"l{STACK_LMAX}, {ITERATIONS} iterations, {STACK_MAPS} maps; "
          f"synthesize at n{NSIDE} l{LMAX}): {path_txt}; launches by "
          f"(kernel, nb) over the path {path_by_nb}; {kern_txt}; card {smi} "
          f"({time.perf_counter() - t:.1f} s)", flush=True)
    return path_by_nb, report


def ring_bounds(nside, nm, m0, cdtype, complex_in, batch=1):
    """(bound of the maps in and F out, bound of the kernels' passes), ms
    at HBM's rate.  The first is the least the analysis could move: the
    maps read once, F (and Fneg) written once.  The second counts this
    design's own passes: a cap bucket's (rows, L) buffer written by the
    rows kernel, read and written by each FFT and by the spectrum kernel,
    and its first orders read by the orders kernel; the chirp spectra
    (north rows) read once; the belt's spectrum written by its FFT and its
    orders read."""
    from heracles_tpu_torch.ops.ringfft import ring_plan

    citem = torch.empty((), dtype=cdtype).element_size()
    dirs = 2 if complex_in else 1
    io = batch * 12 * nside ** 2 * (citem if complex_in else citem // 2)
    io += batch * dirs * (4 * nside - 1) * nm * citem
    passes = io
    for b in ring_plan(nside, m0 + nm):
        rows = b["rings"][1] - b["rings"][0]
        passes += batch * dirs * rows * nm * citem  # the orders read
        if b["belt"]:
            width = b["L"] if complex_in else b["L"] // 2 + 1
            passes += batch * rows * width * citem
            continue
        passes += 7 * batch * dirs * rows * b["L"] * citem
        passes += rows * b["L"] * citem / 2  # a pair's table: its north rows
    return io / HBM_BYTES_PER_S * 1e3, passes / HBM_BYTES_PER_S * 1e3


def phase15(dev, smi):
    """The ring analysis' kernels at the cell's shape, on a complex map and
    on the second order block of a two-block mesh (m0 > 0) against their
    plain version (the parent's torch ops on the card) and its float64
    run; timed beside the plain version and the bounds, the complex map
    and the block no slower than their plain version.  Returns the report
    row of the float32 map."""
    from heracles_tpu_torch import tracing
    from heracles_tpu_torch.ops import ringfft, sht
    from heracles_tpu_torch.parallel import _m_block

    t = time.perf_counter()
    npix = 12 * NSIDE ** 2
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    w = sht._weights_on(NSIDE, "ring", dev)
    spin0 = torch.randn((1, npix), generator=gen, device=dev)
    qu = torch.randn((2, npix), generator=gen, device=dev)
    spin2 = torch.complex(qu[0], qu[1])[None]
    del qu
    per = _m_block(LMAX, 2)
    cases = (("spin-0 float32", spin0, 0, LMAX + 1),
             ("spin-2 complex64", spin2, 0, LMAX + 1),
             (f"spin-0 float32 block m0 {per}", spin0, per, per))
    parts, rows = [], {}
    for what, maps, m0, nm in cases:
        complex_in = maps.is_complex()
        outs = 2 if complex_in else 1
        kw = dict(weight=w, m0=m0)
        truth = ringfft.ring_analysis_plain(maps.to(torch.complex128 if complex_in
                                                    else torch.float64),
                                            NSIDE, nm, **kw)
        want, plain_ms = best_ms(lambda: ringfft.ring_analysis_plain(
            maps, NSIDE, nm, **kw))
        got, ms = best_ms(lambda: ringfft.ring_analysis(maps, NSIDE, nm,
                                                        **kw))
        tracing.reset()
        ringfft.ring_analysis(maps, NSIDE, nm, **kw)
        torch.cuda.synchronize()
        c = tracing.counts()
        check(not [k for k in c["table_builds"] if k.startswith("ringfft.")]
              and not [k for k, _ in c["host_copies"]
                       if k.startswith("ringfft.")],
              f"phase 15 {what}: a warm call built or uploaded {c}")
        launches = dict(ringfft.LAUNCHES)
        errs = []
        for i in range(outs):
            err = compare(got[i], want[i], *TOL[torch.complex64],
                          what=f"ring_analysis {what}")
            e_k = float((got[i].to(torch.complex128) - truth[i]).abs().max()
                        / truth[i].abs().max())
            e_p = float((want[i].to(torch.complex128) - truth[i]).abs().max()
                        / truth[i].abs().max())
            check(e_k <= 1.25 * e_p, f"phase 15 {what}: the kernels' float32 "
                  f"error {e_k:.3e} above 1.25 x the plain version's {e_p:.3e}")
            errs.append((err[0], e_k, e_p))
        io_ms, passes_ms = ring_bounds(NSIDE, nm, m0, torch.complex64,
                                       complex_in)
        if complex_in or m0:
            check(ms <= plain_ms, f"phase 15 {what}: kernels {ms:.2f} ms, "
                  f"slower than the plain version's {plain_ms:.2f} ms")
        rows[what] = dict(ms=ms, plain_ms=plain_ms, bound_ms=io_ms,
                          bound_by="bytes", passes_bound_ms=passes_ms,
                          max_abs_err=max(e[0] for e in errs),
                          launches_per_call=sum(launches.values()))
        parts.append(
            f"{what}: kernels {ms:.3f} ms, plain {plain_ms:.3f} ms "
            f"({plain_ms / ms:.2f}x), bound {io_ms:.3f} ms (the maps in and "
            f"F out; {passes_ms:.3f} ms the bytes of the passes); against the "
            f"float64 plain run " + ", ".join(
                f"kernels {e_k:.2e}, plain {e_p:.2e}" for _, e_k, e_p in errs)
            + f"; launches a call {launches}")
        del truth, want, got
    print(f"phase 15 ring analysis at n{NSIDE}, {LMAX + 1} orders, ring "
          f"weights: {'; '.join(parts)}; card {smi} "
          f"({time.perf_counter() - t:.1f} s)", flush=True)
    return rows["spin-0 float32"]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device; this script "
                         "runs on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t = time.perf_counter()
    smi = card()
    print(f"phase 0 card: {smi} | {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | python {sys.version.split()[0]} "
          f"({time.perf_counter() - t:.2f} s)", flush=True)

    import heracles_tpu_torch as th
    from heracles_tpu_torch import tracing, twopoint
    from heracles_tpu_torch.ops import (
        _build, fma_peak, gram, ringfft, sht, sht_kernels, wigner)

    t = time.perf_counter()
    kl = _build.load_library()
    dmma = sass_count(kl.path, "gram_kernel", "DMMA")
    check(dmma > 0, "the Gram kernel's SASS has no DMMA instruction")
    # the spreader's tile: native 32-bit shared atomics, no compare-and-swap
    # loop (a float64 atomicAdd in shared memory would compile to one)
    spread_ops = {}
    for tag, fn in (("w6/real", "spread_kernelILi6ELi1E"),
                    ("w13/cplx", "spread_kernelILi13ELi2E")):
        ops = sass_opcodes(kl.path, fn)
        spread_ops[tag] = (
            sum(n for op, n in ops.items() if op.startswith("ATOMS")),
            sum(n for op, n in ops.items() if "CAS" in op),
            sum(n for op, n in ops.items() if op.startswith("RED")))
        check(spread_ops[tag][0] > 0 and spread_ops[tag][1] == 0,
              f"spread {tag} SASS: {dict(ops)}")
    spread_txt = "; ".join(f"{t} {a} ATOMS, {c} CAS, {r} RED"
                           for t, (a, c, r) in spread_ops.items())
    blocks = "; ".join(
        f"{kernel} {kl.blocks_per_sm(kernel, False)} (f32), "
        f"{kl.blocks_per_sm(kernel, True)} (f64), "
        f"{kl.blocks_per_sm(kernel, False, comp=True)} (comp)"
        for kernel in ("analysis_spin0", "analysis_pair", "synthesis_spin0",
                       "synthesis_pair"))
    blocks += "; groups of nb maps (f32, f64, comp): " + "; ".join(
        f"{name.rsplit('_', 1)[0]} nb{nb} " + "/".join(
            str(kl.blocks_per_sm(name.rsplit("_", 1)[0], d, comp=c, nb=nb))
            for d, c in ((False, False), (True, False), (False, True)))
        for name in GROUPED for nb in wigner.GROUP_SIZES[name][1:])
    # an existing build has no compiler log to read
    ptxas = ptxas_summary(kl.log) if kl.seconds else "ptxas: no log, built before"
    rows = ptxas.split("; ")
    # the comp instantiations' spills are reported, not refused
    synth0 = [row for row in rows if row.startswith("synth/spin0/")
              and "/comp" not in row]
    check(not kl.seconds or (len(synth0) == 3 and all(
        row.endswith(", 0 B stack, 0 B spill") for row in synth0)),
          f"the spin-0 synthesis spills, or an instantiation is missing: {synth0}")
    comp_rows = [row for row in rows if "/comp" in row
                 and not row.startswith("group/")]
    check(not kl.seconds or len(comp_rows) == 7,
          f"a comp instantiation is missing: {comp_rows}")
    # every grouped instantiation of the four kernels (f32, f64, comp at
    # each nb > 1), none spilling
    group_rows = [row for row in rows if row.startswith("group/")]
    # and the pair analysis' counting twins, f32 and comp at nb 2 and 4
    n_groups = 3 * sum(len(wigner.GROUP_SIZES[n]) - 1 for n in GROUPED) + 4
    check(not kl.seconds or (len(group_rows) == n_groups and all(
        row.endswith(", 0 B spill") for row in group_rows)),
          f"a grouped kernel spills, or an instantiation is missing: "
          f"{group_rows}")
    # the grouped analyses contract on the tensor cores: HMMA (3xTF32) in
    # float32 and comp, DMMA in float64, and fewer shuffles than the
    # parent's per-map butterflies
    sass_rows = []
    for (kernel, prec, nb), ops in group_sass(kl.path).items():
        mma = "DMMA" if prec == "f64" else "HMMA"
        parent = PARENT_SHFL[kernel, prec, nb]
        check(ops[mma] > 0 and ops["SHFL"] < parent,
              f"group/{kernel}/{prec}/nb{nb} SASS: {ops[mma]} {mma}, "
              f"{ops['SHFL']} SHFL (the parent's {parent})")
        sass_rows.append(f"{kernel}/{prec}/nb{nb} {ops[mma]} {mma}, "
                         f"{ops['SHFL']} SHFL (parent {parent})")
    print(f"phase 1 build: nvcc {kl.seconds:.1f} s -> {kl.path.name}; "
          f"{ptxas}; gram DMMA instructions {dmma}; grouped analyses' SASS: "
          f"{'; '.join(sass_rows)}; spread SASS (shared "
          f"atomics, compare-and-swap, global reductions) {spread_txt}; blocks "
          f"per SM at any lmax: {blocks} ({time.perf_counter() - t:.1f} s)",
          flush=True)

    t = time.perf_counter()
    rows = phase2(dev)
    torch.cuda.synchronize()
    print(f"phase 2 kernel vs plain, max|d|/max|plain|: {', '.join(rows)} "
          f"({time.perf_counter() - t:.1f} s)", flush=True)

    # -- phase 3: the pipeline at full size, through the mixing matrices ----
    t = time.perf_counter()
    mapper = th.HealpixMapper(NSIDE, LMAX, dtype=torch.float32, device=dev)
    fields = {
        "POS": th.Positions(mapper, "RA", "DEC", mask="VIS", overdensity=False),
        "SHE": th.Shears(mapper, "RA", "DEC", "G1", "G2", "W", mask="VIS"),
        "VIS": th.Visibility(mapper),
    }
    npix = 12 * NSIDE**2
    ring = torch.arange(npix, device=dev)
    vis = ((ring > npix // 5) & (ring < 4 * npix // 5)).to(torch.float32)
    del ring
    catalogs = {}
    arrays = catalog_arrays()
    for i, arr in enumerate(arrays):
        catalogs[i] = th.ArrayCatalog(arr)
        catalogs[i].visibility = vis
    # one page of bin 0's rows, for phase 8
    page = {name: np.ascontiguousarray(arrays[0][name][:PAGE_ROWS])
            for name in ("RA", "DEC", "W")}
    del arrays
    setup = time.perf_counter() - t

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    maps, t_maps = sync_time(lambda: th.map_catalogs(fields, catalogs))
    alms, t_alms = sync_time(lambda: th.transform(fields, maps))
    cls, t_cls = sync_time(lambda: th.angular_power_spectra(alms))
    mask_cls = {k: v for k, v in cls.items() if k[:2] == ("VIS", "VIS")}
    mms, t_mms = sync_time(
        lambda: th.mixing_matrices(fields, mask_cls, l3max=LMAX))
    launches, plain_runs = counts()
    peak = torch.cuda.max_memory_allocated()
    for name in PIPELINE_KERNELS:
        check(launches.get(name, 0) > 0, f"{name} never launched in the slice")
    check(launches.get("gram") == 13, f"expected 13 gram launches, got "
          f"{launches.get('gram')}")
    # the maps of a group stack under the budget (``mapping._STACK_BYTES``):
    # POS and VIS of both bins (spin 0) in one stack, B1 at nb 4, and the
    # two SHE maps in another, B2 at nb 2; one ring analysis a stack: a
    # rows and a spectrum launch per cap bucket pair, an orders launch per
    # pair and one for the belt (``ringfft.LAUNCHES``, apart from
    # ``counts()``, whose exact checks of other phases hold the SHT and
    # Gram kernels alone)
    stacks = dict(tracing.TRANSFORM_STACKS)
    check(stacks == {2 * NBINS: 1, NBINS: 1}, f"transform stacks {stacks} "
          f"of the pipeline's {len(maps)} maps, expected "
          f"{{{2 * NBINS}: 1, {NBINS}: 1}}")
    by_nb = {k: v for k, v in sht_kernels.LAUNCHES_BY_NB.items()
             if k[0] in PIPELINE_KERNELS}
    want_nb = {("analysis_spin0_folded", 4): 1, ("analysis_pair_folded", 2): 1}
    check(by_nb == want_nb, f"pipeline analyses by (kernel, nb) {by_nb}, "
          f"expected {want_nb}")
    calls = sum(stacks.values())
    ring_launches = {k: ringfft.LAUNCHES.get(k, 0) for k in RING_KERNELS}
    pairs = (len(ringfft.ring_plan(NSIDE, LMAX + 1)) - 1) // 2
    want = dict(zip(RING_KERNELS, (pairs * calls, pairs * calls,
                                   (pairs + 1) * calls)))
    check(ring_launches == want, f"ring analysis launches {ring_launches} "
          f"in the pipeline's {calls} transforms, expected {want}")
    launches["ring_analysis"] = sum(ring_launches.values())
    check(sum(plain_runs.values()) == 0, f"plain versions ran: {plain_runs}")
    check(len(cls) == 21, f"expected 21 spectra, got {len(cls)}")
    for key, cl in cls.items():
        check(bool(np.all(np.isfinite(np.asarray(cl)))), f"{key} not finite")
    check(len(mms) == 10, f"expected 10 mixing matrices, got {len(mms)}")
    n = LMAX + 1
    for key, mm in mms.items():
        want = (3, n, n) if mm.spin == (2, 2) else (n, n)
        check(mm.shape == want, f"mixing matrix {key}: shape {mm.shape}")
        check(bool(np.all(np.isfinite(mm.array))), f"{key} not finite")
    t_spectra = t_maps + t_alms + t_cls
    print(f"phase 3 pipeline n{NSIDE} l{LMAX} {NBINS}x{NROWS} rows "
          f"POS+SHE+VIS f32: map_catalogs {t_maps:.2f} s, transform "
          f"{t_alms:.2f} s, spectra {t_cls:.2f} s, mixmats {t_mms:.2f} s; "
          f"total through spectra {t_spectra:.2f} s, through mixmats "
          f"{t_spectra + t_mms:.2f} s; peak {peak / 2**30:.2f} GiB; launches "
          f"{launches} (ring analysis {ring_launches}; by nb {by_nb}; "
          f"stacks {stacks}); plain runs {plain_runs}; {len(cls)} finite spectra, "
          f"{len(mms)} finite mixing matrices; card {smi} "
          f"(setup {setup:.1f} s, {time.perf_counter() - t:.1f} s)", flush=True)

    # -- phase 4: bin 0 at full size, kernel against plain ------------------
    t = time.perf_counter()
    pos = maps["POS", 0].array
    she = maps["SHE", 0].array
    w = sht.ring_weights(NSIDE)
    x, lch, lsh = sht._geometry(NSIDE, dev)
    F, _ = ringfft.ring_analysis(pos, NSIDE, LMAX + 1, weight=w)
    spin0_args = sht._folded_inputs((F,), (0,))
    Fp, Fn = ringfft.ring_analysis(torch.complex(she[0], she[1]), NSIDE,
                                   LMAX + 1, weight=w)
    pair_args = sht._folded_inputs((Fp, Fn.conj()), (2, -2))
    del F, Fp, Fn
    report = {}
    for name, args, extra in (
        ("analysis_spin0_folded", spin0_args, ()),
        ("analysis_pair_folded", pair_args, (2,)),
    ):
        kernel = getattr(sht_kernels, name)
        plain = getattr(wigner, name + "_plain")
        event_ms(lambda: kernel(*args, x, lch, lsh, LMAX, *extra))  # warm
        got, ms = event_ms(lambda: kernel(*args, x, lch, lsh, LMAX, *extra))
        want, plain_ms = event_ms(lambda: plain(*args, x, lch, lsh, LMAX, *extra))
        if name == "analysis_spin0_folded":
            got, want = (got,), (want,)
        errs = [compare(g, p, *TOL[torch.complex64]) for g, p in zip(got, want)]
        *batch, nhalf, nm = args[0].shape
        dims = (int(np.prod(batch)), nhalf, nm)
        bound_ms, bound_by = sht_bound(name, *dims, LMAX, torch.complex64)
        report[name] = dict(max_abs_err=max(e[0] for e in errs),
                            rel=max(e[1] for e in errs), ms=ms,
                            plain_ms=plain_ms, dims=dims, bound_ms=bound_ms,
                            bound_by=bound_by)
        del got, want
    spin0_paths, spin0_paths_txt = path_shares(
        "analysis_spin0_folded", *spin0_args, x, lch, lsh, LMAX)
    del spin0_args, pair_args

    bands = {}
    pos_alms = None  # bin 0's float32 and float64 POS alms, for phase 8
    for key, spin, m32 in (("POS", 0, pos), ("SHE", 2, she)):
        a32 = sht.map2alm(m32, LMAX, spin=spin)
        a64 = sht.map2alm(m32.double(), LMAX, spin=spin)
        if key == "POS":
            pos_alms = (a32, a64)
        comps = [(key, a32, a64)] if spin == 0 else [
            (key + "_E", a32[0], a64[0]), (key + "_B", a32[1], a64[1])]
        for label, b32, b64 in comps:
            rel = band_max_rel(th.alm2cl(b32), th.alm2cl(b64), lmin=spin)
            bands[label] = rel
            check(max(rel) <= 1e-3, f"{label} f32 vs f64 band max {max(rel):.2e}")
    parts = [f"{n}: kernel {r['ms']:.1f} ms, plain {r['plain_ms']:.1f} ms, "
             f"bound {r['bound_ms']:.2f} ms ({r['bound_by']}), "
             f"max|d| {r['max_abs_err']:.3e} ({r['rel']:.2e} of max)"
             for n, r in report.items()]
    band_txt = "; ".join(f"{k} " + " ".join(f"{v:.1e}" for v in vals)
                         for k, vals in bands.items())
    print(f"phase 4 bin 0 at n{NSIDE} l{LMAX} f32: {'; '.join(parts)}; "
          f"{spin0_paths_txt}; "
          f"f32 vs f64 Cl band max rel (10 bands): {band_txt}; card {smi} "
          f"({time.perf_counter() - t:.1f} s)", flush=True)

    # -- phase 5: inversion, application, Gram at full size -----------------
    t = time.perf_counter()
    inv, t_inv = sync_time(
        lambda: th.invert_mixing_matrix(mms, rcond=1e-5, device=dev))
    for key, mm in inv.items():
        check(bool(np.all(np.isfinite(mm.array))), f"inverse {key} not finite")
    n_pinv = sum(3 if 0 not in mm.spin else 1 for mm in mms.values())
    data = {k: v for k, v in cls.items() if k in inv}
    mixed, t_apply = sync_time(lambda: th.apply_mixing_matrix(data, inv))
    check(len(mixed) == 9, f"expected 9 spectra with a matrix, got {len(mixed)}")
    for key, cl in mixed.items():
        check(bool(np.all(np.isfinite(cl.array))), f"unmixed {key} not finite")

    cl3 = np.asarray(mask_cls["VIS", "VIS", 0, 0].array, np.float64)
    contractions = {}
    for label, (s1, s2), eb, which in (
        ("(0,0)", (0, 0), False, 0), ("(0,2)", (0, 2), False, 0),
        ("(2,2) even", (2, 2), True, 0), ("(2,2) odd", (2, 2), True, 1),
    ):
        A, B, us = twopoint._mixmat_operands(cl3, LMAX, LMAX, s1, s2, eb, dev)
        u = us[which]
        event_ms(lambda: gram.gram(A, B, u))  # warm
        got, ms = event_ms(lambda: gram.gram(A, B, u))
        want, plain_ms = event_ms(lambda: gram.gram_plain(A, B, u))
        # the library yardstick: one PyTorch call (cuBLAS DGEMM underneath)
        event_ms(lambda: torch.einsum("ka,k,kb->ab", A, u, B))  # warm
        _, library_ms = event_ms(lambda: torch.einsum("ka,k,kb->ab", A, u, B))
        err, rel = compare(got, want, GRAM_TOL, what=f"gram {label}")
        (K, L1), L2 = A.shape, B.shape[1]
        flop = 2.0 * L1 * L2 * K
        # A, B and u read once, M written once; the u scaling is K L2 flops
        bound_ms, bound_by = bound(8.0 * (K * L1 + K * L2 + K + L1 * L2),
                                   flop + K * L2, torch.float64)
        contractions[label] = dict(max_abs_err=err, rel=rel, ms=ms,
                                   plain_ms=plain_ms, library_ms=library_ms,
                                   bound_ms=bound_ms, bound_by=bound_by,
                                   flops=flop / (ms / 1e3))
        del got, want
    gram_rate = float(np.mean([c["flops"] for c in contractions.values()]))

    K = (3 * LMAX) // 2 + 1
    t0 = time.perf_counter()
    nodes, _ = np.polynomial.legendre.leggauss(K)
    t_gl = time.perf_counter() - t0
    t0 = time.perf_counter()
    wigner.wigner_table_host(2, 2, np.arccos(nodes), LMAX)
    t_table = time.perf_counter() - t0
    t0 = time.perf_counter()
    wigner.legendre_sum_host((2 * np.arange(LMAX + 1) + 1) / (4 * np.pi) * cl3,
                             nodes)
    t_xi = time.perf_counter() - t0
    parts = [f"{k}: kernel {c['ms']:.2f} ms, plain {c['plain_ms']:.2f} ms, "
             f"einsum {c['library_ms']:.2f} ms, bound {c['bound_ms']:.2f} ms "
             f"({c['bound_by']}), "
             f"max|d| {c['max_abs_err']:.2e} ({c['rel']:.1e} of max), "
             f"{c['flops'] / 1e12:.2f} TFLOP/s = "
             f"{100 * c['flops'] / FP64_TENSOR_PEAK:.1f}% of the FP64 tensor "
             f"peak" for k, c in contractions.items()]
    print(f"phase 5 invert_mixing_matrix ({n_pinv} pinv of {LMAX + 1}^2 on "
          f"the card) {t_inv:.2f} s; apply_mixing_matrix ({len(mixed)} spectra) "
          f"{t_apply:.3f} s; gram at K{K} x {LMAX + 1}^2: {'; '.join(parts)}; "
          f"Gram kernel FP64 rate {gram_rate / 1e12:.2f} TFLOP/s; host: "
          f"leggauss({K}) {t_gl:.2f} s, wigner_table_host(2,2) "
          f"{t_table:.2f} s, legendre_sum_host {t_xi:.3f} s; card {smi} "
          f"({time.perf_counter() - t:.1f} s)", flush=True)

    # -- phase 6: the FMA-peak probe, the probe's own path -------------------
    t = time.perf_counter()
    reset_counts()
    rates, secs = {}, {}
    for dtype in (torch.float32, torch.float64):
        for kind in ("fma", "rec3"):
            sec, n_ops = fma_peak.run(kind, None, PROBE_STEPS_RATE,
                                      PROBE_NCHAIN, dtype=dtype, device=dev)
            rates[kind, dtype] = n_ops / sec
            secs[kind, dtype] = sec
    probe_launches, probe_plain = counts()
    check(probe_launches.get("fma_peak", 0) > 0, "fma_peak never launched")
    check(sum(probe_plain.values()) == 0, f"plain versions ran: {probe_plain}")
    report["fma_peak"] = probe_row(dev, secs["fma", torch.float32])
    fma32 = rates["fma", torch.float32]
    fma64 = rates["fma", torch.float64]
    einsum_rate = float(np.mean([c["flops"] * c["ms"] / c["library_ms"]
                                 for c in contractions.values()]))
    shares = [f"gram FP64 {gram_rate / 1e12:.2f} TFLOP/s = "
              f"{100 * gram_rate / FP64_TENSOR_PEAK:.1f}% of the 67 TFLOP/s "
              f"FP64 tensor-core peak, {gram_rate / einsum_rate:.2f}x einsum's "
              f"{einsum_rate / 1e12:.2f} TFLOP/s ({gram_rate / fma64:.2f}x the "
              f"probe's FP64 fma rate)"]
    for name in ("analysis_spin0_folded", "analysis_pair_folded"):
        shares.append(issue_share(
            name, report[name]["dims"], report[name]["ms"], fma32,
            spin0_paths if name == "analysis_spin0_folded" else None))
    rate_txt = ", ".join(
        f"{k}/{'f32' if d == torch.float32 else 'f64'} {r / 1e12:.2f} Top/s"
        for (k, d), r in rates.items())
    b6 = report["fma_peak"]
    print(f"phase 6 probe at {fma_peak.default_rows(dev)}x128, "
          f"{PROBE_STEPS_RATE} steps, {PROBE_NCHAIN} chains: {rate_txt}; "
          f"fma/f32 once more (the kernels line): kernel {b6['ms']:.3f} ms, "
          f"plain {b6['plain_ms']:.1f} ms, bound {b6['bound_ms']:.3f} ms "
          f"({b6['bound_by']}); "
          f"launches {probe_launches}; {'; '.join(shares)}; card {smi} "
          f"({time.perf_counter() - t:.1f} s)", flush=True)

    # -- phase 7: synthesis, its own path --------------------------------
    synth_report, synth_launches = phase7(dev, maps, cls, fma32, smi)
    report.update(synth_report)

    # -- phase 8: dd=, resample, map_values --------------------------------
    phase8(dev, maps, page, *pos_alms, smi)
    # phase 3's four spin-0 alms (POS and VIS of both bins) stacked, which
    # phase 14 synthesises at once
    stack0 = torch.stack([alms[k, i].array for k in ("POS", "VIS")
                          for i in range(NBINS)])
    # what phase 11 holds against: phase 3's POS and SHE maps of both bins,
    # their alms, the mask spectrum and the POS x POS mixing matrix
    p3 = dict(
        pos=torch.stack([maps["POS", i].array for i in range(NBINS)]),
        she=torch.stack([maps["SHE", i].array for i in range(NBINS)]),
        alms={k: v for k, v in alms.items() if k[0] in ("POS", "SHE")},
        cl3=cl3, mm=np.asarray(mms["POS", "POS", 0, 0].array, np.float64))
    del maps, alms, cls, mms, inv, mixed, pos_alms, page

    # -- phase 9: DICES, its own path --------------------------------------
    dices_alms, dices_report, dices_by_nb = phase9(dev, smi)

    # -- phase 10: pixel-free alms, its own path ---------------------------
    report["spread"], discrete_launches, discrete = phase10(dev, smi)
    launches["spread"] = discrete_launches.get("spread", 0)

    # -- phase 11: the device mesh, its own path ---------------------------
    phase11(dev, smi, p3, dices_alms, discrete)
    del dices_alms, discrete

    # -- phase 12: the compensated kernels, their own path ----------------
    comp_report, comp_launches = phase12(dev, smi, p3)
    report.update(comp_report)
    launches.update(comp_launches)

    # -- phase 13: the device trace of the spin-0 analysis and the refined
    # transform ----------------------------------------------------------
    phase13(dev, smi, p3, report["analysis_spin0_folded"]["ms"])
    del p3

    # -- phase 14: the groups of maps at full width, and the stacked
    # syntheses' own path ---------------------------------------------------
    path_by_nb, path_report = phase14(dev, smi, stack0)
    del stack0

    # -- phase 15: the ring analysis' kernels at the cell's shape ----------
    report["ring_analysis"] = phase15(dev, smi)

    def mean(key):
        return float(np.mean([c[key] for c in contractions.values()]))

    report["gram"] = dict(
        max_abs_err=max(c["max_abs_err"] for c in contractions.values()),
        ms=mean("ms"), plain_ms=mean("plain_ms"), library_ms=mean("library_ms"),
        bound_ms=mean("bound_ms"), bound_by=contractions["(0,0)"]["bound_by"],
    )
    launches["fma_peak"] = probe_launches.get("fma_peak", 0)
    for name in SYNTHESIS_KERNELS:
        launches[name] = synth_launches.get(name, 0)
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches.get(name, 0),
            "max_abs_err": report[name]["max_abs_err"],
            "ms": report[name]["ms"],
            "plain_ms": report[name]["plain_ms"],
            "bound_ms": report[name]["bound_ms"],
            "bound_by": report[name]["bound_by"],
            # no single PyTorch call computes the recurrence-generated
            # contractions or the probe's chains
            "library_ms": report[name].get("library_ms"),
            # the ring analysis: the bound of its design's own passes, and
            # one call's launches (phase 15) beside the pipeline's (phase 3)
            **{key: report[name][key] for key in ("passes_bound_ms",
                                                  "launches_per_call")
               if key in report[name]},
        }
        for name, (source, replaces) in KERNELS.items()
    ]
    # the grouped launches of the DICES path (phase 9), timed at its batch
    for (name, nb), n in sorted(dices_by_nb.items()):
        if nb == 1:
            continue
        source, replaces = KERNELS[name]
        r = dices_report[name]
        row = r["by_nb"][nb]
        kernels.append({
            "name": f"{name}_nb{nb}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": n,
            # this group's own error against the plain version
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            # the bound with the contraction on the FP32 pipe
            "bound_fp32_ms": row["bound_fp32_ms"]})
    # the grouped launches of the stacked syntheses' path (phase 14), timed
    # at its transform's stack
    for (name, nb), n in sorted(path_by_nb.items()):
        if nb == 1 or not name.startswith("synthesis"):
            continue
        source, replaces = KERNELS[name]
        r = path_report[name]
        kernels.append({
            "name": f"{name}_nb{nb}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": n,
            "max_abs_err": r["max_abs_err"], "ms": r["by_nb"][nb]["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["by_nb"][nb]["bound_ms"],
            "bound_by": r["by_nb"][nb]["bound_by"], "library_ms": None})
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} never launched on its path")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
