"""Drive the PyTorch / H100 port of Heracles once on the card.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; fails (non-zero exit, no result line) on a
machine without a card, and on any failed check.  Phases, one line each
with its seconds:

0. the card (``nvidia-smi`` name and power limit), torch and CUDA;
1. build the Hopper kernels from ``heracles_tpu_torch/csrc``;
2. each kernel against its plain PyTorch version on the same CUDA
   tensors: the analysis kernels in float32 and float64 at three shapes,
   the Gram kernel at three ragged shapes weighted and unweighted, the
   probe kernels in float32 and float64 at full occupancy;
3. the ``pipeline_n4096_l3000`` configuration: positions + shear +
   visibility, 2 tomographic bins of 5e6 rows, nside 4096, lmax 3000,
   float32 maps, through ``map_catalogs`` -> ``transform`` ->
   ``angular_power_spectra`` -> ``mixing_matrices`` of the mask spectra,
   with the kernels' launch counts over that run;
4. bin 0's POS and SHE analyses at full size through each kernel and its
   plain version (times, agreement), and float32 against float64 spectra
   per l-band;
5. the pseudo-inverses of the mixing matrices and their application to
   the data spectra; one Gram contraction of each spin kind at full size
   through the kernel and its plain version (times, agreement, FP64
   rate); the host seconds of the quadrature rule and tables;
6. the FMA-peak probe at full occupancy (FP32 and FP64 rates, with its
   launch count), and the kernels' rates as shares of it.

Then a JSON line of the kernels, the card line, and the result line.
"""

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

NSIDE, LMAX, NROWS, NBINS = 4096, 3000, 5_000_000, 2

# kernel vs plain: float32 at the bar the Pallas kernels were held to
# (tests/test_pallas.py), float64 at the float64 rounding level
TOL = {torch.complex64: (2e-5, 2e-4), torch.complex128: (1e-11, 0.0)}

# kernel name: (source, the TPU kernel it replaces)
KERNELS = {
    "analysis_spin0_folded": ("heracles_tpu_torch/csrc/sht_analysis.cu",
                              "heracles_tpu/ops/pallas_sht.py:713"),
    "analysis_pair_folded": ("heracles_tpu_torch/csrc/sht_analysis.cu",
                             "heracles_tpu/ops/pallas_sht.py:1049"),
    "gram": ("heracles_tpu_torch/csrc/gram.cu", "heracles_tpu/ops/df32.py:93"),
    "fma_peak": ("heracles_tpu_torch/csrc/fma_peak.cu", "tools/vpu_peak.py:31"),
}
# the kernels of the pipeline path (phase 3); the probe has its own (phase 6)
PIPELINE_KERNELS = ("analysis_spin0_folded", "analysis_pair_folded", "gram")

# Gram kernel vs plain: float64 sums in another order
GRAM_TOL = 1e-12
# the probe: an FMA and a multiply-then-add round differently every step
PROBE_STEPS_CHECK, PROBE_STEPS_RATE, PROBE_NCHAIN = 256, 4096, 4
# vector instructions per (ring, l, m) triple of the analysis kernels, by
# count of the source: ~14 for spin 0 (recurrence step, rescale, emit and
# 2 contraction FMAs), twice that for the pair (two recurrences, 8 FMAs)
INSTR_PER_TRIPLE = {"analysis_spin0_folded": 14, "analysis_pair_folded": 28}


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
    m = re.search(r"analysis_kernelI([fd])Lb([01])E", entry)
    if m:
        return f"{'pair' if m.group(2) == '1' else 'spin0'}/" \
               f"{'f32' if m.group(1) == 'f' else 'f64'}"
    m = re.search(r"probe_kernelI([fd])Li([01])ELi(\d)E", entry)
    if m:
        return f"{'rec3' if m.group(2) == '1' else 'fma'}/" \
               f"{'f32' if m.group(1) == 'f' else 'f64'}/nchain{m.group(3)}"
    return "gram/f64" if "gram_kernel" in entry else None


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


def catalog_arrays():
    """bench.py's pipeline catalogue recipe, one array per bin."""
    rng = np.random.default_rng(8)
    dtype = [(n, "f8") for n in ("RA", "DEC", "G1", "G2", "W")]
    out = []
    for _ in range(NBINS):
        arr = np.empty(NROWS, dtype)
        arr["RA"] = rng.uniform(0, 360, NROWS)
        arr["DEC"] = np.degrees(np.arcsin(rng.uniform(-1, 1, NROWS)))
        arr["G1"] = rng.normal(0, 0.1, NROWS)
        arr["G2"] = rng.normal(0, 0.1, NROWS)
        arr["W"] = rng.uniform(0.5, 1.0, NROWS)
        out.append(arr)
    return out


def reset_counts():
    """Zero every kernel's launch count and every plain-version run count."""
    from heracles_tpu_torch.ops import fma_peak, gram, sht_kernels

    sht_kernels.reset_counts()
    gram.reset_counts()
    fma_peak.reset_counts()


def counts():
    """(kernel launches, plain-version runs), each by kernel name."""
    from heracles_tpu_torch.ops import fma_peak, gram, sht_kernels, wigner

    launches = {**sht_kernels.LAUNCHES, **gram.LAUNCHES, **fma_peak.LAUNCHES}
    plain = {**wigner.PLAIN_RUNS, **gram.PLAIN_RUNS, **fma_peak.PLAIN_RUNS}
    return launches, plain


def phase2(dev):
    from heracles_tpu_torch.healpix import ring_geometry
    from heracles_tpu_torch.ops import fma_peak, gram, sht_kernels, wigner

    rows = []
    # batched, lmax > 2 nside at high order (seeds near the poles), odd nside
    for nside, lmax, batch in [(256, 384, 3), (64, 191, 1), (33, 80, 1)]:
        nhalf = 2 * nside
        z = ring_geometry(nside)["z"][:nhalf]
        geom = [torch.as_tensor(a, device=dev) for a in (
            z, 0.5 * np.log((1.0 + z) / 2.0), 0.5 * np.log((1.0 - z) / 2.0))]
        rng = np.random.default_rng(nside)
        shape = (batch, nhalf, lmax + 1)
        F64 = [rng.normal(size=shape) + 1j * rng.normal(size=shape)
               for _ in range(4)]
        for cdtype in (torch.complex64, torch.complex128):
            F = [torch.as_tensor(a, dtype=cdtype, device=dev) for a in F64]
            want = wigner.analysis_spin0_folded_plain(F[0], F[1], *geom, lmax)
            got = sht_kernels.analysis_spin0_folded(F[0], F[1], *geom, lmax)
            _, rel = compare(got, want, *TOL[cdtype])
            tag = "f32" if cdtype == torch.complex64 else "f64"
            rows.append(f"spin0/{tag}/n{nside}l{lmax} {rel:.2e}")
            want = wigner.analysis_pair_folded_plain(*F, *geom, lmax, 2)
            got = sht_kernels.analysis_pair_folded(*F, *geom, lmax, 2)
            rel = max(compare(g, w, *TOL[cdtype])[1] for g, w in zip(got, want))
            rows.append(f"pair/{tag}/n{nside}l{lmax} {rel:.2e}")

    # ragged: K not a multiple of the chunk, L1 = 1, L2 not of the tile
    for K, L1, L2 in [(37, 1, 70), (500, 65, 129), (4501, 130, 3)]:
        rng = np.random.default_rng(K)
        A = torch.as_tensor(rng.normal(size=(K, L1)), device=dev)
        B = torch.as_tensor(rng.normal(size=(K, L2)), device=dev)
        u = torch.as_tensor(rng.normal(size=K), device=dev)
        for tag, w in (("u", u), ("1", None)):
            _, rel = compare(gram.gram(A, B, w), gram.gram_plain(A, B, w),
                             GRAM_TOL, what=f"gram K{K} {L1}x{L2}")
            rows.append(f"gram/{tag}/K{K}x{L1}x{L2} {rel:.2e}")

    # the probe at full occupancy, few steps; the float32 fma case is the
    # one the kernels line reports
    rows_full = fma_peak.default_rows(dev)
    probe = {}
    for dtype in (torch.float32, torch.float64):
        a, b = fma_peak.inputs(rows_full, dtype, dev)
        for kind in ("fma", "rec3"):
            args = (a, b, kind, PROBE_STEPS_CHECK, PROBE_NCHAIN)
            event_ms(lambda: fma_peak.chains(*args))  # warm
            got, ms = event_ms(lambda: fma_peak.chains(*args))
            want, plain_ms = event_ms(lambda: fma_peak.chains_plain(*args))
            tol = PROBE_STEPS_CHECK * torch.finfo(dtype).eps
            err, rel = compare(got, want, tol, what=f"{kind} probe {dtype}")
            tag = f"{kind}/{'f32' if dtype == torch.float32 else 'f64'}"
            rows.append(f"{tag}/{rows_full}x128x{PROBE_STEPS_CHECK} {rel:.2e}")
            probe[tag] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return rows, probe["fma/f32"]


def band_max_rel(cl32, cl64, lmin, nbands=10):
    """Largest |cl32/cl64 - 1| in each of ``nbands`` l-bands from lmin."""
    cl32 = cl32.cpu().numpy()[lmin:]
    cl64 = cl64.cpu().numpy()[lmin:]
    edges = np.linspace(0, cl64.shape[-1], nbands + 1).astype(int)
    rel = np.abs(cl32 - cl64) / np.abs(cl64)
    return [float(rel[a:b].max()) for a, b in zip(edges[:-1], edges[1:])]


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
    from heracles_tpu_torch import twopoint
    from heracles_tpu_torch.ops import (
        _build, fma_peak, gram, ringfft, sht, sht_kernels, wigner)

    t = time.perf_counter()
    kl = _build.load_library()
    print(f"phase 1 build: nvcc {kl.seconds:.1f} s -> {kl.path.name}; "
          f"{ptxas_summary(kl.log)} ({time.perf_counter() - t:.1f} s)",
          flush=True)

    t = time.perf_counter()
    rows, probe_check = phase2(dev)
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
    for i, arr in enumerate(catalog_arrays()):
        catalogs[i] = th.ArrayCatalog(arr)
        catalogs[i].visibility = vis
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
          f"{launches}; plain runs {plain_runs}; {len(cls)} finite spectra, "
          f"{len(mms)} finite mixing matrices; card {smi} "
          f"(setup {setup:.1f} s, {time.perf_counter() - t:.1f} s)", flush=True)
    del alms

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
        report[name] = dict(max_abs_err=max(e[0] for e in errs),
                            rel=max(e[1] for e in errs), ms=ms,
                            plain_ms=plain_ms, shape=tuple(args[0].shape))
        del got, want
    del spin0_args, pair_args

    bands = {}
    for key, spin, m32 in (("POS", 0, pos), ("SHE", 2, she)):
        a32 = sht.map2alm(m32, LMAX, spin=spin)
        a64 = sht.map2alm(m32.double(), LMAX, spin=spin)
        comps = [(key, a32, a64)] if spin == 0 else [
            (key + "_E", a32[0], a64[0]), (key + "_B", a32[1], a64[1])]
        for label, b32, b64 in comps:
            rel = band_max_rel(th.alm2cl(b32), th.alm2cl(b64), lmin=spin)
            bands[label] = rel
            check(max(rel) <= 1e-3, f"{label} f32 vs f64 band max {max(rel):.2e}")
    parts = [f"{n}: kernel {r['ms']:.1f} ms, plain {r['plain_ms']:.1f} ms, "
             f"max|d| {r['max_abs_err']:.3e} ({r['rel']:.2e} of max)"
             for n, r in report.items()]
    band_txt = "; ".join(f"{k} " + " ".join(f"{v:.1e}" for v in vals)
                         for k, vals in bands.items())
    print(f"phase 4 bin 0 at n{NSIDE} l{LMAX} f32: {'; '.join(parts)}; "
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
        err, rel = compare(got, want, GRAM_TOL, what=f"gram {label}")
        flop = 2.0 * A.shape[1] * B.shape[1] * A.shape[0]
        contractions[label] = dict(max_abs_err=err, rel=rel, ms=ms,
                                   plain_ms=plain_ms, flops=flop / (ms / 1e3))
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
             f"max|d| {c['max_abs_err']:.2e} ({c['rel']:.1e} of max), "
             f"{c['flops'] / 1e12:.2f} TFLOP/s" for k, c in contractions.items()]
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
    rates = {}
    for dtype in (torch.float32, torch.float64):
        for kind in ("fma", "rec3"):
            sec, n_ops = fma_peak.run(kind, None, PROBE_STEPS_RATE,
                                      PROBE_NCHAIN, dtype=dtype, device=dev)
            rates[kind, dtype] = n_ops / sec
    probe_launches, probe_plain = counts()
    check(probe_launches.get("fma_peak", 0) > 0, "fma_peak never launched")
    check(sum(probe_plain.values()) == 0, f"plain versions ran: {probe_plain}")
    fma32 = rates["fma", torch.float32]
    fma64 = rates["fma", torch.float64]
    shares = [f"gram FP64 {gram_rate / 1e12:.2f} TFLOP/s = "
              f"{100 * gram_rate / fma64:.1f}% of FP64 fma"]
    for name in INSTR_PER_TRIPLE:
        *batch, nhalf, nm = report[name]["shape"]
        spin = 0 if name == "analysis_spin0_folded" else 2
        j0 = np.maximum(np.arange(nm), spin)
        triples = float(np.prod(batch)) * nhalf * float(np.sum(LMAX + 1 - j0))
        instr = INSTR_PER_TRIPLE[name] * triples / (report[name]["ms"] / 1e3)
        # an FMA instruction is 2 of the probe's operations
        shares.append(f"{name} ~{INSTR_PER_TRIPLE[name]} instr/triple x "
                      f"{triples:.3g} triples in {report[name]['ms']:.1f} ms = "
                      f"{instr / 1e12:.2f} Tinstr/s = {100 * instr / (fma32 / 2):.1f}% "
                      f"of the FP32 fma issue rate")
    rate_txt = ", ".join(
        f"{k}/{'f32' if d == torch.float32 else 'f64'} {r / 1e12:.2f} Top/s"
        for (k, d), r in rates.items())
    print(f"phase 6 probe at {fma_peak.default_rows(dev)}x128, "
          f"{PROBE_STEPS_RATE} steps, {PROBE_NCHAIN} chains: {rate_txt}; "
          f"launches {probe_launches}; {'; '.join(shares)}; card {smi} "
          f"({time.perf_counter() - t:.1f} s)", flush=True)

    gram_report = dict(
        max_abs_err=max(c["max_abs_err"] for c in contractions.values()),
        ms=float(np.mean([c["ms"] for c in contractions.values()])),
        plain_ms=float(np.mean([c["plain_ms"] for c in contractions.values()])),
    )
    report["gram"] = gram_report
    report["fma_peak"] = probe_check
    launches["fma_peak"] = probe_launches.get("fma_peak", 0)
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
        }
        for name, (source, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
