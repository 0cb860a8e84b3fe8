"""Capture and summarise a torch.profiler device trace of a port op on the card.

Twin of ``tools/trace_capture.py`` for ``heracles_tpu_torch``: runs one op
once untraced (build and warm-up), then ``--reps`` times under
``torch.profiler.profile(activities=[CPU, CUDA])``, each rep inside the
tool's own annotation and ending in ``torch.cuda.synchronize()``, with
the port's stages labelled from outside the package (:class:`StageLabels`).
It prints the device time per op name (ms per rep), the launches, the
device's busy and idle time over the reps' windows, and the idle gaps
summed by the host work that made the card wait, and appends one record
per op to ``tools/torch_trace_capture.json``.

    python3 tools/torch_trace_capture.py
        [--op spin0|spin2|synthesis|transform|pipeline|dices|mesh|gram]
        [--nside 4096] [--lmax 3000] [--reps 2] [--top 25]
        [--outdir DIR] [--min-gap-us 20] [--stack]

The ops, seed 0 and float32 maps unless said otherwise:

* ``spin0``, ``spin2``: ``sht.map2alm(packed=False)`` of one map;
* ``synthesis``: ``sht.alm2map`` of one set of random alms;
* ``transform``: ``HealpixMapper(nside, lmax, iterations=3).transform`` of
  one spin-0 and one spin-2 map (``chip_smoke.py`` phase 7's refined
  transform);
* ``pipeline``: ``map_catalogs`` -> ``transform`` ->
  ``angular_power_spectra`` -> ``mixing_matrices`` of the mask spectra at
  the ``pipeline_n4096_l3000`` configuration (``chip_smoke.py`` phase 3:
  2 bins of 5e6 seeded rows, POS + SHE + VIS), each rep with the host
  caches of the quadrature rule and the Wigner tables emptied, as in a
  fresh process; one rep unless asked;
* ``dices``: ``compute_jk_alms`` in device mode at the ``dices_njk50_n1024``
  configuration (nside 1024, lmax 1536, 50 regions in batches of 8; the
  ``--nside`` / ``--lmax`` flags do not apply), then
  ``compute_jk_cls_from_alms`` of two delete-1 samples (the region map
  relabelled to its first two regions: the same work per sample);
* ``mesh``: ``parallel.pipeline_step`` of two spin-0 and two spin-2 maps
  on ``make_mesh()`` and on a (2, 2) mesh of one card (phase 11);
* ``gram``: the Gram kernel (B5) and ``torch.einsum`` on phase 5's four
  contractions at K = 3 lmax / 2 + 1, back to back in every rep, each
  under its own label, so that the trace gives each one's device time.

The raw trace goes to ``--outdir`` (default ``torchtrace`` in the
temporary directory), never into the repository.  Needs a CUDA card: with
none, ``main()`` exits non-zero before it traces anything.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import functools
import gzip
import json
import os
import re
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

RECORDS = os.path.join(HERE, "torch_trace_capture.json")
# the name of the tool's annotation around each rep: the summary's window
REP_LABEL = "torch_trace_capture.rep"
# Chrome-trace categories of the work on the card, and of the host calls
# that queue it
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
FINAL_SYNC = "(final sync)"
NO_LAUNCH = "(no launch found)"

# the port's kernel symbols (heracles_tpu_torch/csrc) and their rows of
# PERF.md's kernel table
KERNEL_TABLE = {
    "analysis_kernel": "B1", "pair_analysis_kernel": "B2",
    # the launches on groups of maps (nb > 1)
    "analysis_group_kernel": "B1", "pair_group_kernel": "B2",
    "synthesis_kernel": "B3", "pair_synthesis_kernel": "B4",
    "synth_group_kernel": "B3", "synth_pair_group_kernel": "B4",
    "gram_kernel": "B5", "probe_kernel": "B6",
    "bin_kernel": "S1", "scan_kernel": "S1", "order_kernel": "S1",
    "spread_kernel": "S1",
}
_KERNEL_RE = re.compile(r"(?<![\w])(" + "|".join(
    sorted(KERNEL_TABLE, key=len, reverse=True)) + r")(<[^()]*>)?")

# (module, attribute) of the stages labelled during a trace: the label is
# the module's last name and the attribute.  Module attributes are also
# patched wherever another of the package's modules bound the same object.
STAGES = (
    ("heracles_tpu_torch.ops.ringfft", "ring_analysis"),
    ("heracles_tpu_torch.ops.ringfft", "ring_synthesis"),
    ("heracles_tpu_torch.ops.sht", "map2alm"),
    ("heracles_tpu_torch.ops.sht", "_map2alm_once"),
    ("heracles_tpu_torch.ops.sht", "_map2alm_block"),
    ("heracles_tpu_torch.ops.sht", "_folded_inputs"),
    ("heracles_tpu_torch.ops.sht", "alm2map"),
    ("heracles_tpu_torch.ops.sht", "_synthesis_block"),
    ("heracles_tpu_torch.ops.sht_kernels", "analysis_spin0_folded"),
    ("heracles_tpu_torch.ops.sht_kernels", "analysis_pair_folded"),
    ("heracles_tpu_torch.ops.sht_kernels", "synthesis_spin0_folded"),
    ("heracles_tpu_torch.ops.sht_kernels", "synthesis_pair_folded"),
    ("heracles_tpu_torch.ops.gram", "gram"),
    ("heracles_tpu_torch.mappers", "HealpixMapper.transform"),
    ("heracles_tpu_torch.mapping", "map_catalogs"),
    ("heracles_tpu_torch.mapping", "transform"),
    ("heracles_tpu_torch.twopoint", "angular_power_spectra"),
    ("heracles_tpu_torch.twopoint", "angular_power_spectra_sample_stacks"),
    ("heracles_tpu_torch.twopoint", "mixing_matrices"),
    ("heracles_tpu_torch.twopoint", "_leggauss"),
    ("heracles_tpu_torch.twopoint", "_mixmat_tables"),
    ("heracles_tpu_torch.twopoint", "_pinv_batch"),
    ("heracles_tpu_torch.ops.wigner", "wigner_table_host"),
    ("heracles_tpu_torch.ops.wigner", "legendre_sum_host"),
    ("heracles_tpu_torch.dices.jackknife", "compute_jk_alms"),
    ("heracles_tpu_torch.dices.jackknife", "compute_jk_cls_from_alms"),
    ("heracles_tpu_torch.dices.jackknife", "jackknife_fsky"),
    ("heracles_tpu_torch.parallel", "map2alm_sharded"),
    ("heracles_tpu_torch.parallel", "pipeline_step"),
)


def stage_label(module, attr):
    return f"{module.rsplit('.', 1)[-1]}.{attr}"


# the labels each op must enter (the others it may)
_ANALYSIS = ("ringfft.ring_analysis", "sht._map2alm_block",
             "sht._folded_inputs")
OP_LABELS = {
    "spin0": ("sht.map2alm", "sht._map2alm_once", *_ANALYSIS,
              "sht_kernels.analysis_spin0_folded"),
    "spin2": ("sht.map2alm", "sht._map2alm_once", *_ANALYSIS,
              "sht_kernels.analysis_pair_folded"),
    "synthesis": ("sht.alm2map", "sht._synthesis_block",
                  "ringfft.ring_synthesis",
                  "sht_kernels.synthesis_spin0_folded"),
    "transform": ("mappers.HealpixMapper.transform", "sht.map2alm",
                  "sht._map2alm_once", *_ANALYSIS, "sht.alm2map",
                  "sht._synthesis_block", "ringfft.ring_synthesis",
                  "sht_kernels.analysis_spin0_folded",
                  "sht_kernels.analysis_pair_folded",
                  "sht_kernels.synthesis_spin0_folded",
                  "sht_kernels.synthesis_pair_folded"),
    "pipeline": ("mapping.map_catalogs", "mapping.transform",
                 "mappers.HealpixMapper.transform", "sht.map2alm",
                 "sht._map2alm_once", *_ANALYSIS,
                 "sht_kernels.analysis_spin0_folded",
                 "sht_kernels.analysis_pair_folded",
                 "twopoint.angular_power_spectra", "twopoint.mixing_matrices",
                 "twopoint._leggauss", "twopoint._mixmat_tables",
                 "wigner.wigner_table_host",
                 "wigner.legendre_sum_host", "gram.gram"),
    "dices": ("jackknife.compute_jk_alms", "jackknife.compute_jk_cls_from_alms",
              "jackknife.jackknife_fsky",
              "twopoint.angular_power_spectra_sample_stacks",
              "mappers.HealpixMapper.transform", "sht.map2alm", *_ANALYSIS,
              "sht_kernels.analysis_spin0_folded",
              "sht_kernels.analysis_pair_folded"),
    "mesh": ("parallel.pipeline_step", *_ANALYSIS,
             "sht_kernels.analysis_spin0_folded",
             "sht_kernels.analysis_pair_folded"),
    "gram": ("gram.gram",),
}
OPS = tuple(OP_LABELS)


# -- stage labels ----------------------------------------------------------

class StageLabels:
    """Wrap the listed stages in ``torch.profiler.record_function(label)``
    for the length of a ``with`` block, then restore every attribute.

    ``stages``: (module, attribute) pairs, the attribute possibly a
    ``Class.method``.  A module attribute is patched in its module's
    globals, so that calls by bare name inside it see the wrapper, and in
    every loaded module of the package that bound the same object.
    ``entered`` counts each label's calls inside the block; a label never
    entered is dead (:meth:`dead`): its target was reached by another
    binding.  The wrappers pass arguments and results through unchanged.
    """

    def __init__(self, stages=STAGES):
        self.stages = tuple(stages)
        self.entered = collections.Counter()
        self._saved = []
        self._originals = {}  # id(wrapper): (wrapper, original)

    def _wrap(self, fn, label):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            self.entered[label] += 1
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        self._originals[id(wrapper)] = (wrapper, fn)
        return wrapper

    def _patch(self, owner, name, wrapper):
        self._saved.append((owner, name, vars(owner)[name]))
        setattr(owner, name, wrapper)

    def __enter__(self):
        import importlib

        # every module first, so that none is imported while another's
        # attributes are patched
        targets = []
        for module, attr in self.stages:
            owner = importlib.import_module(module)
            *path, name = attr.split(".")
            for part in path:
                owner = getattr(owner, part)
            targets.append((stage_label(module, attr), owner, name, not path))
        try:
            for label, owner, name, is_module in targets:
                fn = vars(owner)[name]
                wrapper = self._wrap(fn, label)
                self._patch(owner, name, wrapper)
                if not is_module:
                    continue
                for other in _package_modules():
                    if other is owner:
                        continue
                    for key, value in list(vars(other).items()):
                        if value is fn:
                            self._patch(other, key, wrapper)
        except BaseException:
            self._restore()
            raise
        return self

    def _restore(self):
        while self._saved:
            owner, name, value = self._saved.pop()
            setattr(owner, name, value)
        # a module first imported inside the block may have bound a wrapper
        for other in _package_modules():
            for key, value in list(vars(other).items()):
                hit = self._originals.get(id(value))
                if hit is not None and hit[0] is value:
                    setattr(other, key, hit[1])
        self._originals.clear()

    def __exit__(self, *exc):
        self._restore()
        return False

    def labels(self):
        return [stage_label(m, a) for m, a in self.stages]

    def dead(self, expected=None):
        """The labels of ``expected`` (default: all) never entered."""
        return [lab for lab in (self.labels() if expected is None else expected)
                if not self.entered[lab]]


def _package_modules():
    return [m for name, m in list(sys.modules.items())
            if m is not None and name.startswith("heracles_tpu_torch")]


# -- the summariser: pure functions over a Chrome-trace dict ---------------

def load_trace(path):
    """The dict that ``prof.export_chrome_trace(path)`` wrote (plain or
    gzipped JSON)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _strip_params(name):
    """A demangled name without its parameter list and leading ``void``."""
    name = name.removeprefix("void ")
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                return name[:i]
    return name


def kernel_label(name):
    """The table label of a port kernel with its template arguments
    (``B1 analysis_kernel<float, false, false>``); other names without
    their parameter lists."""
    m = _KERNEL_RE.search(name)
    if m:
        return f"{KERNEL_TABLE[m.group(1)]} {m.group(1)}{m.group(2) or ''}"
    return _strip_params(name)


def table_tag(label):
    """The table label (``B1`` ... ``S1``) of a :func:`kernel_label`, else
    None."""
    tag = label.split(" ", 1)[0]
    return tag if tag in set(KERNEL_TABLE.values()) else None


def _union(intervals):
    """Sorted disjoint (start, end) covering the given intervals, each
    piece with the index of the interval that starts it."""
    out = []
    for s, e, i in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e, i])
    return out


def _innermost(intervals, queries):
    """For each query (key, t), the name of the innermost interval
    (key, start, end, name) of the same key that contains t, else None
    (also for a query that is None).

    Intervals of one key nest (one thread's call stack), so a sweep in
    time order with a stack finds it.
    """
    by_key = collections.defaultdict(list)
    for key, s, e, name in intervals:
        by_key[key].append((s, -e, name))
    for iv in by_key.values():
        iv.sort()
    out = [None] * len(queries)
    order = sorted((i for i, q in enumerate(queries) if q is not None),
                   key=lambda i: queries[i][1])
    stacks, pos = collections.defaultdict(list), collections.Counter()
    for qi in order:
        key, t = queries[qi]
        iv, stack = by_key.get(key, ()), stacks[key]
        while pos[key] < len(iv) and iv[pos[key]][0] <= t:
            s, neg_e, name = iv[pos[key]]
            while stack and stack[-1][0] < s:
                stack.pop()
            stack.append((-neg_e, name))
            pos[key] += 1
        while stack and stack[-1][0] < t:
            stack.pop()
        out[qi] = stack[-1][1] if stack else None
    return out


def summarise(trace, *, min_gap_us=20.0, rep_label=REP_LABEL):
    """The device activity of a Chrome trace inside the tool's reps.

    The windows are the ``rep_label`` annotations.  Device events are the
    ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events that start in a
    window, cut at its end; their union is the busy time, its complement
    in the windows the idle time.  Each device event is charged to the
    innermost annotation (the tool's labels) that encloses the runtime or
    driver call with its correlation id.  A gap is a maximal span of a
    window with no device event; one longer than ``min_gap_us`` is
    labelled ``annotation | cpu_op``, the innermost annotation and
    ``cpu_op`` enclosing the call that queued the event ending it, or
    ``(final sync)`` where it runs to the window's end.

    Returns a dict: ``reps``; per rep ``window_ms``, ``busy_ms``,
    ``idle_ms``, ``device_ms`` and ``launches`` by op name (a kernel's
    :func:`kernel_label`, a copy's or a fill's own name),
    ``device_ms_by_label``, ``device_ms_by_stage_op`` (by ``annotation |
    cpu_op`` of the queuing call), ``idle_ms_by_host_label`` (the idle
    time split by the innermost annotation open on the reps' thread at
    each instant: what the host was inside while the card waited);
    ``idle_share`` (1 - busy / window); ``gaps`` by label (``n`` and ``ms`` per rep, longest
    first); ``longest_gaps`` (the ten longest, ms and label);
    ``per_rep`` (each window's ``window_ms``, ``busy_ms``, ``idle_ms``,
    ``device_ms_by_label``); ``launch_skew_us``, the least time from a
    launch call to the start of its device event as recorded, and
    ``clock_shift_us``, the time by which the device events were moved
    later so that it is not negative; ``events``, the trace's complete
    events.  Raises ValueError on a trace with no device events or no rep
    annotation.
    """
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not device:
        raise ValueError("the trace holds no device events (kernel, "
                         "gpu_memcpy, gpu_memset): a CPU-only trace, or the "
                         "profiler recorded nothing on the card")
    windows = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in events if e.get("cat") == "user_annotation"
                     and e.get("name") == rep_label)
    if not windows:
        raise ValueError(f"the trace holds no {rep_label!r} annotation")
    starts = [w[0] for w in windows]

    def window_of(t):
        i = bisect.bisect_right(starts, t) - 1
        return i if i >= 0 and t < windows[i][1] else None

    launches_by_corr = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches_by_corr.setdefault(corr, e)

    # The host and device clocks of a trace can disagree by a constant
    # (up to ~1.2 ms seen on an H100): no device event starts before the
    # call that queued it, so the device times are moved later by the
    # largest such lead.
    skew = min((float(e["ts"]) - float(launch["ts"]) for e in device
                if (launch := launches_by_corr.get(
                    e.get("args", {}).get("correlation"))) is not None),
               default=None)
    shift = max(0.0, -skew) if skew is not None else 0.0

    # the device events of each window, and the call that queued each
    picked = []  # (window, start, end, label, launch event or None)
    for e in device:
        ts = float(e["ts"]) + shift
        w = window_of(ts)
        if w is None:
            continue
        end = min(ts + float(e["dur"]), windows[w][1])
        launch = launches_by_corr.get(e.get("args", {}).get("correlation"))
        name = e.get("name", "?")
        if e["cat"] == "kernel":
            name = kernel_label(name)
        picked.append((w, ts, end, name, launch))

    def key(e):
        return (e.get("pid"), e.get("tid"))

    annotations = [(key(e), float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("cat") == "user_annotation"]
    cpu_ops = [(key(e), float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                e["name"]) for e in events if e.get("cat") == "cpu_op"]
    queries = [None if p[4] is None else (key(p[4]), float(p[4]["ts"]))
               for p in picked]
    where = _innermost(annotations, queries)
    what = _innermost(cpu_ops, queries)

    nrep = len(windows)
    device_ms = collections.Counter()
    launches = collections.Counter()
    by_label = collections.Counter()
    by_stage_op = collections.Counter()
    per_rep = [dict(window_ms=(w1 - w0) / 1e3, busy_ms=0.0, idle_ms=0.0,
                    device_ms_by_label=collections.Counter())
               for w0, w1 in windows]
    for (w, s, e, name, launch), ann, op in zip(picked, where, what):
        ms = (e - s) / 1e3
        device_ms[name] += ms
        launches[name] += 1
        if launch is None:
            lab = stage_op = NO_LAUNCH
        else:
            lab, stage_op = ann or "-", f"{ann or '-'} | {op or '-'}"
        by_label[lab] += ms
        by_stage_op[stage_op] += ms
        per_rep[w]["device_ms_by_label"][lab] += ms

    # the host's innermost annotation on the reps' thread, piece by piece
    rep_key = next(key(e) for e in events if e.get("cat") == "user_annotation"
                   and e.get("name") == rep_label)
    cuts = sorted({t for k, s0, e0, _ in annotations if k == rep_key
                   for t in (s0, e0)} | {t for w in windows for t in w})
    mids = [(rep_key, (a + b) / 2) for a, b in zip(cuts, cuts[1:])]
    host = list(zip(cuts, cuts[1:], _innermost(annotations, mids)))
    host_starts = [a for a, _, _ in host]
    idle_by_host = collections.Counter()

    gaps = collections.defaultdict(lambda: [0, 0.0])
    longest = []
    for w, (w0, w1) in enumerate(windows):
        mine = [(s, e, i) for i, (pw, s, e, *_) in enumerate(picked)
                if pw == w]
        pieces = _union(mine)
        busy = sum(e - s for s, e, _ in pieces)
        bounds = [(w0, None)] + [(e, i) for _, e, i in pieces]
        nexts = [(s, i) for s, _, i in pieces] + [(w1, None)]
        idle = 0.0
        for (g0, _), (g1, i) in zip(bounds, nexts):
            if g1 <= g0:
                continue
            idle += g1 - g0
            j = max(bisect.bisect_right(host_starts, g0) - 1, 0)
            while j < len(host) and host[j][0] < g1:
                a, b, name = host[j]
                idle_by_host[name or "-"] += min(b, g1) - max(a, g0)
                j += 1
            if g1 - g0 <= min_gap_us:
                continue
            if i is None:
                label = FINAL_SYNC
            elif picked[i][4] is None:
                label = NO_LAUNCH
            else:
                label = f"{where[i] or '-'} | {what[i] or '-'}"
            gaps[label][0] += 1
            gaps[label][1] += (g1 - g0) / 1e3
            longest.append(((g1 - g0) / 1e3, label))
        per_rep[w]["busy_ms"] = busy / 1e3
        per_rep[w]["idle_ms"] = idle / 1e3

    window = sum(r["window_ms"] for r in per_rep)
    busy = sum(r["busy_ms"] for r in per_rep)
    idle = sum(r["idle_ms"] for r in per_rep)
    for r in per_rep:
        r["device_ms_by_label"] = dict(r["device_ms_by_label"])
    return dict(
        reps=nrep,
        window_ms=window / nrep,
        busy_ms=busy / nrep,
        idle_ms=idle / nrep,
        idle_share=1.0 - busy / window if window else 0.0,
        device_ms={k: v / nrep for k, v in device_ms.most_common()},
        launches={k: v / nrep for k, v in launches.most_common()},
        device_ms_by_label={k: v / nrep for k, v in by_label.most_common()},
        device_ms_by_stage_op={k: v / nrep
                               for k, v in by_stage_op.most_common()},
        idle_ms_by_host_label={k: v / 1e3 / nrep
                               for k, v in idle_by_host.most_common()},
        gaps={k: dict(n=n / nrep, ms=ms / nrep) for k, (n, ms) in sorted(
            gaps.items(), key=lambda kv: -kv[1][1])},
        longest_gaps=sorted(longest, reverse=True)[:10],
        per_rep=per_rep,
        launch_skew_us=skew,
        clock_shift_us=shift,
        events=len(events),
    )


def launches_by_table(summary):
    """Launches per rep summed by table label (B1 ... S1)."""
    out = collections.Counter()
    for name, n in summary["launches"].items():
        tag = table_tag(name)
        if tag:
            out[tag] += n
    return dict(out)


def device_ms_by_table(summary):
    """Device ms per rep summed by table label (B1 ... S1)."""
    out = collections.Counter()
    for name, ms in summary["device_ms"].items():
        tag = table_tag(name)
        if tag:
            out[tag] += ms
    return dict(out)


def report(summary, top=25, ngaps=10):
    """The printed summary: the JAX tool's table, then launches, busy /
    window / idle and the top gaps by label."""
    s, n = summary, summary["reps"]
    lines = [f"# device op totals over {n} reps (ms per rep):"]
    for name, ms in list(s["device_ms"].items())[:top]:
        lines.append(f"{ms:9.2f} ms  {name[:100]}")
    lines.append("# launches per rep:")
    for name, k in list(s["launches"].items())[:top]:
        lines.append(f"{k:9g}     {name[:100]}")
    lines.append(f"# busy {s['busy_ms']:.3f} ms / window {s['window_ms']:.3f} "
                 f"ms per rep, idle {s['idle_ms']:.3f} ms, idle share "
                 f"{s['idle_share']:.4f}")
    lines.append("# device ms per rep by stage label:")
    for lab, ms in list(s["device_ms_by_label"].items())[:top]:
        lines.append(f"{ms:9.2f} ms  {lab}")
    lines.append("# device ms per rep by stage | op:")
    for lab, ms in list(s["device_ms_by_stage_op"].items())[:top]:
        lines.append(f"{ms:9.2f} ms  {lab[:120]}")
    lines.append("# idle ms per rep by the host's stage:")
    for lab, ms in list(s["idle_ms_by_host_label"].items())[:top]:
        lines.append(f"{ms:9.2f} ms  {lab}")
    lines.append("# idle gaps by label (ms per rep, gaps per rep):")
    for lab, g in list(s["gaps"].items())[:ngaps]:
        lines.append(f"{g['ms']:9.2f} ms  {g['n']:7g}  {lab[:120]}")
    lines.append(f"# launch-to-start skew min {s['launch_skew_us']} us as "
                 f"recorded, device clock moved {s['clock_shift_us']} us; "
                 f"{s['events']} events")
    return "\n".join(lines)


# -- the ops ---------------------------------------------------------------

def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _chip_smoke():
    """``chip_smoke.py`` of this checkout (its configurations' recipes)."""
    import chip_smoke

    return chip_smoke


def build_op(op, nside, lmax, device="cuda", *, rows=None, regions=None):
    """A zero-argument function running the op once on ``device`` (a
    scalar of its result, so the work is consumed).

    ``rows`` (pipeline: rows per bin, default the configuration's 5e6) and
    ``regions`` (dices: regions of the region map, default 50) shrink the
    op for a CPU run; ``dices`` takes ``nside`` / ``lmax`` from the
    configuration unless ``regions`` is given.
    """
    import heracles_tpu_torch as th
    from heracles_tpu_torch import parallel, twopoint
    from heracles_tpu_torch.ops import gram, sht

    dev = torch.device(device)
    rng = np.random.default_rng(0)
    npix = 12 * nside * nside

    def upload(a):
        return torch.as_tensor(a.astype(np.float32), device=dev)

    if op in ("spin0", "spin2"):
        spin = 0 if op == "spin0" else 2
        maps = upload(rng.normal(size=(npix,) if spin == 0 else (2, npix)))
        return lambda: float(sht.map2alm(maps, lmax, spin=spin,
                                         packed=False).abs().sum())
    if op == "synthesis":
        nlm = sht.alm_size(lmax)
        alm = torch.complex(upload(rng.normal(size=nlm)),
                            upload(rng.normal(size=nlm)))
        return lambda: float((sht.alm2map(alm, nside, lmax) ** 2).sum())
    if op == "transform":
        mapper = th.HealpixMapper(nside, lmax, dtype=torch.float32, device=dev,
                                  iterations=3)
        pos = upload(rng.normal(size=npix))
        she = upload(rng.normal(size=(2, npix)))
        return lambda: float(mapper.transform(pos, spin=0).array.abs().sum()
                             + mapper.transform(she, spin=2).array.abs().sum())
    if op == "pipeline":
        return _pipeline_op(nside, lmax, dev, rows)
    if op == "dices":
        return _dices_op(dev, nside if regions else None,
                         lmax if regions else None, regions)
    if op == "mesh":
        if dev.type == "cuda":
            cards = parallel.make_mesh()
        else:
            cards = parallel.make_mesh(1, devices=[dev])
        quad = parallel.make_mesh(4, m_axis=2, devices=[dev] * 4)
        pos = upload(rng.normal(size=(2, npix)))
        she = upload(rng.normal(size=(2, 2, npix)))
        return lambda: float(
            parallel.pipeline_step(cards, pos, lmax, she).sum()
            + parallel.pipeline_step(quad, pos, lmax, she).sum())
    if op == "gram":
        ell = np.arange(lmax + 1)
        cl3 = 1.0 / (1.0 + ell) ** 2
        contractions = []
        for (s1, s2), eb, which in (((0, 0), False, 0), ((0, 2), False, 0),
                                    ((2, 2), True, 0), ((2, 2), True, 1)):
            A, B, us = twopoint._mixmat_operands(cl3, lmax, lmax, s1, s2, eb,
                                                 dev)
            contractions.append((A, B, us[which]))

        def run():
            total = 0.0
            for A, B, u in contractions:
                total += float(gram.gram(A, B, u).sum())
                with torch.profiler.record_function("torch.einsum"):
                    total += float(torch.einsum("ka,k,kb->ab", A, u, B).sum())
            return total
        return run
    raise SystemExit(f"unknown --op {op}")


def _pipeline_op(nside, lmax, dev, rows):
    import heracles_tpu_torch as th
    from heracles_tpu_torch import mapping, twopoint

    cs = _chip_smoke()
    mapper = th.HealpixMapper(nside, lmax, dtype=torch.float32, device=dev)
    fields = {
        "POS": th.Positions(mapper, "RA", "DEC", mask="VIS", overdensity=False),
        "SHE": th.Shears(mapper, "RA", "DEC", "G1", "G2", "W", mask="VIS"),
        "VIS": th.Visibility(mapper),
    }
    npix = 12 * nside * nside
    ring = torch.arange(npix, device=dev)
    vis = ((ring > npix // 5) & (ring < 4 * npix // 5)).to(torch.float32)
    catalogs = {}
    for i, arr in enumerate(cs.catalog_arrays(rows or cs.NROWS)):
        catalogs[i] = th.ArrayCatalog(arr)
        catalogs[i].visibility = vis

    # a cold step, as phase 3 runs it: the host caches of the quadrature
    # rule and the Wigner tables emptied (through the functions themselves,
    # not the labels' wrappers)
    caches = (twopoint._leggauss, twopoint._mixmat_tables)

    def run():
        for cached in caches:
            cached.cache_clear()
        maps = mapping.map_catalogs(fields, catalogs)
        alms = mapping.transform(fields, maps)
        cls = twopoint.angular_power_spectra(alms)
        mask_cls = {k: v for k, v in cls.items() if k[:2] == ("VIS", "VIS")}
        mms = twopoint.mixing_matrices(fields, mask_cls, l3max=lmax)
        # host arrays already: one entry each
        return float(sum(np.asarray(m.array).flat[-1] for m in mms.values()))
    return run


def _dices_op(dev, nside, lmax, regions):
    from heracles_tpu_torch.dices import jackknife as jk_mod

    cs = _chip_smoke()
    kw = {} if nside is None else dict(nside=nside, lmax=lmax)
    _, fields, data, vmaps, region_map = cs._dices_inputs(dev, **kw)
    jk = region_map(regions or cs.DICES_NJK)
    # the first two regions, the others outside: two delete-1 samples
    jk2 = np.where(jk <= 2, jk, 0)

    def run():
        cache = jk_mod.compute_jk_alms(data, vmaps, jk, fields, dir=None,
                                       region_batch=cs.DICES_BATCH)
        cls = jk_mod.compute_jk_cls_from_alms(jk2, fields, nd=1, dir=None,
                                              alms_cache=cache)
        return float(sum(np.abs(np.asarray(c)).sum()
                         for sample in cls.values() for c in sample.values()))
    return run


# -- capture ---------------------------------------------------------------

def capture(fn, reps, device, path, *, stack=False):
    """Run ``fn`` ``reps`` times under the profiler, each rep inside the
    tool's annotation and ending in a synchronisation, with every stage
    labelled; writes the Chrome trace to ``path`` and returns the
    :class:`StageLabels`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    stages = StageLabels()
    with stages, profile(activities=activities, with_stack=stack) as prof:
        for _ in range(reps):
            with record_function(REP_LABEL):
                fn()
                _sync(device)
    prof.export_chrome_trace(str(path))
    return stages


def append_record(record):
    records = []
    if os.path.exists(RECORDS):
        with open(RECORDS) as f:
            records = json.load(f)
    records.append(record)
    with open(RECORDS, "w") as f:
        json.dump(records, f, indent=1)
        f.write("\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--op", default="spin0", choices=OPS)
    ap.add_argument("--nside", type=int, default=4096)
    ap.add_argument("--lmax", type=int, default=3000)
    ap.add_argument("--outdir",
                    default=os.path.join(tempfile.gettempdir(), "torchtrace"))
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--reps", type=int, default=None,
                    help="default 2 (pipeline: 1)")
    ap.add_argument("--min-gap-us", type=float, default=20.0)
    ap.add_argument("--stack", action="store_true",
                    help="record Python stacks (short ops only)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_trace_capture: torch sees no CUDA device; "
                         "this tool traces the card only")
    reps = args.reps or (1 if args.op == "pipeline" else 2)
    smi = _chip_smoke().card()
    kind = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    fn = build_op(args.op, args.nside, args.lmax, "cuda")
    fn()  # build + warm
    _sync("cuda")
    t_warm = time.perf_counter() - t0
    os.makedirs(args.outdir, exist_ok=True)
    nside, lmax = args.nside, args.lmax
    if args.op == "dices":  # the configuration's own
        nside, lmax = _chip_smoke().DICES_NSIDE, _chip_smoke().DICES_LMAX
    path = os.path.join(args.outdir, f"{args.op}_n{nside}_l{lmax}.trace.json")
    t0 = time.perf_counter()
    stages = capture(fn, reps, "cuda", path, stack=args.stack)
    t_trace = time.perf_counter() - t0
    summary = summarise(load_trace(path), min_gap_us=args.min_gap_us)
    dead = stages.dead(OP_LABELS[args.op])
    print(f"# {path} ({os.path.getsize(path)} bytes)")
    print(f"# card: {smi} | {kind}")
    print(report(summary, args.top))
    print(f"# stage labels entered: {dict(stages.entered)}; dead: {dead}")
    record = dict(
        op=args.op, nside=nside, lmax=lmax, reps=reps,
        min_gap_us=args.min_gap_us, stack=args.stack, card=smi, kind=kind,
        torch=torch.__version__, cuda=torch.version.cuda,
        warm_s=t_warm, traced_s=t_trace, trace_bytes=os.path.getsize(path),
        **{k: summary[k] for k in (
            "window_ms", "busy_ms", "idle_ms", "idle_share", "launch_skew_us",
            "clock_shift_us", "events")},
        device_ms=dict(list(summary["device_ms"].items())[:args.top]),
        launches=dict(list(summary["launches"].items())[:args.top]),
        device_ms_by_label=summary["device_ms_by_label"],
        device_ms_by_stage_op=dict(list(
            summary["device_ms_by_stage_op"].items())[:args.top]),
        idle_ms_by_host_label=summary["idle_ms_by_host_label"],
        gaps=dict(list(summary["gaps"].items())[:args.top]),
        longest_gaps=summary["longest_gaps"],
        per_rep=summary["per_rep"],
        entered=dict(stages.entered), dead=dead,
    )
    append_record(record)
    if dead:
        raise SystemExit(f"torch_trace_capture: dead stage labels {dead}")


if __name__ == "__main__":
    main()
