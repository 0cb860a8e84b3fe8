"""Device traces of a run: stage labels and the Chrome-trace summariser.

A frozen copy of ``tools/torch_trace_capture.py`` as of commit bacb88b
(``KERNEL_TABLE``, ``stage_label``, ``StageLabels``, ``load_trace``,
``summarise`` and their helpers), so that later changes to the tool do
not move the yardstick.  It differs in four ways: ``STAGES`` puts the
labels on public names of the port only (no leading underscore), the rep
annotation is the benchmark's own, ``StageLabels`` keeps no count of the
labels entered, and ``summarise`` returns only what the runner reads.
"""

from __future__ import annotations

import bisect
import collections
import functools
import gzip
import json
import re
import sys

import torch

# the name of the annotation around each traced step: the summary's window
REP_LABEL = "benchmark.step"
# Chrome-trace categories of the work on the card, and of the host calls
# that queue it
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
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


# (module, attribute) of the stages labelled during a trace, public names
# only: the label is the module's last name and the attribute.  Module
# attributes are also patched wherever another of the package's modules
# bound the same object.
STAGES = (
    ("heracles_tpu_torch.ops.ringfft", "ring_analysis"),
    ("heracles_tpu_torch.ops.ringfft", "ring_synthesis"),
    ("heracles_tpu_torch.ops.sht", "map2alm"),
    ("heracles_tpu_torch.ops.sht", "alm2map"),
    ("heracles_tpu_torch.ops.sht_kernels", "analysis_spin0_folded"),
    ("heracles_tpu_torch.ops.sht_kernels", "analysis_pair_folded"),
    ("heracles_tpu_torch.ops.sht_kernels", "synthesis_spin0_folded"),
    ("heracles_tpu_torch.ops.sht_kernels", "synthesis_pair_folded"),
    ("heracles_tpu_torch.ops.gram", "gram"),
    ("heracles_tpu_torch.mappers", "HealpixMapper.transform"),
    ("heracles_tpu_torch.mapping", "map_catalogs"),
    ("heracles_tpu_torch.mapping", "transform"),
    ("heracles_tpu_torch.twopoint", "angular_power_spectra"),
    ("heracles_tpu_torch.twopoint", "mixing_matrices"),
    ("heracles_tpu_torch.twopoint", "mixmat"),
    ("heracles_tpu_torch.twopoint", "mixmat_eb"),
    ("heracles_tpu_torch.ops.wigner", "wigner_table_host"),
    ("heracles_tpu_torch.ops.wigner", "legendre_sum_host"),
)


def stage_label(module, attr):
    return f"{module.rsplit('.', 1)[-1]}.{attr}"


class StageLabels:
    """Wrap the listed stages in ``torch.profiler.record_function(label)``
    for the length of a ``with`` block, then restore every attribute.

    ``stages``: (module, attribute) pairs, the attribute possibly a
    ``Class.method``.  A module attribute is patched in its module's
    globals, so that calls by bare name inside it see the wrapper, and in
    every loaded module of the package that bound the same object.  The
    wrappers pass arguments and results through unchanged.
    """

    def __init__(self, stages=STAGES):
        self.stages = tuple(stages)
        self._saved = []
        self._originals = {}  # id(wrapper): (wrapper, original)

    def _wrap(self, fn, label):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
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


def _package_modules():
    return [m for name, m in list(sys.modules.items())
            if m is not None and name.startswith("heracles_tpu_torch")]


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


def summarise(trace, *, rep_label=REP_LABEL):
    """The device activity of a Chrome trace inside the traced steps.

    The windows are the ``rep_label`` annotations.  Device events are the
    ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events that start in a
    window, cut at its end; their union is the busy time, its complement
    in the windows the idle time.  Each device event is charged to the
    innermost annotation (the stage labels) that encloses the runtime or
    driver call with its correlation id.

    Returns a dict, each time per window: ``reps``, ``window_ms``,
    ``busy_ms``, ``device_ms`` by op name (a kernel's
    :func:`kernel_label`, a copy's or a fill's own name), longest first,
    ``device_ms_by_label``, and ``idle_ms_by_host_label`` (the idle time
    split by the innermost annotation open on the steps' thread at each
    instant: what the host was inside while the card waited).  Raises
    ValueError on a trace with no device events or no rep annotation.
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
    queries = [None if p[4] is None else (key(p[4]), float(p[4]["ts"]))
               for p in picked]
    where = _innermost(annotations, queries)

    nrep = len(windows)
    device_ms = collections.Counter()
    by_label = collections.Counter()
    for (_, s, e, name, launch), ann in zip(picked, where):
        ms = (e - s) / 1e3
        device_ms[name] += ms
        by_label[NO_LAUNCH if launch is None else ann or "-"] += ms

    # the host's innermost annotation on the steps' thread, piece by piece
    rep_key = next(key(e) for e in events if e.get("cat") == "user_annotation"
                   and e.get("name") == rep_label)
    cuts = sorted({t for k, s0, e0, _ in annotations if k == rep_key
                   for t in (s0, e0)} | {t for w in windows for t in w})
    mids = [(rep_key, (a + b) / 2) for a, b in zip(cuts, cuts[1:])]
    host = list(zip(cuts, cuts[1:], _innermost(annotations, mids)))
    host_starts = [a for a, _, _ in host]
    idle_by_host = collections.Counter()

    busy = 0.0
    for w, (w0, w1) in enumerate(windows):
        pieces = _union([(s, e, i) for i, (pw, s, e, *_) in enumerate(picked)
                         if pw == w])
        busy += sum(e - s for s, e, _ in pieces)
        bounds = [w0] + [e for _, e, _ in pieces]
        nexts = [s for s, _, _ in pieces] + [w1]
        for g0, g1 in zip(bounds, nexts):
            if g1 <= g0:
                continue
            j = max(bisect.bisect_right(host_starts, g0) - 1, 0)
            while j < len(host) and host[j][0] < g1:
                a, b, name = host[j]
                idle_by_host[name or "-"] += min(b, g1) - max(a, g0)
                j += 1

    return dict(
        reps=nrep,
        window_ms=sum(w1 - w0 for w0, w1 in windows) / 1e3 / nrep,
        busy_ms=busy / 1e3 / nrep,
        device_ms={k: v / nrep for k, v in device_ms.most_common()},
        device_ms_by_label={k: v / nrep for k, v in by_label.most_common()},
        idle_ms_by_host_label={k: v / 1e3 / nrep
                               for k, v in idle_by_host.most_common()},
    )
