"""Run one cell of the benchmark once and print its result line.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``
(configuration, chips), the configuration file named there, the traffic
file ``workloads/<cell>.json`` (the entry it drives and its parameters:
warm-up steps, pool, kept steps, traced steps, the limits of the compared
numbers), the entry ``entries/<entry>.py`` (one kind of step) with its
plain reference ``reference/<entry>.py``, and one reader
``metrics/<metric>.py`` per metric.

A run: set-up (inputs from the seed, the program's objects, warm-up
steps), then steps back to back until ``--seconds`` have passed (the
window ends at the end of the step during which it passed), a sample of
the steps' outputs drawn from the seed kept; then the peak device memory,
the program's state freed, the kept outputs compared with the plain
reference, the limits printed on standard error and one JSON line on
standard output.  ``--trace 1`` runs, after set-up, a few steps with
every layer's span fenced by ``torch.cuda.synchronize()`` and a few
under ``torch.profiler`` with the stage labels of :mod:`.trace`, and
reports the per-layer metrics.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
BUILD = os.path.join(ROOT, "build", "benchmark")
# top-level module names that no run may have loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "heracles_tpu")


def process_start():
    """The wall-clock time at which this process started (Linux), else
    now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Host-clock spans around the calls into each layer of a step, each
    fenced by a synchronisation; with no device, nothing is recorded."""

    def __init__(self, device=None):
        self.device = device
        self.records = collections.defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name):
        if self.device is None:
            yield
            return
        sync(self.device)
        t = time.perf_counter()
        yield
        sync(self.device)
        self.records[name].append(time.perf_counter() - t)


class Keeper:
    """A uniform sample of ``size`` step outputs, drawn from the seed
    (reservoir sampling), whatever the number of steps."""

    def __init__(self, seed, size):
        self.rng = np.random.default_rng([seed, 1])
        self.size = size
        self.kept = []
        self.seen = 0

    def offer(self, out):
        if len(self.kept) < self.size:
            self.kept.append(out)
        else:
            j = int(self.rng.integers(self.seen + 1))
            if j < self.size:
                self.kept[j] = out
        self.seen += 1


def load_spec(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_files(spec, name, bench=BENCH, root=ROOT):
    """(workload entry, configuration, traffic) of the cell ``name``."""
    wl = next((w for w in spec["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in spec["configs"] if c["name"] == wl["config"])
    config = _load_json(os.path.join(root, cfg_entry["file"]))
    config.setdefault("name", cfg_entry["name"])
    traffic = _load_json(os.path.join(bench, "workloads", f"{name}.json"))
    if traffic.get("traffic") != wl["traffic"]:
        raise ValueError(f"workloads/{name}.json is traffic "
                         f"{traffic.get('traffic')!r}, BENCHMARK.json says "
                         f"{wl['traffic']!r}")
    return wl, config, traffic


def metrics_of(spec, name, kind):
    """The ``end_to_end`` or ``per_layer`` metrics that the cell reports."""
    return [m for m in spec[kind] if "workloads" not in m
            or name in m["workloads"]]


def load_reader(name, bench=BENCH):
    """``metrics/<name>.py``'s ``read``, loaded by path (a name may hold a
    dot)."""
    path = os.path.join(bench, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "__"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def power_limit():
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def forbidden_modules():
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def _sht_kernels():
    return sys.modules.get("heracles_tpu_torch.ops.sht_kernels")


def make_context(config, traffic, seed, device, build_dir=BUILD):
    return types.SimpleNamespace(
        config=config, traffic=traffic, seed=seed % 2**64, device=device,
        build_dir=build_dir, no_spans=Spans(None))


def window(cell, seconds, keeper, spans):
    """Steps back to back until ``seconds`` have passed: (step seconds,
    units per step, window seconds)."""
    times, units = [], []
    t0 = time.perf_counter()
    k = 0
    while True:
        ts = time.perf_counter()
        out = cell.step(k, spans)
        te = time.perf_counter()
        times.append(te - ts)
        units.append(cell.units())
        keeper.offer(out)
        del out
        k += 1
        if te - t0 >= seconds:
            return times, units, te - t0


def window_halves(run):
    """The steps' mean and standard deviation, and the units per second
    over the window's first and second halves (split at the step that
    ends past half the window): a spread between runs that the halves of
    one run do not show comes from outside the window's own steps."""
    t = np.asarray(run.step_seconds)
    ends = np.cumsum(t)
    cut = int(np.searchsorted(ends, run.window_s / 2)) + 1
    units = np.asarray(run.units, float)
    first = units[:cut].sum() / ends[cut - 1]
    second = (units[cut:].sum() / (ends[-1] - ends[cut - 1])
              if cut < len(t) else float("nan"))
    return (f"step mean {t.mean() * 1e3:.3f} ms, sd {t.std() * 1e3:.3f} ms; "
            f"units/s first half {first:.4f}, second half {second:.4f}")


def traced(cell, traffic, keeper, device):
    """The per-layer phases: fenced steps (host-clock spans), then steps
    under the profiler.  Returns (spans, summary, traced steps)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import trace

    spans = Spans(device)
    k = 0
    for _ in range(traffic["fenced_steps"]):
        keeper.offer(cell.step(k, spans))
        k += 1
    n = traffic["traced_steps"]
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    fd, path = tempfile.mkstemp(suffix=".trace.json")
    os.close(fd)
    try:
        with trace.StageLabels(), profile(activities=activities) as prof:
            for _ in range(n):
                with record_function(trace.REP_LABEL):
                    keeper.offer(cell.step(k, cell.ctx.no_spans))
                    sync(device)
                k += 1
        prof.export_chrome_trace(path)
        try:
            summary = trace.summarise(trace.load_trace(path))
        except ValueError as exc:  # no device events: a CPU run
            print(f"# trace: {exc}", file=sys.stderr)
            summary = None
    finally:
        os.unlink(path)
    return spans.records, summary, n


def run_cell(spec, name, seed, seconds, trace_on, device, start,
             bench=BENCH, root=ROOT, build_dir=BUILD, err=sys.stderr):
    """One run of the cell ``name``: the result dict, its checks last.
    ``bench`` and ``root``: where the cell's files and the configuration
    files are found."""
    wl, config, traffic = cell_files(spec, name, bench, root)
    entry = importlib.import_module(f"entries.{traffic['entry']}")
    ctx = make_context(config, traffic, seed, device, build_dir)
    cell = entry.Cell(ctx)
    cell.setup()
    sync(device)
    kernels = _sht_kernels()
    if kernels is not None:
        kernels.reset_counts()
    setup_s = time.time() - start
    keeper = Keeper(ctx.seed, traffic["kept_steps"])
    run = types.SimpleNamespace(
        cell=name, config=config, traffic=traffic, setup_s=setup_s,
        step_seconds=[], units=[], window_s=None, spans={}, summary=None,
        traced_steps=0, sht_maps=getattr(cell, "sht_maps", lambda: {})())
    if trace_on:
        run.spans, run.summary, run.traced_steps = traced(cell, traffic,
                                                          keeper, device)
        kinds = "per_layer"
    else:
        run.step_seconds, run.units, run.window_s = window(
            cell, seconds, keeper, ctx.no_spans)
        kinds = "end_to_end"
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    launches = dict(kernels.LAUNCHES_BY_NB) if kernels is not None else {}
    steps = len(run.step_seconds) or keeper.seen
    cell.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    print(f"# {name}: {steps} steps; peak device memory {peak} bytes; SHT "
          f"launches by (kernel, nb) {launches}", flush=True)
    if run.step_seconds:
        print(f"# window: {window_halves(run)}", flush=True)

    metrics = {}
    for m in metrics_of(spec, name, kinds):
        value = load_reader(m["name"], bench)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    detail = {}
    numbers = cell.check(keeper.kept, detail=detail)
    print(f"# worst of each compared number: {detail}", file=err, flush=True)
    limits = traffic["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": wl["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": ok, "attempted": steps,
              "failed": 0 if ok else len(keeper.kept),
              "metrics": metrics, "device": dev_info}
    if trace_on and run.summary is not None:
        s, n = run.summary, run.summary["reps"]
        dev_info["busy_s"] = s["busy_ms"] * n / 1e3
        dev_info["window_s"] = s["window_ms"] * n / 1e3
        result["breakdown"] = {
            "device_ops": [[k, v * n / 1e3]
                           for k, v in list(s["device_ms"].items())[:10]],
            "idle_gaps": [[k, v * n / 1e3] for k, v in list(
                s["idle_ms_by_host_label"].items())[:10]]}
    result["checks"] = checks
    return result


def main(argv=None, start=None):
    start = process_start() if start is None else start
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec()
    wl = next((w for w in spec["workloads"] if w["name"] == args.workload),
              None)
    if wl is None:
        print(f"benchmark: no cell {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"benchmark: the cell needs {wl['chips']} CUDA card(s), torch "
              f"sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = power_limit()
    result = run_cell(spec, args.workload, args.seed, args.seconds,
                      bool(args.trace), device, start)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"# card {card}", flush=True)
    print(json.dumps(result), flush=True)
    return 0
