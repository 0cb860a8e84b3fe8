"""FMA-peak probe: the vector FP32 / FP64 rate the card sustains.

Counterpart of ``tools/vpu_peak.py``.  The rate of a kernel that is bound
by vector arithmetic (the Wigner analysis kernels in float32, the Gram
kernel in float64) is read against what the card sustains on chains of
dependent operations, not against a data sheet.  Two probes, each with
``nchain`` independent chains per element of a (rows, 128) block:

* ``fma`` — ``acc = acc * b + a``: one dependent FMA per step, counted
  as 2 operations;
* ``rec3`` — ``new = 1.0001 (x curr) - 0.9999 prev``: the Wigner
  recurrence step's shape (mul, mul, FMA), counted as 3 operations.

:func:`chains` runs a probe: a CPU tensor takes :func:`chains_plain` (the
same chains as torch elementwise ops), a CUDA tensor launches the
hand-written kernel (``heracles_tpu_torch/csrc/fma_peak.cu``) or raises.
:func:`run` times the kernel on the card with CUDA events.  ``LAUNCHES``
and ``PLAIN_RUNS`` count kernel launches and plain runs under the name
``"fma_peak"``.

    python -m heracles_tpu_torch.ops.fma_peak [--rows N] [--steps 8192] [--nchain 4]
"""

from __future__ import annotations

import argparse
import functools
import math
import operator

import torch

from .. import tracing

__all__ = ["chains", "chains_plain", "default_rows", "run", "LAUNCHES",
           "PLAIN_RUNS", "reset_counts"]

UNROLL = 64
KINDS = {"fma": 0, "rec3": 1}
OPS_PER_STEP = {"fma": 2, "rec3": 3}
NCHAINS = (1, 2, 4, 8)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

LAUNCHES = tracing.counter("fma_peak.LAUNCHES")
PLAIN_RUNS = tracing.counter("fma_peak.PLAIN_RUNS")


def reset_counts():
    """Zero every counter of :mod:`..tracing`, this module's among them."""
    tracing.reset()


def executed_steps(steps):
    """The steps the probe runs: whole loop iterations of ``UNROLL``."""
    steps = (int(steps) // UNROLL) * UNROLL
    if steps == 0:
        raise ValueError(f"steps must be >= {UNROLL}")
    return steps


def inputs(rows, dtype, device):
    """The probe's operands: a = 1 + 2^-20 and b = 1 - 2^-20, (rows, 128)."""
    a = torch.full((rows, 128), 1.0 + 2.0**-20, dtype=dtype, device=device)
    b = torch.full((rows, 128), 1.0 - 2.0**-20, dtype=dtype, device=device)
    return a, b


def _check(a, b, kind, nchain):
    if kind not in KINDS:
        raise ValueError(f"unknown probe {kind!r}; expected one of {list(KINDS)}")
    if nchain not in NCHAINS:
        raise ValueError(f"nchain must be one of {NCHAINS}, got {nchain}")
    if a.dtype not in _SUFFIX or b.dtype != a.dtype:
        raise TypeError(f"expected float32 or float64 operands of one dtype, "
                        f"got {a.dtype} and {b.dtype}")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError("operands differ in shape or device")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")


def chains_plain(a, b, kind, steps, nchain):
    """Plain version of :func:`chains` (same signature)."""
    PLAIN_RUNS["fma_peak"] += 1
    steps = executed_steps(steps)
    if kind == "fma":
        accs = [a * (0.5 + 0.125 * c) for c in range(nchain)]
        for _ in range(steps):
            accs = [acc * b + a for acc in accs]
        return functools.reduce(operator.add, accs)
    prevs = [a * (0.25 * (c + 1)) for c in range(nchain)]
    currs = [a * (0.125 * (c + 1)) for c in range(nchain)]
    for _ in range(steps):
        prevs, currs = currs, [1.0001 * (b * cur) - 0.9999 * prev
                               for cur, prev in zip(currs, prevs)]
    return functools.reduce(operator.add, currs)


def _launch(a, b, kind, steps, nchain):
    from . import _build

    kl = _build.load_library()
    a = a.contiguous()
    b = b.contiguous()
    out = torch.empty_like(a)
    fn = getattr(kl.lib, f"heracles_fma_peak_{_SUFFIX[a.dtype]}")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
                 KINDS[kind], nchain, steps // UNROLL, stream)
    kl.check(err)
    LAUNCHES["fma_peak"] += 1
    return out


def chains(a, b, kind, steps, nchain):
    """Run ``nchain`` chains of probe ``kind`` for ``steps`` steps.

    ``a``, ``b``: float32 or float64 tensors of one shape (b is the
    recurrence's x for ``rec3``).  The probe runs ``executed_steps(steps)``
    steps and returns the sum of its chains, shaped like ``a``.
    """
    _check(a, b, kind, nchain)
    steps = executed_steps(steps)
    if a.device.type == "cpu":
        return chains_plain(a, b, kind, steps, nchain)
    return _launch(a, b, kind, steps, nchain)


def default_rows(device):
    """Rows that fill the card: SMs x resident threads per SM / 128.

    One thread per element, so every SM holds its full complement of
    threads (2112 rows on an H100 SXM: 132 SMs x 2048 threads / 128).
    """
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count * props.max_threads_per_multi_processor // 128


def run(kind, rows, steps, nchain, *, dtype, device, reps=3):
    """Best of ``reps`` timed kernel runs; returns (seconds, operations).

    ``rows=None`` takes :func:`default_rows`.  Operations are counted as
    ``tools/vpu_peak.py`` counts them: rows x 128 x executed steps x
    nchain x (2 for fma, 3 for rec3).  Times are CUDA events around one
    launch, after one warm-up launch.  Needs a CUDA device: the probe
    measures the card, and a CPU has no rate to report here.
    """
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"run times the card; got device {device}")
    rows = default_rows(device) if rows is None else int(rows)
    steps = executed_steps(steps)
    a, b = inputs(rows, dtype, device)
    chains(a, b, kind, steps, nchain)  # warm-up
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = chains(a, b, kind, steps, nchain)
        stop.record()
        tracing.synced("fma_peak.run", device)
        stop.synchronize()
        best = min(best, start.elapsed_time(stop) / 1e3)
    tracing.synced("fma_peak.run", device)
    tracing.copied("fma_peak.run", "d2h", device)
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"{kind} probe produced non-finite values")
    n_ops = rows * 128 * steps * nchain * OPS_PER_STEP[kind]
    return best, n_ops


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=None,
                    help="rows of 128 elements (default: fill the card)")
    ap.add_argument("--steps", type=int, default=8192)
    ap.add_argument("--nchain", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fma_peak: torch sees no CUDA device; the probe "
                         "measures the card")
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.float64):
        for kind in KINDS:
            dt, n_ops = run(kind, args.rows, args.steps, args.nchain,
                            dtype=dtype, device=dev)
            print(f"{kind}/{_SUFFIX[dtype]}: {dt * 1e3:.2f} ms for "
                  f"{n_ops / 1e9:.2f} Gop -> {n_ops / dt / 1e12:.3f} Top/s "
                  f"({torch.cuda.get_device_name(dev)})")


if __name__ == "__main__":
    main()
