"""Shared arithmetic of the metric readers in ``metrics/``.

A reader gets the run (:func:`hbench.runner.run_cell`'s record: step
seconds and units of the window, set-up seconds, the fenced spans, the
trace summary over the traced steps) and returns a number, or None where
the run has nothing to read.
"""

from __future__ import annotations


def span_mean(run, name):
    """Mean seconds of the span ``name`` over the fenced steps."""
    values = run.spans.get(name)
    return sum(values) / len(values) if values else None


def device_ms(run, labels):
    """Device ms per traced step of the work under the stage labels whose
    name is in ``labels`` (or, for a label ending in ``*``, starts with
    it); None where none of them ran."""
    if run.summary is None:
        return None
    total, hit = 0.0, False
    for label, ms in run.summary["device_ms_by_label"].items():
        if any(label == p or (p.endswith("*") and label.startswith(p[:-1]))
               for p in labels):
            total += ms
            hit = True
    return total if hit else None


def idle_pct(run):
    """100 (1 - busy / window) over the traced steps."""
    if run.summary is None or not run.summary["window_ms"]:
        return None
    return 100.0 * (1.0 - run.summary["busy_ms"] / run.summary["window_ms"])
