"""The program's own counters (``heracles_tpu_torch.tracing``), per map.

The runner zeroes every counter of the program after set-up (through
``sht_kernels.reset_counts``), so a ``--trace 1`` run's counters hold its
fenced and traced steps: ``fenced_steps + traced_steps`` steps of the
cell's ``sht_maps`` maps each.  A program without the module (one older
than its counters) gives None, and the metric is left out.
"""

from __future__ import annotations

import sys


def per_map(run, name):
    """The sum over every site of the counter ``name`` of the program's
    tracing module, per map analysed since set-up; None where the program
    has no such counter or the run analysed no map."""
    tracing = sys.modules.get("heracles_tpu_torch.tracing")
    counter = getattr(tracing, name, None)
    steps = run.traffic["fenced_steps"] + run.traced_steps
    maps = sum(run.sht_maps.values()) * steps
    if counter is None or not maps:
        return None
    return sum(counter.values()) / maps
