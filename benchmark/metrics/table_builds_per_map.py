"""table_builds_per_map: the arrays that depend only on the transform's
sizes, spins, dtype and device and were computed, read from a file or
uploaded inside a step, as the program counts them
(``tracing.TABLE_BUILDS``, every table), per map of the fenced and traced
steps."""

from hbench.counters import per_map


def read(run):
    return per_map(run, "TABLE_BUILDS")
