"""The device's idle share over the traced steps, in percent:
100 (1 - busy / window), busy the union of the device's events."""

from hbench.readers import idle_pct


def read(run):
    return idle_pct(run)
