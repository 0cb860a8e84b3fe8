"""host_syncs_per_map: the times the host waited for the card, as the
program counts them (``tracing.HOST_SYNCS``, every site: copies to the
host, blocking copies to the card, torch ops that read a device value on
the host, synchronisations), per map of the fenced and traced steps."""

from hbench.counters import per_map


def read(run):
    return per_map(run, "HOST_SYNCS")
