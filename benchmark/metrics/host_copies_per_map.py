"""host_copies_per_map: the copies between the host and the card, either
way, blocking or not, as the program counts them (``tracing.HOST_COPIES``,
every site), per map of the fenced and traced steps."""

from hbench.counters import per_map


def read(run):
    return per_map(run, "HOST_COPIES")
