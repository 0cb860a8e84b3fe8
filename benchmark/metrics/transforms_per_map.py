"""transforms_per_map: the calls of the mapper's ``transform`` that
``mapping.transform`` made, as the program counts them
(``tracing.TRANSFORM_STACKS``, every stack size), per map of the fenced
and traced steps: 1 where every map transforms alone, 0.2 for 10 maps a
step in stacks of 8 and 2."""

from hbench.counters import per_map


def read(run):
    return per_map(run, "TRANSFORM_STACKS")
