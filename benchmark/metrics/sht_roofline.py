"""sht_roofline: the least time of a step's Wigner SHT work
(:mod:`hbench.sht_counts`: the recurrence once per spin kind, the
products once per map, the bytes once) over the device time of the work
under the ``sht_kernels.*_folded`` stage labels, in percent."""

from hbench.readers import device_ms
from hbench.sht_counts import least_seconds


def read(run):
    ms = device_ms(run, ("sht_kernels.analysis_*", "sht_kernels.synthesis_*"))
    if ms is None or not run.sht_maps:
        return None
    cfg = run.config
    least, _ = least_seconds(cfg["nside"], cfg["lmax"],
                             cfg.get("mmax", cfg["lmax"]), run.sht_maps)
    return 100.0 * least / (ms / 1e3)
