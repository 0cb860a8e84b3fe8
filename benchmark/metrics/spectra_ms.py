"""spectra_ms: host ms per step of ``angular_power_spectra``, fenced by
synchronisations on both sides."""

from hbench.readers import span_mean


def read(run):
    s = span_mean(run, "spectra")
    return None if s is None else s * 1e3
