"""maps_per_s: maps taken to spectra per second, every map of every step
over the whole window (a spin-2 map counts as one)."""


def read(run):
    if not run.step_seconds:
        return None
    return sum(run.units) / run.window_s
