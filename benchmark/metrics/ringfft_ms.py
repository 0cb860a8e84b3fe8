"""ringfft_ms: device ms per map of the work under the ring-FFT stage
labels (``ringfft.ring_analysis``, ``ringfft.ring_synthesis``)."""

from hbench.readers import device_ms


def read(run):
    ms = device_ms(run, ("ringfft.ring_analysis", "ringfft.ring_synthesis"))
    maps = sum(run.sht_maps.values())
    return ms / maps if ms is not None and maps else None
