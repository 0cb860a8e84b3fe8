"""Carry data between heracles_tpu and the port.

The system has no learned weights: its state is the data handed between
stages (maps, alms, spectra) plus host tables, so conversion is of
:class:`~heracles_tpu_torch.core.TocDict` values.  :func:`to_torch` turns
numpy values with ``heracles_tpu`` dtype metadata (or anything with
``__array__`` and such a ``dtype``, such as a ``heracles_tpu`` device
map) into the port's :class:`DeviceMap` on a device, so that any stage
of the port can take the JAX package's output; :func:`to_numpy` goes
back to metadata-tagged numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from . import tracing
from .core import TocDict
from .devicemap import DeviceMap

__all__ = ["to_torch", "to_numpy"]


def to_torch(tocdict, device="cuda"):
    """TocDict of metadata-tagged arrays -> TocDict of DeviceMaps on ``device``.

    ``device`` defaults to the CUDA card.
    """
    out = TocDict()
    for key, value in tocdict.items():
        if isinstance(value, DeviceMap):
            out[key] = DeviceMap(value.array.to(device), dtype=value.dtype)
            continue
        md = dict(getattr(getattr(value, "dtype", None), "metadata", None) or {})
        arr = np.asarray(value)
        arr = np.ascontiguousarray(arr, dtype=np.dtype(arr.dtype.str))
        out[key] = DeviceMap(tracing.upload("convert.to_torch", arr, device),
                             metadata=md)
    return out


def to_numpy(tocdict):
    """TocDict of DeviceMaps (or tensors) -> metadata-tagged numpy arrays."""
    out = TocDict()
    for key, value in tocdict.items():
        if isinstance(value, torch.Tensor):
            value = DeviceMap(value)
        out[key] = np.asarray(value)
    return out
