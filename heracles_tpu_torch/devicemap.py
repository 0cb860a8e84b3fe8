"""Device-resident maps and alms with numpy-style dtype metadata.

Counterpart of :mod:`heracles_tpu.devicemap` over a torch tensor.  The
pipeline's scientific metadata rides on numpy dtypes
(:func:`heracles_tpu_torch.core.update_metadata`); a tensor has no such
dtype, so :class:`DeviceMap` pairs the tensor with a numpy dtype of the
same kind and size that carries the metadata:

* ``dtype`` is a real ``np.dtype`` and is settable, so
  ``update_metadata`` works on it unchanged;
* in-place arithmetic (``/= nbar``, ``-= visibility``) updates the
  tensor in place on its device;
* ``np.asarray(m)`` copies the data to the host with the metadata.
"""

from __future__ import annotations

import numpy as np
import torch

from . import tracing

__all__ = ["DeviceMap"]

_NUMPY = {
    torch.float32: np.float32,
    torch.float64: np.float64,
    torch.complex64: np.complex64,
    torch.complex128: np.complex128,
}


def _numpy_dtype(dtype):
    """The numpy dtype of a torch floating or complex dtype."""
    try:
        return np.dtype(_NUMPY[dtype])
    except KeyError:
        raise TypeError(f"no numpy counterpart for {dtype}") from None


class DeviceMap:
    """A tensor (on any device) + numpy dtype metadata."""

    __slots__ = ("_array", "_dtype")

    def __init__(self, array, metadata=None, dtype=None):
        self._array = array
        if dtype is not None:
            self._dtype = np.dtype(dtype)
        else:
            base = _numpy_dtype(array.dtype)
            # numpy takes no metadata=None: a plain dtype has none
            self._dtype = (np.dtype(base.str, metadata=dict(metadata))
                           if metadata else np.dtype(base.str))

    @property
    def array(self):
        """The underlying tensor."""
        return self._array

    @property
    def device(self):
        return self._array.device

    @property
    def dtype(self):
        return self._dtype

    @dtype.setter
    def dtype(self, dt):
        dt = np.dtype(dt)
        if dt.itemsize != self._dtype.itemsize or dt.kind != self._dtype.kind:
            raise ValueError(
                f"cannot set dtype {dt!r} on a {self._dtype!r} DeviceMap"
            )
        self._dtype = dt

    @property
    def metadata(self):
        return dict(self._dtype.metadata or {})

    @property
    def shape(self):
        return tuple(self._array.shape)

    @property
    def ndim(self):
        return self._array.ndim

    @property
    def size(self):
        return self._array.numel()

    def __len__(self):
        return self._array.shape[0]

    def __array__(self, dtype=None, copy=None):
        out = tracing.to_host("devicemap.to_host", self._array)
        if dtype is not None:
            return out.astype(dtype)
        out = np.array(out)
        out.dtype = self._dtype
        return out

    def block_until_ready(self):
        """Wait for the work queued on the tensor's card; returns self."""
        if self._array.device.type == "cuda":
            tracing.synced("devicemap.block_until_ready", self._array)
            torch.cuda.synchronize(self._array.device)
        return self

    def __repr__(self):
        return (
            f"DeviceMap(shape={self.shape}, dtype={self._dtype.str}, "
            f"device={self.device}, metadata={self.metadata})"
        )

    def _coerce(self, other):
        if isinstance(other, DeviceMap):
            return other._array
        if isinstance(other, np.ndarray):
            return tracing.upload("devicemap.coerce",
                                  np.asarray(other, self._dtype.str),
                                  self._array.device)
        return other

    # in place on the tensor: the pipeline's fields normalise their
    # freshly accumulated maps this way (heracles_tpu mutates its numpy
    # maps in place at the same points)
    def __itruediv__(self, other):
        self._array.div_(self._coerce(other))
        return self

    def __imul__(self, other):
        self._array.mul_(self._coerce(other))
        return self

    def __isub__(self, other):
        self._array.sub_(self._coerce(other))
        return self

    def __iadd__(self, other):
        self._array.add_(self._coerce(other))
        return self

    def __setitem__(self, idx, value):
        # in place, as numpy's item assignment
        self._array[idx] = self._coerce(value)

    def _new(self, array):
        return DeviceMap(array, dtype=self._dtype)

    def __truediv__(self, other):
        return self._new(self._array / self._coerce(other))

    def __mul__(self, other):
        return self._new(self._array * self._coerce(other))

    __rmul__ = __mul__

    def __sub__(self, other):
        return self._new(self._array - self._coerce(other))

    def __add__(self, other):
        return self._new(self._array + self._coerce(other))

    __radd__ = __add__

    def __getitem__(self, idx):
        return self._new(self._array[idx])

    def __copy__(self):
        return DeviceMap(self._array, dtype=self._dtype)

    def __deepcopy__(self, memo):
        # in-place arithmetic mutates the tensor, so a deep copy owns one
        return DeviceMap(self._array.clone(), dtype=self._dtype)
