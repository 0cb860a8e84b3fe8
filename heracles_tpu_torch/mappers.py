"""HEALPix mapper on torch: device scatter map-making and the SHT.

Counterpart of :class:`heracles_tpu.mappers.HealpixMapper`: catalogue
points are scatter-added into a map on the mapper's device
(``index_add_``), ``transform`` runs the spin-0/2 ``map2alm`` of
:mod:`heracles_tpu_torch.ops.sht` with quadrature ring weights, optional
Jacobi iterations and optional pixel-window deconvolution, and
``synthesize`` runs ``alm2map``, ``resample`` changes a map's resolution
(``ud_grade``) on its device.  ``transform_resident`` and
``transform_async`` are the two variants of ``transform`` that the DICES
jackknife uses: alms kept on the device, and alms copied to the host on a
side stream while the next analysis runs.  The map dtype and the device (the CUDA
card unless the caller names another) are constructor arguments.
"""

from __future__ import annotations

from functools import cache, cached_property

import numpy as np
import torch

from .devicemap import DeviceMap
from .healpix import ang2pix_ring, nside2npix, nside2pixarea, ud_grade
from .ops import sht

__all__ = ["HealpixMapper"]


class HealpixMapper:
    """Mapper for HEALPix maps.

    ``lmax`` defaults to ``3*nside//2`` and ``deconvolve`` (pixel-window
    deconvolution of the alms) to True.  ``iterations`` is the number of
    Jacobi refinement steps of every analysis (healpy's ``iter=``).
    ``dtype`` (torch.float32 or torch.float64) is the map precision; the
    alms are complex of the same precision.  Maps and alms live on
    ``device``, by default the CUDA card.  ``dd`` goes to every
    ``map2alm`` and ``alm2map`` the mapper runs (``transform`` with its
    Jacobi iterations, ``synthesize``): True or ``"comp"`` run the Wigner
    recurrence of float32 transforms in float64 and still return
    complex64 alms and float32 maps; it is ignored for float64 maps.
    ``device_maps`` is the reference's switch between host maps and
    device-resident ones: this mapper always returns a :class:`DeviceMap`
    (the reference's ``device_maps=True``), so True and None are accepted
    and False raises a ValueError.
    """

    # transform() accepts leading batch axes
    batched_transform = True

    def __init__(self, nside, lmax=None, *, deconvolve=None, iterations=0,
                 dtype=torch.float64, device="cuda", dd=None,
                 device_maps=None):
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"map dtype must be float32 or float64, got {dtype}")
        if device_maps is not None and not device_maps:
            raise ValueError(
                "device_maps=False (maps as host numpy arrays) is not "
                "supported: this mapper always returns a DeviceMap; copy one "
                "to the host with np.asarray"
            )
        self._nside = int(nside)
        self._lmax = sht.resolve_lmax(nside, lmax)
        self._deconv = True if deconvolve is None else bool(deconvolve)
        self._iterations = int(iterations)
        self._dtype = dtype
        self._device = torch.device(device)
        self._dd = dd

    @property
    def nside(self):
        return self._nside

    @property
    def lmax(self):
        return self._lmax

    @property
    def deconvolve(self):
        return self._deconv

    @property
    def iterations(self):
        return self._iterations

    @property
    def dtype(self):
        return self._dtype

    @property
    def device(self):
        return self._device

    @property
    def dd(self):
        return self._dd

    @cached_property
    def area(self):
        return nside2pixarea(self._nside)

    def _metadata(self, spin):
        return dict(
            geometry="healpix",
            kernel="healpix",
            nside=self._nside,
            lmax=self._lmax,
            deconv=self._deconv,
            spin=spin,
        )

    def create(self, *dims, spin=0):
        """A zero map (DeviceMap) with the mapper's metadata."""
        return DeviceMap(self.begin(*dims, spin=spin),
                         metadata=self._metadata(spin))

    # -- device accumulation interface ------------------------------------

    def begin(self, *dims, spin=0):
        """Zero accumulator on the mapper's device."""
        return torch.zeros((*dims, nside2npix(self._nside)), dtype=self._dtype,
                           device=self._device)

    def add(self, state, lon, lat, values):
        """Scatter-add one page of points (lon/lat in degrees) into ``state``.

        ``state``: (..., npix) tensor; ``values``: (..., npoints), one row
        per leading index.  Runs on the state's device and in its dtype.
        """
        dev = state.device
        # torch.tensor copies: catalogue pages are read-only numpy arrays
        ipix = ang2pix_ring(
            self._nside,
            torch.tensor(lon, dtype=torch.float64, device=dev),
            torch.tensor(lat, dtype=torch.float64, device=dev),
            lonlat=True,
        )
        values = torch.tensor(values, dtype=state.dtype, device=dev)
        # in place: the accumulator belongs to the mapping loop that
        # created it with begin()
        state.index_add_(-1, ipix, values)
        return state

    def map_values(self, lon, lat, data, values, spin=0):
        """Add ``values`` at (lon, lat) [degrees] into ``data`` in place.

        The ``Mapper`` protocol's scatter: ``data`` is a (..., npix) tensor
        or :class:`DeviceMap`, ``values`` (..., npoints) with one row per
        leading index of ``data``.  The same scatter as :meth:`add`, on the
        device of ``data``.
        """
        state = data.array if isinstance(data, DeviceMap) else data
        if not isinstance(state, torch.Tensor):
            raise TypeError("map_values adds in place into a tensor or a "
                            f"DeviceMap, got {type(data).__name__}")
        self.add(state, lon, lat, values)

    def finish(self, state, spin=0):
        return DeviceMap(state, metadata=self._metadata(spin))

    # -- harmonic transform ------------------------------------------------

    def _fl_packed(self, spin, dtype):
        """Packed (nlm,) pixel-window deconvolution filter on the device."""
        s = abs(spin)
        # spin-2 maps deconvolve with the polarization window
        pw = sht.pixel_window(self._nside, self._lmax, pol=(s == 2))
        if s == 2:
            pw = pw[1]
        fl = np.ones(self._lmax + 1)
        fl[s:] /= pw[s:]
        ls, _ = sht._pack_index(self._lmax, self._lmax, self._device)
        return torch.as_tensor(fl, dtype=dtype, device=self._device)[ls]

    def _unwrap(self, data, metadata):
        """(tensor, metadata) of a DeviceMap, a tensor or a numpy array.

        Numpy input is moved to the mapper's device; a tensor stays where
        it is and takes its metadata from ``metadata``.
        """
        if isinstance(data, DeviceMap):
            return data.array, {**data.metadata, **(metadata or {})}
        if isinstance(data, torch.Tensor):
            return data, dict(metadata or {})
        md = dict(getattr(data.dtype, "metadata", None) or {})
        md.update(metadata or {})
        arr = torch.as_tensor(np.asarray(data, np.dtype(data.dtype.str)),
                              device=self._device)
        return arr, md

    def transform(self, data, spin=0, *, metadata=None):
        """Spin-0/2 spherical harmonic analysis with quadrature weights.

        Spin-0 input may carry leading batch axes; spin-2 input is
        (..., 2, npix) [Q, U] and returns (..., 2, nlm) (E, B).  ``data``
        is a DeviceMap, a tensor (metadata from ``metadata``) or a numpy
        map (moved to the mapper's device).  The mapper's Jacobi
        iterations run before the pixel-window deconvolution.  Returns a
        DeviceMap of packed alms.
        """
        arr, md = self._unwrap(data, metadata)
        alm = sht.map2alm(arr, lmax=self._lmax, spin=spin, weights="ring",
                          iterations=self._iterations, dd=self._dd)
        if self._deconv:
            alm = alm * self._fl_packed(spin, alm.real.dtype)
        return DeviceMap(alm, metadata={**md, "deconv": self._deconv})

    def transform_resident(self, data, spin=0, *, metadata=None):
        """Analysis with device-resident output: a DeviceMap of packed alms
        on the data's device (the mapper's for numpy input).

        :meth:`transform` always returns such a DeviceMap; this is that
        call under the name the DICES device cache uses.
        """
        return self.transform(data, spin, metadata=metadata)

    def transform_async(self, data, spin=0, *, metadata=None):
        """Dispatch the analysis and start the copy of its alms to the host.

        Returns a zero-argument callable that gives the same alms as
        :meth:`transform`, as a host numpy array with the metadata on its
        dtype.  On a card the analysis is queued on the current stream and
        the alms are copied on a side stream, into pinned host memory,
        after an event of the current stream; the caller may dispatch more
        work before it calls the handle, which waits for the copy alone.
        The source tensor is recorded on the side stream, so the caching
        allocator does not hand its memory out before the copy is done.
        """
        alm = self.transform(data, spin, metadata=metadata)
        arr = alm.array
        if arr.device.type != "cuda":
            return lambda: np.asarray(alm)
        computed = torch.cuda.Event()
        computed.record(torch.cuda.current_stream(arr.device))
        side = _copy_stream(arr.device)
        side.wait_event(computed)
        host = torch.empty(arr.shape, dtype=arr.dtype, pin_memory=True)
        with torch.cuda.stream(side):
            host.copy_(arr, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(side)
        arr.record_stream(side)
        dtype = alm.dtype

        def finish():
            copied.synchronize()
            out = host.numpy()
            out.dtype = dtype
            return out

        return finish

    def synthesize(self, alm, spin=0):
        """Inverse transform: packed alms -> a DeviceMap of maps.

        ``alm``: a DeviceMap, a tensor or a numpy array of packed alms
        (..., nlm) for spin 0 or (..., 2, nlm) (E, B) for spin 2; numpy
        input is moved to the mapper's device.  Like the reference, no
        pixel window is applied.  The map has the mapper's dtype and
        metadata.
        """
        arr, _ = self._unwrap(alm, None)
        out = sht.alm2map(arr, self._nside, lmax=self._lmax, spin=spin,
                          dd=self._dd)
        return DeviceMap(out.to(self._dtype), metadata=self._metadata(spin))

    def resample(self, data):
        """``data`` at the mapper's resolution: a DeviceMap of the mapper's
        dtype, degraded by the mean of the child pixels or upgraded by
        repeating the parent's value, with the input's metadata and the new
        ``nside``.  ``data`` is a DeviceMap, a tensor or a numpy map (moved
        to the mapper's device)."""
        arr, md = self._unwrap(data, None)
        out = ud_grade(arr, self._nside, dtype=self._dtype)
        if out is arr:  # same resolution and dtype: the result owns its data
            out = arr.clone()
        return DeviceMap(out, metadata={**md, "nside": self._nside})


@cache
def _copy_stream(device):
    """The side stream of a card on which alms are copied to the host."""
    return torch.cuda.Stream(device)
