"""Mappers on torch: HEALPix maps and pixel-free alms.

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

:class:`DiscreteMapper` is the counterpart of
:class:`heracles_tpu.mappers.DiscreteMapper`: alms straight from the
points, a_lm += sum_p v_p conj(sYlm(p)), exactly (the analysis kernels with
points in place of rings) or gridded (:mod:`heracles_tpu_torch.ops.nufft`).
"""

from __future__ import annotations

from functools import cached_property

import numpy as np
import torch

from . import tracing
from .devicemap import DeviceMap
from .healpix import ang2pix_ring, nside2npix, nside2pixarea, ud_grade
from .ops import nufft, sht

__all__ = ["DiscreteMapper", "HealpixMapper"]


class HealpixMapper:
    """Mapper for HEALPix maps.

    ``lmax`` defaults to ``3*nside//2`` and ``deconvolve`` (pixel-window
    deconvolution of the alms) to True.  ``iterations`` is the number of
    Jacobi refinement steps of every analysis (healpy's ``iter=``).
    ``dtype`` (torch.float32 or torch.float64) is the map precision; the
    alms are complex of the same precision.  Maps and alms live on
    ``device``, by default the CUDA card.  ``dd`` goes to every
    ``map2alm`` and ``alm2map`` the mapper runs (``transform`` with its
    Jacobi iterations, ``synthesize``): True runs the Wigner recurrence
    of float32 transforms in float64, ``"comp"`` in the kernels'
    compensated float32 instantiation, and both still return complex64
    alms and float32 maps; it is ignored for float64 maps.
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
        self._fl = {}

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
        tracing.copied("mappers.add", "h2d", dev, 3)
        tracing.synced("mappers.add", dev, 3)
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
        """Packed (nlm,) pixel-window deconvolution filter on the device.

        Computed at the first call per (|spin|, dtype) and kept by the
        mapper, as the reference's ``_fl_packed_dev`` keeps it: the mapper
        keeps the window it chose then, and a window file that reaches the
        cache later serves new mappers.
        """
        s = abs(spin)
        fl = self._fl.get((s, dtype))
        if fl is not None:
            return fl
        # spin-2 maps deconvolve with the polarization window
        pw = sht.pixel_window(self._nside, self._lmax, pol=(s == 2),
                              device=self._device)
        if s == 2:
            pw = pw[1]
        fl = np.ones(self._lmax + 1)
        fl[s:] /= pw[s:]
        tracing.built("mappers.deconvolve")
        fl = tracing.upload("mappers.deconvolve", fl, self._device, dtype)
        ls, _ = sht._pack_index(self._lmax, self._lmax, fl.device)
        self._fl[s, dtype] = fl = fl[ls]
        return fl

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
        arr = tracing.upload("mappers.unwrap",
                             np.asarray(data, np.dtype(data.dtype.str)),
                             self._device)
        return arr, md

    @tracing.spanned("mappers.HealpixMapper.transform")
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
            with tracing.span("mappers.deconvolve"):
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
        copied = sht._host_copy_async(alm.array)

        def finish():
            out = copied()
            out.dtype = alm.dtype
            return out

        return finish

    def transform_sharded(self, mesh, data, spin=0, *, metadata=None):
        """Batched analysis over a device mesh (:mod:`..parallel`).

        ``data``: (B, npix) spin-0 or (B, 2, npix) [Q, U] stacked maps (a
        DeviceMap, a tensor or a numpy array); the batch is split over the
        mesh's "batch" axis and each transform's orders over its "m" axis.
        Returns a DeviceMap of packed alms (B[, 2], nlm) on the mesh's
        first device, equal to :meth:`transform` of the same stack.  The
        mapper's Jacobi iterations run sharded too (the reference's
        ``transform_sharded`` leaves them out).
        """
        from .parallel import alm2map_sharded, map2alm_sharded

        arr, md = self._unwrap(data, metadata)
        rect = map2alm_sharded(mesh, arr, self._lmax, spin=spin,
                               weights="ring", dd=self._dd)
        for _ in range(self._iterations):
            resid = arr.to(rect.device) - alm2map_sharded(
                mesh, rect, self._nside, lmax=self._lmax, spin=spin,
                dd=self._dd)
            rect = rect + map2alm_sharded(mesh, resid, self._lmax, spin=spin,
                                          weights="ring", dd=self._dd)
        alm = sht.pack_alm(rect[..., : self._lmax + 1], self._lmax,
                           self._lmax)
        if self._deconv:
            with tracing.span("mappers.deconvolve"):
                alm = alm * self._fl_packed(spin,
                                            alm.real.dtype).to(alm.device)
        return DeviceMap(alm, metadata={**md, "deconv": self._deconv})

    def synthesize_sharded(self, mesh, alm, spin=0):
        """Batched synthesis over a device mesh: the inverse of
        :meth:`transform_sharded`.

        ``alm``: a (B, nlm) or (B, 2, nlm) [E, B] packed stack (a
        DeviceMap, a tensor or a numpy array); bins are split over "batch"
        and each synthesis' orders over "m".  Returns a DeviceMap of
        (B[, 2], npix) maps on the mesh's first device, equal to
        :meth:`synthesize` of the same stack.
        """
        from .parallel import alm2map_sharded

        arr, _ = self._unwrap(alm, None)
        rect = sht.unpack_alm(arr, self._lmax, self._lmax)
        out = alm2map_sharded(mesh, rect, self._nside, lmax=self._lmax,
                              spin=spin, dd=self._dd)
        return DeviceMap(out.to(self._dtype), metadata=self._metadata(spin))

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


class DiscreteMapper:
    """Pixel-free mapper: alms accumulated straight from point positions.

    a_lm += sum_p v_p conj(sYlm(theta_p, phi_p)) by one of two paths,
    chosen by ``method``:

    * ``"exact"``: the analysis kernels with the points in place of rings,
      O(N lmax^2), exact to working precision;
    * ``"gridded"``: ES-kernel spreading onto a torus and the analysis of
      a coarse grid (:mod:`.ops.nufft`), O(N w^2) plus a fixed reduce,
      accurate to ``epsilon``;
    * ``"auto"`` (default): gridded once there are more than 4 (lmax + 1)
      points, exact below; the paged mapping path (``begin``) is gridded.

    ``epsilon`` defaults to 1e-5 for float32 values (complex64 alms in the
    paged path) and 1e-12 otherwise.  ``dtype`` is the alms' type:
    complex64 runs the float32 kernels, complex128 the float64 ones.  Alms
    and the spreading grid live on ``device``, by default the CUDA card.
    The exact path runs blocks of ``point_block`` points, each sorted by
    colatitude (the sum does not depend on the order, and neighbours in a
    warp then share their recurrence's path).  ``nthreads`` is accepted
    and ignored, as the reference does (upstream's ducc mapper hands it to
    ducc's host threads; the kernels here have none to set).
    """

    def __init__(self, lmax, *, dtype=torch.complex128, nthreads=0,
                 point_block=1 << 16, epsilon=None, method="auto",
                 device="cuda"):
        if dtype not in (torch.complex64, torch.complex128):
            raise TypeError(f"alm dtype must be complex64 or complex128, got "
                            f"{dtype}")
        if method not in ("auto", "exact", "gridded"):
            raise ValueError(f"unknown method: {method!r}")
        self._lmax = int(lmax)
        self._dtype = dtype
        self._point_block = int(point_block)
        self._epsilon = epsilon
        self._method = method
        self._device = torch.device(device)

    @property
    def lmax(self):
        return self._lmax

    @property
    def dtype(self):
        return self._dtype

    @property
    def device(self):
        return self._device

    @property
    def area(self):
        return 1.0

    def _metadata(self, spin):
        return dict(geometry="discrete", kernel="none", lmax=self._lmax,
                    spin=spin)

    def _nlm(self):
        return (self._lmax + 1) * (self._lmax + 2) // 2

    def create(self, *dims, spin=0):
        """Zero packed alms (DeviceMap) with the mapper's metadata."""
        return DeviceMap(torch.zeros((*dims, self._nlm()), dtype=self._dtype,
                                     device=self._device),
                         metadata=self._metadata(spin))

    def map_values(self, lon, lat, data, values, spin=0):
        """Add the alms of ``values`` at (lon, lat) [degrees] into ``data``.

        ``data``: packed alms (DeviceMap or tensor), updated in place;
        ``values``: (npoints,) or (rows, npoints), the two components of a
        spin-s field as two rows.
        """
        state = data.array if isinstance(data, DeviceMap) else data
        if not isinstance(state, torch.Tensor):
            raise TypeError("map_values adds in place into a tensor or a "
                            f"DeviceMap, got {type(data).__name__}")
        values = np.asarray(values)
        flatten = values.ndim == 1
        if flatten:
            values = values.reshape(1, -1)
        epsilon = self._epsilon
        if epsilon is None:
            epsilon = 1e-5 if values.dtype == np.float32 else 1e-12
        theta, phi = _angles(lon, lat)
        method = self._method
        if method == "auto":
            method = "gridded" if theta.size > 4 * (self._lmax + 1) else "exact"
        if method == "gridded":
            alm = self._adjoint_gridded(theta, phi, values, spin, epsilon)
        else:
            alm = self._adjoint_synthesis(theta, phi, values, spin)
        state += alm[0] if flatten else alm

    def _adjoint_gridded(self, theta, phi, values, spin, epsilon):
        alm = nufft.adjoint_gridded(
            theta, phi, values, self._lmax, spin=spin, epsilon=epsilon,
            f32=self._dtype == torch.complex64, device=self._device,
        )
        if spin:
            alm = alm.reshape(values.shape[0], -1)
        return alm.to(self._dtype)

    # -- paged accumulation (the mapping pipeline) --------------------------
    #
    # The gridded path's reduce is paid once per catalogue: the padded
    # spreading grid stays on the device across pages and is folded and
    # reduced in finish(); the exact path adds each page's alms.

    def begin(self, *dims, spin=0):
        """Accumulation state of one catalogue (a dict)."""
        epsilon = self._epsilon
        if epsilon is None:
            epsilon = 1e-5 if self._dtype == torch.complex64 else 1e-12
        method = "gridded" if self._method == "auto" else self._method
        state = {"spin": spin, "dims": dims, "epsilon": epsilon,
                 "method": method}
        if method == "exact":
            state["alm"] = self.create(*dims, spin=spin)
        else:
            nrows = 1 if spin else max(1, int(np.prod(dims, dtype=int)))
            state["w"] = nufft.kernel_width(epsilon)
            state["pad"] = nufft.alloc_padded(nrows, self._lmax, state["w"],
                                              bool(spin), self._device)
        return state

    def add(self, state, lon, lat, values):
        """Add one page of points (lon/lat in degrees) to ``state``."""
        if state["method"] == "exact":
            self.map_values(lon, lat, state["alm"], values, spin=state["spin"])
            return state
        values = np.asarray(values)
        if values.ndim == 1:
            values = values.reshape(1, -1)
        theta, phi = _angles(lon, lat)
        if state["spin"]:
            vals = (values[0] + 1j * values[1]).reshape(1, -1)
        else:
            vals = values.astype(np.float64, copy=False)
        nufft.spread_padded(theta, phi, vals, self._lmax, state["w"],
                            state["pad"])
        return state

    def finish(self, state, spin=0):
        """The catalogue's packed alms (DeviceMap).

        The spin is the one ``begin`` recorded, whatever ``spin`` says: a
        spin-2 state holds a complex grid.
        """
        spin = state["spin"]
        if state["method"] == "exact":
            return state["alm"]
        grid = nufft.fold_padded(state.pop("pad"), self._lmax, state["w"])
        alm = nufft.adjoint_gridded(
            None, None, None, self._lmax, spin=spin, epsilon=state["epsilon"],
            f32=self._dtype == torch.complex64, grid=grid,
        )
        if spin:
            alm = alm.reshape(2, -1)
        out = alm.to(self._dtype).reshape(tuple(state["dims"]) + alm.shape[-1:])
        return DeviceMap(out.contiguous(), metadata=self._metadata(spin))

    def _adjoint_synthesis(self, theta, phi, values, spin, device=None):
        """The exact point adjoint, block by block: (rows, nlm) alms on
        ``device`` (default the mapper's)."""
        lmax = self._lmax
        dev = self._device if device is None else device
        real = torch.float64 if self._dtype == torch.complex128 else torch.float32
        out = torch.zeros((values.shape[0], self._nlm()), dtype=self._dtype,
                          device=dev)
        B = self._point_block
        for start in range(0, theta.size, B):
            th = theta[start : start + B]
            ph = phi[start : start + B]
            v = values[:, start : start + B]
            npts = th.size
            if npts < B and theta.size > B:
                # a ragged tail is padded with zero-valued points at the
                # equator, which add nothing
                pad = B - npts
                th = np.pad(th, (0, pad), constant_values=np.pi / 2)
                ph = np.pad(ph, (0, pad))
                v = np.pad(v, ((0, 0), (0, pad)))
            order = np.argsort(th, kind="stable")
            site = "mappers.adjoint_synthesis"
            geom = [tracing.upload(site, a, dev)
                    for a in sht._point_geometry(th[order])]
            ph = tracing.upload(site, ph[order], dev)
            v = v[:, order]
            if spin == 0:
                vt = tracing.upload(site, v, dev).to(real)
                out += _adjoint_spin0(*geom, ph, vt, lmax)
            else:
                u = torch.complex(tracing.upload(site, v[0], dev),
                                  tracing.upload(site, v[1], dev))
                eb = _adjoint_spin(*geom, ph, u[None].to(self._dtype), lmax,
                                   spin)
                out += eb.reshape(out.shape)
        return out

    def adjoint_synthesis_sharded(self, mesh, theta, phi, values, spin=0):
        """The exact point adjoint with the points split over a device mesh.

        ``theta``, ``phi``: (npts,) radians; ``values``: (npts,) or (rows,
        npts), the two components of a spin-s field as two rows.  The
        point axis is cut into one equal block per shard (padded with
        zero-valued points at theta = pi/2, which add nothing); each shard
        runs the block path of the exact adjoint (the analysis kernels with
        the points in place of rings) on its device, and the partial alms
        are summed.  Returns packed alms (rows, nlm) on the mesh's first
        device, as the exact path of :meth:`map_values` computes them.
        """
        from .parallel import _psum

        devices = list(mesh.devices.flat)
        theta = np.asarray(theta, np.float64)
        phi = np.asarray(phi, np.float64)
        values = np.atleast_2d(np.asarray(values))
        per = -(-theta.size // len(devices))
        pad = per * len(devices) - theta.size
        theta = np.pad(theta, (0, pad), constant_values=np.pi / 2)
        phi = np.pad(phi, (0, pad))
        values = np.pad(values, ((0, 0), (0, pad)))
        parts = [self._adjoint_synthesis(theta[i * per:(i + 1) * per],
                                         phi[i * per:(i + 1) * per],
                                         values[:, i * per:(i + 1) * per],
                                         spin, device=d)
                 for i, d in enumerate(devices)]
        return _psum(parts, devices, dest=devices[0])

    def transform(self, data, spin=0):
        """Identity: the data already are alms."""
        return data

    def resample(self, data):
        """Packed alms re-truncated (or zero-padded) to this mapper's lmax.

        ``data``: a DeviceMap, tensor or numpy array of packed alms (...,
        nlm).  Returns a DeviceMap of the mapper's dtype on its device, with
        the input's metadata and the new ``lmax``.
        """
        if isinstance(data, DeviceMap):
            arr, md = data.array, data.metadata
        else:
            md = dict(getattr(data.dtype, "metadata", None) or {})
            arr = torch.as_tensor(np.asarray(data) if isinstance(data, np.ndarray)
                                  else data)
        *dims, n = arr.shape
        lmax_in = (int((8 * n + 1) ** 0.5 + 0.01) - 3) // 2
        lmax_out = self._lmax
        lmax = min(lmax_in, lmax_out)
        out = torch.zeros((*dims, self._nlm()), dtype=self._dtype,
                          device=self._device)
        i = j = 0
        for m in range(lmax + 1):
            out[..., j : j + lmax - m + 1] = arr[..., i : i + lmax - m + 1]
            i += lmax_in - m + 1
            j += lmax_out - m + 1
        if md:
            md["lmax"] = lmax_out
        return DeviceMap(out, metadata=md)


def _angles(lon, lat):
    """(theta, phi) in radians, host float64, of lon/lat in degrees."""
    theta = np.radians(90.0 - np.asarray(lat, dtype=np.float64))
    phi = np.radians(np.asarray(lon, dtype=np.float64) % 360.0)
    return theta, phi


def _phases(phi, lmax, real):
    """e^{-im phi} (npts, lmax+1), the phase taken in float64 and rounded
    to ``real`` (float32 or float64)."""
    ang = torch.outer(phi.to(torch.float64),
                      torch.arange(lmax + 1, dtype=torch.float64,
                                   device=phi.device))
    return torch.complex(torch.cos(ang).to(real), -torch.sin(ang).to(real))


def _adjoint_spin0(x, logch, logsh, phi, values, lmax):
    """a_lm = sum_p v_p conj(Ylm(p)) of real point values: (rows, nlm).

    ``x``, ``logch``, ``logsh``: (npts,) float64 point geometry
    (:func:`.ops.sht._point_geometry`); ``phi``: (npts,); ``values``:
    (rows, npts) float32 or float64, which sets the kernels' precision.
    """
    # F[p, m] = v_p e^{-im phi_p}: the "ring FFT" of a single point
    F = values[..., :, None] * _phases(phi, lmax, values.dtype)
    return sht._analysis_points((F,), x, logch, logsh, lmax, (0,))


def _adjoint_spin(x, logch, logsh, phi, u, lmax, spin):
    """(E, B) alms of complex spin-s point values u = v1 + i v2.

    ``u``: (rows, npts) complex64 or complex128; returns (rows, 2, nlm).
    """
    phase = _phases(phi, lmax, u.real.dtype)
    F = u[..., :, None] * phase
    Fc = u.conj()[..., :, None] * phase
    return sht._analysis_points((F, Fc), x, logch, logsh, lmax, (spin, -spin))

