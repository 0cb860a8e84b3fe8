"""FITS persistence of maps, alms and results.

Counterpart of :mod:`heracles_tpu.io`, in the same file format on top of
the port's copy of the FITS layer (:mod:`heracles_tpu_torch.fits`), so
that files written by either package read the same in the other:

* tuple keys <-> EXTNAME strings with escaping;
* array metadata as ``META <KEY>`` header cards with standard comments;
* HEALPix map tables with the standard HEALPix headers;
* complex alms as real/imag columns;
* Result tables with ARRAY/ELL/LOWER/UPPER/WEIGHT columns and
  ELLAXIS/SPIN headers including multi-ell-axis transpose/pad logic;
* ``read_vmap`` with UNSEEN handling, the port's RING ``ud_grade`` and an
  optional harmonic transform on a device;
* bulk read/write with include/exclude, and lazy FITS-backed mappings
  :class:`FitsDict` / :class:`MapFits` / :class:`AlmFits` /
  :class:`ClsFits` / :class:`MmsFits`.

Writers take numpy arrays, :class:`~heracles_tpu_torch.devicemap.DeviceMap`
values and tensors on any device (copied to the host with their
metadata); readers return host numpy arrays with dtype metadata, as
:mod:`heracles_tpu.io` does.
"""

from __future__ import annotations

import logging
import os
import re
from ast import literal_eval
from collections.abc import MutableMapping, Sequence
from pathlib import Path
from warnings import warn
from weakref import WeakValueDictionary

import numpy as np
import torch

from . import tracing
from .core import toc_match
from .devicemap import DeviceMap
from .fits import FitsFile, Header
from .healpix import npix2nside, ring2nest, ud_grade
from .result import Result, get_result_array, normalize_result_axis

logger = logging.getLogger(__name__)

__all__ = [
    "read",
    "write",
    "read_maps",
    "write_maps",
    "read_alms",
    "write_alms",
    "read_vmap",
    "FitsDict",
    "MapFits",
    "AlmFits",
    "ClsFits",
    "MmsFits",
]

UNSEEN = -1.6375e30  # HEALPix bad-pixel sentinel

_METADATA_COMMENTS = {
    "catalog": "catalog of field",
    "catalog_1": "catalog of first field",
    "catalog_2": "catalog of second field",
    "spin": "spin weight of field",
    "spin_1": "spin weight of first field",
    "spin_2": "spin weight of second field",
    "geometry": "mapper geometry of field",
    "geometry_1": "mapper geometry of first field",
    "geometry_2": "mapper geometry of second field",
    "kernel": "mapper kernel of field",
    "kernel_1": "mapper kernel of first field",
    "kernel_2": "mapper kernel of second field",
    "nside": "HEALPix resolution parameter of field",
    "nside_1": "HEALPix resolution parameter of first field",
    "nside_2": "HEALPix resolution parameter of second field",
    "lmax": "LMAX parameter of field",
    "lmax_1": "LMAX parameter of first field",
    "lmax_2": "LMAX parameter of second field",
    "nbar": "mean number count of field",
    "nbar_1": "mean number count of first field",
    "nbar_2": "mean number count of second field",
    "wbar": "mean weight of field",
    "wbar_1": "mean weight of first field",
    "wbar_2": "mean weight of second field",
    "bias": "additive bias of spectrum",
}


_INTEGER = re.compile(r"-?[0-9]+")


def _string_from_key(key):
    """Encode a (possibly nested tuple) key as a FITS EXTNAME string.

    Wire format (shared with :mod:`heracles_tpu.io`, so files stay
    interchangeable): components joined by ``-``; literal ``\\`` and
    ``-`` backslash-escaped; runs of non-printable-ASCII folded to ``~``.
    """
    if isinstance(key, Sequence) and not isinstance(key, str):
        return "-".join(map(_string_from_key, key))
    out = []
    in_run = False
    for ch in str(key):
        if ch in ("\\", "-"):
            out.append("\\" + ch)
            in_run = False
        elif " " <= ch <= "~":
            out.append(ch)
            in_run = False
        else:
            # each run of non-printables folds to ONE '~', never merging
            # with a preceding literal '~' (re.sub(r"[^ -~]+", "~", ...))
            if not in_run:
                out.append("~")
            in_run = True
    return "".join(out)


def _key_from_string(s):
    """Decode an EXTNAME string back into a key (scalar or flat tuple)."""
    parts, buf = [], []
    chars = iter(s)
    for ch in chars:
        if ch == "\\":
            buf.append(next(chars, "\\"))
        elif ch == "-":
            parts.append("".join(buf))
            buf.clear()
        else:
            buf.append(ch)
    parts.append("".join(buf))
    keys = [int(p) if _INTEGER.fullmatch(p) else p for p in parts]
    return tuple(keys) if len(keys) > 1 else keys[0]


def _metadata_header(metadata, extra=None):
    """Header with META cards (and any extra cards prepended)."""
    hdr = Header()
    if extra:
        for item in extra:
            hdr.set(item["name"], item["value"], item.get("comment"))
    for key, value in (metadata or {}).items():
        hdr.set("META " + key.upper(), value, _METADATA_COMMENTS.get(key, ""))
    return hdr


def _host(a):
    """A host numpy array of a map or alm, with its metadata.

    A DeviceMap is copied to the host with the metadata of its dtype, a
    tensor (on any device) without metadata; numpy arrays pass as they are.
    """
    if isinstance(a, DeviceMap):
        return np.asarray(a)
    if isinstance(a, torch.Tensor):
        return tracing.to_host("io.to_host", a)
    return a


def _read_metadata(hdu):
    h = hdu.read_header()
    return {
        key[5:].lower(): h[key] for key in h.keys() if key.startswith("META ")
    }


# -- maps -----------------------------------------------------------------


def _healpix_header(npix):
    nside = npix2nside(npix)
    return [
        dict(name="PIXTYPE", value="HEALPIX", comment="HEALPIX pixelisation"),
        dict(name="ORDERING", value="RING",
             comment="Pixel ordering scheme, either RING or NESTED"),
        dict(name="NSIDE", value=nside,
             comment="Resolution parameter of HEALPIX"),
        dict(name="FIRSTPIX", value=0, comment="First pixel # (0 based)"),
        dict(name="LASTPIX", value=npix - 1, comment="Last pixel # (0 based)"),
        dict(name="INDXSCHM", value="IMPLICIT",
             comment="Indexing: IMPLICIT or EXPLICIT"),
        dict(name="OBJECT", value="FULLSKY",
             comment="Sky coverage, either FULLSKY or PARTIAL"),
    ]


def _write_map(fits, ext, m, *, names=None):
    m = _host(m)
    cols = list(np.atleast_2d(np.asarray(m)))
    if names is None:
        names = ["MAP"] if len(cols) == 1 else [
            f"MAP{j}" for j in range(1, len(cols) + 1)
        ]
    npix = np.shape(m)[-1]
    hdr = _metadata_header(m.dtype.metadata, extra=_healpix_header(npix))
    fits.write_table(cols, names=names, extname=ext, header=hdr)


def _read_map(hdu):
    data = hdu.read()
    m = np.squeeze(np.stack([data[name] for name in data.dtype.names]).T.T)
    m = np.ascontiguousarray(m)
    m.dtype = np.dtype(m.dtype, metadata=_read_metadata(hdu))
    return m


# -- complex (alm) arrays ---------------------------------------------------


def _write_complex(fits, ext, arr):
    arr = _host(arr)
    a = np.asarray(arr)
    if a.ndim > 1:
        a = np.moveaxis(a, -1, 0)
    hdr = _metadata_header(arr.dtype.metadata)
    fits.write_table(
        [np.ascontiguousarray(a.real), np.ascontiguousarray(a.imag)],
        names=["real", "imag"],
        extname=ext,
        header=hdr,
    )


def _read_complex(hdu):
    data = hdu.read()
    arr = np.empty(data["real"].shape,
                   dtype=np.dtype(complex, metadata=_read_metadata(hdu)))
    arr.real = data["real"]
    arr.imag = data["imag"]
    if arr.ndim > 1:
        arr = np.moveaxis(arr, 0, -1)
    return arr


# -- results -----------------------------------------------------------------


def _prepare_result_array(arrs, order, size):
    if len(order) == 1:
        return arrs[0]
    return np.transpose(
        [np.pad(arrs[i], (0, size - arrs[i].size)) for i in order]
    )


def _write_result(fits, ext, result):
    ell_attr = getattr(result, "ell", None)
    axes = normalize_result_axis(getattr(result, "axis", None), result, ell_attr)

    # decreasing order of ell axes by dimension size
    order = np.argsort([result.shape[i] for i in axes])[::-1]
    axis = tuple(axes[i] for i in order)

    arr = np.moveaxis(np.asarray(result), axis, tuple(range(len(axis))))
    nrows = arr.shape[0]

    ell = _prepare_result_array(get_result_array(result, "ell"), order, nrows)
    lower = _prepare_result_array(get_result_array(result, "lower"), order, nrows)
    upper = _prepare_result_array(get_result_array(result, "upper"), order, nrows)
    weight = _prepare_result_array(get_result_array(result, "weight"), order, nrows)

    extra = [
        dict(name="ELLAXIS", value=str(axis).replace(" ", ""),
             comment="angular axis indices"),
    ]
    spin = getattr(result, "spin", None)
    if spin is not None:
        extra.append(
            dict(name="SPIN", value=str(spin).replace(" ", ""),
                 comment="spin values")
        )
    hdr = _metadata_header(result.dtype.metadata, extra=extra)
    fits.write_table(
        [arr, ell, lower, upper, weight],
        names=["ARRAY", "ELL", "LOWER", "UPPER", "WEIGHT"],
        extname=ext,
        header=hdr,
    )


def _read_result(hdu):
    data = hdu.read()
    h = hdu.read_header()
    axis = literal_eval(str(h["ELLAXIS"]))
    spin = literal_eval(str(h["SPIN"])) if "SPIN" in h else None

    arr = np.moveaxis(data["ARRAY"], tuple(range(len(axis))), axis)
    order = np.argsort(axis)

    def unpack(col):
        values = data[col]
        if values.ndim == 1:
            return values
        return tuple(values[: arr.shape[axis[i]], i] for i in order)

    return Result(
        np.ascontiguousarray(arr).view(
            np.dtype(arr.dtype, metadata=_read_metadata(hdu))
        ),
        axis=tuple(axis[i] for i in order),
        spin=spin,
        ell=unpack("ELL"),
        lower=unpack("LOWER"),
        upper=unpack("UPPER"),
        weight=unpack("WEIGHT"),
    )


# -- visibility maps ---------------------------------------------------------


def read_vmap(filename, nside=None, field=0, *, transform=False, lmax=None,
              device="cuda"):
    """Read a visibility map from a HEALPix map FITS file.

    UNSEEN pixels are zeroed; the map is optionally regraded to ``nside``
    (the port's :func:`~heracles_tpu_torch.healpix.ud_grade`: RING in, RING
    out) and optionally transformed to (pixel-window-deconvolved) alms by
    the port's ``map2alm`` on ``device`` (default the CUDA card).  Returns
    a host numpy map, or host numpy alms with ``transform=True``.
    """
    fits = FitsFile(os.fspath(filename))
    hdu = None
    for candidate in list(fits)[1:]:
        if candidate.get_nrows() > 0:
            hdu = candidate
            break
    if hdu is None:
        raise OSError(f"no map data in {filename}")
    data = hdu.read()
    name = data.dtype.names[field]
    vmap = np.asarray(data[name], dtype=float).reshape(-1)
    hdr = hdu.read_header()
    if str(hdr.get("ORDERING", "RING")).strip().upper() == "NESTED":
        # RING pixel i holds the value of NEST pixel ring2nest(i)
        nside_in = npix2nside(vmap.size)
        vmap = vmap[ring2nest(nside_in, np.arange(vmap.size))]

    vmap[vmap == UNSEEN] = 0.0

    if nside is not None and nside != npix2nside(vmap.size):
        warn(f"{filename}: changing NSIDE to {nside}")
        vmap = ud_grade(torch.as_tensor(vmap), nside).numpy()

    if transform:
        from .ops import sht

        nside_map = npix2nside(vmap.size)
        if lmax is None:
            lmax = sht.resolve_lmax(nside_map)
        dev = torch.device(device)
        alm = sht.map2alm(tracing.upload("io.read_vmap", vmap, dev),
                          lmax=lmax, weights="ring")
        pw = tracing.upload("io.read_vmap", sht.pixel_window(nside_map, lmax),
                            dev)
        ls, _ = sht._pack_index(lmax, lmax, dev)
        vmap = np.ascontiguousarray(tracing.to_host("io.read_vmap",
                                                    alm / pw[ls]))

    return vmap


# -- bulk read/write ---------------------------------------------------------


def _open_for_append(path, clobber):
    if not os.path.isfile(path) or clobber:
        return FitsFile(path, mode="rw", clobber=True)
    return FitsFile(path, mode="rw")


def _iter_named_hdus(fits):
    for hdu in list(fits)[1:]:
        if hdu.get_nrows() == 0 and int(hdu.header.get("NAXIS", 0)) == 0:
            continue
        ext = hdu.get_extname()
        if not ext:
            continue
        key = _key_from_string(ext)
        if not key:
            continue
        yield key, hdu


def write_maps(path, maps, *, clobber=False):
    """Write a set of maps to FITS (append unless ``clobber``)."""
    logger.info("writing %d maps to %s", len(maps), path)
    fits = _open_for_append(path, clobber)
    for key, m in maps.items():
        _write_map(fits, _string_from_key(key), m)
    logger.info("done with %d maps", len(maps))


def read_maps(path, *, include=None, exclude=None):
    """Read a set of maps from a FITS file."""
    logger.info("reading maps from %s", path)
    maps = {}
    fits = FitsFile(path)
    for key, hdu in _iter_named_hdus(fits):
        if not toc_match(key, include=include, exclude=exclude):
            continue
        maps[key] = _read_map(hdu)
    return maps


def write_alms(path, alms, *, clobber=False):
    """Write a set of alms to FITS (append unless ``clobber``)."""
    logger.info("writing %d alms to %s", len(alms), path)
    fits = _open_for_append(path, clobber)
    for key, alm in alms.items():
        _write_complex(fits, _string_from_key(key), alm)


def read_alms(path, *, include=None, exclude=None):
    """Read a set of alms from a FITS file."""
    logger.info("reading alms from %s", path)
    alms = {}
    fits = FitsFile(path)
    for key, hdu in _iter_named_hdus(fits):
        if not toc_match(key, include=include, exclude=exclude):
            continue
        alms[key] = _read_complex(hdu)
    return alms


def write(path, results, *, clobber=False):
    """Write a set of results to FITS (append unless ``clobber``)."""
    logger.info("writing %d results to %s", len(results), path)
    fits = _open_for_append(path, clobber)
    for key, result in results.items():
        _write_result(fits, _string_from_key(key), result)


def read(path):
    """Read a set of results from a FITS file."""
    logger.info("reading results from %s", path)
    results = {}
    fits = FitsFile(path)
    for key, hdu in _iter_named_hdus(fits):
        results[key] = _read_result(hdu)
    return results


# -- lazy FITS-backed mappings ------------------------------------------------


class FitsDict(MutableMapping):
    """Lazy FITS-backed mutable mapping (one extension per key).

    Values stream to disk on ``__setitem__``, so partial pipelines leave
    a valid, resumable file behind.
    """

    @staticmethod
    def reader(hdu):
        return hdu.read()

    @staticmethod
    def writer(fits, ext, data):
        if data.dtype.names is None:
            raise TypeError("data must be structured array")
        fits.write_table(data, extname=ext)

    @property
    def fits(self):
        # one scanned handle per mapping: appends through THIS handle
        # update the HDU index incrementally, so streaming thousands of
        # keys stays O(n); if the file changed size through any OTHER
        # handle (concurrent pipeline stage), drop and rescan
        size = self.path.stat().st_size if self.path.exists() else -1
        if self._fits is None or size != self._fits_size:
            if self._fits is not None:
                self._fits.close()
            self._fits = FitsFile(self.path, mode="rw")
            self._fits_size = size
        return self._fits

    def _sync_size(self):
        self._fits_size = (
            self.path.stat().st_size if self.path.exists() else -1
        )

    def __init__(self, path, *, clobber=False):
        self.path = Path(path)
        if not self.path.exists() or clobber:
            FitsFile(self.path, mode="rw", clobber=True)
        self._fits = None
        self._fits_size = -1
        self._cache = WeakValueDictionary()

    def __iter__(self):
        for key, _ in _iter_named_hdus(self.fits):
            yield key

    def __len__(self):
        return sum(1 for _ in iter(self))

    def __contains__(self, key):
        return _string_from_key(key) in self.fits

    def __getitem__(self, key):
        ext = _string_from_key(key)
        data = self._cache.get(ext)
        if data is None:
            fits = self.fits
            if ext not in fits:
                raise KeyError(ext)
            data = self.reader(fits[ext])
            try:
                self._cache[ext] = data
            except TypeError:
                pass  # some values (e.g. plain slices) are not weakref-able
        return data

    def __setitem__(self, key, value):
        ext = _string_from_key(key)
        self.writer(self.fits, ext, value)
        self._sync_size()

    def __delitem__(self, key):
        raise NotImplementedError("deleting FITS extensions is not supported")


class MapFits(FitsDict):
    """FITS-backed mapping for maps."""

    reader = staticmethod(_read_map)
    writer = staticmethod(_write_map)


class AlmFits(FitsDict):
    """FITS-backed mapping for alms."""

    reader = staticmethod(_read_complex)
    writer = staticmethod(_write_complex)


class ClsFits(FitsDict):
    """FITS-backed mapping for Result-valued spectra."""

    reader = staticmethod(_read_result)
    writer = staticmethod(_write_result)


class MmsFits(FitsDict):
    """FITS-backed mapping for Result-valued mixing matrices."""

    reader = staticmethod(_read_result)
    writer = staticmethod(_write_result)
