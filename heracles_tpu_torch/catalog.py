"""Catalogue ingestion: paged readers, views and selections.

Counterpart of :mod:`heracles_tpu.catalog` for in-memory catalogues
(host numpy; the pages feed the device scatter of the mappers):

* :class:`CatalogPage` — immutable batch of columns with NaN checking,
  ``-COLUMN`` sign negation, and row deletion;
* :class:`Catalog` protocol / :class:`CatalogBase` / :class:`CatalogView`
  — selections, per-view visibility and fsky (maps, alms, or tensors on
  the device);
* :class:`ArrayCatalog` — in-memory structured array source;
* :class:`FitsCatalog` — paged FITS table source (the port's own reader,
  :mod:`heracles_tpu_torch.fits`) with cached page reads and row
  selection by boolean expressions over columns;
* :class:`InvalidValueFilter`, :class:`FootprintFilter` — page filters.
"""

from __future__ import annotations

import warnings
import weakref
from abc import ABCMeta, abstractmethod
from functools import lru_cache
from types import MappingProxyType
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from . import tracing
from .healpix import ang2pix_ring, npix2nside

__all__ = [
    "Catalog",
    "CatalogBase",
    "CatalogPage",
    "CatalogView",
    "ArrayCatalog",
    "FitsCatalog",
    "InvalidValueFilter",
    "FootprintFilter",
    "fsky_from_visibility",
]


def fsky_from_visibility(visibility):
    """Sky fraction of a visibility given as a map or as alms.

    A complex array is interpreted as alms, whose monopole gives the mean:
    fsky = a00.real / sqrt(4 pi); a real array is a pixel map and the mean
    is direct.  Tensors are reduced on their device in float64.
    """
    if isinstance(visibility, torch.Tensor):
        if visibility.is_complex():
            return float(visibility[0].real / np.sqrt(4 * np.pi))
        return float(visibility.mean(dtype=torch.float64))
    visibility = np.asanyarray(visibility)
    if np.iscomplexobj(visibility):
        return float(visibility[0].real / np.sqrt(4 * np.pi))
    return float(visibility.mean())


class CatalogPage:
    """One immutable batch of catalogue rows, column-oriented."""

    def __init__(self, data):
        self._cols = {}
        size = None
        for name, values in dict(data).items():
            arr = np.asanyarray(values)
            arr.flags.writeable = False
            if size is None:
                size = len(arr)
            elif len(arr) != size:
                raise ValueError("inconsistent row length")
            self._cols[name] = arr
        self._size = 0 if size is None else size

    def _column(self, name):
        # a leading "-" negates the column (sign-convention flips)
        if name.startswith("-"):
            return -self._cols[name[1:]]
        return self._cols[name]

    def __getitem__(self, name):
        if isinstance(name, (list, tuple)):
            return tuple(self._column(n) for n in name)
        return self._column(name)

    def __len__(self):
        return len(self._cols)

    def __iter__(self):
        yield from self._cols

    def __copy__(self):
        return self.copy()

    @property
    def names(self):
        return list(self._cols)

    @property
    def size(self):
        return self._size

    @property
    def data(self):
        return MappingProxyType(self._cols)

    def get(self, *names):
        """Column access with NaN validation."""
        out = []
        for name in names:
            col = self._column(name)
            if np.any(np.isnan(col)):
                raise ValueError(f'invalid values in column "{name}"')
            out.append(col)
        return out[0] if len(out) == 1 else out

    def copy(self):
        return CatalogPage(self._cols)

    def delete(self, where):
        """Remove the rows selected by ``where`` (indices or bool mask)."""
        cols = {n: np.delete(v, where) for n, v in self._cols.items()}
        self._cols = {}
        for n, v in cols.items():
            v.flags.writeable = False
            self._cols[n] = v
        self._size = next(iter(cols.values())).size if cols else 0


@runtime_checkable
class Catalog(Protocol):
    """Protocol for catalogues."""

    def __getitem__(self, where): ...

    @property
    def metadata(self): ...

    @property
    def label(self): ...

    @property
    def base(self): ...

    @property
    def selection(self): ...

    @property
    def names(self): ...

    @property
    def size(self): ...

    @property
    def visibility(self): ...

    @property
    def fsky(self): ...

    def where(self, selection, visibility=None): ...

    @property
    def page_size(self): ...

    def __iter__(self): ...

    def select(self, selection): ...


class CatalogView:
    """A catalogue with a selection applied; may carry its own visibility."""

    def __init__(self, catalog, selection, visibility=None, fsky=None):
        self._catalog = catalog
        self._selection = selection
        self._visibility = visibility
        self._fsky = fsky
        if fsky is None and visibility is not None:
            self._fsky = fsky_from_visibility(visibility)

    def __repr__(self):
        return f"{self._catalog!r}[{self._selection!r}]"

    def __getitem__(self, where):
        return self.where(where)

    @property
    def base(self):
        return self._catalog

    @property
    def metadata(self):
        return self._catalog.metadata

    @property
    def label(self):
        return self._catalog.label

    @property
    def selection(self):
        return self._selection

    @property
    def names(self):
        return self._catalog.names

    @property
    def size(self):
        return self._catalog._size(self._selection)

    @property
    def visibility(self):
        if self._visibility is None:
            return self._catalog.visibility
        return self._visibility

    @visibility.setter
    def visibility(self, visibility):
        self._visibility = visibility
        self._fsky = None if visibility is None else fsky_from_visibility(visibility)

    @property
    def fsky(self):
        if self._fsky is None:
            return self._catalog.fsky
        return self._fsky

    @fsky.setter
    def fsky(self, fsky):
        self._fsky = fsky

    def _joined(self, selection):
        if isinstance(selection, (tuple, list)):
            return (self._selection, *selection)
        return (self._selection, selection)

    def where(self, selection, visibility=None):
        if visibility is None:
            visibility = self._visibility
        return self._catalog.where(self._joined(selection), visibility)

    @property
    def page_size(self):
        return self._catalog.page_size

    def __iter__(self):
        yield from self._catalog.select(self._selection)

    def select(self, selection):
        yield from self._catalog.select(self._joined(selection))


class CatalogBase(metaclass=ABCMeta):
    """Base class for concrete (non-view) catalogues."""

    default_page_size = 1_000_000

    def __init__(self):
        self._page_size = self.default_page_size
        self._filters = []
        self._label = None
        self._visibility = None
        self._fsky = None

    def __copy__(self):
        other = self.__class__.__new__(self.__class__)
        other._page_size = self._page_size
        other._filters = list(self._filters)
        other._label = self._label
        other._visibility = self._visibility
        other._fsky = self._fsky
        return other

    @abstractmethod
    def _names(self): ...

    @abstractmethod
    def _size(self, selection): ...

    @abstractmethod
    def _join(self, *where): ...

    @abstractmethod
    def _pages(self, selection): ...

    @property
    def filters(self):
        return self._filters

    @filters.setter
    def filters(self, filters):
        self._filters = filters

    def add_filter(self, filt):
        self._filters.append(filt)

    def __getitem__(self, where):
        return self.where(where)

    @property
    def base(self):
        return None

    @property
    def metadata(self):
        return MappingProxyType({"catalog": self._label})

    @property
    def label(self):
        return self._label

    @label.setter
    def label(self, label):
        self._label = label

    @property
    def selection(self):
        return None

    @property
    def names(self):
        return self._names()

    @property
    def size(self):
        return self._size(None)

    @property
    def visibility(self):
        return self._visibility

    @visibility.setter
    def visibility(self, visibility):
        self._visibility = visibility
        self._fsky = None if visibility is None else fsky_from_visibility(visibility)

    @property
    def fsky(self):
        return self._fsky

    @fsky.setter
    def fsky(self, fsky):
        self._fsky = fsky

    def where(self, selection, visibility=None):
        if isinstance(selection, (tuple, list)):
            selection = self._join(*selection)
        return CatalogView(self, selection, visibility)

    @property
    def page_size(self):
        return self._page_size

    @page_size.setter
    def page_size(self, value):
        self._page_size = value

    def __iter__(self):
        yield from self.select(None)

    def select(self, selection):
        if isinstance(selection, (tuple, list)):
            selection = self._join(*selection)
        pages = self._pages(selection)
        while True:
            # the page's read and filters, not the consumer's work on it
            with tracing.span("catalog.page"):
                page = next(pages, None)
                if page is None:
                    return
                for filt in self._filters:
                    filt(page)
            yield page


class ArrayCatalog(CatalogBase):
    """In-memory catalogue over a numpy structured array.

    Selections are boolean masks (or callables producing them), ANDed
    together when joined.
    """

    def __init__(self, arr):
        super().__init__()
        self._arr = arr

    def __copy__(self):
        other = super().__copy__()
        other._arr = self._arr
        return other

    def _names(self):
        return self._arr.dtype.names

    def _size(self, selection):
        if selection is None:
            return len(self._arr)
        return len(self._arr[selection])

    def _join(self, first, *rest):
        mask = np.asanyarray(first).copy()
        for other in rest:
            mask &= other
        return mask

    def _pages(self, selection):
        arr = self._arr if selection is None else self._arr[selection]
        names = arr.dtype.names
        size = self.page_size
        for start in range(0, len(arr), size):
            chunk = arr[start : start + size]
            yield CatalogPage({name: chunk[name] for name in names})


def rowfilter(expr, table):
    """Evaluate a boolean expression string over the columns of a table."""
    return eval(expr, None, {name: table[name] for name in table.dtype.names})


class FitsCatalog(CatalogBase):
    """Paged catalogue over a FITS binary table.

    Selections are boolean expression strings evaluated per page (joined
    with ``&``); page reads are LRU-cached so interleaved fields re-reading
    the same rows hit memory, and page k+1 is read on a worker thread while
    page k is consumed.
    """

    @staticmethod
    def _page_cache(catalog):
        """LRU page reader bound through a weakref.

        A ``lru_cache`` over the bound method would create an instance ->
        cache -> bound-method -> instance cycle, and dead catalogues (with
        their page buffers and file maps) would wait for the cycle
        collector; the weakref keeps collection refcount-driven.
        """
        ref = weakref.ref(catalog)

        @lru_cache(maxsize=8)
        def read_page(start, stop):
            return ref()._read_page_impl(start, stop)

        return read_page

    def __init__(self, path, columns=None, *, ext=None):
        super().__init__()
        self._path = path
        self._columns = columns
        self._ext = ext
        self._hdu_cached = None
        self._read_page = self._page_cache(self)

    def __copy__(self):
        other = super().__copy__()
        other._path = self._path
        other._columns = self._columns
        other._ext = self._ext
        other._hdu_cached = self._hdu_cached  # read-only; safe to share
        other._read_page = self._page_cache(other)
        return other

    def __repr__(self):
        return f"FitsCatalog({self._path!r})"

    @property
    def path(self):
        return self._path

    def _hdu(self):
        if self._hdu_cached is not None:
            return self._hdu_cached
        from .fits import FitsFile

        fits = FitsFile(self._path)
        if self._ext is not None:
            hdu = fits[self._ext]
        else:
            # first extension with rows
            for hdu in list(fits)[1:]:
                if hdu.get_nrows() > 0:
                    break
            else:
                raise OSError(f"no table data in {self._path}")
        self._hdu_cached = hdu
        return hdu

    def _names(self):
        if self._columns is not None:
            return list(self._columns)
        return list(self._hdu()._row_dtype()[0].names)

    def _size(self, selection):
        if selection is None:
            return self._hdu().get_nrows()
        return None

    def _join(self, *where):
        exprs = [w for w in where if w is not None]
        if not exprs:
            return None
        return "(" + ") & (".join(map(str, exprs)) + ")"

    def _read_page_impl(self, start, stop):
        # only the requested columns are decoded
        return CatalogPage(self._hdu().read_columns(self._names(),
                                                    rows=(start, stop)))

    def _pages(self, selection):
        from concurrent.futures import ThreadPoolExecutor

        nrows = self._hdu().get_nrows()
        size = self.page_size
        spans = [(start, min(start + size, nrows))
                 for start in range(0, nrows, size)]
        if not spans:
            return
        # double-buffer: read page k+1 on a worker thread while the
        # caller (device scatter, SHT) consumes page k
        with ThreadPoolExecutor(1) as pool:
            future = pool.submit(self._read_page, *spans[0])
            for i, _ in enumerate(spans):
                page = future.result()
                if i + 1 < len(spans):
                    future = pool.submit(self._read_page, *spans[i + 1])
                if selection is not None:
                    table = np.rec.fromarrays(
                        [page[n] for n in page.names], names=page.names
                    )
                    mask = rowfilter(selection, table)
                    page = CatalogPage({n: page[n][mask] for n in page.names})
                else:
                    page = page.copy()
                yield page


class InvalidValueFilter:
    """Delete rows with NaN in the given columns (those of zero ``weight``
    are kept)."""

    def __init__(self, *columns, weight=None, warn=True):
        self.columns = columns
        self.weight = weight
        self.warn = warn

    def __repr__(self):
        args = [repr(c) for c in self.columns]
        args += [f"weight={self.weight!r}", f"warn={self.warn!r}"]
        return f"{self.__class__.__name__}({', '.join(args)})"

    def __call__(self, page):
        bad = np.zeros(page.size, dtype=bool)
        for col in self.columns:
            bad |= np.isnan(page[col])
        if self.weight is not None:
            bad &= page[self.weight] != 0
        index = np.flatnonzero(bad)
        if index.size:
            if self.warn:
                warnings.warn("WARNING: catalog contains invalid values")
            page.delete(index)


class FootprintFilter:
    """Keep only rows inside a HEALPix footprint (a RING map, nonzero
    inside); the pixel lookup runs on the host."""

    def __init__(self, footprint, lon, lat):
        self._footprint = np.asanyarray(footprint)
        self._nside = npix2nside(self._footprint.shape[-1])
        self._lonlat = (lon, lat)

    @property
    def footprint(self):
        return self._footprint

    @property
    def lonlat(self):
        return self._lonlat

    def __repr__(self):
        lon, lat = self._lonlat
        return f"{self.__class__.__name__}(..., {lon!r}, {lat!r})"

    def __call__(self, page):
        lon, lat = self._lonlat
        # torch.tensor copies: page columns are read-only numpy arrays
        ipix = ang2pix_ring(
            self._nside,
            torch.tensor(page[lon], dtype=torch.float64),
            torch.tensor(page[lat], dtype=torch.float64),
            lonlat=True,
        ).numpy()
        outside = np.flatnonzero(self._footprint[ipix] == 0)
        if outside.size:
            page.delete(outside)
