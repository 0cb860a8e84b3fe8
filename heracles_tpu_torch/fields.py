"""Field definitions: catalogue -> map coroutines with online statistics.

Counterpart of :mod:`heracles_tpu.fields`.  Each concrete field pages
through a catalogue, scatters the page into a map on the mapper's device,
keeps online moments of the weights and values on the host, then
normalises the map and attaches the noise-bias ingredients as metadata:

* :class:`Positions` — number counts / overdensity, nbar normalisation,
  bias ingredients ``musq=1``, ``dens=(nbar/area)^2 / (ngal/4 pi fsky) / <w^2>``;
* :class:`ScalarField` — weighted scalar values (magnification,
  convergence), ``musq = <|w v|^2> / <w^2>``;
* :class:`ComplexField` (spin 0) and :class:`Spin2Field` (= ``Shears`` =
  ``Ellipticities``) — two-component values;
* :class:`Visibility` — copy the catalogue's visibility map;
* :class:`Weights` — map of the weights themselves (the mask of a
  weighted field);
* :func:`get_masks` — mask names or n-combinations of a set of fields,
  with ``_E``/``_B`` key filtering; mixing-matrix users build their mask
  spectra with these.
"""

from __future__ import annotations

import warnings
from abc import ABCMeta, abstractmethod
from functools import partial
from itertools import combinations_with_replacement, product

import numpy as np
import torch

from . import _scheduler as coroutines
from .core import toc_match, update_metadata

__all__ = [
    "Field",
    "Positions",
    "ScalarField",
    "ComplexField",
    "Visibility",
    "Weights",
    "Spin2Field",
    "Shears",
    "Ellipticities",
    "get_masks",
]


class Field(metaclass=ABCMeta):
    """Abstract base class for field definitions.

    Subclasses declare their catalogue columns via ``uses`` (trailing
    ``[name]`` entries are optional) and their spin weight via the
    ``spin=`` class keyword; instances bind a mapper, concrete column
    names and an optional mask name.
    """

    uses = None

    _spin = None

    def __init_subclass__(cls, *, spin=None, **kwargs):
        super().__init_subclass__(**kwargs)
        if spin is not None:
            cls._spin = spin
        uses = cls.uses
        if uses is None:
            uses = ()
        elif isinstance(uses, str):
            uses = (uses,)
        nopt = 0
        for name in reversed(uses):
            if name.startswith("[") and name.endswith("]"):
                nopt += 1
            else:
                break
        cls._ncol = (len(uses) - nopt, len(uses))

    def __init__(self, mapper, *columns, mask=None):
        self._mapper = mapper
        self._columns = self._init_columns(*columns) if columns else None
        self._mask = mask

    @classmethod
    def _init_columns(cls, *columns):
        nmin, nmax = cls._ncol
        if not nmin <= len(columns) <= nmax:
            uses = cls.uses or ()
            if isinstance(uses, str):
                uses = (uses,)
            count = f"{nmin}" if nmin == nmax else f"{nmin} to {nmax}"
            msg = f"field of type '{cls.__name__}' accepts {count} columns"
            if uses:
                msg += " (" + ", ".join(uses) + ")"
            msg += f", received {len(columns)}"
            raise ValueError(msg)
        return columns + (None,) * (nmax - len(columns))

    @property
    def mapper(self):
        return self._mapper

    @property
    def mapper_or_error(self):
        if self._mapper is None:
            raise ValueError("no mapper for field")
        return self._mapper

    @property
    def columns(self):
        return self._columns

    @property
    def columns_or_error(self):
        if self._columns is None:
            raise ValueError("no columns for field")
        return self._columns

    @property
    def spin(self):
        if self._spin is None:
            raise ValueError(
                f"field of type '{self.__class__.__name__}' has undefined spin weight"
            )
        return self._spin

    @property
    def mask(self):
        return self._mask

    @abstractmethod
    async def __call__(self, catalog, *, progress=None):
        """Map a catalogue; returns the finished map with metadata."""


async def aiter_pages(catalog, progress):
    """Async page iterator with progress updates and suspension points."""
    page_size = catalog.page_size
    current, total = 0, catalog.size
    for page in catalog:
        if progress is not None:
            progress.update(current, total)
        await coroutines.sleep()
        yield page
        current += page_size
    await coroutines.sleep()


def _size(array):
    return array.numel() if isinstance(array, torch.Tensor) else np.size(array)


class _Accumulator:
    """Map accumulation through the mapper's begin/add/finish interface."""

    def __init__(self, mapper, *dims, spin=0):
        self._mapper = mapper
        self._spin = spin
        self._state = mapper.begin(*dims, spin=spin)

    def add(self, lon, lat, values):
        self._state = self._mapper.add(self._state, lon, lat, values)

    def result(self):
        return self._mapper.finish(self._state, spin=self._spin)


class _Moments:
    """Streaming means of the weights (and squared values) over a catalogue.

    Running-mean updates, one shot per page, so a catalogue of any length
    accumulates in O(1) memory: count n, <w>, <w^2>, and <|v|^2> of the
    already-weighted values.
    """

    __slots__ = ("count", "wmean", "w2mean", "vsqmean")

    def __init__(self):
        self.count = 0
        self.wmean = 0.0
        self.w2mean = 0.0
        self.vsqmean = 0.0

    def update(self, n, w, vsq=None):
        self.count += n
        self.wmean += np.sum(w - self.wmean) / self.count
        self.w2mean += np.sum(w**2 - self.w2mean) / self.count
        if vsq is not None:
            self.vsqmean += np.sum(vsq - self.vsqmean) / self.count


class _PagedField(Field):
    """Template for fields that scatter catalogue pages into a map.

    Subclasses provide three hooks: ``_shape`` (leading map dimensions),
    ``_page_values(page, value_columns, w)`` returning the values to
    scatter plus their squared magnitude for the variance estimate, and
    ``_finalise(raw_map, moments, catalog, mapper)`` for normalisation
    and metadata.  The paging loop itself — zero-weight row removal,
    device scatters, streaming moments — lives here once.
    """

    _shape = ()
    _drop_zero_weight = True

    def _page_values(self, page, value_columns, w):
        return w, None

    def _finalise(self, raw, mom, catalog, mapper):
        raise NotImplementedError

    async def __call__(self, catalog, *, progress=None):
        mapper = self.mapper_or_error
        lon_col, lat_col, *val_cols, wcol = self.columns_or_error
        acc = _Accumulator(mapper, *self._shape, spin=self.spin)
        mom = _Moments()

        async for page in aiter_pages(catalog, progress):
            if self._drop_zero_weight and wcol is not None:
                page.delete(page[wcol] == 0)
            if not page.size:
                continue
            lon, lat = page.get(lon_col, lat_col)
            w = page.get(wcol) if wcol is not None else np.ones(page.size)
            values, vsq = self._page_values(page, val_cols, w)
            acc.add(lon, lat, values)
            mom.update(page.size, w, vsq)
            del page, lon, lat, w, values, vsq

        return self._finalise(acc.result(), mom, catalog, mapper)

    def _mean_weight_normalise(self, arr, mom, catalog, mapper, *, musq):
        """Shared wbar normalisation + bias metadata of the value fields."""
        fsky = catalog.fsky if catalog.fsky is not None else 1.0
        density = mom.count / (4 * np.pi * fsky)
        wbar = density * mom.wmean * mapper.area
        arr /= wbar
        dens = density * mom.wmean**2 / mom.w2mean
        update_metadata(arr, catalog, wbar=wbar, musq=musq, dens=dens, fsky=fsky)
        return arr


class Positions(_PagedField, spin=0):
    """Field of galaxy positions: number counts or overdensity.

    Normalisation and bias ingredients as in :class:`heracles_tpu.fields.Positions`.
    """

    uses = "longitude", "latitude", "[weight]"

    # zero-weight objects stay in the counts map
    _drop_zero_weight = False

    def __init__(self, mapper, *columns, overdensity=True, nbar=None, mask=None):
        super().__init__(mapper, *columns, mask=mask)
        self._overdensity = overdensity
        self._nbar = nbar

    @property
    def overdensity(self):
        return self._overdensity

    @property
    def nbar(self):
        return self._nbar

    @nbar.setter
    def nbar(self, nbar):
        self._nbar = nbar

    async def __call__(self, catalog, *, progress=None):
        if self._overdensity and catalog.visibility is None:
            raise ValueError(
                "cannot compute density contrast: no visibility in catalog"
            )
        return await super().__call__(catalog, progress=progress)

    def _finalise(self, pos, mom, catalog, mapper):
        fsky = catalog.fsky if catalog.fsky is not None else 1.0
        npix = 4 * np.pi / mapper.area
        nbar = mom.count * mom.wmean / fsky / npix
        if (given := self._nbar) is not None:
            if abs(nbar - given) > 3 * (given / fsky / npix) ** 0.5:
                warnings.warn(
                    f"estimated mean density {nbar:g} is more than 3 sigma "
                    f"away from the given nbar={given:g}; keeping the given "
                    "value"
                )
            nbar = given

        pos /= nbar
        if self._overdensity:
            vis = catalog.visibility
            if vis is not None and _size(vis) != pos.size:
                warnings.warn(
                    "resampling visibility to the positions map resolution"
                )
                vis = mapper.resample(vis)
            pos -= vis

        dens = (nbar / mapper.area) ** 2 / (
            mom.count / (4 * np.pi * fsky)
        ) / mom.w2mean
        update_metadata(pos, catalog, nbar=nbar, musq=1.0, dens=dens, fsky=fsky)
        return pos


class ScalarField(_PagedField, spin=0):
    """Weighted scalar values (e.g. magnification, convergence)."""

    uses = "longitude", "latitude", "value", "[weight]"

    def _page_values(self, page, value_columns, w):
        wv = w * page.get(value_columns[0])
        return wv, wv**2

    def _finalise(self, val, mom, catalog, mapper):
        return self._mean_weight_normalise(
            val, mom, catalog, mapper, musq=mom.vsqmean / mom.w2mean
        )


class ComplexField(_PagedField, spin=0):
    """Two-component (complex) values; spin set by subclasses."""

    uses = "longitude", "latitude", "real", "imag", "[weight]"

    _shape = (2,)

    def _page_values(self, page, value_columns, w):
        re, im = page.get(*value_columns)
        wv = np.stack([w * re, w * im])
        return wv, np.sum(wv**2, axis=0)

    def _finalise(self, val, mom, catalog, mapper):
        return self._mean_weight_normalise(
            val, mom, catalog, mapper, musq=mom.vsqmean / mom.w2mean
        )


class Visibility(Field, spin=0):
    """Copy the catalogue's visibility map into a map of the mapper."""

    async def __call__(self, catalog, *, progress=None):
        mapper = self.mapper_or_error
        visibility = catalog.visibility
        if visibility is None:
            raise ValueError("no visibility in catalog")
        out = mapper.create(spin=self.spin)
        if _size(visibility) != out.size:
            warnings.warn("resampling visibility to the mapper resolution")
            visibility = mapper.resample(visibility)
        out[:] = visibility
        update_metadata(out, catalog)
        return out


class Weights(_PagedField, spin=0):
    """Map of the weights themselves."""

    uses = "longitude", "latitude", "[weight]"

    def _finalise(self, wht, mom, catalog, mapper):
        return self._mean_weight_normalise(wht, mom, catalog, mapper, musq=1.0)


class Spin2Field(ComplexField, spin=2):
    """Spin-2 complex field (cosmic shear, ellipticities)."""


Shears = Spin2Field
Ellipticities = Spin2Field


def get_masks(fields, *, comb=None, include=None, exclude=None, append_eb=False):
    """Mask names (or n-combinations) for a set of fields.

    ``include``/``exclude`` filter by *field* keys; with ``append_eb``,
    spin-weighted field keys are expanded to their ``_E``/``_B`` variants
    before filtering.
    """
    matches = partial(toc_match, include=include, exclude=exclude)

    def eb_keys(key):
        if append_eb and fields[key].spin != 0:
            return (f"{key}_E", f"{key}_B")
        return (key,)

    if comb is None:
        out = []
        for key, field in fields.items():
            if field.mask is None:
                continue
            if not any(map(matches, eb_keys(key))):
                continue
            out.append(field.mask)
        return out

    out = []
    for keys in combinations_with_replacement(fields, comb):
        masks = tuple(fields[key].mask for key in keys)
        if any(mask is None for mask in masks):
            continue
        if not any(map(matches, product(*map(eb_keys, keys)))):
            continue
        out.append(masks)
    return out
