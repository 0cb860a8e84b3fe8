"""Backend-neutral mapper protocol.

Counterpart of :mod:`heracles_tpu.mapper`: a mapper turns catalogue
points into a map-like product (``create`` + ``map_values``), provides
the harmonic ``transform`` and ``resample``.
:class:`~heracles_tpu_torch.mappers.HealpixMapper` satisfies it, and
adds the device accumulation interface (``begin``/``add``/``finish``)
that the mapping pipeline uses: the map lives on the mapper's device
across catalogue pages.
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

__all__ = ["Mapper"]


@runtime_checkable
class Mapper(Protocol):
    """Protocol for mappers."""

    @property
    def area(self) -> float:
        """Effective area in steradians of one "pixel" of this mapper."""

    def create(self, *dims: int, spin: int = 0) -> Any:
        """Create a new map for this mapper."""

    def map_values(self, lon, lat, data, values, spin: int = 0) -> None:
        """Add values at positions (lon, lat) to data, in place."""

    def transform(self, data, spin: int = 0) -> Any:
        """The spherical harmonic transform for this mapper."""

    def resample(self, data) -> Any:
        """Change resolution of data, which must be in this mapper's format."""
