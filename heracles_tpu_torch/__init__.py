"""Heracles on PyTorch and CUDA: harmonic-space statistics on the sphere.

The port of :mod:`heracles_tpu` to PyTorch with hand-written Hopper
kernels.  It imports torch and numpy, never jax or heracles_tpu (whose
shipped tables it reads from disk).  A tensor's device picks the path:
CPU tensors run plain PyTorch, CUDA tensors run the kernels.  Ported so
far: catalogue (in memory or FITS) -> HEALPix maps -> alms -> angular
power spectra -> mixing matrices, their pseudo-inverses and their
application to spectra; synthesis; FITS persistence of maps, alms and
results; Cl <-> correlation transforms and NaturalSpice; the DICES
jackknife covariances (:mod:`heracles_tpu_torch.dices`); pixel-free alms
straight from the catalogue (:class:`DiscreteMapper`); exact pixel
windows; the command line (``python -m heracles_tpu_torch``).
"""

__version__ = "0.1.0"
__version_tuple__ = (0, 1, 0)

from .catalog import (
    ArrayCatalog,
    Catalog,
    CatalogBase,
    CatalogPage,
    CatalogView,
    FitsCatalog,
    FootprintFilter,
    InvalidValueFilter,
    fsky_from_visibility,
)
from .convert import to_numpy, to_torch
from .core import (
    ExceptionExplainer,
    TocDict,
    external_dependency_explainer,
    toc_filter,
    toc_match,
    update_metadata,
)
from .devicemap import DeviceMap
from .fields import (
    ComplexField,
    Ellipticities,
    Field,
    Positions,
    ScalarField,
    Shears,
    Spin2Field,
    Visibility,
    Weights,
    get_masks,
)
from .io import (
    AlmFits,
    ClsFits,
    FitsDict,
    MapFits,
    MmsFits,
    read,
    read_alms,
    read_maps,
    read_vmap,
    write,
    write_alms,
    write_maps,
)
from .mapper import Mapper
from .mappers import DiscreteMapper, HealpixMapper
from .mapping import map_catalogs, transform
from .progress import NoProgress, Progress
from .result import Result, binned
from .transforms import cl2corr, corr2cl
from .twopoint import (
    alm2cl,
    angular_power_spectra,
    angular_power_spectra_samples,
    apply_mixing_matrix,
    debias_cls,
    invert_mixing_matrix,
    mixing_matrices,
    mixmat,
    mixmat_eb,
)
from .unmixing import naturalspice

__all__ = [
    "__version__",
    "__version_tuple__",
    "AlmFits",
    "ArrayCatalog",
    "Catalog",
    "CatalogBase",
    "CatalogPage",
    "CatalogView",
    "ClsFits",
    "ComplexField",
    "DeviceMap",
    "DiscreteMapper",
    "Ellipticities",
    "ExceptionExplainer",
    "Field",
    "FitsCatalog",
    "FitsDict",
    "FootprintFilter",
    "HealpixMapper",
    "InvalidValueFilter",
    "MapFits",
    "Mapper",
    "MmsFits",
    "NoProgress",
    "Positions",
    "Progress",
    "Result",
    "ScalarField",
    "Shears",
    "Spin2Field",
    "TocDict",
    "Visibility",
    "Weights",
    "alm2cl",
    "angular_power_spectra",
    "angular_power_spectra_samples",
    "apply_mixing_matrix",
    "binned",
    "cl2corr",
    "corr2cl",
    "debias_cls",
    "external_dependency_explainer",
    "fsky_from_visibility",
    "get_masks",
    "invert_mixing_matrix",
    "map_catalogs",
    "mixing_matrices",
    "mixmat",
    "mixmat_eb",
    "naturalspice",
    "read",
    "read_alms",
    "read_maps",
    "read_vmap",
    "to_numpy",
    "to_torch",
    "toc_filter",
    "toc_match",
    "transform",
    "update_metadata",
    "write",
    "write_alms",
    "write_maps",
]
