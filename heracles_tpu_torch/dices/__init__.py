"""DICES: delete-1/delete-2 jackknife covariances of angular power spectra.

Counterpart of :mod:`heracles_tpu.dices`, with the same public names.
"""

__all__ = [
    # jackknife
    "jackknife_cls",
    "jackknife_fsky",
    "jackknife_bias",
    "correct_bias",
    "correct_footprint_naturalspice",
    "correct_footprint_fsky",
    "jackknife_covariance",
    "debias_covariance",
    "delete2_correction",
    "compute_jk_alms",
    "sample_covariance",
    # shrinkage
    "shrink",
    "shrinkage_factor",
    "gaussian_covariance",
    # utils
    "impose_correlation",
    "get_cl",
    "flatten",
]

from ..utils import flatten, get_cl, impose_correlation
from .jackknife import (
    compute_jk_alms,
    correct_bias,
    correct_footprint_fsky,
    correct_footprint_naturalspice,
    debias_covariance,
    delete2_correction,
    jackknife_bias,
    jackknife_cls,
    jackknife_covariance,
    jackknife_fsky,
    sample_covariance,
)
from .shrinkage import gaussian_covariance, shrink, shrinkage_factor
