"""NaturalSpice: real-space mask deconvolution of angular power spectra.

Carried over unchanged from :mod:`heracles_tpu.unmixing` (host numpy):
transform data and mask spectra to correlation functions on
Gauss-Legendre nodes, divide xi_data / xi_mask with a logistic
regularisation in log10|xi_mask| (the cutoff position from ``theta_max``
or a fixed -5), transform back, and restore the original band limit.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from .result import binned
from .transforms import _gauss_legendre, cl2corr, corr2cl
from .utils import get_cl

__all__ = ["naturalspice"]


def logistic(x, x0=-2, k=50):
    """Soft step 1 + exp(-k (x - x0)), applied to log10|xi_mask|."""
    return 1.0 + np.exp(-k * (x - x0))


def naturalspice(d, m, fields, theta_max=None):
    """Deconvolve the mask from data cls in real space.

    ``d``: data cls, ``m``: mask cls (higher band limit), ``fields``:
    mapping of field name -> Field (for mask-name lookup); ``theta_max``
    in degrees sets the logistic cutoff from the mask correlation
    amplitude at that angle.
    """
    first_wd = next(iter(d.values()))
    first_wm = next(iter(m.values()))
    lmax = first_wd.shape[first_wd.axis[0]]
    lmax_mask = first_wm.shape[first_wm.axis[0]]

    # pad data to the mask band limit so the division happens on the
    # mask's (finer) quadrature nodes
    d = binned(d, np.arange(0, lmax_mask + 1))

    wd = cl2corr(d)
    wm = cl2corr(m)
    corr_wds = _naturalspice(wd, wm, fields, theta_max=theta_max)
    corr_d = corr2cl(corr_wds)
    return binned(corr_d, np.arange(0, lmax + 1))


def _naturalspice(wd, wm, fields, theta_max=None):
    """Divide data by (regularised) mask correlation functions."""
    masks = {
        key: field.mask for key, field in fields.items() if field.mask is not None
    }

    if theta_max is not None:
        first_wm = next(iter(wm.values()))
        lmax_mask = first_wm.shape[first_wm.axis[0]]
        xvals, _ = _gauss_legendre(lmax_mask)
        theta = np.degrees(np.arccos(xvals))
        i_cut = np.abs(theta - theta_max).argmin()
        x0 = np.log10(abs(first_wm[i_cut]))
    else:
        x0 = -5

    out = {}
    for key in wd.keys():
        a, b, i, j = key
        mask_corr = get_cl((masks[a], masks[b], i, j), wm).array
        data_corr = wd[key].array
        mask_corr = mask_corr * logistic(np.log10(abs(mask_corr)), x0=x0)
        out[key] = replace(wd[key], array=data_corr / mask_corr)
    return out
