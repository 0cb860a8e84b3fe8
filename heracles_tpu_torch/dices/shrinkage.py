"""Linear shrinkage of jackknife covariances (Schafer-Strimmer style).

Carried over unchanged from :mod:`heracles_tpu.dices.shrinkage` (host
numpy, float64): the shrunk covariance is ``lambda * (correlation-imposed
target) + (1 - lambda) * cov``, with the optimal ``lambda*`` estimated
from the per-sample deviation outer products; the Gaussian target is the
Knox formula ``cov[l,l] = C13*C24 + C14*C23`` per spin component.

Every moment of the deviation matrices W_k = s * outer(d_k, d_k) needed
by lambda* reduces to a matmul of elementwise powers of the centred
sample matrix D, because

    sum_k W_k[i,j]^2          = s^2 * (D^2)^T (D^2)
    sum_k W_k[i,i] W_k[i,j]   = s^2 * (D^3)^T  D

which makes the whole estimate three matmuls at any vector size.
"""

from __future__ import annotations

import itertools
from dataclasses import replace

import numpy as np

from ..result import Result, get_result_array
from ..utils import (
    add_to_Cls,
    expand_spin0_dims,
    flatten,
    get_cl,
    impose_correlation,
    squeeze_spin0_dims,
)
from .jackknife import bias

__all__ = ["shrink", "shrinkage_factor", "gaussian_covariance"]


def shrink(cov, target, shrinkage_factor):
    """lambda * correlated-target + (1 - lambda) * cov, per key."""
    toward = impose_correlation(target, cov)
    return {
        key: replace(
            block,
            array=shrinkage_factor * toward[key].array
            + (1 - shrinkage_factor) * block.array,
        )
        for key, block in cov.items()
    }


def shrinkage_factor(cls1, target):
    """Optimal linear shrinkage factor lambda* from delete-1 samples.

    ``cls1`` maps sample labels to spectrum dicts; ``target`` is the
    (dict of) target covariance blocks.  Both are flattened to vectors /
    one matrix with :func:`~heracles_tpu_torch.utils.flatten`.
    """
    x = np.stack([flatten(sample) for sample in cls1.values()])
    n = len(x)
    d = x - x.mean(axis=0)

    s = (n - 1) ** 2 / n  # jackknife scaling of the deviation matrices
    wbar = (s / n) * (d.T @ d)  # mean W matrix
    w_diag = np.diag(wbar)
    cov_s = n / (n - 1) * wbar  # empirical covariance estimate S

    # covW moments via elementwise-power matmuls (see module docstring)
    c = n / (n - 1) ** 3
    var_w = c * (s**2 * ((d**2).T @ (d**2)) - n * wbar**2)
    m = c * (s**2 * ((d**3).T @ d) - n * w_diag[:, None] * wbar)
    ratio = np.sqrt(w_diag[None, :] / w_diag[:, None])  # sqrt(W_jj / W_ii)
    f = 0.5 * (ratio * m + ratio.T * m.T)

    t_mat = flatten(target) if not isinstance(target, np.ndarray) else target
    t_sd = np.sqrt(np.diag(t_mat))
    t_corr = t_mat / np.outer(t_sd, t_sd)

    s_sd = np.sqrt(np.diag(cov_s))
    numerator = var_w - t_corr * f
    denominator = (cov_s - t_corr * np.outer(s_sd, s_sd)) ** 2
    off = ~np.eye(len(cov_s), dtype=bool)
    return numerator[off].sum() / denominator[off].sum()


def gaussian_covariance(cls):
    """Diagonal Gaussian (Knox) covariance target from measured cls.

    cov[(pq),(st),l,l'] = delta_ll' * (C13[p,s] C24[q,t] + C14[p,t] C23[q,s])
    evaluated as one broadcast product over the spin components.
    """
    cls = add_to_Cls(cls, bias(cls))
    cov = {}
    for key1, key2 in itertools.combinations_with_replacement(cls.keys(), 2):
        a1, b1, i1, j1 = key1
        a2, b2, i2, j2 = key2
        (ell1,) = get_result_array(cls[key1], "ell")
        (ell2,) = get_result_array(cls[key2], "ell")
        cl1 = expand_spin0_dims(cls[key1])
        cl2 = expand_spin0_dims(cls[key2])
        c13 = np.asarray(expand_spin0_dims(get_cl((a1, a2, i1, i2), cls)))
        c24 = np.asarray(expand_spin0_dims(get_cl((b1, b2, j1, j2), cls)))
        c14 = np.asarray(expand_spin0_dims(get_cl((a1, b2, i1, j2), cls)))
        c23 = np.asarray(expand_spin0_dims(get_cl((b1, a2, j1, i2), cls)))
        nell = min(len(ell1), len(ell2))
        # r[p, q, s, t, l] by broadcasting the component axes
        r = (
            c13[:, None, :, None, :nell] * c24[None, :, None, :, :nell]
            + c14[:, None, None, :, :nell] * c23[None, :, :, None, :nell]
        )
        r = r[..., :, None] * np.eye(nell)
        result = Result(
            r, spin=(*cl1.spin, *cl2.spin), ell=(ell1, ell2), axis=(-2, -1)
        )
        cov[a1, b1, a2, b2, i1, j1, i2, j2] = squeeze_spin0_dims(result)
    return cov
