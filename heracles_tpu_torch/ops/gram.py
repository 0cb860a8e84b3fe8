"""Weighted Gram contraction in float64: the Hopper kernel and its dispatch.

Counterpart of :mod:`heracles_tpu.ops.df32`, whose Pallas kernel
(``_gram_kernel``) computes

    M[a, b] = sum_k A[k, a] u[k] B[k, b]

for the Gauss-Legendre quadrature of the mixing matrices.  That module is
named for its arithmetic: double-single, unevaluated (hi, lo) float32
pairs with Dekker products and compensated sums, which emulate float64 on
a chip that has only float32.  The H100 computes in native float64, so
this module keeps none of the emulation, and not its name either.

The tensor decides the path:

* a CPU tensor takes :func:`gram_plain`, a torch float64 matmul;
* a CUDA tensor launches the hand-written kernel
  (``heracles_tpu_torch/csrc/gram.cu``, built at first use by
  :mod:`._build`), or raises.

``LAUNCHES`` counts kernel launches and ``PLAIN_RUNS`` runs of the plain
version, both under the name ``"gram"``.
"""

from __future__ import annotations

import collections

import torch

__all__ = ["gram", "gram_plain", "LAUNCHES", "PLAIN_RUNS", "reset_counts"]

LAUNCHES = collections.Counter()
PLAIN_RUNS = collections.Counter()


def reset_counts():
    """Zero the kernel launch count and the plain-version run count."""
    LAUNCHES.clear()
    PLAIN_RUNS.clear()


def _check(A, B, u):
    for name, t, ndim in (("A", A, 2), ("B", B, 2), ("u", u, 1)):
        if t is None:
            continue
        if t.dtype != torch.float64:
            raise TypeError(f"gram: {name} must be float64, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"gram: {name} must have {ndim} dimensions, "
                             f"got shape {tuple(t.shape)}")
        if t.device != A.device:
            raise ValueError(f"gram: {name} is on {t.device}, A on {A.device}")
    K = A.shape[0]
    if B.shape[0] != K or (u is not None and u.shape[0] != K):
        raise ValueError(f"gram: node axes differ: A {tuple(A.shape)}, "
                         f"B {tuple(B.shape)}, u "
                         f"{None if u is None else tuple(u.shape)}")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gram: unsupported device {A.device}")


def gram_plain(A, B, u=None):
    """Plain version of :func:`gram` (same signature): ``A.T @ (u B)``."""
    PLAIN_RUNS["gram"] += 1
    Bu = B if u is None else B * u[:, None]
    return A.T @ Bu


def _launch(A, B, u):
    from . import _build

    kl = _build.load_library()
    K, L1 = A.shape
    L2 = B.shape[1]
    A = A.contiguous()
    B = B.contiguous()
    u = None if u is None else u.contiguous()
    M = torch.empty((L1, L2), dtype=torch.float64, device=A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = kl.lib.heracles_gram_f64(
            A.data_ptr(), B.data_ptr(), None if u is None else u.data_ptr(),
            M.data_ptr(), K, L1, L2, stream,
        )
    kl.check(err)
    LAUNCHES["gram"] += 1
    return M


def gram(A, B, u=None):
    """M[a, b] = sum_k A[k, a] u[k] B[k, b] in float64.

    ``A``: (K, L1), ``B``: (K, L2), ``u``: (K,) float64 tensors on one
    device; ``u=None`` is the unweighted product ``A.T @ B`` (the
    ``matmul_df32`` case of the TPU kernel).  Returns (L1, L2) float64 on
    the inputs' device.
    """
    _check(A, B, u)
    if A.device.type == "cpu":
        return gram_plain(A, B, u)
    return _launch(A, B, u)
