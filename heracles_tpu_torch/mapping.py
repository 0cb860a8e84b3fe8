"""Mapping orchestration: catalogues -> maps -> alms.

Counterpart of :mod:`heracles_tpu.mapping`:

* :func:`map_catalogs` — run every (field x catalogue) work item; items of
  one catalogue run concurrently on the cooperative scheduler so they
  share cached pages (``parallel=True`` flattens all groups into one);
  include/exclude filtering; results in a :class:`~heracles_tpu_torch.core.TocDict`
  keyed ``(field, catalog)``.
* :func:`transform` — per-map harmonic transform dispatch with
  spin-metadata fill-in and mismatch checking.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _scheduler as coroutines
from . import tracing
from .core import TocDict, toc_match, update_metadata
from .devicemap import DeviceMap
from .progress import NoProgress

__all__ = ["map_catalogs", "transform"]


async def _map_field(key, field, catalog, progress, task_done):
    label = "(" + ", ".join(map(str, key)) + ")"
    with progress.task(label) as task:
        result = await field(catalog, progress=task)
    task_done()
    return result


@tracing.spanned("mapping.map_catalogs")
def map_catalogs(
    fields,
    catalogs,
    *,
    parallel=False,
    out=None,
    include=None,
    exclude=None,
    progress=None,
):
    """Map a set of catalogues into fields; returns {(field, catalog): map}."""
    if out is None:
        out = TocDict()
    if progress is None:
        progress = NoProgress()

    groups = [
        [((i, j), field, catalog) for i, field in fields.items()]
        for j, catalog in catalogs.items()
    ]
    if parallel:
        groups = [sum(groups, [])]

    current, total = 0, sum(len(g) for g in groups)
    progress.update(0, total)

    def task_done():
        nonlocal current
        current += 1
        progress.update(current, total)

    for items in groups:
        keys, coros = [], []
        for key, field, catalog in items:
            if toc_match(key, include, exclude):
                keys.append(key)
                coros.append(_map_field(key, field, catalog, progress, task_done))
        try:
            results = coroutines.run(coroutines.gather(*coros))
        finally:
            for coro in coros:
                coro.close()
        for key, value in zip(keys, results):
            out[key] = value
        del results

    return out


@tracing.spanned("mapping.transform")
def transform(fields, data, *, out=None, progress=None, batch=8, mesh=None):
    """Transform maps to alms via each field's mapper.

    Fills in missing spin metadata from the field and raises on a
    mismatch.  Maps that share a mapper, spin, shape, dtype and device
    are stacked and transformed in groups of up to ``batch`` (the kernels
    take leading batch dims), capped so that a stack holds at most
    ``_STACK_BYTES`` (7e9) bytes of maps (:func:`_stack_size`): at nside
    4096, 8 float32 spin-0 maps, 4 float32 spin-2 or float64 spin-0
    maps.  Such a stack of 8 maps costs the card, above its inputs, the
    stack's copy (6.4 GB) and the ring analysis of 8 maps (its largest
    cap bucket's rows and FFT buffers, ~13 GB, and the 3.1 GB of ring
    spectra): ~20 GB in all; a smaller ``batch`` lowers it.  Per-map
    metadata is preserved on the batched path.  Every call of a mapper's
    ``transform`` is counted in ``tracing.TRANSFORM_STACKS``, by its
    number of maps.

    ``mesh``: a :class:`~heracles_tpu_torch.parallel.Mesh`.  A group
    whose mapper has ``transform_sharded`` then goes out whole, as one
    stack split over the mesh (even a group of one map); the alms come
    back on the mesh's first device, equal to the unsharded ones.
    """
    if out is None:
        out = TocDict()
    if progress is None:
        progress = NoProgress()

    # pass 1: validate, fill spins, collect work items in input order
    items = []
    for (k, i), m in data.items():
        try:
            field = fields[k]
        except KeyError:
            raise ValueError(f"unknown field name: {k}") from None
        spin = field.spin
        m_spin = (m.dtype.metadata or {}).get("spin")
        if m_spin is None:
            update_metadata(m, spin=spin)
        elif m_spin != spin:
            raise ValueError(
                f"spin mismatch for field {k!r}: "
                f"map has spin {m_spin}, field has spin {spin}"
            )
        items.append(((k, i), field, m))

    # pass 2: group compatible maps (same mapper object, spin, shape)
    groups = {}
    for idx, (key, field, m) in enumerate(items):
        mapper = field.mapper_or_error
        if ((mesh is not None or (batch and batch > 1))
                and getattr(mapper, "batched_transform", False)):
            dev = m.device if isinstance(m, DeviceMap) else None
            gkey = (id(mapper), field.spin, tuple(np.shape(m)),
                    np.dtype(m.dtype.str), dev)
        else:
            gkey = ("solo", idx)
        groups.setdefault(gkey, []).append(idx)

    # pass 3: transform per group (chunked stacks), emit in input order
    results = {}
    current, total = 0, len(items)
    progress.update(0, total)
    for gkey, idxs in groups.items():
        mapper = items[idxs[0]][1].mapper_or_error
        spin = items[idxs[0]][1].spin
        sharded = (mesh is not None and gkey[0] != "solo"
                   and hasattr(mapper, "transform_sharded"))
        first = items[idxs[0]][2]
        if sharded:
            step = len(idxs)
        elif gkey[0] == "solo":
            step = 1
        else:
            step = _stack_size(np.shape(first),
                               np.dtype(first.dtype.str).itemsize, batch)
        for start in range(0, len(idxs), step):
            chunk = idxs[start : start + step]
            labels = ", ".join(str(items[idx][0]) for idx in chunk)
            with progress.task(f"[{labels}]"):
                if not sharded:
                    tracing.TRANSFORM_STACKS[len(chunk)] += 1
                if len(chunk) == 1 and not sharded:
                    m = items[chunk[0]][2]
                    results[chunk[0]] = mapper.transform(m, spin=spin)
                else:
                    stack = _stack([items[idx][2] for idx in chunk])
                    if sharded:
                        alms = mapper.transform_sharded(
                            mesh, stack, spin=spin, metadata={"spin": spin})
                    else:
                        alms = mapper.transform(stack, spin=spin,
                                                metadata={"spin": spin})
                    for row, idx in enumerate(chunk):
                        alm = alms[row]
                        md = dict(items[idx][2].dtype.metadata or {})
                        update_metadata(alm, **{**md, **alms.metadata})
                        results[idx] = alm
            current += len(chunk)
            progress.update(current, total)

    for idx, (key, _, _) in enumerate(items):
        out[key] = results[idx]
    return out


# largest stack (bytes of maps) one batched transform takes: at nside
# 4096, 8 float32 spin-0 maps (6.44e9 bytes) and not 5 float32 spin-2
# maps (8.05e9), whose batch of 5 would run every kernel at nb 1
_STACK_BYTES = 7 * 10**9


def _stack_size(shape, itemsize, batch):
    """How many maps of ``shape`` and ``itemsize`` bytes one batched
    transform stacks: up to ``batch``, at most ``_STACK_BYTES`` together,
    at least one."""
    nbytes = max(1, int(np.prod(shape)) * int(itemsize))
    return max(1, min(batch, _STACK_BYTES // nbytes))


def _stack(maps):
    """Stack maps for one batched transform, on the device of device maps."""
    if all(isinstance(m, DeviceMap) for m in maps):
        return torch.stack([m.array for m in maps])
    stack = np.stack([np.asarray(m) for m in maps])
    return stack.view(np.dtype(stack.dtype.str))
