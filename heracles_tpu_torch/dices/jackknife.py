"""Delete-1/delete-2 jackknife spectra and covariances, on torch.

Counterpart of :mod:`heracles_tpu.dices.jackknife`:

* per-region alms are computed once from region-masked maps and cached
  (FITS files, restartable; in memory; or on the device);
* delete-k alms are formed by *alm subtraction* full - sum(regions),
  exploiting the linearity of the SHT;
* per-sample noise bias is rescaled by the sky-fraction ratio;
* footprint correction is "Fast" (divide by the fsky ratio) or "Full"
  (NaturalSpice with the mask-correlation ratio);
* the covariance is a centred outer product over samples with the
  delete-1 prefactor (njk-1)^2/njk or the delete-2 prefactor
  (njk(njk-1)-2)/(2 njk(njk+1));
* delete-2 debiasing builds the ensemble
  Q = njk*x0 - (njk-1)(x1_k + x1_k') + (njk-2) x2_kk', covariances it,
  and keeps only its diagonal.

Each full map is uploaded once to its mapper's device; each batch of
``region_batch`` region-masked maps is one product there and one batched
transform (one launch of the spin-0 or spin-pair analysis kernel per map
key and batch).  In device mode every region's alms stay on the device
and the delete-k samples are assembled there, one gather-subtract per
key, so only the float64 spectra grids come back to the host.  The FITS
cache files are those of :mod:`heracles_tpu.dices`: a directory that one
package half filled is finished by the other.  Spectra, covariances and
their corrections are host float64 :class:`~heracles_tpu_torch.result.Result`
dicts.
"""

from __future__ import annotations

import itertools
import os
from copy import deepcopy
from dataclasses import replace
from itertools import combinations

import numpy as np
import torch

from ..convert import to_torch
from ..core import update_metadata
from ..devicemap import DeviceMap
from ..io import read, read_alms, write, write_alms
from ..mapping import transform
from ..progress import NoProgress
from ..result import Result, binned, get_result_array
from ..transforms import cl2corr, corr2cl
from ..twopoint import (
    _fields_device,
    angular_power_spectra,
    angular_power_spectra_sample_stacks,
    angular_power_spectra_samples,
)
from ..unmixing import _naturalspice
from ..utils import add_to_Cls, sub_to_Cls

__all__ = [
    "jackknife_cls",
    "compute_jk_alms",
    "compute_jk_cls_from_alms",
    "jackknife_fsky",
    "jackknife_bias",
    "correct_bias",
    "correct_footprint_fsky",
    "correct_footprint_naturalspice",
    "jackknife_covariance",
    "sample_covariance",
    "delete2_correction",
    "debias_covariance",
]


def _labels(jk_map):
    """The region map as a host numpy array (labels 1..njk, 0 outside)."""
    if isinstance(jk_map, DeviceMap):
        jk_map = jk_map.array
    if isinstance(jk_map, torch.Tensor):
        return jk_map.detach().cpu().numpy()
    return np.asarray(jk_map)


def _n_regions(jk_map):
    labels = np.unique(_labels(jk_map))
    return len(labels[labels != 0])


def jackknife_cls(
    data_maps,
    vis_maps,
    jk_map,
    fields,
    mask_correction="Fast",
    unmixed=False,
    nd=1,
    dir="./dices",
    progress=None,
):
    """Spectra of all delete-``nd`` jackknife samples (cached to ``dir``).

    ``dir=None`` selects the in-memory mode (no FITS caches); the default
    keeps the restartable file cache.
    """
    if progress is None:
        progress = NoProgress()
    alms_cache = compute_jk_alms(data_maps, vis_maps, jk_map, fields, dir=dir,
                                 progress=progress)
    return compute_jk_cls_from_alms(
        jk_map,
        fields,
        mask_correction=mask_correction,
        unmixed=unmixed,
        nd=nd,
        dir=dir,
        progress=progress,
        alms_cache=alms_cache,
    )


def _assemble_deletek(full_a, R_a, idx):
    """Delete-k alms on the device, by the linearity of the SHT: the full
    alms minus the sum of the deleted regions' (``idx``: (S, nd) region
    rows of ``R_a``)."""
    return full_a[None] - R_a[idx].sum(dim=1)


def _device_cache_budget():
    """Device budget (bytes) for the DICES device alm cache (default 4 GiB;
    HERACLES_TPU_DICES_DEVICE_BYTES overrides)."""
    return int(os.environ.get("HERACLES_TPU_DICES_DEVICE_BYTES",
                              4 * 1024**3))


def _estimate_alm_bytes(data_maps, vis_maps, fields, njk):
    """Estimated device bytes of a full per-region alm cache."""
    total = 0
    for key in list(data_maps) + list(vis_maps):
        field = fields[key[0]]
        mapper = field.mapper_or_error
        lmax = mapper.lmax
        nlm = (lmax + 1) * (lmax + 2) // 2
        planes = 2 if abs(field.spin) == 2 else 1
        # complex alms of the mapper's precision (complex64 by default)
        dtype = getattr(mapper, "dtype", torch.float32)
        total += planes * nlm * 2 * torch.empty((), dtype=dtype).element_size()
    return (njk + 1) * total


def compute_jk_alms(data_maps, vis_maps, jk_map, fields, dir="./dices",
                    progress=None, region_batch=8, device_cache=None):
    """Compute and cache the alms of every jackknife region (and the full sky).

    Regions are processed in batches of ``region_batch``: the
    region-masked maps of a batch are one product on the maps' device and
    one batched transform.  In file mode (``dir`` given) each region's
    alms are written to ``{dir}/data_alms_{k}.fits`` and
    ``{dir}/vis_alms_{k}.fits``, a region whose files exist is skipped,
    and the transform of batch k+1 is dispatched before batch k's alms
    are copied back and written (``transform_async``).  ``region_batch=1``
    transforms one region at a time through
    :func:`~heracles_tpu_torch.mapping.transform`.

    ``device_cache``: keep every region's alms on the device
    (:class:`DeviceMap` values); the spectra stage then assembles the
    delete-k samples there too.  Requires ``dir=None`` and the batched
    path.  Default (None): on when ``dir`` is None, the path is batched and
    the estimated cache fits :func:`_device_cache_budget`.  Returns the
    alms computed here, keyed ``(name, k)`` with name "data" or "vis".
    """
    if progress is None:
        progress = NoProgress()
    if dir is not None:
        os.makedirs(dir, exist_ok=True)
    jk_map = _labels(jk_map)
    njk = _n_regions(jk_map)
    progress.update(0, njk + 1)
    cache = {}
    batched_ok = region_batch > 1 and all(
        getattr(fields[key[0]].mapper_or_error, "batched_transform", False)
        for key in list(data_maps) + list(vis_maps)
    )
    if device_cache:
        if dir is not None:
            raise ValueError(
                "device_cache=True requires dir=None (the device cache "
                "replaces the FITS checkpoints)"
            )
        if not batched_ok:
            raise ValueError(
                "device_cache requires the batched path (region_batch > 1, "
                "batched-transform mappers)"
            )
        resident = True
    elif device_cache is None:
        resident = (
            dir is None and batched_ok
            and _estimate_alm_bytes(data_maps, vis_maps, fields, njk)
            <= _device_cache_budget()
        )
    else:
        resident = False
    if not batched_ok:
        for k in range(njk + 1):
            with progress.task(f"ALMs {k}"):
                _compute_single_jk_alm(k, data_maps, vis_maps, jk_map, fields,
                                       dir, cache=cache)
            progress.update(k + 1, njk + 1)
        return cache
    pending = [
        k
        for k in range(1, njk + 1)
        if dir is None or not (
            os.path.exists(os.path.join(dir, f"data_alms_{k}.fits"))
            and os.path.exists(os.path.join(dir, f"vis_alms_{k}.fits"))
        )
    ]
    if pending or resident:
        dev_data = _device_region_maps(data_maps, fields)
        dev_vis = _device_region_maps(vis_maps, fields)
        first = next(iter(dev_data.values()))[0]
        # labels compare in the maps' dtype (exact up to 2^24 in float32)
        jk_dev = torch.as_tensor(jk_map, dtype=first.dtype, device=first.device)
        device_state = (dev_data, dev_vis, jk_dev)
    # full-footprint alms (k = 0)
    with progress.task("ALMs 0"):
        if resident:
            for name, dev_maps in (("data", dev_data), ("vis", dev_vis)):
                cache[name, 0] = {
                    key: fields[key[0]].mapper_or_error.transform_resident(
                        arr, spin=fields[key[0]].spin, metadata=md)
                    for key, (arr, md) in dev_maps.items()
                }
        else:
            _compute_single_jk_alm(0, data_maps, vis_maps, jk_map, fields,
                                   dir, cache=cache)
    progress.update(1, njk + 1)
    done = njk - len(pending)
    progress.update(1 + done, njk + 1)
    if not pending:
        return cache
    # dispatch batch k+1's transforms (the copies of batch k already in
    # flight) before finishing batch k, so that one batch's readback
    # overlaps the next batch's kernels; in device mode the finishers
    # only slice the batched alms
    prev_finish = None
    for start in range(0, len(pending), region_batch):
        ks = pending[start : start + region_batch]
        with progress.task(f"ALMs {ks[0]}..{ks[-1]}"):
            fin = _dispatch_batched_jk_alms(ks, fields, dir, device_state,
                                            cache, resident)
            if prev_finish is not None:
                prev_finish()
                done += prev_len
                progress.update(1 + done, njk + 1)
            prev_finish, prev_len = fin, len(ks)
    if prev_finish is not None:
        prev_finish()
        done += prev_len
        progress.update(1 + done, njk + 1)
    return cache


def _masked_stack(arr, jk_dev, ks_arr):
    """(len(ks), ...) stack of ``arr`` masked to each region label in
    ``ks_arr``: one product on the device, masks in the map's dtype."""
    masks = (jk_dev[None, :] == ks_arr[:, None]).to(arr.dtype)
    shape = masks.shape[:1] + (1,) * (arr.ndim - 1) + masks.shape[-1:]
    return arr[None, ...] * masks.reshape(shape)


def _device_region_maps(maps, fields):
    """Upload each full map once: {key: (tensor, metadata)}.

    A DeviceMap stays where it is; a numpy map goes to its field's mapper
    device in its own precision.  The region-masked stacks are then
    products on the device and never exist on the host.
    """
    out = {}
    for key, m in maps.items():
        if isinstance(m, DeviceMap):
            out[key] = (m.array, m.metadata)
            continue
        md = dict(getattr(m.dtype, "metadata", None) or {})
        arr = np.asarray(m)
        arr = np.ascontiguousarray(arr, dtype=np.dtype(arr.dtype.str))
        device = fields[key[0]].mapper_or_error.device
        out[key] = (torch.as_tensor(arr, device=device), md)
    return out


def _dispatch_batched_jk_alms(ks, fields, dir, device_state, cache,
                              resident):
    """Dispatch one batched transform per map key over the maps of
    ``device_state`` masked to the regions ``ks``.

    Returns a zero-argument *finisher*.  With ``resident`` it slices the
    batched alms into per-region DeviceMap cache entries; otherwise the
    transforms were dispatched with :meth:`transform_async` and it waits
    for the host alms and writes the per-region FITS caches.
    """
    dev_data, dev_vis, jk_dev = device_state
    ks_arr = torch.as_tensor(np.asarray(ks, np.float32), dtype=jk_dev.dtype,
                             device=jk_dev.device)

    def batched(dev_maps, method):
        out = {}
        for key, (arr, md) in dev_maps.items():
            field = fields[key[0]]
            stacked = _masked_stack(arr, jk_dev.to(arr.device),
                                    ks_arr.to(arr.device))
            out[key] = getattr(field.mapper_or_error, method)(
                stacked, spin=field.spin, metadata=md)
        return out

    if resident:
        data_res = batched(dev_data, "transform_resident")
        vis_res = batched(dev_vis, "transform_resident")

        def finish():
            for i, k in enumerate(ks):
                for res, name in ((data_res, "data"), (vis_res, "vis")):
                    cache[name, k] = {key: dm[i] for key, dm in res.items()}

        return finish

    data_handles = batched(dev_data, "transform_async")
    vis_handles = batched(dev_vis, "transform_async")

    def finish():
        data_batched = {key: h() for key, h in data_handles.items()}
        vis_batched = {key: h() for key, h in vis_handles.items()}
        _store_batched_jk_alms(ks, data_batched, vis_batched, dir, cache)

    return finish


def _store_batched_jk_alms(ks, data_batched, vis_batched, dir, cache):
    for i, k in enumerate(ks):
        for batched, name in ((data_batched, "data"), (vis_batched, "vis")):
            alms = {}
            for key, stack_alm in batched.items():
                alm = np.ascontiguousarray(stack_alm[i])
                update_metadata(alm, **dict(stack_alm.dtype.metadata or {}))
                alms[key] = alm
            if dir is not None:
                write_alms(os.path.join(dir, f"{name}_alms_{k}.fits"), alms,
                           clobber=True)
            cache[name, k] = alms


def _compute_single_jk_alm(k, data_maps, vis_maps, jk_map, fields, dir,
                           cache):
    """Region k's alms (k = 0: the full footprint) through ``transform``,
    as host numpy arrays with their metadata; skipped where ``dir`` holds
    them."""
    if dir is not None:
        data_path = os.path.join(dir, f"data_alms_{k}.fits")
        vis_path = os.path.join(dir, f"vis_alms_{k}.fits")
        if os.path.exists(data_path) and os.path.exists(vis_path):
            return
    if k == 0:
        data, vis = data_maps, vis_maps
    else:
        data = _get_region_maps(data_maps, jk_map, k)
        vis = _get_region_maps(vis_maps, jk_map, k)
    data_alms = {key: np.asarray(a) for key, a in transform(fields, data).items()}
    vis_alms = {key: np.asarray(a) for key, a in transform(fields, vis).items()}
    if dir is not None:
        write_alms(data_path, data_alms, clobber=True)
        write_alms(vis_path, vis_alms, clobber=True)
    cache["data", k] = data_alms
    cache["vis", k] = vis_alms


def compute_jk_cls_from_alms(
    jk_map,
    fields,
    mask_correction="Fast",
    unmixed=False,
    nd=1,
    dir="./dices",
    progress=None,
    sample_batch=16,
    alms_cache=None,
):
    """Spectra of every delete-``nd`` region combination from cached alms.

    Samples are processed ``sample_batch`` at a time: the delete-k alm
    sets stack over a leading sample axis and every sample's pair grid
    computes in one batched contraction
    (:func:`~heracles_tpu_torch.twopoint.angular_power_spectra_sample_stacks`).
    In device mode (DeviceMap alms in ``alms_cache``) the samples are
    assembled on the device; otherwise on the host, and the grids run on
    the fields' mapper device.  With ``dir`` each sample's spectra are
    cached in ``cls_{regions}_unmixed_{unmixed}.fits`` and read back from
    there when present.
    """
    cache = alms_cache or {}
    jk_map = _labels(jk_map)

    def _load_alms(name, k):
        alms = cache.get((name, k))
        if alms is None:
            if dir is None:
                raise KeyError(
                    f"alms ({name}, {k}) not in alms_cache and dir=None "
                    "(in-memory mode has no FITS fallback)"
                )
            alms = read_alms(os.path.join(dir, f"{name}_alms_{k}.fits"))
        return alms

    if nd == 0:
        return {(): angular_power_spectra(_load_alms("data", 0))}
    if nd < 1 or nd > 2:
        raise ValueError("number of deletions must be 1 or 2")
    if mask_correction not in ("Fast", "Full"):
        raise ValueError("mask_correction must be 'Fast' or 'Full'")
    if progress is None:
        progress = NoProgress()

    njk = _n_regions(jk_map)
    all_regions = list(combinations(range(1, njk + 1), nd))
    cls = {}
    progress.update(0, len(all_regions))

    def tag_path(regions):
        tag = "_".join(map(str, regions))
        return os.path.join(dir, f"cls_{tag}_unmixed_{unmixed}.fits")

    if dir is None:
        pending = list(all_regions)
    else:
        pending = [r for r in all_regions if not os.path.exists(tag_path(r))]
        for regions in all_regions:
            if regions not in pending:
                cls[regions] = read(tag_path(regions))
    done = len(all_regions) - len(pending)
    progress.update(done, len(all_regions))
    if not pending:
        return cls

    full = {name: _load_alms(name, 0) for name in ("data", "vis")}
    mls0 = (angular_power_spectra(full["vis"])
            if mask_correction == "Full" else None)
    names = ("data", "vis") if mask_correction == "Full" else ("data",)

    if any(isinstance(v, DeviceMap) for v in full["data"].values()):
        # device mode: per-key region stacks on the device once, then one
        # gather-subtract per key and batch
        regions_on_device = {
            name: {key: torch.stack([_load_alms(name, r)[key].array
                                     for r in range(1, njk + 1)])
                   for key in full[name]}
            for name in names
        }

        def samples(name, batch):
            alms, R = full[name], regions_on_device[name]
            dev = next(iter(alms.values())).device
            idx = torch.as_tensor(np.asarray(batch, np.int64) - 1, device=dev)
            stacks = {key: _assemble_deletek(alms[key].array, R[key], idx)
                      for key in alms}
            md = {key: alms[key].metadata for key in alms}
            return angular_power_spectra_sample_stacks(stacks, md, len(batch))
    else:
        device = _fields_device(fields.values())

        def samples(name, batch):
            # linearity of the SHT: delete-k = full - sum of regions, on
            # the host; the grids on the fields' device
            alm_sets = [
                _subtract_alms(full[name], _accumulate_alms(
                    _load_alms(name, r) for r in regions))
                for regions in batch
            ]
            return angular_power_spectra_samples(
                [to_torch(alms, device) for alms in alm_sets])

    step = max(1, sample_batch)
    for start in range(0, len(pending), step):
        batch = pending[start : start + step]
        with progress.task(f"Cls {batch[0]}..{batch[-1]}"):
            cls_samples = samples("data", batch)
            if mask_correction == "Full":
                mm_samples = samples("vis", batch)
            for i, regions in enumerate(batch):
                cls_jk = correct_bias(cls_samples[i], jk_map, fields, *regions)
                if mask_correction == "Full":
                    cls_jk = correct_footprint_naturalspice(
                        cls_jk, mm_samples[i], mls0, fields, unmixed=unmixed
                    )
                else:
                    cls_jk = correct_footprint_fsky(
                        cls_jk, jk_map, *regions, unmixed=unmixed
                    )
                if dir is not None:
                    write(tag_path(regions), cls_jk, clobber=True)
                cls[regions] = cls_jk
        done += len(batch)
        progress.update(done, len(all_regions))
    return cls


def _get_region_maps(maps, jk_map, jk):
    """Zero out all pixels outside jackknife region ``jk``."""
    out = deepcopy(maps)
    mask = (_labels(jk_map) == float(jk)).astype(int)
    for key in maps.keys():
        out[key] *= mask
    return out


def _copy(alm):
    """An alm array that owns its data: numpy ``copy``, tensor ``clone``."""
    if isinstance(alm, DeviceMap):
        return DeviceMap(alm.array.clone(), dtype=alm.dtype)
    if isinstance(alm, torch.Tensor):
        return alm.clone()
    return alm.copy()


def _accumulate_alms(alm_sets):
    """Sum already-loaded alm sets, one at a time."""
    total = None
    for alms in alm_sets:
        if total is None:
            total = {key: _copy(arr) for key, arr in alms.items()}
        else:
            for key in total:
                total[key] += alms[key]
    return total


def _subtract_alms(full_alms, region_sum):
    out = {}
    for key in full_alms:
        out[key] = _copy(full_alms[key])
        if region_sum is not None:
            out[key] -= region_sum[key]
    return out


def bias(cls):
    """Per-key noise bias read back from the cl metadata."""
    return {
        key: (cls[key].dtype.metadata or {}).get("bias", 0) for key in cls.keys()
    }


def jackknife_fsky(jk_map, jk=0, jk2=0, ratio=True):
    """Sky fraction after deleting (up to) two regions.

    With ``ratio=True`` (default) relative to the full footprint.
    """
    jk_map = _labels(jk_map)
    mask = (jk_map > 0).astype(int)
    fsky = mask.sum() / mask.size
    keep = (mask == 1) & (jk_map != jk) & (jk_map != jk2)
    fskyjk = keep.sum() / mask.size
    return fskyjk / fsky if ratio else fskyjk


def jackknife_bias(bias, fsky, fields):
    """Rescale each bias by the delete-region sky fraction ratio."""
    return {key: value * fsky for key, value in bias.items()}


def correct_bias(cls, jk_map, fields, jk=0, jk2=0):
    """Swap the full-footprint bias for the jackknife-footprint bias.

    Adds back the bias subtracted during ``angular_power_spectra`` and
    subtracts the fsky-rescaled one, updating the metadata accordingly.
    """
    b = bias(cls)
    fskyjk = jackknife_fsky(jk_map, jk=jk, jk2=jk2)
    b_jk = jackknife_bias(b, fskyjk, fields)
    cls = add_to_Cls(cls, b)
    cls = sub_to_Cls(cls, b_jk)
    out = {}
    for key in cls.keys():
        arr = cls[key].array
        update_metadata(arr, bias=b_jk[key])
        out[key] = replace(cls[key], array=arr)
    return out


def correct_footprint_fsky(cls, jk_map, jk=0, jk2=0, unmixed=False):
    """"Fast" footprint correction: divide by the deleted-sky fraction."""
    fskyjk = jackknife_fsky(jk_map, jk=jk, jk2=jk2, ratio=not unmixed)
    return {
        key: replace(value, array=value.array / fskyjk)
        for key, value in cls.items()
    }


def _mask_correlation_ratio(mljk, mls0, unmixed=False):
    """alpha = xi_mask_jk / xi_mask_full at the quadrature nodes."""
    alphas = {}
    wmls0 = cl2corr(mls0)
    wmljk = cl2corr(mljk)
    for key in wmljk.keys():
        alpha = wmljk[key].array
        if not unmixed:
            alpha = alpha / wmls0[key].array
        alphas[key] = replace(mls0[key], array=alpha)
    return alphas


def correct_footprint_naturalspice(cls, cls_mm, mls0, fields, unmixed=False):
    """"Full" footprint correction: NaturalSpice with the mask ratio."""
    alphas = _mask_correlation_ratio(cls_mm, mls0, unmixed=unmixed)
    first_cls = next(iter(cls.values()))
    first_mls = next(iter(mls0.values()))
    lmax = first_cls.shape[first_cls.axis[0]]
    lmax_mask = first_mls.shape[first_mls.axis[0]]
    cls = binned(cls, np.arange(0, lmax_mask + 1))
    wcls = _naturalspice(cl2corr(cls), alphas, fields)
    return binned(corr2cl(wcls), np.arange(0, lmax + 1))


def _delete_count_prefactor(m, nd):
    """Unbiased-covariance prefactor for a delete-``nd`` sample ensemble.

    ``m`` is the ensemble size: njk samples for delete-1, njk-choose-2
    for delete-2 (inverted via the quadratic formula).
    """
    if nd == 1:
        return (m - 1) ** 2 / m
    if nd == 2:
        njk = (1 + np.sqrt(1 + 8 * m)) / 2
        return (njk * (njk - 1) - 2) / (2 * njk * (njk + 1))
    raise ValueError("number of deletions must be 1 or 2")


def _stacked_covariance(stacks, template, nd):
    """Jackknife covariance blocks from per-key sample stacks.

    ``stacks`` maps each 4-tuple spectra key to an (m, ...) array of
    samples; ``template`` supplies the per-key spin/axis/ell metadata.
    Every key pair produces one covariance Result whose trailing axes are
    the ell axes of both halves, in that order.
    """
    cov = {}
    for key1, key2 in itertools.combinations_with_replacement(stacks, 2):
        stack1, stack2 = stacks[key1], stacks[key2]
        if len(stack1) <= 1:
            continue
        block = _delete_count_prefactor(len(stack1), nd) * sample_covariance(
            stack1, stack2
        )
        r1, r2 = template[key1], template[key2]
        src = r1.axis + tuple(r1.ndim + ax for ax in r2.axis)
        dst = tuple(range(-len(src), 0))
        cov[key1[0], key1[1], key2[0], key2[1],
            key1[2], key1[3], key2[2], key2[3]] = Result(
            np.moveaxis(block, src, dst),
            axis=dst,
            spin=(*r1.spin, *r2.spin),
            ell=get_result_array(r1, "ell") + get_result_array(r2, "ell"),
        )
    return cov


def jackknife_covariance(samples, nd=1):
    """Jackknife covariance of a dict of per-sample spectra dicts."""
    samples = list(samples.values())
    template = samples[0]
    stacks = {
        key: np.stack([np.asarray(s[key]) for s in samples])
        for key in template
    }
    return _stacked_covariance(stacks, template, nd)


def sample_covariance(samples, samples2=None):
    """Sample covariance / cross-covariance over the leading axis.

    One two-pass centred matmul over the flattened feature axes; the
    result has the feature shape of ``samples`` followed by that of
    ``samples2``.
    """
    x = np.asarray(samples)
    y = x if samples2 is None else np.asarray(samples2)
    n = len(x)
    if len(y) != n:
        raise ValueError("different numbers of samples")
    xc = (x - x.mean(axis=0)).reshape(n, -1)
    yc = (y - y.mean(axis=0)).reshape(n, -1)
    return (xc.T @ yc).reshape(x.shape[1:] + y.shape[1:]) / (n - 1)


def delete2_correction(cls0, cls1, cls2):
    """Delete-2 debiasing ensemble, diagonalised.

    Q ensemble members: njk*x0 - (njk-1)(x1_k + x1_k') + (njk-2)*x2_kk'
    over all delete-2 pairs; the correction is their (delete-2
    prefactored) covariance with only the ell-diagonal kept.
    """
    njk = len(cls1)
    pairs = list(cls2)
    stacks = {}
    for key, block in cls0.items():
        x0 = np.asarray(block.array)
        x1 = np.stack(
            [np.asarray(cls1[(k,)][key].array) for pair in pairs for k in pair]
        ).reshape((len(pairs), 2) + x0.shape)
        x2 = np.stack([np.asarray(cls2[pair][key].array) for pair in pairs])
        stacks[key] = njk * x0 - (njk - 1) * x1.sum(axis=1) + (njk - 2) * x2
    corr = _stacked_covariance(stacks, cls0, nd=2)
    for key, block in corr.items():
        q = np.asarray(block)
        corr[key] = replace(block, array=q * np.eye(q.shape[-1]))
    return corr


def debias_covariance(cov_jk, cls0, cls1, cls2):
    """Subtract the delete-2 correction from the delete-1 covariance."""
    correction = delete2_correction(cls0, cls1, cls2)
    return {
        key: replace(block, array=block.array - correction[key].array)
        for key, block in cov_jk.items()
    }
