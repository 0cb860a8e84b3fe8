"""The port's DICES jackknife against heracles_tpu.dices, on the CPU.

Positions + shear + visibility maps at nside 8, lmax 8, 3 regions: the
same seeded numpy maps go through both packages in float64
(``deconvolve=False``: the port has no exact pixel window at nside <= 32
yet).  The reference runs once per module (it compiles every transform
anew); the port runs in its three modes (FITS files, in memory, device
cache) and each delete-``nd`` sample's spectra, their bias metadata, the
covariances, the delete-2 correction and the shrinkage are held to the
reference's to 1e-10 relative.  FITS caches that one package half filled
are finished by the other.
"""

import copy
import os
import shutil
from dataclasses import replace

import numpy as np
import pytest
import torch

import heracles_tpu as jh
import heracles_tpu.dices as jdices
import heracles_tpu_torch as th
import heracles_tpu_torch.dices as tdices
from heracles_tpu_torch.dices import jackknife as tjk

NSIDE, LMAX, NJK = 8, 8, 3
RTOL = 1e-10
MODES = ("file", "memory", "device")
CORRECTIONS = ("Fast", "Full")


def _close(got, want, what):
    dtype = np.complex128 if np.iscomplexobj(want) else np.float64
    got, want = np.asarray(got, dtype), np.asarray(want, dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    # the shrunk cross blocks hold NaN where a cross-covariance diagonal is
    # negative, in both packages: NaN must meet NaN
    scale = max(np.nanmax(np.abs(want)), 1e-300)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=str(what))


def _setup(pkg, device=None):
    kw = {} if device is None else {"device": device}
    mapper = pkg.HealpixMapper(NSIDE, LMAX, deconvolve=False, **kw)
    fields = {
        "POS": pkg.Positions(mapper, "RA", "DEC", mask="VIS"),
        "SHE": pkg.Spin2Field(mapper, "RA", "DEC", "G1", "G2", mask="VIS"),
        "VIS": pkg.Visibility(mapper),
    }
    rng = np.random.default_rng(42)
    npix = 12 * NSIDE**2
    pos = mapper.create(spin=0)
    pos[:] = rng.normal(size=npix)
    pkg.update_metadata(pos, fsky=1.0, musq=1.0, dens=100.0)
    she = mapper.create(2, spin=2)
    she[:] = rng.normal(size=(2, npix))
    pkg.update_metadata(she, fsky=1.0, musq=1.0, dens=100.0)
    vis = mapper.create(spin=0)
    vis[:] = 1.0
    pkg.update_metadata(vis, fsky=1.0)
    jk = np.zeros(npix)
    edges = np.linspace(0, npix, NJK + 1).astype(int)
    for k in range(NJK):
        jk[edges[k] : edges[k + 1]] = k + 1
    return fields, {("POS", 0): pos, ("SHE", 0): she}, {("VIS", 0): vis}, jk


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's alms (file mode) and spectra for every nd and
    correction; nd=1 "Fast" also leaves its cls files in the directory."""
    fields, data, vis, jk = _setup(jh)
    d = str(tmp_path_factory.mktemp("ref") / "dices")
    alms = jdices.compute_jk_alms(data, vis, jk, fields, dir=d)
    cls = {}
    for nd in (0, 1, 2):
        for mc in CORRECTIONS:
            cls[nd, mc] = jdices.jackknife.compute_jk_cls_from_alms(
                jk, fields, mask_correction=mc, nd=nd,
                dir=d if (nd, mc) == (1, "Fast") else None, alms_cache=alms)
    return dict(fields=fields, data=data, vis=vis, jk=jk, dir=d, alms=alms,
                cls=cls)


@pytest.fixture(scope="module")
def port(ref, tmp_path_factory):
    """The port's spectra in each mode, from numpy maps (file and memory
    modes) or from the port's own DeviceMaps (device mode)."""
    out = {}
    for mode in MODES:
        if mode == "device":
            fields, data, vis, jk = _setup(th, device="cpu")
        else:
            fields, data, vis, jk = _setup(th, device="cpu")
            data = copy.deepcopy(ref["data"])
            vis = copy.deepcopy(ref["vis"])
        for mc in CORRECTIONS:
            d = (str(tmp_path_factory.mktemp(f"port_{mode}_{mc}") / "dices")
                 if mode == "file" else None)
            alms = tdices.compute_jk_alms(
                data, vis, jk, fields, dir=d,
                device_cache=False if mode == "memory" else None)
            for nd in (0, 1, 2):
                # file mode reads its alms back from the FITS caches
                out[mode, nd, mc] = tjk.compute_jk_cls_from_alms(
                    jk, fields, mask_correction=mc, nd=nd, dir=d,
                    alms_cache=None if mode == "file" else alms)
            out[mode, "alms", mc] = alms
            out[mode, "dir", mc] = d
    out["fields"] = fields
    return out


def _same_samples(got, want):
    assert set(got) == set(want)
    for regions in want:
        assert set(got[regions]) == set(want[regions]), regions
        for key, w in want[regions].items():
            g = got[regions][key]
            assert g.spin == w.spin and g.axis == w.axis, (regions, key)
            _close(g.array, w.array, (regions, key))
            gb = (g.array.dtype.metadata or {}).get("bias")
            wb = (w.array.dtype.metadata or {}).get("bias")
            assert (gb is None) == (wb is None), (regions, key, gb, wb)
            if wb is not None:
                assert gb == pytest.approx(wb, rel=RTOL), (regions, key)


@pytest.mark.parametrize("mc", CORRECTIONS)
@pytest.mark.parametrize("nd", (0, 1, 2))
@pytest.mark.parametrize("mode", MODES)
def test_samples_match_reference(ref, port, mode, nd, mc):
    """Every delete-nd sample's spectra and bias, in every mode."""
    _same_samples(port[mode, nd, mc], ref["cls"][nd, mc])


def test_modes_keep_their_alms(port):
    """Memory mode keeps host numpy alms, device mode DeviceMaps."""
    for mc in CORRECTIONS:
        mem, dev = port["memory", "alms", mc], port["device", "alms", mc]
        assert set(mem) == set(dev) == {(n, k) for n in ("data", "vis")
                                        for k in range(NJK + 1)}
        assert all(isinstance(a, np.ndarray) for v in mem.values()
                   for a in v.values())
        assert all(isinstance(a, th.DeviceMap) for v in dev.values()
                   for a in v.values())
        for key, alm in dev["data", 2].items():
            md = alm.metadata
            assert md["spin"] == (2 if key[0] == "SHE" else 0)
            assert (md["fsky"], md["musq"], md["dens"]) == (1.0, 1.0, 100.0)
            assert (md["nside"], md["lmax"], md["deconv"]) == (NSIDE, LMAX, False)
            _close(np.asarray(alm), mem["data", 2][key], key)


@pytest.mark.parametrize("nd", (1, 2))
@pytest.mark.parametrize("mode", MODES)
def test_covariance_matches_reference(ref, port, mode, nd):
    got = tdices.jackknife_covariance(port[mode, nd, "Fast"], nd=nd)
    want = jdices.jackknife_covariance(ref["cls"][nd, "Fast"], nd=nd)
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].spin == w.spin and got[key].axis == w.axis
        _close(got[key].array, w.array, key)
    if nd == 1:
        # oracle: the prefactored np.cov of the samples
        key = ("POS", "POS", "POS", "POS", 0, 0, 0, 0)
        samples = np.stack([np.asarray(c["POS", "POS", 0, 0])
                            for c in port[mode, 1, "Fast"].values()])
        _close(got[key].array,
               np.cov(samples.T, bias=False) * (NJK - 1) ** 2 / NJK, key)


@pytest.mark.parametrize("mode", MODES)
def test_delete2_and_debias_match_reference(ref, port, mode):
    args = [port[mode, nd, "Fast"] for nd in (0, 1, 2)]
    args[0] = args[0][()]
    rargs = [ref["cls"][nd, "Fast"] for nd in (0, 1, 2)]
    rargs[0] = rargs[0][()]
    got = tdices.delete2_correction(*args)
    want = jdices.delete2_correction(*rargs)
    for key, w in want.items():
        q = np.asarray(got[key])
        _close(q, w.array, key)
        off = ~np.eye(q.shape[-1], dtype=bool)
        np.testing.assert_array_equal(q[..., off], 0.0)
    cov = tdices.jackknife_covariance(args[1])
    deb = tdices.debias_covariance(cov, *args)
    rdeb = jdices.debias_covariance(jdices.jackknife_covariance(rargs[1]),
                                    *rargs)
    for key, w in rdeb.items():
        _close(deb[key].array, w.array, key)


def _from_l2(cls):
    """Spectra from l = 2: the spin-2 rows below are zero, and a zero
    variance leaves the shrinkage factor undefined in both packages."""
    return {key: replace(r, array=np.asarray(r.array)[..., 2:],
                         ell=np.arange(2, LMAX + 1))
            for key, r in cls.items()}


@pytest.mark.parametrize("mode", MODES)
def test_shrinkage_matches_reference(ref, port, mode):
    target = tdices.gaussian_covariance(port[mode, 0, "Fast"][()])
    rtarget = jdices.gaussian_covariance(ref["cls"][0, "Fast"][()])
    assert set(target) == set(rtarget)
    for key, w in rtarget.items():
        assert target[key].spin == w.spin
        _close(target[key].array, w.array, key)

    cls0 = _from_l2(port[mode, 0, "Fast"][()])
    cls1 = {r: _from_l2(c) for r, c in port[mode, 1, "Fast"].items()}
    rcls0 = _from_l2(ref["cls"][0, "Fast"][()])
    rcls1 = {r: _from_l2(c) for r, c in ref["cls"][1, "Fast"].items()}
    target = tdices.gaussian_covariance(cls0)
    rtarget = jdices.gaussian_covariance(rcls0)
    lam = tdices.shrinkage_factor(cls1, target)
    rlam = jdices.shrinkage_factor(rcls1, rtarget)
    assert np.isfinite(rlam)
    assert lam == pytest.approx(rlam, rel=RTOL)
    # the cross blocks' negative variances give NaN in both packages
    with np.errstate(invalid="ignore"):
        shrunk = tdices.shrink(tdices.jackknife_covariance(cls1), target, lam)
        rshrunk = jdices.shrink(jdices.jackknife_covariance(rcls1), rtarget,
                                rlam)
    for key, w in rshrunk.items():
        _close(shrunk[key].array, w.array, key)


def test_shrinkage_factor_is_nan_with_spin2_rows_below_l2(ref, port):
    """Found in the reference (ROADMAP section C): the spin-2 spectra's
    rows l < 2 are zero in every sample, a zero variance enters the
    shrinkage factor as 0 / 0, and the factor is NaN; the port does the
    same.  ``test_shrinkage_matches_reference`` cuts the spectra at l = 2."""
    target = tdices.gaussian_covariance(port["memory", 0, "Fast"][()])
    rtarget = jdices.gaussian_covariance(ref["cls"][0, "Fast"][()])
    with np.errstate(invalid="ignore", divide="ignore"):
        lam = tdices.shrinkage_factor(port["memory", 1, "Fast"], target)
        rlam = jdices.shrinkage_factor(ref["cls"][1, "Fast"], rtarget)
    assert np.isnan(lam) and np.isnan(rlam)


def _mtimes(d):
    return {f: os.stat(os.path.join(d, f)).st_mtime_ns for f in os.listdir(d)}


def test_port_finishes_a_reference_cache(ref, tmp_path):
    """Regions 2, 3 and one cls file missing from the reference's cache:
    the port computes those alone and reads the rest."""
    d = str(tmp_path / "dices")
    shutil.copytree(ref["dir"], d)
    for name in ("data_alms_2", "vis_alms_2", "data_alms_3", "vis_alms_3",
                 "cls_3_unmixed_False"):
        os.remove(os.path.join(d, name + ".fits"))
    kept = _mtimes(d)
    fields, _, _, jk = _setup(th, device="cpu")
    data, vis = copy.deepcopy(ref["data"]), copy.deepcopy(ref["vis"])
    alms = tdices.compute_jk_alms(data, vis, jk, fields, dir=d)
    assert set(alms) == {("data", 2), ("vis", 2), ("data", 3), ("vis", 3)}
    cls = tdices.jackknife_cls(data, vis, jk, fields, nd=1, dir=d)
    assert {f: t for f, t in _mtimes(d).items() if f in kept} == kept
    _same_samples(cls, ref["cls"][1, "Fast"])
    # the reference reads the port's files back
    back = jdices.jackknife.compute_jk_cls_from_alms(
        jk, ref["fields"], nd=2, dir=d)
    _same_samples(back, ref["cls"][2, "Fast"])


def test_reference_finishes_a_port_cache(ref, port, tmp_path):
    """The other way round: the reference resumes the port's file cache."""
    d = str(tmp_path / "dices")
    shutil.copytree(port["file", "dir", "Fast"], d)
    for name in ("data_alms_3", "vis_alms_3", "cls_2_unmixed_False"):
        os.remove(os.path.join(d, name + ".fits"))
    kept = _mtimes(d)
    cls = jdices.jackknife_cls(ref["data"], ref["vis"], ref["jk"],
                               ref["fields"], nd=1, dir=d)
    assert {f: t for f, t in _mtimes(d).items() if f in kept} == kept
    _same_samples(cls, ref["cls"][1, "Fast"])
    for k in range(NJK + 1):
        for name in ("data", "vis"):
            path = os.path.join(d, f"{name}_alms_{k}.fits")
            got, want = th.read_alms(path), jh.read_alms(path)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key])
                assert got[key].dtype.metadata == want[key].dtype.metadata


def test_region_masks_compare_labels_as_floats():
    """A label that is not exactly representable in the maps' float32 is
    selected as the reference's ``jk == float(k)`` selects it."""
    npix = 12 * 4**2
    jk = np.full(npix, 2.0**24 + 1)  # rounds to 2^24 in float32
    arr = torch.ones(npix, dtype=torch.float32)
    jk_dev = torch.as_tensor(jk, dtype=arr.dtype)
    ks = torch.as_tensor(np.asarray([2.0**24 + 1], np.float32), dtype=arr.dtype)
    stack = tjk._masked_stack(arr, jk_dev, ks)
    assert stack.shape == (1, npix) and bool((stack == 1).all())


def test_device_cache_budget(ref, monkeypatch):
    fields, data, vis, jk = _setup(th, device="cpu")
    need = tjk._estimate_alm_bytes(data, vis, fields, NJK)
    # (njk + 1) x (POS + 2 SHE + VIS planes) x nlm x complex128
    assert need == (NJK + 1) * 4 * (LMAX + 1) * (LMAX + 2) // 2 * 16
    monkeypatch.setenv("HERACLES_TPU_DICES_DEVICE_BYTES", str(need - 1))
    alms = tdices.compute_jk_alms(data, vis, jk, fields, dir=None)
    assert isinstance(alms["data", 1]["POS", 0], np.ndarray)
    monkeypatch.setenv("HERACLES_TPU_DICES_DEVICE_BYTES", str(need))
    alms = tdices.compute_jk_alms(data, vis, jk, fields, dir=None)
    assert isinstance(alms["data", 1]["POS", 0], th.DeviceMap)
    with pytest.raises(ValueError, match="requires dir=None"):
        tdices.compute_jk_alms(data, vis, jk, fields, dir="x", device_cache=True)


def test_sequential_regions_match_batched(ref):
    """``region_batch=1`` transforms one region at a time through
    ``mapping.transform``; the spectra do not change."""
    fields, _, _, jk = _setup(th, device="cpu")
    data, vis = copy.deepcopy(ref["data"]), copy.deepcopy(ref["vis"])
    alms = tdices.compute_jk_alms(data, vis, jk, fields, dir=None,
                                  region_batch=1)
    cls = tjk.compute_jk_cls_from_alms(jk, fields, nd=1, dir=None,
                                       alms_cache=alms)
    _same_samples(cls, ref["cls"][1, "Fast"])
