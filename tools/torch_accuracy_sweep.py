"""Accuracy of the port's float32 SHT modes against float64 truth, per l-band.

    python3 tools/torch_accuracy_sweep.py --nside 4096 --lmax 3000 \\
        [--spin 0 2] [--seed 0] [--device cuda] [--out FILE]

The twin of ``tools/accuracy_sweep.py`` for ``heracles_tpu_torch`` (it
imports no JAX and nothing of ``heracles_tpu``):

* draw random band-limited float64 alms from ``--seed`` (unit variance,
  a flat C(l); a_l0 real; l < spin zero) and synthesise the float64
  "truth" map with the port's float64 transform;
* analyse the truth map in the four modes of ``sht.map2alm``: float32
  plain (``dd=False``), float32 compensated (``dd="comp"``), float32
  maps with the float64 recurrence (``dd=True``) and float64;
* synthesise the truth alms in the same four modes and analyse each map
  in float64, which turns the map error into per-l rows on the scale of
  the analysis rows (the "f64" synthesis row is the float64 floor of
  that round trip);
* report per mode the max and rms relative alm error (of the largest
  truth alm), the relative C(l) error (C(l) = the mean over m of |a_lm|^2)
  as its maximum over l >= 2 and over six log-spaced l-bands, as
  ``tools/accuracy_sweep.py``'s ``_band_max`` does, and on the card the
  Wigner kernel's milliseconds (CUDA events, median of three after a
  warm-up) and the whole transform's.

Prints one JSON object per spin and writes them, keyed
``n{nside}_l{lmax}_s{spin}``, into ``--out`` when given (merged with what
the file holds).  ``--device cpu`` runs the plain versions (no times);
the card's name and power limit go with every result from the card.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
MODES = ("f32", "comp", "dd", "f64")


def make_alms(lmax, spin, seed):
    """Rectangular (lmax+1, lmax+1) complex128 alms, (2, ...) for a spin
    pair (E, B): unit normals below the diagonal m <= l, a_l0 real, the
    rows l < spin zero."""
    rng = np.random.default_rng(seed)
    shape = ((2,) if spin else ()) + (lmax + 1, lmax + 1)
    alm = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    ls, ms = np.meshgrid(np.arange(lmax + 1), np.arange(lmax + 1),
                         indexing="ij")
    alm[..., ms > ls] = 0
    alm[..., 0] = alm[..., 0].real
    alm[..., ls < spin] = 0
    return alm


def cl_of(rect):
    """C(l) of rectangular alms: sum_m |a_lm|^2 (m > 0 twice) / (2l + 1)."""
    lmax = rect.shape[-2] - 1
    eps = np.where(np.arange(rect.shape[-1]) == 0, 1.0, 2.0)
    p = (rect.real**2 + rect.imag**2) * eps
    return p.sum(axis=-1) / (2 * np.arange(lmax + 1) + 1)


def band_max(rel, lmax, nbands=6):
    """Max of ``rel`` over log-spaced bands of l from 2 (the reference's
    ``_band_max``)."""
    edges = np.unique(np.geomspace(2, lmax + 1, nbands + 1).astype(int))
    ells = np.arange(rel.shape[-1])
    out = {}
    for lo, hi in zip(edges[:-1], edges[1:]):
        sel = (ells >= lo) & (ells < hi)
        out[f"{lo}-{hi - 1}"] = float(np.nanmax(rel[..., sel]))
    return out


def errors(got, truth):
    """The error record of rectangular alms ``got`` against ``truth``."""
    lmax = truth.shape[-2] - 1
    scale = np.abs(truth).max()
    err = np.abs(got - truth)
    cl_t = cl_of(truth)
    rel = np.abs(cl_of(got) - cl_t) / np.where(cl_t > 0, cl_t, 1.0)
    return {
        "alm_max_rel": float(err.max() / scale),
        "alm_rms_rel": float(np.sqrt((err**2).mean()) / scale),
        "cl_max_rel": float(np.nanmax(rel[..., 2:])),
        "cl_band_max_rel": band_max(rel, lmax),
    }


def card():
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _mode_kw(mode):
    """(map dtype, map2alm / alm2map keywords) of a mode."""
    import torch

    return {"f32": (torch.float32, {}),
            "comp": (torch.float32, {"dd": "comp"}),
            "dd": (torch.float32, {"dd": True}),
            "f64": (torch.float64, {})}[mode]


def sweep(nside, lmax, spin, seed=0, device="cuda"):
    """The error records (and on the card the times) of one spin."""
    import torch

    sys.path.insert(0, str(REPO))
    from heracles_tpu_torch.ops import ringfft, sht, sht_kernels

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("torch_accuracy_sweep: torch sees no CUDA device")

    def timed(fn, n=3):
        """(result, median ms) on the card, (result, None) elsewhere."""
        if not on_card:
            return fn(), None
        out = fn()
        times = []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        return out, float(np.median(times))

    truth = make_alms(lmax, spin, seed)
    truth_t = torch.as_tensor(truth, device=dev)
    truth_map = sht.alm2map(truth_t, nside, lmax, spin=spin, packed=False)
    x, lch, lsh = sht._geometry(nside, dev)
    w = sht.ring_weights(nside)
    pair = "pair" if spin else "spin0"
    result = {"nside": nside, "lmax": lmax, "spin": spin, "seed": seed,
              "device": (torch.cuda.get_device_name(dev) if on_card
                         else "cpu"),
              "card": card() if on_card else None,
              "analysis": {}, "synthesis": {}}

    for mode in MODES:
        dtype, kw = _mode_kw(mode)
        maps = truth_map.to(dtype)
        got, ms = timed(lambda: sht.map2alm(maps, lmax, spin=spin,
                                            packed=False, **kw))
        rec = errors(got.cpu().numpy(), truth)
        rec["transform_ms"] = ms
        # the Wigner kernel alone, on the folded spectra of this map (with
        # dd=True the twin's widening casts included)
        if spin == 0:
            F, _ = ringfft.ring_analysis(maps, nside, lmax + 1, weight=w)
            args = sht._folded_inputs((F,), (0,)) + (x, lch, lsh, lmax)
        else:
            u = torch.complex(maps[0], maps[1])
            F, Fn = ringfft.ring_analysis(u, nside, lmax + 1, weight=w)
            args = sht._folded_inputs((F, Fn.conj()), (spin, -spin)) + (
                x, lch, lsh, lmax, spin)
            del u, Fn
        kernel = getattr(sht_kernels, f"analysis_{pair}_folded")
        kkw = dict(dd=kw.get("dd", False),
                   x_lo=sht._x_lo(nside, kw.get("dd"), dev))
        _, rec["kernel_ms"] = timed(lambda: kernel(*args, **kkw))
        del F, args
        result["analysis"][mode] = rec

        ctype = torch.complex64 if dtype == torch.float32 else torch.complex128
        alms = truth_t.to(ctype)
        back, ms = timed(lambda: sht.alm2map(alms, nside, lmax, spin=spin,
                                             packed=False, **kw))
        again = sht.map2alm(back.double(), lmax, spin=spin, packed=False)
        rec = errors(again.cpu().numpy(), truth)
        rec["map_max_rel"] = float((back.double() - truth_map).abs().max()
                                   / truth_map.abs().max())
        rec["transform_ms"] = ms
        if spin == 0:
            sargs = (alms, x, lch, lsh, lmax)
        else:
            a_p = -(alms[0] + 1j * alms[1])
            a_m = -(alms[0] - 1j * alms[1]).conj()
            sargs = (a_p, a_m, x, lch, lsh, lmax, spin)
        kernel = getattr(sht_kernels, f"synthesis_{pair}_folded")
        _, rec["kernel_ms"] = timed(lambda: kernel(*sargs, **kkw))
        del back, again, sargs
        result["synthesis"][mode] = rec
    return result


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nside", type=int, required=True)
    parser.add_argument("--lmax", type=int)
    parser.add_argument("--spin", type=int, nargs="+", default=[0, 2])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out")
    args = parser.parse_args()
    lmax = 3 * args.nside // 2 if args.lmax is None else args.lmax
    results = {}
    for spin in args.spin:
        rec = sweep(args.nside, lmax, spin, args.seed, args.device)
        results[f"n{args.nside}_l{lmax}_s{spin}"] = rec
        print(json.dumps(rec), flush=True)
    if args.out:
        path = Path(args.out)
        old = json.loads(path.read_text()) if path.exists() else {}
        old.update(results)
        path.write_text(json.dumps(old, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    main()
