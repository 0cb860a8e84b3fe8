"""Entry ``map_spectra``: a stream of steps, each taking a stack of maps to
alms and all their cross-spectra.

Set-up draws a pool of map stacks on the device from the seed (white
noise inside the configuration's footprint, zero outside) and warms the
path up; step k analyses pool stack (offset + k) mod pool with
``mapping.transform`` through one ``HealpixMapper`` and forms every
spectrum with ``twopoint.angular_power_spectra``, whose results are host
arrays, so a step ends with its spectra on the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import map_spectra as reference


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg = ctx.config
        self.nside, self.lmax = cfg["nside"], cfg["lmax"]
        self.mmax = cfg.get("mmax", self.lmax)
        self.nmaps = cfg["bins"]
        self.pool_size = ctx.traffic["pool"]
        self.dtype = getattr(torch, cfg["dtype"])

    def setup(self):
        import heracles_tpu_torch as th

        self.th = th
        dev = self.ctx.device
        npix = 12 * self.nside ** 2
        g = torch.Generator(device=dev).manual_seed(self.ctx.seed)
        self.pool = torch.randn((self.pool_size, self.nmaps, npix), generator=g,
                                device=dev, dtype=self.dtype)
        lo, hi = footprint(self.ctx.config, npix)
        self.pool[..., :lo] = 0.0
        self.pool[..., hi:] = 0.0
        self.offset = int(np.random.default_rng(self.ctx.seed).integers(
            self.pool_size))
        self.mapper = th.HealpixMapper(
            self.nside, self.lmax, dtype=self.dtype, device=dev,
            deconvolve=self.ctx.config.get("deconvolve", True))
        self.fields = {"D": th.Positions(self.mapper, "RA", "DEC")}
        self.metadata = dict(geometry="healpix", kernel="healpix",
                             nside=self.nside, lmax=self.lmax,
                             deconv=self.mapper.deconvolve, spin=0)
        for k in range(self.ctx.traffic["warmup_steps"]):
            self.step(k, self.ctx.no_spans)

    def units(self):
        return self.nmaps

    def sht_maps(self):
        """Maps a step analyses, by spin kind."""
        return {0: self.nmaps}

    def step(self, k, spans):
        th = self.th
        p = (self.offset + k) % self.pool_size
        data = {("D", i): th.DeviceMap(self.pool[p, i], metadata=self.metadata)
                for i in range(self.nmaps)}
        with spans("transform"):
            alms = th.transform(self.fields, data)
        with spans("spectra"):
            cls = th.angular_power_spectra(alms)
        return {"pool": p,
                "alms": torch.stack([alms["D", i].array
                                     for i in range(self.nmaps)]),
                "cls": {(k2, k3): v.array for (_, _, k2, k3), v in cls.items()}}

    def release(self):
        self.mapper = self.fields = None

    def check(self, kept, precision="f64", detail=None):
        """The compared numbers over the kept steps (the largest of each);
        ``precision="tf32"``: the control in the program's place;
        ``detail`` gets each number's worst step and pool stack.  The
        reference takes the kept steps' pool stacks one at a time."""
        cfg = self.ctx.config
        worst = {}
        for p in sorted({out["pool"] for out in kept}):
            ref = reference.alms(cfg, self.pool[p])
            ctl = (None if precision == "f64"
                   else reference.as_program(
                       reference.alms(cfg, self.pool[p], precision)))
            for n, out in enumerate(kept):
                if out["pool"] != p:
                    continue
                got = (out["alms"], out["cls"]) if ctl is None else ctl
                for name, v in reference.numbers(cfg, *got, ref).items():
                    if v >= worst.get(name, 0.0):
                        worst[name] = v
                        if detail is not None:
                            detail[name] = (n, p)
            del ref, ctl
        return worst


def footprint(config, npix):
    """(lo, hi): the pixels lo..hi-1 (RING order) of the footprint, the
    band about the equator that covers the configuration's area."""
    fsky = config["footprint_deg2"] / (4 * math.pi * (180 / math.pi) ** 2)
    half = round(npix * fsky / 2)
    return npix // 2 - half, npix // 2 + half
