"""Device meshes and the sharded SHT pipeline step, on torch.

Counterpart of :mod:`heracles_tpu.parallel`.  A :class:`Mesh` is a
("batch", "m") grid of devices held by one controlling process, as a JAX
mesh is: the public functions take whole tensors, split them across the
mesh's devices, and return whole tensors on the mesh's first device, in
the reference's layout and shapes.

* ``"batch"`` -- tomographic bins, fields or jackknife regions: every
  map's transform is independent.
* ``"m"`` -- the SHT's harmonic orders: each shard runs the ring FFT of
  its maps and the Wigner kernels for its contiguous block of ``per``
  orders (:func:`_m_block`, padded past lmax to whole chunks of
  ``sht.DEFAULT_M_CHUNK``); spectra reduce over the orders with one sum.

Work for a shard is queued on its device's current stream, and the loop
over shards waits for no card: every shard's inputs are copied to its
device before any shard's work is queued (a copy between cards runs on
the source card's stream, behind the work queued there), and the
transforms copy their host constants without waiting for the card and
read nothing back.  A device may repeat in a mesh
(``make_mesh(devices=["cpu"] * 8)`` on the CPU, ``[cuda:0] * 4`` on one
card): shards that share a device are summed or concatenated there, in
shard order.  Between distinct cards the collectives are those of
:mod:`torch.cuda.comm` (NCCL within one process).  The tensor's device
picks each kernel's path, as everywhere in the port: the Hopper kernels
on a card, their plain versions on the CPU.

Not ported: the reference's ``engine`` switch ("jnp", "pallas",
"pallas-interpret"), which chose between emulations that the device
choice replaces here (only ``"auto"`` is accepted), and multi-process
runs, which would need ``torch.distributed``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..devicemap import DeviceMap
from ..healpix import npix2nside, nside2npix
from ..ops import sht
from ..twopoint import rect_pair_grid

__all__ = [
    "Mesh",
    "make_mesh",
    "example_batch",
    "pipeline_step",
    "map2alm_sharded",
    "alm2map_sharded",
]


class Mesh:
    """A ("batch", "m") grid of devices for one controlling process.

    ``devices``: a (batch, m) numpy object array of ``torch.device``, in
    which a device may repeat; ``shape``: ``{"batch": ..., "m": ...}``;
    ``axis_names``: ``("batch", "m")``.  Results come back on
    ``devices.flat[0]``.
    """

    axis_names = ("batch", "m")

    def __init__(self, devices):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError("Mesh: devices must be a non-empty (batch, m) "
                             f"grid, got shape {devices.shape}")
        self.devices = devices
        self.shape = {"batch": devices.shape[0], "m": devices.shape[1]}

    @property
    def size(self):
        return self.devices.size

    def __repr__(self):
        return (f"Mesh(shape={self.shape}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def make_mesh(n_devices=None, *, m_axis=None, devices=None):
    """A ("batch", "m") mesh of ``n_devices`` devices, ``m_axis`` of them
    along "m" (default 2 when the count is even and above 1).

    By default the devices are every visible card, ``cuda:0`` to
    ``cuda:{device_count - 1}``; with none visible this raises (it never
    falls back to the CPU).  ``devices=`` names them instead, in order,
    and a device may repeat: ``["cpu"] * 8`` gives eight shards on the
    CPU, ``["cuda:0"] * 4`` four shards on one card.
    """
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; name the devices "
                "with devices= (for example ['cpu'] * 8)")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [torch.device(d) for d in devices]
        devices = [torch.device("cuda", torch.cuda.current_device())
                   if d.type == "cuda" and d.index is None else d
                   for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"make_mesh: {n_devices} devices asked for, "
                             f"{len(devices)} given")
        devices = devices[:n_devices]
    n = len(devices)
    if m_axis is None:
        m_axis = 2 if n % 2 == 0 and n > 1 else 1
    if m_axis < 1 or n % m_axis:
        raise ValueError(f"make_mesh: {n} devices do not split into an "
                         f"'m' axis of {m_axis}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(n // m_axis, m_axis))


def example_batch(mesh, *, nside=16, lmax=24, seed=0, spin2=False):
    """A batch of 2 x batch-axis random float32 maps on the mesh's first
    device, drawn from ``numpy.random.default_rng(seed)``.

    ``spin2=True`` also returns an (nbins, 2, npix) [Q, U] batch.
    (``lmax`` is unused, as in the reference.)
    """
    nbins = 2 * mesh.shape["batch"]
    rng = np.random.default_rng(seed)
    dev = mesh.devices.flat[0]
    maps = rng.normal(size=(nbins, nside2npix(nside))).astype(np.float32)
    out = (tracing.upload("parallel.example_batch", maps, dev),)
    if spin2:
        qu = rng.normal(size=(nbins, 2, nside2npix(nside))).astype(np.float32)
        out += (tracing.upload("parallel.example_batch", qu, dev),)
    return out


# -- collectives over per-shard tensors -----------------------------------


def _distinct_cards(devices):
    return (len(devices) > 1 and all(d.type == "cuda" for d in devices)
            and len(set(devices)) == len(devices))


def _copies(t, devices):
    """``t`` on each of ``devices`` (one copy per distinct device)."""
    out = {}
    return [out.setdefault(d, t.to(d)) for d in devices]


def _real(t):
    """``torch.cuda.comm`` moves a complex tensor as its real view (and
    hands that view back): pass it so, and take it back with
    :func:`_like`."""
    return torch.view_as_real(t) if t.is_complex() else t


def _like(t, out):
    return torch.view_as_complex(out) if t.is_complex() else out


def _broadcast(t, devices):
    from torch.cuda import comm

    return [_like(t, c) for c in comm.broadcast(
        _real(t), devices=[d.index for d in devices])]


def _psum(tensors, devices, dest=None):
    """Sum of the per-shard ``tensors`` (shard i on ``devices[i]``).

    Returns the sum on ``dest`` when it is given, else one copy on each
    shard's device.  Distinct cards reduce through ``torch.cuda.comm``;
    otherwise the tensors are summed on the first device, in shard order.
    """
    if _distinct_cards(devices):
        from torch.cuda import comm

        root = devices[0] if dest is None else dest
        total = _like(tensors[0], comm.reduce_add(
            [_real(t) for t in tensors], destination=root.index))
        return total.to(dest) if dest is not None else _broadcast(total,
                                                                  devices)
    total = tensors[0].to(devices[0])
    for t in tensors[1:]:
        total = total + t.to(devices[0])
    return total.to(dest) if dest is not None else _copies(total, devices)


def _all_gather(tensors, devices, dim, dest=None):
    """The per-shard ``tensors`` concatenated along ``dim`` in shard order.

    Returns the whole on ``dest`` when it is given, else one copy on each
    shard's device.  Distinct cards gather through ``torch.cuda.comm``;
    otherwise the tensors are concatenated on the first device.
    """
    if _distinct_cards(devices):
        from torch.cuda import comm

        root = devices[0] if dest is None else dest
        # a dim counted from the front holds for the real views too
        whole = _like(tensors[0], comm.gather(
            [_real(t) for t in tensors], dim=dim % tensors[0].dim(),
            destination=root.index))
        return whole.to(dest) if dest is not None else _broadcast(whole,
                                                                  devices)
    whole = torch.cat([t.to(devices[0]) for t in tensors], dim=dim)
    return whole.to(dest) if dest is not None else _copies(whole, devices)


# -- the sharded transforms ------------------------------------------------


def _check_engine(engine):
    if engine != "auto":
        raise ValueError(
            f"engine={engine!r}: the port has no engine switch (the tensor's "
            "device picks the path); only 'auto' is accepted")


def _moved(site, t, device):
    """``t`` on ``device``; a copy from the host to a card counted at
    ``site``."""
    if not t.is_cuda:
        tracing.copied(site, "h2d", device)
        tracing.synced(site, device)
    return t.to(device)


def _whole(a):
    """A whole input as a tensor: a DeviceMap's, a tensor where it lies,
    numpy on the host (each shard's block is moved to its device)."""
    if isinstance(a, DeviceMap):
        return a.array
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    return torch.as_tensor(np.ascontiguousarray(a, np.dtype(a.dtype.str)))


def _batch_blocks(a, nb):
    """``a``'s leading axis zero-padded to a multiple of ``nb`` and cut
    into ``nb`` equal blocks."""
    pad = (-a.shape[0]) % nb
    if pad:
        a = torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
    return a.chunk(nb) if a.shape[0] else [a] * nb


def _m_block(lmax, n_m):
    """Orders per "m" shard: the padded order axis over ``n_m`` shards, in
    whole chunks of ``sht.DEFAULT_M_CHUNK``."""
    m_chunk = sht.DEFAULT_M_CHUNK
    nm_pad = sht._mmax_pad(lmax, m_chunk)
    return -(-nm_pad // (n_m * m_chunk)) * m_chunk


@tracing.spanned("parallel.map2alm_sharded")
def map2alm_sharded(mesh, maps, lmax, *, weights="ring", spin=0,
                    engine="auto", dd=None):
    """Sharded analysis: bins over "batch", harmonic orders over "m".

    ``maps``: (nbins, npix) for spin 0 or (nbins, 2, npix) [Q, U] for a
    spin pair, a tensor, a DeviceMap or a numpy array.  Returns
    rectangular alms (nbins[, 2], lmax+1, per * n_m) on the mesh's first
    device, the trailing axis padded past lmax with zero orders (the
    reference's layout).  ``weights`` and ``dd`` as for ``sht.map2alm``
    (True: the Wigner stage of float32 maps in the kernels' float64
    instantiation; "comp": their compensated float32 one; complex64
    returned).
    """
    _check_engine(engine)
    maps = _whole(maps)
    nside = npix2nside(maps.shape[-1])
    lmax, spin, dd = int(lmax), abs(int(spin)), sht._dd_mode(dd)
    nb, n_m = mesh.shape["batch"], mesh.shape["m"]
    per = _m_block(lmax, n_m)
    blocks = _batch_blocks(maps, nb)
    devices = list(mesh.devices.flat)
    local = [_moved("parallel.map2alm_sharded", blocks[i // n_m], d)
             for i, d in enumerate(devices)]
    parts = [sht._map2alm_block(m, nside, lmax, (i % n_m) * per, per, spin,
                                sht._weights_on(nside, weights, m.device), dd)
             for i, m in enumerate(local)]
    return _assemble(mesh, parts, maps.shape[0])


def _assemble(mesh, parts, nbins):
    """Whole tensor on the mesh's first device from the per-shard blocks
    (in the mesh's row-major order): orders along the last axis, bins
    along the first, trimmed to ``nbins``."""
    nb, n_m = mesh.shape["batch"], mesh.shape["m"]
    first = mesh.devices.flat[0]
    rows = [_all_gather(parts[bi * n_m:(bi + 1) * n_m],
                        list(mesh.devices[bi]), dim=-1,
                        dest=mesh.devices[bi, 0])
            for bi in range(nb)]
    return _all_gather(rows, list(mesh.devices[:, 0]), dim=0,
                       dest=first)[:nbins]


def alm2map_sharded(mesh, alms, nside, *, lmax=None, spin=0, engine="auto",
                    dd=None):
    """Sharded synthesis: bins over "batch", harmonic orders over "m".

    Inverse of :func:`map2alm_sharded`, on its layout: ``alms`` is
    (nbins, lmax+1, nm) for spin 0 or (nbins, 2, lmax+1, nm) [E, B], with
    nm up to per * n_m (zero-padded to it).  Each shard synthesises the
    ring spectra of its block of orders; the blocks of a batch row are
    gathered on the row's first device, where the ring FFT runs once on
    the full spectra.  Returns (nbins, npix) maps, or (nbins, 2, npix)
    [Q, U], on the mesh's first device.
    """
    _check_engine(engine)
    alms = _whole(alms)
    spin, nside, dd = abs(int(spin)), int(nside), sht._dd_mode(dd)
    lmax = alms.shape[-2] - 1 if lmax is None else int(lmax)
    nb, n_m = mesh.shape["batch"], mesh.shape["m"]
    per = _m_block(lmax, n_m)
    pad = per * n_m - alms.shape[-1]
    if pad < 0:
        raise ValueError(f"alms m axis {alms.shape[-1]} exceeds the mesh "
                         f"block layout {per * n_m}")
    if pad:
        alms = torch.nn.functional.pad(alms, (0, pad))
    blocks = _batch_blocks(alms, nb)
    devices = list(mesh.devices.flat)
    local = [_moved("parallel.alm2map_sharded",
                    blocks[i // n_m][..., (i % n_m) * per:(i % n_m + 1) * per],
                    d)
             for i, d in enumerate(devices)]
    Gs = [sht._synthesis_block(a, nside, lmax, spin, dd, (i % n_m) * per)
          for i, a in enumerate(local)]
    rows = []
    for bi in range(nb):
        devs = list(mesh.devices[bi])
        row_Gs = Gs[bi * n_m:(bi + 1) * n_m]
        full = [_all_gather([G[j] for G in row_Gs], devs, dim=-1,
                            dest=devs[0])[..., : lmax + 1]
                for j in range(len(row_Gs[0]))]
        rows.append(sht._ring_maps(full, nside, spin))
    return _all_gather(rows, list(mesh.devices[:, 0]), dim=0,
                       dest=mesh.devices.flat[0])[: alms.shape[0]]


@tracing.spanned("parallel.pipeline_step")
def pipeline_step(mesh, maps, lmax, maps2=None, *, engine="auto", dd=None):
    """Full sharded pipeline step: maps -> alms -> all-pair spectra.

    ``maps``: (nbins, npix) spin-0 batch; ``maps2`` (optional): (nbins2,
    2, npix) [Q, U]; each count a multiple of the mesh's "batch" axis.
    The component planes (spin-0 bins, then E, B per spin-2 bin) enter one
    all-pairs grid: each shard pairs its planes with the stack gathered
    over "batch" (``twopoint.rect_pair_grid`` on its block of orders), and
    the grids are summed over "m".  Returns the (nplanes, nplanes,
    lmax+1) float64 grid on the mesh's first device.
    """
    _check_engine(engine)
    maps = _whole(maps)
    maps2 = None if maps2 is None else _whole(maps2)
    nside = npix2nside(maps.shape[-1])
    lmax, dd = int(lmax), sht._dd_mode(dd)
    nb, n_m = mesh.shape["batch"], mesh.shape["m"]
    for what, a in (("maps", maps), ("maps2", maps2)):
        if a is not None and a.shape[0] % nb:
            raise ValueError(f"pipeline_step: {a.shape[0]} {what} do not "
                             f"split over a 'batch' axis of {nb}")
    per = _m_block(lmax, n_m)
    b0 = maps.shape[0] // nb
    b2 = 0 if maps2 is None else maps2.shape[0] // nb

    devices = list(mesh.devices.flat)
    site = "parallel.pipeline_step"
    local = [(_moved(site, maps[(i // n_m) * b0:(i // n_m + 1) * b0], d),
              None if maps2 is None
              else _moved(site, maps2[(i // n_m) * b2:(i // n_m + 1) * b2], d))
             for i, d in enumerate(devices)]

    planes = []
    for i, (spin0, pair) in enumerate(local):
        m0 = (i % n_m) * per
        w = sht._weights_on(nside, "ring", spin0.device)
        p = sht._map2alm_block(spin0, nside, lmax, m0, per, 0, w, dd)
        if pair is not None:
            eb = sht._map2alm_block(pair, nside, lmax, m0, per, 2, w, dd)
            p = torch.cat([p, eb.reshape((-1,) + eb.shape[-2:])])
        planes.append(p)
    # each shard's planes against the stack gathered over "batch"
    others = [None] * len(devices)
    for mi in range(n_m):
        column = list(range(mi, len(devices), n_m))
        gathered = _all_gather([planes[i] for i in column],
                               [devices[i] for i in column], dim=0)
        for i, g in zip(column, gathered):
            others[i] = g

    grids = [rect_pair_grid(planes[i], others[i],
                            torch.arange((i % n_m) * per, (i % n_m + 1) * per))
             for i in range(len(devices))]
    rows = [_psum(grids[bi * n_m:(bi + 1) * n_m], list(mesh.devices[bi]),
                  dest=mesh.devices[bi, 0])
            for bi in range(nb)]
    out = _all_gather(rows, list(mesh.devices[:, 0]), dim=0,
                      dest=mesh.devices.flat[0])
    if maps2 is None:
        return out
    # each shard emitted [its spin-0 bins, its E/B planes]: permute to the
    # global order [all spin-0 bins, then E, B per spin-2 bin]
    blocks = np.arange(nb)[:, None] * (b0 + 2 * b2)
    rows0 = (blocks + np.arange(b0)).ravel()
    rows2 = (blocks + b0 + np.arange(2 * b2)).ravel()
    perm = tracing.upload("parallel.pipeline_step",
                          np.concatenate([rows0, rows2]), out.device)
    return out[perm][:, perm]
