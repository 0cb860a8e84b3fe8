"""The stack budget of ``mapping.transform``: how many maps of a group one
call of the mapper's ``transform`` takes.

On the CPU: the rule (``mapping._stack_size``) at nside 4096 shapes,
without allocating a map; with ``mapping._STACK_BYTES`` set to the bytes
of 8 toy maps, 10 maps at nside 16 in stacks of 8 + 2 (spin 0) and
4 + 4 + 2 (spin 2), as ``pick_nb`` and ``tracing.TRANSFORM_STACKS`` see
them, their alms bit for bit those of the maps transformed alone (the
plain versions give the same bits at every ``nb``) and, within the
float32 bar of ``tests/test_pallas.py``, the reference's
``heracles_tpu.mapping.transform``, with each map's metadata kept.

The test that needs a card carries the ``cuda`` marker and skips
elsewhere; the file imports no JAX at the top (the comparison with the
reference imports it inside its test), so on the card it runs on its
own:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_mapping_stack.py
"""

import numpy as np
import pytest
import torch

import heracles_tpu_torch as th
from heracles_tpu_torch import mapping, tracing
from heracles_tpu_torch.core import update_metadata
from heracles_tpu_torch.ops import sht_kernels

NSIDE, LMAX, NMAPS = 16, 24, 10
# float32 at the Pallas kernels' bar (tests/test_pallas.py)
BAR = (2e-5, 2e-4)
N4096 = 12 * 4096**2


@pytest.mark.parametrize("shape,itemsize,batch,want", [
    ((N4096,), 4, 8, 8),           # float32 spin 0: 6.44e9 bytes
    ((2, N4096), 4, 8, 4),         # float32 spin 2: not 5 (nb 1)
    ((N4096,), 8, 8, 4),           # float64 spin 0
    ((12 * 2048**2,), 4, 8, 8),    # nside 2048: ``batch``
    ((12 * 2048**2,), 4, 3, 3),
    ((12 * 8192**2,), 4, 8, 2),    # nside 8192 float32
    ((2, 12 * 8192**2), 8, 8, 1),  # never less than one map
], ids=["n4096-f32-s0", "n4096-f32-s2", "n4096-f64-s0", "n2048-batch8",
        "n2048-batch3", "n8192-f32-s0", "n8192-f64-s2"])
def test_stack_size_rule(shape, itemsize, batch, want):
    assert mapping._stack_size(shape, itemsize, batch) == want


@pytest.fixture
def picks(monkeypatch):
    """Every (B, name, precision, nb) that pick_nb answered."""
    seen = []
    pick = sht_kernels.pick_nb

    def spy(B, lmax, name, precision="f32"):
        nb = pick(B, lmax, name, precision)
        seen.append((B, name, precision, nb))
        return nb

    monkeypatch.setattr(sht_kernels, "pick_nb", spy)
    return seen


def _fields(pkg, **kw):
    mapper = pkg.HealpixMapper(NSIDE, LMAX, deconvolve=False, **kw)
    return {0: pkg.Positions(mapper, "RA", "DEC"),
            2: pkg.Shears(mapper, "RA", "DEC", "G1", "G2", "W")}


def _values(spin):
    rng = np.random.default_rng(40 + spin)
    npix = 12 * NSIDE**2
    shape = (NMAPS, 2, npix) if spin else (NMAPS, npix)
    return rng.normal(size=shape).astype(np.float32)


def _port_maps(fields, spin, values):
    """Each map a DeviceMap with the mapper's metadata and its own."""
    out = {}
    for i, v in enumerate(values):
        m = fields[spin].mapper.create(*v.shape[:-1], spin=spin)
        m.array[:] = torch.as_tensor(v)
        md = dict(m.metadata, bias=1.0 + i)
        out[spin, i] = th.DeviceMap(m.array, metadata=md)
    return out


# stacks of 8 + 2 spin-0 maps and 4 + 4 + 2 spin-2 maps, and their groups
STACKS = {0: ([8, 2], "analysis_spin0_folded"),
          2: ([4, 4, 2], "analysis_pair_folded")}


@pytest.mark.parametrize("spin", [0, 2])
def test_stacks_under_the_budget(spin, picks, monkeypatch):
    values = _values(spin)
    # the bytes of 8 float32 spin-0 maps
    monkeypatch.setattr(mapping, "_STACK_BYTES", 8 * 4 * 12 * NSIDE**2)
    fields = _fields(th, dtype=torch.float32, device="cpu")
    sht_kernels.reset_counts()
    stacked = th.transform(fields, _port_maps(fields, spin, values))
    sizes, name = STACKS[spin]
    assert tracing.counts()["transform_stacks"] == {
        n: sizes.count(n) for n in sizes}
    # B1 float32 skips nb 2 (``NB_SIZES``): its stack of 2 runs at nb 1
    nbs = [4, 1] if spin == 0 else [4, 4, 2]
    assert picks == [(n, name, "f32", nb) for n, nb in zip(sizes, nbs)]

    # the maps alone: the same bits
    sht_kernels.reset_counts()
    alone = th.transform(fields, _port_maps(fields, spin, values), batch=1)
    assert tracing.TRANSFORM_STACKS == {1: NMAPS}
    assert sorted(stacked) == sorted(alone)
    for key, a in alone.items():
        assert torch.equal(stacked[key].array, a.array), key
        assert stacked[key].dtype.metadata == a.dtype.metadata

    # the reference's transform, with each map's metadata
    import heracles_tpu as jh

    jfields = _fields(jh, dtype=np.float32)
    jmaps = {}
    for i, v in enumerate(values):
        m = jfields[spin].mapper.create(*v.shape[:-1], spin=spin)
        m[:] = v
        update_metadata(m, bias=1.0 + i)
        jmaps[spin, i] = m
    want = jh.transform(jfields, jmaps)
    assert sorted(want) == sorted(stacked)
    atol, rtol = BAR
    for key, w in want.items():
        w = np.asarray(w)
        got = stacked[key]
        np.testing.assert_allclose(got.array.numpy(), w, rtol=rtol,
                                   atol=atol * np.abs(w).max())
        assert got.dtype.metadata == want[key].dtype.metadata
        assert got.dtype.metadata["bias"] == 1.0 + key[1]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_stack_of_8_runs_b1_at_nb4_on_the_card(cuda, monkeypatch):
    """8 float32 maps at nside 32 in one stack: one B1 launch at nb 4 (the
    group's ring contraction on the tensor cores), its alms within the
    float32 bar of the maps transformed alone (B1 at nb 1)."""
    nside, lmax = 32, 48
    npix = 12 * nside**2
    monkeypatch.setattr(mapping, "_STACK_BYTES", 8 * 4 * npix)
    mapper = th.HealpixMapper(nside, lmax, dtype=torch.float32, device=cuda,
                              deconvolve=False)
    fields = {"D": th.Positions(mapper, "RA", "DEC")}
    g = torch.Generator(device=cuda).manual_seed(23)
    pool = torch.randn((8, npix), generator=g, device=cuda)
    md = dict(mapper.create().metadata)
    data = {("D", i): th.DeviceMap(pool[i], metadata=md) for i in range(8)}
    alone = th.transform(fields, data, batch=1)
    sht_kernels.reset_counts()
    stacked = th.transform(fields, data)
    torch.cuda.synchronize()
    assert dict(sht_kernels.LAUNCHES_BY_NB) == {
        ("analysis_spin0_folded", 4): 1}
    assert tracing.TRANSFORM_STACKS == {8: 1}
    atol, rtol = BAR
    for key, a in alone.items():
        want = a.array.cpu().numpy()
        np.testing.assert_allclose(stacked[key].array.cpu().numpy(), want,
                                   rtol=rtol, atol=atol * np.abs(want).max())
