"""The spreading kernel's binning, in its plain versions, on the CPU.

The ES spreader (``heracles_tpu_torch/csrc/spread.cu``) bins the points by
32 x 32 tile of the torus grid, sorts them by bin, and sums each bin's
subproblems (at most ``nufft.MAX_SUB`` points each) in a tile of shared
memory with a halo of w - 1, clipped to the wrap-padded grid.  These
tests hold the plain versions of that binning (``bin_points_plain``,
``subproblems_plain``) and the kernel's tile extent to the invariants it
relies on, at grids whose size is a multiple of the tile (ntheta 96 and
160 at lmax 20 and 32) and is not (40 and 80 at lmax 8 and 16: the last
tiles are clipped), with points at the poles, on the phi wrap and on
tile edges.  Everything is exact integer arithmetic: no tolerance.
The kernel itself is held to these functions on the card
(``tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest
import torch

from heracles_tpu_torch.ops import nufft

WIDTHS = (4, 6, 13, 16)
LMAXS = (8, 16, 20, 32)


def _edge_points(lmax, w):
    """Angles at the poles, on the phi wrap, and with stencil corners on
    tile edges (the last cell of a tile, the first of the next, the last
    of the torus)."""
    ntheta, nphi = nufft.grid_shape(lmax)
    half_w = 0.5 * w
    theta = [0.0, np.pi, np.pi / 2, np.pi / 2]
    phi = [0.0, 0.0, 0.0, 2 * np.pi - 1e-15]
    for j in (nufft.TILE - 1, nufft.TILE, ntheta - 1):
        # the middle of the interval of u whose corner is cell j
        theta.append((j % ntheta + half_w - 0.5 + 0.5) * 2 * np.pi / ntheta)
        phi.append((j % nphi + half_w - 0.5) * 2 * np.pi / nphi)
    return np.array(theta), np.array(phi)


def _points(lmax, w, npts, seed):
    rng = np.random.default_rng(seed)
    theta = np.arccos(rng.uniform(-1, 1, npts))
    phi = rng.uniform(0, 2 * np.pi, npts)
    et, ep = _edge_points(lmax, w)
    return (torch.as_tensor(np.concatenate([et, theta])),
            torch.as_tensor(np.concatenate([ep, phi])))


def _tile_extent(bins, lmax, w):
    """The padded-grid cells the kernel's tile of each bin covers (its
    flush extent, csrc/spread.cu): rows [row0, row1) and columns [col0,
    col1), the tile and a halo of w - 1, clipped to the padded grid."""
    ntheta, nphi = nufft.grid_shape(lmax)
    nbp = -(-nphi // nufft.TILE)
    row0 = (bins // nbp) * nufft.TILE
    col0 = (bins % nbp) * nufft.TILE
    return (row0, torch.clamp(row0 + nufft.TILE + w - 1, max=ntheta + w),
            col0, torch.clamp(col0 + nufft.TILE + w - 1, max=nphi + w))


def _corners(theta, phi, lmax, w):
    ntheta, nphi = nufft.grid_shape(lmax)
    jt, _ = nufft._first_cell(theta * (ntheta / (2 * np.pi)) - 0.5, 0.5 * w,
                              ntheta)
    jp, _ = nufft._first_cell(phi * (nphi / (2 * np.pi)), 0.5 * w, nphi)
    return jt, jp


@pytest.mark.parametrize("lmax", LMAXS)
@pytest.mark.parametrize("w", WIDTHS)
def test_bins_counts_and_offsets(w, lmax):
    """Every point has one bin of the torus' tiles; the counts sum to the
    points and the offsets are their exclusive scan; the kernel's scratch
    has one count per bin."""
    theta, phi = _points(lmax, w, 3000, 1)
    bins, counts, offsets = nufft.bin_points_plain(theta, phi, lmax, w)
    ntheta, nphi = nufft.grid_shape(lmax)
    nbp = -(-nphi // nufft.TILE)
    nbins = -(-ntheta // nufft.TILE) * nbp
    assert counts.shape == (nbins,) and bins.shape == theta.shape
    assert int(bins.min()) >= 0 and int(bins.max()) < nbins
    assert int(counts.sum()) == theta.shape[0]
    assert torch.equal(counts, torch.bincount(bins, minlength=nbins))
    assert int(offsets[0]) == 0
    assert torch.equal(offsets[1:], torch.cumsum(counts, 0)[:-1])
    # the bin is the tile of the stencil's first cell
    jt, jp = _corners(theta, phi, lmax, w)
    assert torch.equal(bins, (jt // nufft.TILE) * nbp + jp // nufft.TILE)
    scratch = nufft._scratch(theta.shape[0], 1, 1, ntheta, nphi, "cpu")
    assert scratch["counts"].shape == counts.shape
    assert scratch["offsets"].shape == scratch["subs"].shape == (nbins + 1,)


@pytest.mark.parametrize("lmax", LMAXS)
@pytest.mark.parametrize("w", WIDTHS)
def test_stencils_lie_in_their_tiles(w, lmax):
    """Each point's w x w stencil, in the padded grid's cells, lies inside
    its bin's tile and halo as the kernel clips it: the tile in shared
    memory holds every addition, and the flush stays in the grid."""
    theta, phi = _points(lmax, w, 3000, 2)
    bins, _, _ = nufft.bin_points_plain(theta, phi, lmax, w)
    jt, jp = _corners(theta, phi, lmax, w)
    row0, row1, col0, col1 = _tile_extent(bins, lmax, w)
    ntheta, nphi = nufft.grid_shape(lmax)
    assert bool((row0 <= jt).all()) and bool((jt + w <= row1).all())
    assert bool((col0 <= jp).all()) and bool((jp + w <= col1).all())
    assert int(row1.max()) <= ntheta + w and int(col1.max()) <= nphi + w
    # the halo is what the invariant needs: rows up to bt*TILE + TILE + w - 2
    assert bool((row1 - row0 <= nufft.TILE + w - 1).all())
    # the edge points: the poles and the wrap land in the last tiles
    n_edge = _edge_points(lmax, w)[0].size
    assert int(jt[0]) == int(np.ceil(-0.5 - 0.5 * w)) % ntheta
    assert int(jp[3]) == nphi - w // 2
    assert bool((jt[:n_edge] < ntheta).all()) and bool((jp[:n_edge] < nphi).all())


@pytest.mark.parametrize("max_sub", [nufft.MAX_SUB, 100])
@pytest.mark.parametrize("lmax", LMAXS)
def test_subproblems_cover_each_point_once(lmax, max_sub):
    """The block -> (bin, chunk) map covers every sorted point exactly
    once: a bin of 5000 points is several subproblems, an empty bin none,
    and every block's bin has points."""
    w = 6
    ntheta, nphi = nufft.grid_shape(lmax)
    # 500 points in one quarter of the northern band (the bins of the
    # other half of phi stay empty), and 5000 with their stencil corner
    # in cell (40, 8): one bin
    rng = np.random.default_rng(4)
    theta = torch.as_tensor(rng.uniform(np.pi / 4, np.pi / 2, 500))
    phi = torch.as_tensor(rng.uniform(0, np.pi / 2, 500))
    u = 40 + 0.5 * w - 0.5 + rng.uniform(-0.4, 0.4, 5000)
    heavy_t = torch.as_tensor((u + 0.5) * 2 * np.pi / ntheta)
    heavy_p = torch.as_tensor((8 + 0.5 * w - 0.5 + rng.uniform(-0.4, 0.4, 5000))
                              * 2 * np.pi / nphi)
    theta, phi = torch.cat([theta, heavy_t]), torch.cat([phi, heavy_p])
    bins, counts, offsets = nufft.bin_points_plain(theta, phi, lmax, w)
    heavy = int(bins[-1])
    assert bool((bins[-5000:] == heavy).all()) and int(counts[heavy]) >= 5000
    assert bool((counts == 0).any())
    subs, bbin, chunk = nufft.subproblems_plain(counts, max_sub)
    nsub = -(-counts // max_sub)
    assert int(subs[0]) == 0 and torch.equal(subs[1:], torch.cumsum(nsub, 0))
    assert bbin.shape == chunk.shape == (int(subs[-1]),)
    assert bool((counts[bbin] > 0).all()) and bool((chunk >= 0).all())
    assert int((bbin == heavy).sum()) == -(-int(counts[heavy]) // max_sub)
    # the kernel's launch has at least as many blocks as subproblems
    assert int(subs[-1]) <= -(-theta.shape[0] // max_sub) + counts.shape[0]
    begin = offsets[bbin] + chunk * max_sub
    end = torch.minimum(begin + max_sub, offsets[bbin] + counts[bbin])
    assert bool((end > begin).all())
    cover = torch.zeros(theta.shape[0] + 1, dtype=torch.int64)
    cover.index_add_(0, begin, torch.ones_like(begin))
    cover.index_add_(0, end, -torch.ones_like(end))
    assert bool((torch.cumsum(cover, 0)[:-1] == 1).all())


def test_bin_points_needs_the_card():
    """The kernel's binning runs only on the card; the CPU has the plain
    version."""
    theta, phi = _points(8, 6, 10, 5)
    with pytest.raises(ValueError, match="on the card"):
        nufft.bin_points(theta, phi, 8, 6)
    assert nufft.LAUNCHES["spread"] == 0


@pytest.mark.parametrize("complex_vals", [False, True])
def test_spread_takes_a_page_without_points(complex_vals):
    """An empty page spreads nothing (the kernel's launcher returns at
    once on the card; the plain version here)."""
    pad = nufft.alloc_padded(2, 8, 6, complex_vals, "cpu")
    vals = np.zeros((2, 0), complex if complex_vals else float)
    assert nufft.spread_padded(np.zeros(0), np.zeros(0), vals, 8, 6, pad) is pad
    assert not bool(pad.any())
