"""The compositor's cluster (csrc/raster.cu: a tile's 32 warps as four
thread blocks of 8, on four SMs) against the plain versions, on the card.

Every test needs a CUDA device and skips without one. This file imports
nothing of JAX:

    GSWT_TEST_TPU=1 python -m pytest tests/test_torch_raster_cluster.py -q

Each case runs the kernel in its four (exact, emit_zcut) variants, in the
16x4-block warp layout and the flat one (the eight instantiations), and
holds the image to the bit against torch_tables.composite_walk (the
per-pixel recurrence pair by pair with the kernel's operations) and within
TOL of rasterize_plain(block_mask=True), whose colour sums are a matrix
product in another order, and the saturation-slot record equal to
rasterize_plain(block_mask=True)'s."""

import pytest
import torch

from gswt_renderer_tpu_torch.ops import binning, kernels, raster
from torch_tables import (composite_walk, cover_splats, fitted,
                          one_rank_splats, opaque_splats, rank_splats,
                          runs_binned, warp_rank)

TOL = 1e-4
VARIANTS = [(True, False), (False, False), (True, True), (False, True)]
# a tile shape in each warp layout
LAYOUTS = [(64, 32), (100, 20)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def check(b, depth, *, image_wh, tile_wh, chunk, exact, emit_zcut,
          use_depth=True):
    """One launch of the kernel against both plain versions; returns the
    image and rasterize_plain's stats."""
    kw = dict(image_wh=image_wh, tile_wh=tile_wh, chunk=chunk,
              use_depth=use_depth, exact=exact)
    before = kernels.LAUNCHES["raster"]
    got = raster.rasterize(b, depth, emit_zcut=emit_zcut, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["raster"] == before + 1
    st = {}
    want = raster.rasterize_plain(b, depth, emit_zcut=emit_zcut,
                                  block_mask=True, stats=st, **kw)
    if emit_zcut:
        (got, zcut), (want, zwant) = got, want
        assert torch.equal(zcut, zwant)
    walk = composite_walk(b, depth, tile_wh=tile_wh, chunk=chunk,
                          use_depth=use_depth, exact=exact)
    assert torch.equal(got, walk), float((got - walk).abs().max())
    assert float((got - want).abs().max()) <= TOL
    assert st["missed"] == 0
    return got, st


def _depth(n_tiles, tile_wh, device, seed=2):
    """Depths 0.6 .. 1 over the strip tables' z of 0 .. 0.5: every pair
    passes the depth test, and the mask still reads each block's."""
    g = torch.Generator(device=device).manual_seed(seed)
    return 0.6 + 0.4 * torch.rand((n_tiles, tile_wh[0] * tile_wh[1]),
                                  device=device, generator=g)


@pytest.mark.parametrize("tile_wh", LAYOUTS)
@pytest.mark.parametrize("exact,emit_zcut", VARIANTS)
def test_exit_waits_for_every_rank(cuda, tile_wh, exact, emit_zcut):
    """A run of over 64 chunks: 64 chunks of pairs that saturate the pixels
    of the cluster's block 1 alone (the other blocks' pixels away from its
    warp blocks keep T = 1), then pairs over the whole tile that saturate
    it within a chunk or two, then more that the early exit must skip;
    beside it a short tile. The exit comes at the first boundary after the
    whole tile saturates, not before."""
    chunk = 64
    rank = rank_splats(8, 1, tile_wh, 1)
    cover = cover_splats(26 * chunk, 2, tile_wh)
    b = runs_binned([torch.cat([rank, cover], 1),
                     cover_splats(90, 3, tile_wh)], chunk, offset=37)
    b = {k: v.to(cuda) for k, v in b.items()}
    image_wh = (2 * tile_wh[0], tile_wh[1])
    depth = _depth(2, tile_wh, cuda)
    _, st = check(b, depth, image_wh=image_wh, tile_wh=tile_wh, chunk=chunk,
                  exact=exact, emit_zcut=emit_zcut)
    entries, needed = int(st["tile_entries"][0]), int(st["tile_needed"][0])
    assert entries >= 64
    # block 1's pixels saturate in the first entries, the rest only once
    # the cover pairs come (from entry 64 on)
    first = runs_binned([rank], chunk, offset=37)
    alpha = raster.rasterize_plain(
        {k: v.to(cuda) for k, v in first.items()}, depth[:1],
        image_wh=tile_wh, tile_wh=tile_wh, chunk=chunk)[0, 3]
    _, warp = raster.warp_layout(tile_wh, cuda)
    assert float(alpha[warp_rank(warp) == 1].min()) > 1.0 - raster.MIN_T
    assert float(alpha.min()) == 0.0
    assert 64 < needed < entries


@pytest.mark.parametrize("tile_wh", [(64, 32), (48, 40)])
@pytest.mark.parametrize("exact,emit_zcut", VARIANTS)
def test_pairs_that_reach_one_rank_only(cuda, tile_wh, exact, emit_zcut):
    """Tiles whose pairs reach the warp blocks of one block of the cluster
    only (another in each tile), in the 16x4-block layout (48x40 with two
    warps without pixels; in the flat layout a warp's rectangle spans whole
    rows, which its neighbours share): the other blocks composite nothing
    and join every barrier; the tiles run to their end, since the other
    blocks' pixels never saturate."""
    chunk = 128
    runs = [one_rank_splats(700 + 97 * t, 10 + t, tile_wh, t)
            for t in range(4)]
    b = {k: v.to(cuda) for k, v in runs_binned(runs, chunk).items()}
    image_wh = (2 * tile_wh[0], 2 * tile_wh[1])
    _, st = check(b, _depth(4, tile_wh, cuda), image_wh=image_wh,
                  tile_wh=tile_wh, chunk=chunk, exact=exact,
                  emit_zcut=emit_zcut)
    assert 0 < st["visits"] <= 8 * st["pairs"]
    assert st["skipped"] == 0


@pytest.mark.parametrize("tile_wh", [(100, 20), (64, 20), (32, 16),
                                     (16, 8), (64, 32)])
@pytest.mark.parametrize("exact,emit_zcut", VARIANTS)
def test_binned_splats_across_tile_shapes(cuda, tile_wh, exact, emit_zcut):
    """bin_pairs' own table of opaque splats under a random depth, in tile
    shapes whose bands of the saturation record each span several blocks
    of the cluster: 100x20 (flat layout), 64x20 (five rows of blocks),
    32x16 (eight blocks, two a rank), 16x8 (two blocks: ranks 2 and 3
    without pixels) and 64x32."""
    image_wh = (3 * tile_wh[0], 4 * tile_wh[1])
    p = opaque_splats(2500, 4, cuda)
    p["cx"] = p["cx"] * (image_wh[0] / 256)
    p["cy"] = p["cy"] * (image_wh[1] / 128)
    p["color"] = p["color"][:3] + (p["color"][3] * 0.5,)
    b = fitted(lambda cap: binning.bin_pairs(
        p, image_wh=image_wh, tile_wh=tile_wh, chunk=256, exact=exact,
        capacity=cap), lambda b: b["n_pairs"], 256)
    n_tiles = b["range_start"].shape[0]
    depth = 0.1 + 0.9 * torch.rand(
        (n_tiles, tile_wh[0] * tile_wh[1]), device=cuda,
        generator=torch.Generator(device=cuda).manual_seed(3))
    got, _ = check(b, depth, image_wh=image_wh, tile_wh=tile_wh, chunk=256,
                   exact=exact, emit_zcut=emit_zcut)
    assert float(got[:, 3].max()) > 0.5


@pytest.mark.parametrize("exact", [True, False])
def test_max_run_equals_the_plain_binning(cuda, exact):
    """binning's max_run on the card: the plain path's, the longest run."""
    image_wh, tile_wh = (256, 128), (64, 32)
    p = opaque_splats(3000, 5, cuda)
    kw = dict(image_wh=image_wh, tile_wh=tile_wh, chunk=128, exact=exact)
    demand = binning.bin_pairs_plain(p, capacity=128, **kw)["n_pairs"]
    cap = binning.fit_capacity(demand, 128)
    got = binning.bin_pairs(p, capacity=cap, **kw)
    want = binning.bin_pairs_plain(p, capacity=cap, **kw)
    runs = got["range_end"] - got["range_start"]
    assert got["max_run"].dtype == torch.int64 and got["max_run"].shape == ()
    assert int(got["max_run"]) == int(want["max_run"]) == int(runs.max())
    assert int(got["max_run"]) > 256
