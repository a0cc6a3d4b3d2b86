"""The triangle raster's design for the card in its plain forms
(ops/trirast.py): the warp-block mask (tri_block_mask), the raster that skips
what it leaves out (rasterize_triangles_plain(block_mask=True)) and the
split into (tile, chunk) entries folded in chunk order
(rasterize_split_plain: trirast_entries_plain then trirast_fold_plain, with
the kernels' scratch slots). Each is held BIT-equal to the plain spec
rasterize_triangles_plain on the adversarial triangles of
tests/torch_tables.py; a negative margin is shown to miss pixels; one small
case is held against the JAX package's Pallas kernel in interpret mode with
tests/test_torch_trirast.py's tolerance (XLA may contract a plane
evaluation to an FMA, which moves an edge pixel on one ulp: at most 0.1% of
the pixels may differ by more than 1e-6 in z, the rest agree to 1e-6 in z
and 1e-5 in the attributes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswt_renderer_tpu.ops import trirast as jtri
from gswt_renderer_tpu_torch.ops import raster as traster
from gswt_renderer_tpu_torch.ops import trirast as ttri
from torch_tables import (TRI_KINDS, adversarial_triangles, binned_triangles,
                          fitted)

IMG = (384, 256)
TILE = (64, 32)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for these small tensors: under the suite's
    parallel workers PyTorch's default pool (a thread per core in every
    worker) oversubscribes the host, which made this file ~15x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _kw(chunk, image_wh=IMG):
    return dict(image_wh=image_wh, tile_wh=TILE, chunk=chunk)


def _spec_and_masked(rows, rs, re_, chunk):
    st = {}
    spec = ttri.rasterize_triangles_plain(rows, rs, re_, **_kw(chunk))
    masked = ttri.rasterize_triangles_plain(rows, rs, re_, block_mask=True,
                                            stats=st, **_kw(chunk))
    return spec, masked, st


@pytest.mark.parametrize("chunk", [32, 128])
@pytest.mark.parametrize("kind", TRI_KINDS)
def test_masked_raster_bit_equal_per_kind(kind, chunk):
    """Each kind alone: the mask keeps every block in which a pair hits a
    pixel centre, skips some, and the masked raster is the spec's bits."""
    rows, rs, re_, n = binned_triangles(
        adversarial_triangles(3, kinds=(kind,)))
    assert n > 0
    spec, masked, st = _spec_and_masked(rows, rs, re_, chunk)
    assert torch.equal(masked, spec)
    assert st["missed"] == 0
    assert st["hits"] > 0 or kind == "sliver"   # slivers reach no centre
    assert st["visits"] < st["blocks"]


@pytest.mark.parametrize("chunk", [32, 128])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_then_fold_bit_equal(seed, chunk):
    """Every kind together: runs that start mid-chunk and span several
    chunks, empty tiles, ties across chunk boundaries. The split (each
    entry on its own, then the fold) is the spec's bits, and so is the
    masked raster."""
    rows, rs, re_, _ = binned_triangles(
        adversarial_triangles(seed, n_per_kind=16))
    spec, masked, st = _spec_and_masked(rows, rs, re_, chunk)
    split = ttri.rasterize_split_plain(rows, rs, re_, **_kw(chunk))
    assert torch.equal(split, spec)
    assert torch.equal(masked, spec)
    assert st["missed"] == 0
    live = re_ > rs
    assert int(st["chunks"].max()) >= 2
    assert bool((rs[live] % chunk != 0).any())   # runs start mid-chunk
    assert int((~live).sum()) >= 6               # the empty bottom row
    assert bool((spec[~live, 0] == 1.0).all()) and not spec[~live, 1:].any()


def test_entries_leave_the_fold_its_tiles():
    """trirast_entries_plain writes the empty tiles (far plane) and those
    of one chunk; the tiles of several chunks stay for the fold (NaN here),
    which reads only the slots their entries wrote."""
    rows, rs, re_, _ = binned_triangles(
        adversarial_triangles(1, n_per_kind=16))
    chunk = 32
    scratch, out = ttri.trirast_entries_plain(rows, rs, re_, **_kw(chunk))
    c0 = torch.div(rs, chunk, rounding_mode="floor")
    c1 = torch.div(re_ - 1, chunk, rounding_mode="floor")
    multi = (re_ > rs) & (c0 != c1)
    assert not torch.isnan(out[~multi]).any()
    assert torch.isnan(out[multi]).all()
    assert bool((out[re_ <= rs, 0] == 1.0).all())
    folded = ttri.trirast_fold_plain(scratch, out, rs, re_, chunk=chunk)
    assert not torch.isnan(folded).any()
    assert scratch.shape == (2 * -(-rows.shape[1] // chunk), 5, 2048)
    assert torch.isnan(scratch).any()   # slots no tile needed


def test_negative_margin_misses_pixels(monkeypatch):
    """The mutation check: with the margin made negative the mask drops
    blocks whose only hits lie on an edge through pixel centres (b = 0
    exactly), and the masked raster loses pixels the spec hits."""
    monkeypatch.setattr(ttri, "_MASK_REL", -(2.0 ** -20))
    rows, rs, re_, _ = binned_triangles(
        adversarial_triangles(0, kinds=("edge_centres",), n_per_kind=24))
    spec, masked, st = _spec_and_masked(rows, rs, re_, 128)
    assert st["missed"] > 0
    assert not torch.equal(masked, spec)
    assert int(((masked[:, 0] < 1.0) != (spec[:, 0] < 1.0)).sum()) > 0


def test_edge_through_block_corner_keeps_the_block():
    """A right triangle whose legs run along pixel-centre lines and whose
    corner is the last pixel centre of a 16x4 warp block: that pixel hits
    (b = 0 counts as inside), so the mask must keep the block although the
    triangle lies beyond it."""
    xs = np.array([[15.5], [47.5], [15.5]], np.float32)
    ys = np.array([[3.5], [3.5], [27.5]], np.float32)
    tris = (xs, ys, np.full((3, 1), 0.5, np.float32),
            np.ones((3, 1), np.float32), np.zeros((3, 3, 1), np.float32))
    rows, rs, re_, n = binned_triangles(tris)
    assert n == 1
    spec, masked, st = _spec_and_masked(rows, rs, re_, 128)
    assert torch.equal(masked, spec)
    assert float(spec[0, 0, 3 * 64 + 15]) == 0.5   # pixel (15, 3)
    rects, _ = traster.warp_layout(TILE)
    reach = ttri.tri_block_mask(
        rows[:, :1], ttri.tile_rects(torch.tensor([0]), TILE, 6, rects))
    assert bool(reach[0, 0])          # block (0, 0): only its corner hits
    assert not bool(reach[0, 29])     # block (1, 7): wholly past the
    # hypotenuse, where b0 < 0 at every centre


def test_block_mask_keeps_nan_and_skips_blocks_without_pixels():
    rows = torch.zeros((24, 2))
    rows[0, 0] = float("nan")          # a NaN plane
    rows[2, 1] = -1.0                  # b0 = -1 everywhere: never inside
    rects, _ = traster.warp_layout((40, 40))   # 30 blocks of 32 warps
    r = ttri.tile_rects(torch.tensor([0]), (40, 40), 1, rects)
    reach = ttri.tri_block_mask(rows, r)
    has_pixels = rects[:, 0] <= rects[:, 1]
    assert not bool(has_pixels.all())
    assert torch.equal(reach[0], has_pixels)
    assert not bool(reach[1].any())


def _jax_planes(tris):
    xs, ys, zs, ws, attrs = tris
    planes, ok, bbox = jtri.triangle_planes(
        *(jnp.asarray(a) for a in (xs, ys, zs, ws, attrs)),
        jnp.ones(xs.shape[1], bool))
    return (np.asarray(planes), np.asarray(ok),
            tuple(np.asarray(b) for b in bbox))


def test_split_and_masked_rasters_match_jax_interpret():
    image_wh = (192, 160)
    # (XLA's contraction moves the edge-centre kind's pixels, set exactly on
    # edges, across them more often than the 0.1% allowed, and the
    # near-plane kind's steep attribute planes past 1e-5: the tests above
    # hold both bit-equal to the port's own spec instead)
    tris = adversarial_triangles(5, image_wh, kinds=("random", "ties"),
                                 n_per_kind=24)
    tris[4][0] /= tris[4].shape[2]   # attributes in [-1, 1], as there
    planes, ok, bbox = _jax_planes(tris)
    t = lambda a: torch.from_numpy(np.array(a))
    rows, rs, re_, n = fitted(lambda cap: ttri.bin_triangles(
        t(planes), tuple(t(b) for b in bbox), t(ok), image_wh=image_wh,
        tile_wh=TILE, capacity=cap), lambda out: out[3])
    kw = _kw(128, image_wh)
    split = ttri.rasterize_split_plain(rows, rs, re_, **kw)
    masked = ttri.rasterize_triangles_plain(rows, rs, re_, block_mask=True,
                                            **kw)
    assert torch.equal(split, masked)
    z, at = (a.numpy() for a in ttri.tiles_to_maps(split, image_wh=image_wh,
                                                   tile_wh=TILE))
    out = jtri.rasterize_triangles(
        jnp.asarray(planes), tuple(jnp.asarray(b) for b in bbox),
        jnp.asarray(ok), image_wh=image_wh, tile_wh=TILE,
        max_pairs=1 << 12, chunk=128, interpret=True)
    assert not bool(out["overflow"]) and int(out["n_pairs"]) == n
    jz, jat = (np.asarray(a) for a in jtri.tiles_to_maps(
        out["tiles"], image_wh=image_wh, tile_wh=TILE))
    zd = np.abs(z - jz)
    assert (zd > 1e-6).mean() <= 1e-3, (zd > 1e-6).mean()
    same = zd <= 1e-6
    assert np.abs(at - jat)[:, same].max() < 1e-5
    assert (z < 1.0).mean() > 0.05


def test_mask_ab_takes_out_only_the_mask():
    """benchmarks/trirast_mask_ab builds the kernel without its mask by
    replacing the mask's one call: the call is found once, and the build
    it makes keeps every pair in every block and changes nothing else."""
    from gswt_renderer_tpu_torch.benchmarks import trirast_mask_ab as ab
    from gswt_renderer_tpu_torch.ops import kernels

    with open(f"{kernels.CSRC}/trirast.cu") as f:
        src = f.read()
    out = ab.unmasked_source()
    assert src.count(ab.MASK_CALL) == 1
    assert "pair_reaches_block(s_tab" not in out
    assert out == src.replace(ab.MASK_CALL, "kFull")
    assert "const unsigned m = kFull;" in out
