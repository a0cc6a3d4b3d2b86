"""The port's compositor against the JAX package's.

The same binned tables (from JAX bin_pairs, or built by hand) go through
JAX rasterize_pallas (interpret mode, exact profile, one and four worklist
entries per grid step), the NumPy rasterize_reference and the port's
rasterize (its plain version on the CPU). Tolerance: max abs 1e-4 per
channel, the slack for FP32 summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswt_renderer_tpu.ops import binning as jbin
from gswt_renderer_tpu.ops import raster as jr
from gswt_renderer_tpu_torch.ops import kernels
from gswt_renderer_tpu_torch.ops import raster as tr

TOL = 1e-4


def _proj(n, seed, w, h):
    """Synthetic projection outputs with PSD quadratics (numpy)."""
    rng = np.random.default_rng(seed)
    cx = rng.uniform(-20, w + 20, n).astype(np.float32)
    cy = rng.uniform(-20, h + 20, n).astype(np.float32)
    qa = rng.uniform(0.002, 0.1, n).astype(np.float32)
    qc = rng.uniform(0.002, 0.1, n).astype(np.float32)
    qb = (rng.uniform(-0.6, 0.6, n) * np.sqrt(qa * qc)).astype(np.float32)
    # extent of the exp(-4) ellipse: sqrt(4 * [Q^-1]_ii)
    det = qa * qc - qb * qb
    ext_x = np.sqrt(4.0 * qc / det).astype(np.float32)
    ext_y = np.sqrt(4.0 * qa / det).astype(np.float32)
    col = rng.uniform(0.0, 1.0, (4, n)).astype(np.float32)
    col[3] = rng.uniform(0.3, 0.99, n)
    return dict(cx=cx, cy=cy, ext_x=ext_x, ext_y=ext_y, q=(qa, qb, qc),
                color=tuple(col), z=rng.uniform(0.0, 1.0, n).astype(np.float32),
                valid=rng.random(n) > 0.3)


def _jax_tree(p):
    return jax.tree_util.tree_map(jnp.asarray, p)


def _port_binned(b):
    return dict(table=torch.from_numpy(np.array(b["table"])),
                range_start=torch.from_numpy(np.array(b["range_start"])),
                range_end=torch.from_numpy(np.array(b["range_end"])))


def _compare(b, depth, *, image_wh, tile_wh, chunk, use_depth):
    got = tr.rasterize(_port_binned(b), torch.from_numpy(depth),
                       image_wh=image_wh, tile_wh=tile_wh, chunk=chunk,
                       use_depth=use_depth).numpy()
    for step in (1, 4):
        want = np.asarray(jr.rasterize_pallas(
            b, jnp.asarray(depth), image_wh=image_wh, tile_wh=tile_wh,
            chunk=chunk, interpret=True, exact=True, use_depth=use_depth,
            step=step))
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    if use_depth:  # the reference always tests depth
        bn = {k: np.asarray(v) for k, v in b.items()}
        ref = jr.rasterize_reference(bn, depth, image_wh=image_wh,
                                     tile_wh=tile_wh, chunk=chunk)
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    return got


@pytest.mark.parametrize("use_depth", [False, True])
def test_plain_matches_jax_on_binned_pairs(use_depth):
    image_wh, tile_wh, chunk = (256, 128), (64, 32), 128
    b = jbin.bin_pairs(_jax_tree(_proj(1500, 0, *image_wh)),
                       image_wh=image_wh, tile_wh=tile_wh, max_pairs=1 << 14,
                       chunk=chunk, exact=True, cull_exact=True)
    assert not bool(b["overflow"])
    n_tiles = 4 * 4
    rng = np.random.default_rng(1)
    depth = (rng.uniform(0.2, 1.0, (n_tiles, 64 * 32)).astype(np.float32)
             if use_depth else np.ones((n_tiles, 64 * 32), np.float32))
    got = _compare(b, depth, image_wh=image_wh, tile_wh=tile_wh, chunk=chunk,
                   use_depth=use_depth)
    assert got[:, 3].max() > 0.5


def _saturating_table(chunk, rs0, alpha):
    """Two 64x32 tiles over a hand-built table. Tile 0's run [rs0, rs0+300)
    starts off a chunk boundary and holds full-coverage splats of `alpha`
    sized so its max T drops just under MIN_T exactly at the first GLOBAL
    chunk boundary; tile 1 holds weaker splats and never saturates."""
    n_dom = 8 * chunk
    table = np.zeros((16, n_dom), np.float32)
    table[5] = -1e30
    table[11] = -np.inf
    key = np.full(n_dom, 2, np.int32)
    rng = np.random.default_rng(5)
    runs = [(rs0, rs0 + 300, alpha), (rs0 + 300, rs0 + 600, 0.02)]
    for tile, (lo, hi, a) in enumerate(runs):
        m = hi - lo
        table[5, lo:hi] = 0.0  # exponent 0 at every pixel: full coverage
        table[6, lo:hi] = rng.uniform(0.0, 1.0, m)
        table[8:11, lo:hi] = rng.uniform(0.2, 1.0, (3, m))
        table[11, lo:hi] = np.log(a)
        table[12, lo:hi] = np.arange(lo, hi)
        key[lo:hi] = tile
    wl = jbin.build_worklist(jnp.asarray(key), n_tiles=2, max_pairs=n_dom,
                             chunk=chunk)
    return dict(table=jnp.asarray(table), **{
        k: wl[k] for k in ("entry_tf", "entry_chunk", "range_start",
                           "range_end")})


@pytest.mark.parametrize("use_depth", [False, True])
def test_early_exit_falls_on_global_chunk_boundaries(use_depth):
    """A tile that saturates mid-run: the kernel may only skip where a
    global multiple of `chunk` begins. Skipping anywhere else (or never)
    changes alpha by ~T * 1 ~ 1.5e-3, fifteen times the tolerance."""
    chunk, rs0 = 128, 100
    # (1 - a)^(128 - rs0) = 1.5e-3 < MIN_T at the first global boundary
    alpha = 1.0 - 1.5e-3 ** (1.0 / (chunk - rs0))
    b = _saturating_table(chunk, rs0, alpha)
    depth = np.full((2, 64 * 32), 2.0, np.float32)
    got = _compare(b, depth, image_wh=(128, 32), tile_wh=(64, 32),
                   chunk=chunk, use_depth=use_depth)
    t_at_cut = (1.0 - alpha) ** (chunk - rs0)
    assert t_at_cut < jr.MIN_T
    # tile 0 stopped at the cut: its alpha is 1 - T there, to float32
    np.testing.assert_allclose(got[0, 3], 1.0 - t_at_cut, atol=1e-5)


def test_random_depth_masks_fragments():
    chunk = 128
    b = _saturating_table(chunk, 0, 0.05)
    rng = np.random.default_rng(6)
    depth = rng.uniform(0.0, 1.0, (2, 64 * 32)).astype(np.float32)
    with_depth = _compare(b, depth, image_wh=(128, 32), tile_wh=(64, 32),
                          chunk=chunk, use_depth=True)
    without = _compare(b, depth, image_wh=(128, 32), tile_wh=(64, 32),
                       chunk=chunk, use_depth=False)
    assert with_depth[:, 3].mean() < without[:, 3].mean() - 0.1


def test_cpu_path_counts_no_launch_and_rejects_emit_zcut():
    b = _port_binned(_saturating_table(128, 0, 0.05))
    depth = torch.ones((2, 64 * 32))
    before = kernels.LAUNCHES["raster"]
    tr.rasterize(b, depth, image_wh=(128, 32), tile_wh=(64, 32), chunk=128)
    assert kernels.LAUNCHES["raster"] == before
    with pytest.raises(NotImplementedError):
        tr.rasterize(b, depth, image_wh=(128, 32), tile_wh=(64, 32),
                     chunk=128, emit_zcut=True)


@pytest.mark.parametrize("wh", [(256, 128), (200, 90)])
def test_tile_image_layouts_match_jax(wh):
    tile_wh = (64, 32)
    rng = np.random.default_rng(7)
    ntx, nty = -(-wh[0] // 64), -(-wh[1] // 32)
    acc = rng.standard_normal((ntx * nty, 4, 64 * 32)).astype(np.float32)
    np.testing.assert_array_equal(
        tr.tiles_to_image(torch.from_numpy(acc), image_wh=wh,
                          tile_wh=tile_wh).numpy(),
        np.asarray(jr.tiles_to_image(jnp.asarray(acc), image_wh=wh,
                                     tile_wh=tile_wh)))
    depth = rng.uniform(0, 1, (wh[1], wh[0])).astype(np.float32)
    np.testing.assert_array_equal(
        tr.image_to_depth_tiles(torch.from_numpy(depth), image_wh=wh,
                                tile_wh=tile_wh).numpy(),
        np.asarray(jr.image_to_depth_tiles(jnp.asarray(depth), image_wh=wh,
                                           tile_wh=tile_wh)))

