"""The port's triangle rasterizer (ops/trirast.py, plain PyTorch version on
the CPU) against the JAX package's Pallas kernel in interpret mode and the
per-pixel NumPy reference, on the same seeded numpy inputs.

Tolerances. triangle_planes: 1e-5 of each row's scale (a plane's c term
sums products of pixel coordinates, so the two compilers' FMA choices
show). Raster vs JAX on the SAME plane values: the plane evaluation may be
contracted to FMAs by XLA, which moves an edge pixel between triangles on
one ulp, so at most 0.1% of the pixels may differ by more than 1e-6 in z;
the rest agree to 1e-6 in z and 1e-5 in the attributes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswt_renderer_tpu.ops import trirast as jtri
from gswt_renderer_tpu_torch.ops import trirast as ttri
from torch_tables import fitted

W, H = 128, 96
TILE = (64, 32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _random_tris(n, rng, z_lo=0.1, z_hi=0.9):
    xs = rng.uniform(-20, W + 20, (3, n)).astype(np.float32)
    ys = rng.uniform(-20, H + 20, (3, n)).astype(np.float32)
    zs = rng.uniform(z_lo, z_hi, (3, n)).astype(np.float32)
    ws = rng.uniform(0.5, 4.0, (3, n)).astype(np.float32)
    attrs = rng.uniform(-1, 1, (3, 3, n)).astype(np.float32)
    return xs, ys, zs, ws, attrs


def _jax_planes(xs, ys, zs, ws, attrs):
    planes, ok, bbox = jtri.triangle_planes(
        *(jnp.asarray(a) for a in (xs, ys, zs, ws, attrs)),
        jnp.ones(xs.shape[1], bool))
    return (np.asarray(planes), np.asarray(ok),
            tuple(np.asarray(b) for b in bbox))


def _torch_raster(planes, bbox, ok, image_wh=(W, H), chunk=128):
    out = fitted(lambda cap: ttri.rasterize_triangles(
        _t(planes), tuple(_t(b) for b in bbox), _t(ok), image_wh=image_wh,
        tile_wh=TILE, chunk=chunk, capacity=cap), lambda o: o["n_pairs"])
    z, at = ttri.tiles_to_maps(out["tiles"], image_wh=image_wh, tile_wh=TILE)
    return z.numpy(), at.numpy(), out["n_pairs"]


def _jax_raster(planes, bbox, ok, image_wh=(W, H), chunk=128,
                max_pairs=1 << 12):
    out = jtri.rasterize_triangles(
        jnp.asarray(planes), tuple(jnp.asarray(b) for b in bbox),
        jnp.asarray(ok), image_wh=image_wh, tile_wh=TILE,
        max_pairs=max_pairs, chunk=chunk, interpret=True)
    assert not bool(out["overflow"])
    z, at = jtri.tiles_to_maps(out["tiles"], image_wh=image_wh, tile_wh=TILE)
    return np.asarray(z), np.asarray(at), int(out["n_pairs"])


def test_triangle_planes_match_jax():
    rng = np.random.default_rng(0)
    xs, ys, zs, ws, attrs = _random_tris(200, rng)
    ws[:, :7] = -1.0          # behind the camera: dropped
    xs[:, 7] = xs[0, 7]       # degenerate (zero area): dropped
    ys[:, 7] = ys[0, 7]
    jp, jok, jbbox = _jax_planes(xs, ys, zs, ws, attrs)
    tp, tok, tbbox = ttri.triangle_planes(
        _t(xs), _t(ys), _t(zs), _t(ws), _t(attrs),
        torch.ones(200, dtype=torch.bool))
    np.testing.assert_array_equal(tok.numpy(), jok)
    assert not jok[:8].any() and jok[8:].all()
    for a, b in zip(tbbox, jbbox):
        np.testing.assert_array_equal(a.numpy(), b)
    scale = np.abs(jp).max(axis=1, keepdims=True) + 1e-30
    assert (np.abs(tp.numpy() - jp) / scale).max() < 1e-5
    # two-attribute and no-attribute forms fill the unused planes with zeros
    tp2, _, _ = ttri.triangle_planes(
        _t(xs), _t(ys), _t(zs), _t(ws), _t(attrs[:2]),
        torch.ones(200, dtype=torch.bool))
    assert not tp2[21:].any() and torch.equal(tp2[:21], tp[:21])
    tp0, _, _ = ttri.triangle_planes(
        _t(xs), _t(ys), _t(zs), _t(ws), None, torch.ones(200, dtype=torch.bool))
    assert not tp0[15:].any()


@pytest.mark.parametrize("seed,n", [(1, 40), (2, 300)])
def test_rasterize_matches_jax_interpret_and_reference(seed, n):
    """n = 300 gives tiles whose runs span several 128-pair chunks."""
    rng = np.random.default_rng(seed)
    planes, ok, bbox = _jax_planes(*_random_tris(n, rng))
    z, at, n_pairs = _torch_raster(planes, bbox, ok)
    jz, jat, jn = _jax_raster(planes, bbox, ok)
    assert n_pairs == jn
    zd = np.abs(z - jz)
    assert (zd > 1e-6).mean() <= 1e-3, (zd > 1e-6).mean()
    same = zd <= 1e-6
    assert np.abs(at - jat)[:, same].max() < 1e-5
    assert (z < 1.0).mean() > 0.5, "triangles should cover the image"
    # the per-pixel reference resolves exact z ties first-wins instead of
    # averaging: compare where depths agree, as tests/test_trirast.py does
    z_ref, at_ref = ttri.rasterize_triangles_reference(
        planes, bbox, ok, image_wh=(W, H))
    zr = np.abs(z - z_ref)
    assert np.median(zr) < 1e-6 and (zr > 1e-5).mean() < 0.01
    assert np.abs(at - at_ref)[:, zr <= 1e-5].max() < 1e-3


def test_tie_rule_is_per_chunk_at_global_boundaries():
    """Coincident triangles (the same plane rows) across a 128-pair chunk
    boundary. Within a chunk all pairs at the minimum z average their
    attributes; a later chunk with the SAME z does not replace the pixel
    (strictly-less update). 200 copies of one triangle with attribute
    values 0..199 in one tile: chunk 0 holds copies 0..127 (mean 63.5),
    chunk 1 copies 128..199, which tie and lose. Shifting the run by 40
    dead-tile pairs moves the global chunk boundary inside the run: copies
    0..87 (mean 43.5) win."""
    n = 200
    xs = np.tile(np.array([[4.0], [60.0], [4.0]], np.float32), (1, n))
    ys = np.tile(np.array([[2.0], [2.0], [30.0]], np.float32), (1, n))
    zs = np.full((3, n), 0.5, np.float32)
    ws = np.ones((3, n), np.float32)
    attrs = np.zeros((3, 3, n), np.float32)
    attrs[0] = np.arange(n, dtype=np.float32)[None, :]
    for shift, want in ((0, 63.5), (40, 43.5)):
        # `shift` triangles confined to tile 0 come first in the sorted
        # table; the copies live in tile 1 (x offset by one tile width)
        pre = np.tile(np.array([[1.0], [3.0], [1.0]], np.float32), (1, shift))
        xs_all = np.concatenate([pre, xs + 64.0], axis=1)
        ys_all = np.concatenate(
            [np.tile(np.array([[1.0], [1.0], [3.0]], np.float32), (1, shift)),
             ys], axis=1)
        m = shift + n
        planes, ok, bbox = _jax_planes(
            xs_all, ys_all, np.full((3, m), 0.5, np.float32),
            np.ones((3, m), np.float32),
            np.concatenate([np.zeros((3, 3, shift), np.float32), attrs], 2))
        assert ok.all()
        z, at, n_pairs = _torch_raster(planes, bbox, ok)
        assert n_pairs == m
        jz, jat, _ = _jax_raster(planes, bbox, ok)
        inside = z[:32, 64:128] < 1.0
        assert inside.sum() > 300
        u = at[1][:32, 64:128][inside] / at[0][:32, 64:128][inside]
        np.testing.assert_allclose(u, want, rtol=1e-5)
        np.testing.assert_allclose(z, jz, rtol=0, atol=1e-6)
        np.testing.assert_allclose(at, jat, rtol=1e-5, atol=1e-6)


def test_nearer_triangle_in_a_later_chunk_replaces():
    """The running pixel IS replaced by a later chunk that is strictly
    nearer, and a triangle past z = 1 or before z = 0 never hits."""
    n = 130
    xs = np.tile(np.array([[4.0], [60.0], [4.0]], np.float32), (1, n))
    ys = np.tile(np.array([[2.0], [2.0], [30.0]], np.float32), (1, n))
    zs = np.full((3, n), 0.6, np.float32)
    zs[:, 129] = 0.3     # pair 129 lies in the second chunk and is nearer
    zs[:, 5] = -0.2      # before the near plane
    zs[:, 6] = 1.5       # beyond the far plane
    attrs = np.zeros((3, 3, n), np.float32)
    attrs[1, :, 129] = 7.0
    planes, ok, bbox = _jax_planes(xs, ys, zs, np.ones((3, n), np.float32),
                                   attrs)
    z, at, _ = _torch_raster(planes, bbox, ok)
    jz, jat, _ = _jax_raster(planes, bbox, ok)
    inside = z < 1.0
    np.testing.assert_allclose(z[inside], 0.3, atol=1e-6)
    np.testing.assert_allclose(at[2][inside], 7.0, rtol=1e-5)
    np.testing.assert_allclose(z, jz, rtol=0, atol=1e-6)
    np.testing.assert_allclose(at, jat, rtol=1e-5, atol=1e-6)


def test_empty_tiles_read_far_plane_and_offscreen_is_dropped():
    xs = np.array([[10.0, -500.0], [50.0, -400.0], [10.0, -500.0]], np.float32)
    ys = np.array([[10.0, 10.0], [10.0, 10.0], [28.0, 50.0]], np.float32)
    zs = np.full((3, 2), 0.4, np.float32)
    planes, ok, bbox = _jax_planes(xs, ys, zs, np.ones((3, 2), np.float32),
                                   np.zeros((3, 3, 2), np.float32))
    out = ttri.rasterize_triangles(
        _t(planes), tuple(_t(b) for b in bbox), _t(ok), image_wh=(W, H),
        tile_wh=TILE, capacity=128)
    assert out["n_pairs"] == 1  # the off-screen triangle makes no pair
    tiles = out["tiles"].numpy()
    assert tiles.shape == (6, 5, 64 * 32)
    assert (tiles[1:, 0] == 1.0).all() and (tiles[1:, 1:] == 0.0).all()
    assert (tiles[0, 0] < 1.0).sum() > 100
    # no triangle at all
    none = ttri.rasterize_triangles(
        _t(planes), tuple(_t(b) for b in bbox), torch.zeros(2, dtype=torch.bool),
        image_wh=(W, H), tile_wh=TILE, capacity=128)
    assert none["n_pairs"] == 0
    assert (none["tiles"][:, 0] == 1.0).all()
    assert (none["tiles"][:, 1:] == 0.0).all()
