"""The port's proxy-depth occlusion cull (ops/binning.py occ_zimg and the
Renderer's depth_cull wiring) against the JAX package's.

The cull drops pairs that fail the compositor's `z < depth` test at every
pixel of their tile, so a frame with it equals the frame without it within
the bound tests/test_depth_cull.py states (1e-4 per channel: only the early
exit's grouping moves), while the pair table shrinks; the kept pairs are
the ones the JAX package keeps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswt_renderer_tpu.ops import binning as jbin
from gswt_renderer_tpu_torch import core as tcore
from gswt_renderer_tpu_torch.core.config import (
    SelectiveMergeType, SurfaceType, TileSortType)
from gswt_renderer_tpu_torch.engine import Engine
from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec
from gswt_renderer_tpu_torch.ops import binning as tbin
from gswt_renderer_tpu_torch.ops import raster
from gswt_renderer_tpu_torch.render.pipeline import RendererConfig
from torch_tables import fitted

IMAGE_WH, TILE_WH, CHUNK = (256, 128), (64, 32), 128


def test_dilate_max2_matches_jax_and_window_semantics():
    rng = np.random.default_rng(0)
    z = rng.random((5, 7)).astype(np.float32)
    d = tbin._dilate_max2(torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(d, np.asarray(jbin._dilate_max2(jnp.asarray(z))))
    for y in range(5):
        for x in range(7):
            assert d[y, x] == z[y:min(y + 2, 5), x:min(x + 2, 7)].max()


def test_zmax_lookup_matches_jax():
    rng = np.random.default_rng(1)
    nty, ntx = 9, 11
    zimg = rng.random((nty, ntx)).astype(np.float32)
    tx = rng.integers(-1, ntx + 1, 300)
    ty = rng.integers(-1, nty + 1, 300)
    got = tbin._zmax_lookup(torch.from_numpy(tx), torch.from_numpy(ty),
                            torch.from_numpy(zimg)).numpy()
    ref = np.asarray(jbin._zmax_lookup(
        jnp.asarray(tx.astype(np.int32)), jnp.asarray(ty.astype(np.int32)),
        jnp.asarray(zimg)))
    np.testing.assert_array_equal(got, ref)
    inb = (tx >= 0) & (tx < ntx) & (ty >= 0) & (ty < nty)
    assert (got[~inb] == 0.0).all() and (~inb).any()


def _proj(n, seed):
    rng = np.random.default_rng(seed)
    qa = rng.uniform(0.01, 0.3, n).astype(np.float32)
    qc = rng.uniform(0.01, 0.3, n).astype(np.float32)
    qb = (0.5 * np.sqrt(qa * qc) * np.sign(rng.normal(size=n))).astype(
        np.float32)
    return dict(
        cx=rng.uniform(-20, 276, n).astype(np.float32),
        cy=rng.uniform(-20, 148, n).astype(np.float32),
        ext_x=rng.uniform(1, 90, n).astype(np.float32),
        ext_y=rng.uniform(1, 60, n).astype(np.float32),
        q=(qa, qb, qc), z=rng.uniform(0.1, 0.9, n).astype(np.float32),
        color=tuple(rng.random(n).astype(np.float32) for _ in range(4)),
        valid=rng.random(n) < 0.8,
    )


def _zimg(kind):
    zimg = np.full((4, 4), 1.0, np.float32)
    if kind == "half":
        zimg[:, 2:] = 0.3   # right half near: pairs with z >= 0.3 die there
    else:
        zimg[:] = np.random.default_rng(7).uniform(0.2, 0.9, (4, 4))
    return zimg


@pytest.mark.parametrize("kind", ["half", "random"])
@pytest.mark.parametrize("cull_exact", [False, True])
def test_occ_zimg_keeps_the_pairs_jax_keeps(kind, cull_exact):
    p = _proj(3000, 3)
    zimg = _zimg(kind)
    jb = jbin.bin_pairs(
        jax.tree_util.tree_map(jnp.asarray, p), image_wh=IMAGE_WH,
        tile_wh=TILE_WH, max_pairs=1 << 15, chunk=CHUNK, exact=True,
        elem_paths=2, cull_exact=cull_exact, occ_zimg=jnp.asarray(zimg))
    assert not bool(jb["overflow"])
    tp = jax.tree_util.tree_map(torch.from_numpy, p)
    cap = tbin.fit_capacity(jb["n_pairs"], CHUNK)
    tb = tbin.bin_pairs(tp, image_wh=IMAGE_WH, tile_wh=TILE_WH, chunk=CHUNK,
                        cull_exact=cull_exact, occ_zimg=torch.from_numpy(zimg),
                        capacity=cap)
    base = fitted(lambda c: tbin.bin_pairs(
        tp, image_wh=IMAGE_WH, tile_wh=TILE_WH, chunk=CHUNK,
        cull_exact=cull_exact, capacity=c), lambda b: b["n_pairs"], CHUNK)
    rs, re_ = np.asarray(jb["range_start"]), np.asarray(jb["range_end"])
    np.testing.assert_array_equal(tb["range_start"].numpy(), rs)
    np.testing.assert_array_equal(tb["range_end"].numpy(), re_)
    jt, tt = np.asarray(jb["table"]), tb["table"].numpy()
    for a, b in zip(rs, re_):  # each tile's run of stream slots
        np.testing.assert_array_equal(tt[12, a:b], jt[12, a:b])
    assert int(tb["n_pairs_kept"]) == int(jb["n_pairs_kept"])
    assert tb["n_pairs"] == int(jb["n_pairs"])       # after the splat level
    assert int(tb["n_live"]) == int(jb["n_live"])
    assert tb["n_pairs"] < base["n_pairs"]
    assert int(tb["n_pairs_kept"]) < int(base["n_pairs_kept"])

    # the compositor's image is the same with and without the cull
    depth_tiles = torch.from_numpy(
        np.repeat(zimg.reshape(-1)[:, None], TILE_WH[0] * TILE_WH[1], 1))
    kw = dict(image_wh=IMAGE_WH, tile_wh=TILE_WH, chunk=CHUNK, use_depth=True)
    out_c = raster.rasterize(tb, depth_tiles, **kw).numpy()
    out_b = raster.rasterize(base, depth_tiles, **kw).numpy()
    np.testing.assert_allclose(out_c, out_b, rtol=0, atol=2e-5)


def test_depth_cull_frame_equals_frame_without_it():
    """A full-config frame through Engine, the scene of
    tests/test_depth_cull.py::test_depth_cull_engine_frame_parity: the
    proxy raised into the splat band, fine raster tiles."""
    sky = np.clip(np.linspace(0, 2, 16)[:, None, None]
                  * np.ones((16, 32, 3), np.float32), 0, 2)
    checker = np.kron(np.indices((8, 8)).sum(0) % 2,
                      np.ones((4, 4))).astype(np.float32)
    tex = np.stack([checker * 0.8 + 0.1, checker * 0.5 + 0.2,
                    checker * 0.3 + 0.1], axis=-1)
    outs = {}
    for dc in (False, True):
        eng = Engine(
            synthetic_scene_vec(n_lod=2, splats_per_tile=48),
            viewport=(64, 64),
            renderer_config=RendererConfig(
                width=64, height=64, max_draws=64, max_stream=1 << 13,
                chunk=128, depth_cull=dc, tile_w=16, tile_h=8, exact=True),
            synchronous=True, device="cpu")
        eng.set_skybox(sky, equirect=True)
        eng.set_proxy(tex)
        eng.configure(tcore.UserData.from_ui(
            tile_map_half_wh=(2, 2), height_map_scale=(1.0, 0.0),
            lod_max_dist=8.0, surface_type=SurfaceType.NONE,
            merge_type=SelectiveMergeType.NONE,
            tile_sort_type=TileSortType.DISTANCE, lod_blending=False))
        assert eng.wait_ready(timeout_s=300)
        eng.render_config.proxy_height = 0.5
        eng.camera = tcore.Camera(
            (64, 64), position=(0.0, -6.0, 6.0), target=(0.0, 2.0, 0.0),
            up=(0.0, 0.0, 1.0), fovy_rad=np.deg2rad(45.0), z_near=0.1,
            z_far=2400.0)
        outs[dc] = (eng.frame(), dict(eng.renderer.last_aux))
        eng.shutdown()
    (img_off, aux_off), (img_on, aux_on) = outs[False], outs[True]
    assert aux_off["n_pairs"] > 0 and np.isfinite(img_on).all()
    np.testing.assert_allclose(img_on, img_off, rtol=0, atol=1e-4)
    assert int(aux_on["n_pairs_kept"]) < int(aux_off["n_pairs_kept"])
    assert aux_on["proxy_pairs"] == aux_off["proxy_pairs"] > 0
    assert np.allclose(img_on[..., 3], 1.0, atol=1e-5)  # the sky is opaque
