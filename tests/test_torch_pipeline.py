"""The ported slices as a whole: the port's Renderer and Engine against the
JAX package's (Pallas kernels in interpret mode on the CPU) and, gs-only,
against the per-pixel NumPy oracle, on the scene and RendererConfig of
tests/test_pipeline.py; gs-only frames and full-config frames (skybox + proxy
ground + splats). Exact profile: tests/test_pipeline.py's _assert_close, mean
abs < 1e-4 and at most 5e-4 of the pixels over 1e-3. Fast profile (the
default): _assert_close_fast below; tests/test_torch_fastmode.py holds it to
the oracle."""

import json

import numpy as np
import pytest
import torch

from gswt_renderer_tpu.core import Camera, UserData
from gswt_renderer_tpu.core.config import (
    RenderConfig, SelectiveMergeType, SurfaceType, TileSortType)
from gswt_renderer_tpu.engine import Engine as JaxEngine
from gswt_renderer_tpu.io.synth import synthetic_scene_vec
from gswt_renderer_tpu.refrender import render_oracle
from gswt_renderer_tpu.render import build_frame_inputs
from gswt_renderer_tpu.render.pipeline import Renderer as JaxRenderer
from gswt_renderer_tpu.render.pipeline import RendererConfig as JaxConfig
from gswt_renderer_tpu.render.uniforms import SceneParams
from gswt_renderer_tpu.tiles import WangTileEngine
from gswt_renderer_tpu_torch import core as tcore
from gswt_renderer_tpu_torch.engine import Engine
from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec as t_synth
from gswt_renderer_tpu_torch.render.pipeline import (
    Renderer, RendererConfig, state_from_numpy)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for these small tensors: under the suite's
    parallel workers PyTorch's default pool (a thread per core in every
    worker) oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


W = H = 128


def _assert_close(img_ref, img, budget=1e-3, frac=5e-4):
    diff = np.abs(img - img_ref).max(axis=-1)
    assert np.mean(diff) < 1e-4, f"mean diff {np.mean(diff)}"
    assert np.mean(diff > budget) <= frac, (
        f"{np.mean(diff > budget):.2%} of pixels over {budget}; max {diff.max()}"
    )


def _jax_config():
    return JaxConfig(exact=True, width=W, height=H, max_draws=128,
                     max_stream=1 << 15, min_stream=1 << 12, chunk=128)


def _config():
    return RendererConfig(width=W, height=H, max_draws=128,
                          max_stream=1 << 15, chunk=128, exact=True)


CASES = {
    "flat": dict(ui={}, cam=(2.0, 2.0, 6.0), target=(2.0, 2.0, 0.0),
                 up=(0.0, 1.0, 0.0)),
    "heightmap": dict(
        ui=dict(surface_type=SurfaceType.HEIGHT_MAP,
                height_map_scale=(1.0, 0.3), height_map_wh=(8, 8)),
        cam=(1.0, -5.0, 3.0), target=(1.0, 0.0, 0.5), up=(0.0, 1.0, 0.0)),
    "sphere": dict(
        ui=dict(tile_map_half_wh=(5, 2), surface_type=SurfaceType.SPHERE,
                sphere_radius=15.0, lod_max_dist=30.0),
        cam=(30.0, 0.0, 8.0), target=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0),
        splats=64),
    "edge_merge_lod_blend": dict(
        ui=dict(tile_map_half_wh=(3, 3), merge_type=SelectiveMergeType.EDGE,
                merge_dot_threshold=0.6, merge_topk=30, lod_blending=True,
                lod_max_dist=3.0, lod_transition_width_ratio=0.3,
                tile_sort_type=TileSortType.GRAPH),
        cam=(0.0, 0.0, 1.0), target=(0.0, 5.0, 0.5), up=(0.0, 0.0, 1.0)),
}


def _frame(case):
    c = CASES[case]
    wang = WangTileEngine(synthetic_scene_vec(
        n_lod=2, splats_per_tile=c.get("splats", 96)))
    kw = dict(tile_map_half_wh=(2, 2), height_map_scale=(1.0, 0.0),
              lod_max_dist=8.0, surface_type=SurfaceType.NONE,
              merge_type=SelectiveMergeType.NONE,
              tile_sort_type=TileSortType.DISTANCE, lod_blending=False)
    kw.update(c["ui"])
    ud = UserData.from_ui(**kw)
    wang.configure(ud)
    cam_pos = np.asarray(c["cam"], np.float32)
    wang.build_tiles(cam_pos)
    camera = Camera((W, H), cam_pos, c["target"], c["up"], np.deg2rad(60.0),
                    0.1, 200.0)
    dt = wang.sort_tiles(cam_pos, camera.view_proj())
    rc = RenderConfig.new(wang.n_tiles[0])
    sp = SceneParams.from_data(ud, wang.center_coord, rc)
    return wang, ud, dt, camera, rc, sp


@pytest.mark.parametrize("case", sorted(CASES))
def test_renderer_matches_jax_and_oracle(case):
    wang, ud, dt, camera, rc, sp = _frame(case)
    if case == "edge_merge_lod_blend":
        assert dt.single_draw.sum() > 0, "case needs merged draws"
    ref = render_oracle(build_frame_inputs(wang, dt, camera, rc), W, H)
    assert ref[..., 3].max() > 0.2, "scene should be visible"
    jr = JaxRenderer(wang, _jax_config())
    jr.configure(ud)
    jimg = jr.render(dt, camera, sp, rc)
    tr = Renderer(wang, _config(), device="cpu")
    tr.configure(ud)
    img = tr.render(dt, camera, sp, rc)
    assert img.shape == (H, W, 4) and np.isfinite(img).all()
    _assert_close(jimg, img)
    _assert_close(ref, img)


def test_state_from_jax_renderer():
    """The port's own resident state is bit-identical to the JAX
    Renderer's; fed the JAX state through state_from_numpy, it renders the
    same frame."""
    wang, ud, dt, camera, rc, sp = _frame("heightmap")
    jr = JaxRenderer(wang, _jax_config())
    jr.configure(ud)
    tr = Renderer(wang, _config(), device="cpu")
    tr.configure(ud)
    for k in ("store_packed", "panels", "hm4"):
        np.testing.assert_array_equal(getattr(tr, k).numpy(),
                                      np.asarray(getattr(jr, k)), err_msg=k)
    np.testing.assert_array_equal(tr.seg_block, jr.seg_block)
    np.testing.assert_array_equal(tr.seg_count, jr.seg_count)
    assert tr.np_panel_blocks == jr.np_panel_blocks

    fed = Renderer(wang, _config(), device="cpu")
    fed.set_state(state_from_numpy(dict(
        store_packed=np.asarray(jr.store_packed), panels=np.asarray(jr.panels),
        seg_block=jr.seg_block, seg_count=jr.seg_count,
        np_panel_blocks=jr.np_panel_blocks, hm4=np.asarray(jr.hm4),
        height_map_wh=jr.height_map_wh), "cpu"))
    _assert_close(jr.render(dt, camera, sp, rc), fed.render(dt, camera, sp, rc))


def test_engine_matches_jax_engine_over_a_camera_move():
    kw = dict(tile_map_half_wh=(2, 2), height_map_scale=(1.0, 0.3),
              height_map_wh=(8, 8), lod_max_dist=8.0,
              surface_type=SurfaceType.HEIGHT_MAP,
              merge_type=SelectiveMergeType.NONE,
              tile_sort_type=TileSortType.DISTANCE, lod_blending=True)
    jeng = JaxEngine(synthetic_scene_vec(n_lod=2, splats_per_tile=96),
                     viewport=(W, H), renderer_config=_jax_config(),
                     synchronous=True)
    teng = Engine(t_synth(n_lod=2, splats_per_tile=96), viewport=(W, H),
                  renderer_config=_config(), synchronous=True, device="cpu")
    jeng.configure(UserData.from_ui(**kw))
    teng.configure(tcore.UserData.from_ui(**kw))
    for i in range(3):
        pos = np.array([1.0 + 0.6 * i, -5.0 + 0.8 * i, 3.0], np.float32)
        tgt = np.array([1.0, 2.0, 0.5], np.float32)
        for eng in (jeng, teng):
            eng.camera.set_view(pos, tgt, np.array([0, 0, 1], np.float32))
        jimg = jeng.frame()
        img = teng.frame()
        assert img is not None and jimg is not None
        assert img[..., 3].mean() > 0.2
        _assert_close(jimg, img)
    teng.shutdown()
    jeng.shutdown()


def test_engine_checkpoint_roundtrip(tmp_path):
    kw = dict(viewport=(64, 64), synchronous=True, device="cpu",
              renderer_config=RendererConfig(width=64, height=64,
                                             max_draws=64, chunk=128,
                                             exact=True))
    eng = Engine(t_synth(n_lod=2, splats_per_tile=48), **kw)
    eng.configure(tcore.UserData.from_ui(tile_map_half_wh=(2, 2),
                                         lod_max_dist=8.0, lod_blending=True))
    eng.camera.set_view(np.array([1.0, -4.0, 3.0], np.float32),
                        np.array([1.0, 2.0, 0.5], np.float32),
                        np.array([0.0, 0.0, 1.0], np.float32))
    assert eng.frame()[..., 3].mean() > 0.2
    path = tmp_path / "session.json"
    eng.save_checkpoint(path)

    eng2 = Engine(t_synth(n_lod=2, splats_per_tile=48), **kw)
    eng2.load_checkpoint(path)
    eng2.save_checkpoint(tmp_path / "again.json")
    first = json.loads(path.read_text())
    again = json.loads((tmp_path / "again.json").read_text())
    assert again["camera"] == first["camera"]
    assert again["rng_state"] == first["rng_state"]
    assert eng2.config_user_data.lod_blending
    img = eng2.frame()
    assert np.isfinite(img).all() and img[..., 3].mean() > 0.2
    eng.shutdown()
    eng2.shutdown()


# ---------------------------------------------------------------------- #
# full config: skybox + proxy ground + splats
# ---------------------------------------------------------------------- #
def _textures():
    sky = np.clip(np.linspace(0, 4, 16)[:, None, None]
                  * np.ones((16, 32, 3), np.float32), 0, 4)
    checker = np.kron(np.indices((8, 8)).sum(0) % 2,
                      np.ones((4, 4))).astype(np.float32)
    tex = np.stack([checker * 0.8 + 0.1, checker * 0.5 + 0.2,
                    checker * 0.3 + 0.1], axis=-1)
    return sky, tex


def _jax_state(jr):
    """The JAX Renderer's resident arrays, as numpy, under the port's state
    names."""
    return dict(
        store_packed=np.asarray(jr.store_packed), panels=np.asarray(jr.panels),
        seg_block=jr.seg_block, seg_count=jr.seg_count,
        np_panel_blocks=jr.np_panel_blocks, hm4=np.asarray(jr.hm4),
        height_map_wh=jr.height_map_wh, hm_src=np.asarray(jr.hm_src),
        skybox_tex=np.asarray(jr.skybox_tex),
        skybox_equirect=jr.skybox_equirect,
        proxy_tex=np.asarray(jr.proxy_tex), proxy_mip_meta=jr.proxy_mip_meta,
        proxy_wh=jr.proxy_wh, proxy_pyr=np.asarray(jr.proxy_pyr),
        proxy_pyr_meta=jr.proxy_pyr_meta,
        proxy_verts=np.asarray(jr.proxy_verts),
        proxy_tris=np.asarray(jr.proxy_tris))


@pytest.mark.parametrize("case", ["flat", "heightmap"])
def test_full_config_frame_matches_jax(case):
    """Skybox + proxy + splats, the port computing from the JAX Renderer's
    own arrays (installed through state_from_numpy), against the JAX
    Renderer; and the port's own set_skybox / set_proxy / configure build
    the same state."""
    wang, ud, dt, camera, rc, sp = _frame(case)
    sky, tex = _textures()
    jr = JaxRenderer(wang, _jax_config())
    jr.configure(ud)
    jr.set_skybox(sky)
    jr.set_proxy(tex)
    jimg = jr.render(dt, camera, sp, rc, use_skybox=True, use_proxy=True)
    assert int(jr.last_aux["proxy_pairs"]) > 0

    fed = Renderer(wang, _config(), device="cpu")
    fed.set_state(state_from_numpy(_jax_state(jr), "cpu"))
    img = fed.render(dt, camera, sp, rc, use_skybox=True, use_proxy=True)
    assert img.shape == (H, W, 4) and np.isfinite(img).all()
    assert np.abs(img[..., 3] - 1.0).max() < 1e-5, "the sky is opaque"
    _assert_close(jimg, img)
    assert fed.last_aux["proxy_pairs"] == int(jr.last_aux["proxy_pairs"])
    assert fed.last_aux["n_pairs"] == int(jr.last_aux["n_pairs"])
    gs_only = fed.render(dt, camera, sp, rc)
    assert np.abs(gs_only - img).max() > 0.1, "the background shows"

    own = Renderer(wang, _config(), device="cpu")
    own.configure(ud)
    own.set_skybox(sky)
    own.set_proxy(tex)
    for k in ("skybox_tex", "proxy_verts", "proxy_tris"):
        np.testing.assert_array_equal(getattr(own, k).numpy(),
                                      getattr(fed, k).numpy(), err_msg=k)
    np.testing.assert_array_equal(own.proxy_tex.numpy(), fed.proxy_tex.numpy())
    assert torch.equal(own.proxy_pyr, fed.proxy_pyr)
    assert own.proxy_pyr.dtype == torch.bfloat16
    assert own.proxy_tex.dtype == torch.int32
    assert own.proxy_mip_meta == fed.proxy_mip_meta
    assert own.proxy_pyr_meta == fed.proxy_pyr_meta
    assert own.proxy_wh == fed.proxy_wh and own.skybox_equirect is True
    np.testing.assert_array_equal(
        own.render(dt, camera, sp, rc, use_skybox=True, use_proxy=True), img)


def test_skybox_and_proxy_flags_need_their_texture():
    """use_skybox / use_proxy are honoured only when the texture is set;
    a baked skybox goes through the cubemap path."""
    wang, ud, dt, camera, rc, sp = _frame("flat")
    sky, tex = _textures()
    tr = Renderer(wang, _config(), device="cpu")
    tr.configure(ud)
    plain = tr.render(dt, camera, sp, rc)
    np.testing.assert_array_equal(
        tr.render(dt, camera, sp, rc, use_skybox=True, use_proxy=True), plain)
    assert "proxy_pairs" not in tr.last_aux
    tr.set_skybox(sky, bake=True, bake_resolution=32)
    assert tuple(tr.skybox_tex.shape) == (6, 32, 32, 3)
    assert tr.skybox_equirect is False
    baked = tr.render(dt, camera, sp, rc, use_skybox=True)
    jr = JaxRenderer(wang, _jax_config())
    jr.configure(ud)
    jr.set_skybox(sky, bake=True, bake_resolution=32)
    _assert_close(jr.render(dt, camera, sp, rc, use_skybox=True), baked)
    tr.set_skybox(None)
    np.testing.assert_array_equal(
        tr.render(dt, camera, sp, rc, use_skybox=True), plain)


def _full_engines(div=0, **ui):
    sky, tex = _textures()
    kw = dict(tile_map_half_wh=(2, 2), height_map_scale=(1.0, 0.2),
              height_map_wh=(4, 4), lod_max_dist=8.0,
              surface_type=SurfaceType.HEIGHT_MAP)
    kw.update(ui)
    jeng = JaxEngine(
        synthetic_scene_vec(n_lod=2, splats_per_tile=48), viewport=(96, 64),
        renderer_config=JaxConfig(
            exact=True, width=96, height=64, max_draws=64, max_stream=1 << 13,
            min_stream=1 << 11, chunk=128, proxy_res_div=div,
            proxy_tile_w=32, proxy_tile_h=16),
        synchronous=True)
    teng = Engine(
        t_synth(n_lod=2, splats_per_tile=48), viewport=(96, 64),
        renderer_config=RendererConfig(
            width=96, height=64, max_draws=64, max_stream=1 << 13, chunk=128,
            proxy_res_div=div, proxy_tile_w=32, proxy_tile_h=16, exact=True),
        synchronous=True, device="cpu")
    for eng, mod in ((jeng, UserData), (teng, tcore.UserData)):
        eng.set_skybox(sky, equirect=True)
        eng.set_proxy(tex)
        eng.configure(mod.from_ui(**kw))
        assert eng.wait_ready(timeout_s=300)
        eng.camera.set_view(np.array([1.0, -5.0, 3.0], np.float32),
                            np.array([1.0, 2.0, 0.5], np.float32),
                            np.array([0.0, 0.0, 1.0], np.float32))
    return jeng, teng


def test_engine_full_config_frame_matches_jax_engine():
    jeng, teng = _full_engines()
    assert teng.use_skybox and teng.use_proxy
    jimg, img = np.asarray(jeng.frame()), teng.frame()
    assert np.abs(img[..., 3] - 1.0).max() < 1e-5
    assert teng.renderer.last_aux["n_pairs"] > 0
    assert teng.renderer.last_aux["proxy_pairs"] > 0
    _assert_close(jimg, img)
    teng.set_proxy(None)
    teng.set_skybox(None)
    assert not teng.use_skybox and not teng.use_proxy
    assert teng.frame()[..., 3].min() < 0.5, "gs-only again"
    teng.shutdown()
    jeng.shutdown()


def test_proxy_res_div_matches_jax_and_full_res():
    """proxy_res_div=2 renders the proxy at half resolution and upsamples
    (depth/hit nearest, colour bilinear). The port's frame equals the JAX
    package's at the same divisor within the parity budget, and stays close
    to the full-resolution frame within the bounds of
    tests/test_passes.py::test_proxy_res_div_parity."""
    jeng, teng = _full_engines(div=2)
    jimg, half = np.asarray(jeng.frame()), teng.frame()
    _assert_close(jimg, half)
    jeng.shutdown()
    teng.shutdown()
    jeng, teng = _full_engines(div=1)
    full = teng.frame()
    jeng.shutdown()
    teng.shutdown()
    assert np.isfinite(half).all()
    assert np.abs(full - half).mean() < 0.02
    assert ((full[..., 3] > 0.02) != (half[..., 3] > 0.02)).mean() < 0.05


def test_bilinear_upsample_matches_jax_image_resize_at_the_borders():
    """The colour upsample of proxy_res_div: F.interpolate(bilinear,
    align_corners=False) against jax.image.resize(linear), borders
    included (both clamp to the edge texel)."""
    import jax.image

    rng = np.random.default_rng(0)
    src = rng.uniform(size=(7, 9, 4)).astype(np.float32)
    for div in (2, 3):
        ref = np.asarray(jax.image.resize(src, (7 * div, 9 * div, 4),
                                          method="linear"))
        got = torch.nn.functional.interpolate(
            torch.from_numpy(src).permute(2, 0, 1)[None], scale_factor=div,
            mode="bilinear", align_corners=False)[0].permute(1, 2, 0).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------- #
# the fast profile (the default RendererConfig), full config
# ---------------------------------------------------------------------- #
def _assert_close_fast(jimg, img):
    """The port's fast frame against the JAX package's fast frame from the
    same state. Both quantize the pair table to the same values; they part
    in the compositor's exponent (JAX: bf16 hi/lo halves, ~1e-3 absolute;
    the port: f32), worth ~1e-3 of a weight and here and there a fragment
    at the e >= -4 cutoff (<= exp(-4) * alpha ~ 0.018), and, with a proxy,
    in an edge pixel of the triangle raster moving between triangles on one
    ulp (tests/test_torch_trirast.py), which swaps ground for sky. So: mean
    <= 3e-4, at most 0.3% of the values over 2/255."""
    d = np.abs(img - jimg)
    assert d.mean() <= 3e-4, d.mean()
    assert (d > 2.0 / 255.0).mean() <= 0.003, (d > 2.0 / 255.0).mean()


@pytest.mark.parametrize("case", ["flat", "heightmap"])
def test_fast_full_config_frame_matches_jax(case):
    """The default profile end to end: skybox + half-resolution proxy
    through the pyramid sampler + quantized splats, the port computing from
    the JAX fast Renderer's own arrays (hm_src included) against that
    Renderer; the port's own configure binds the same source map."""
    wang, ud, dt, camera, rc, sp = _frame(case)
    sky, tex = _textures()
    jr = JaxRenderer(wang, JaxConfig(width=W, height=H, max_draws=128,
                                     max_stream=1 << 15, min_stream=1 << 12,
                                     chunk=128))
    assert jr.cfg.exact is False
    jr.configure(ud)
    jr.set_skybox(sky)
    jr.set_proxy(tex)
    jimg = np.asarray(jr.render(dt, camera, sp, rc, use_skybox=True,
                                use_proxy=True))

    cfg = RendererConfig(width=W, height=H, max_draws=128, max_stream=1 << 15,
                         chunk=128)
    assert cfg.exact is False and cfg.proxy_res_div == 0
    fed = Renderer(wang, cfg, device="cpu")
    fed.set_state(state_from_numpy(_jax_state(jr), "cpu"))
    img = fed.render(dt, camera, sp, rc, use_skybox=True, use_proxy=True)
    assert img.shape == (H, W, 4) and np.isfinite(img).all()
    _assert_close_fast(jimg, img)
    assert fed.last_aux["proxy_pairs"] == int(jr.last_aux["proxy_pairs"])
    assert fed.last_aux["n_pairs"] == int(jr.last_aux["n_pairs"])
    assert int(fed.last_aux["n_pairs_kept"]) == int(
        jr.last_aux["n_pairs_kept"])

    own = Renderer(wang, cfg, device="cpu")
    own.configure(ud)
    own.set_skybox(sky)
    own.set_proxy(tex)
    np.testing.assert_array_equal(own.hm_src.numpy(), np.asarray(jr.hm_src))
    if case == "heightmap":
        assert tuple(own.hm_src.shape) == (8, 8)
    np.testing.assert_array_equal(
        own.render(dt, camera, sp, rc, use_skybox=True, use_proxy=True), img)
    # the exact profile binds no source map and renders another frame
    ex = Renderer(wang, _config(), device="cpu")
    ex.configure(ud)
    assert ex.hm_src is None


def test_engine_default_config_is_the_fast_profile():
    """Engine passes a default RendererConfig through unchanged (fast
    profile, both culls off), builds the pyramid in both profiles, and its
    fast full-config frame equals the JAX Engine's within the fast budget."""
    sky, tex = _textures()
    kw = dict(tile_map_half_wh=(2, 2), height_map_scale=(1.0, 0.2),
              height_map_wh=(4, 4), lod_max_dist=8.0,
              surface_type=SurfaceType.HEIGHT_MAP)
    teng = Engine(t_synth(n_lod=2, splats_per_tile=48), viewport=(96, 64),
                  synchronous=True, device="cpu")
    c = teng.renderer.cfg
    assert (c.width, c.height) == (96, 64)
    assert c.exact is False and not c.sat_cull and not c.depth_cull
    jeng = JaxEngine(synthetic_scene_vec(n_lod=2, splats_per_tile=48),
                     viewport=(96, 64), synchronous=True)
    assert jeng.renderer.cfg.exact is False
    for eng, mod in ((jeng, UserData), (teng, tcore.UserData)):
        eng.set_skybox(sky, equirect=True)
        eng.set_proxy(tex)
        eng.configure(mod.from_ui(**kw))
        assert eng.wait_ready(timeout_s=300)
        eng.camera.set_view(np.array([1.0, -5.0, 3.0], np.float32),
                            np.array([1.0, 2.0, 0.5], np.float32),
                            np.array([0.0, 0.0, 1.0], np.float32))
    assert teng.renderer.proxy_pyr is not None
    assert teng.renderer.hm_src is not None
    jimg, img = np.asarray(jeng.frame()), teng.frame()
    _assert_close_fast(jimg, img)
    teng.shutdown()
    jeng.shutdown()
    exact = Engine(t_synth(n_lod=2, splats_per_tile=48), viewport=(96, 64),
                   renderer_config=RendererConfig(width=96, height=64,
                                                  exact=True),
                   synchronous=True, device="cpu")
    exact.set_proxy(tex)
    assert exact.renderer.proxy_pyr is not None
    exact.shutdown()
