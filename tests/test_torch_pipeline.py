"""The whole gs-only slice: the port's Renderer and Engine against the JAX
package's (exact profile, Pallas kernels in interpret mode on the CPU) and
against the per-pixel NumPy oracle, on the scene and RendererConfig of
tests/test_pipeline.py. Budget: tests/test_pipeline.py's _assert_close,
mean abs < 1e-4 and at most 5e-4 of the pixels over 1e-3."""

import json

import numpy as np
import pytest

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
                          max_stream=1 << 15, chunk=128)


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
                                             max_draws=64, chunk=128))
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
