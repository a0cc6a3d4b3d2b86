"""The port's stream assembly + projection against the JAX package's
assemble_and_project (exact profile), on the same DrawTable and camera.

Flat, height-map and sphere surfaces, with LOD blending and merged draws.
Tolerances: the valid mask equal; on valid lanes cx/cy within 1e-4
absolute (pixels), ext within 1e-4 absolute plus 1e-4 relative, z and
colour within 1e-6 absolute, and the quadratic k = (qa, qb, qc) within
`k_rel` of its scale max(|qa|, |qc|) (relative to the scale, so the
near-zero cross term of an axis-aligned splat is judged on the form):
- 1e-5 on flat and height-map surfaces, on all lanes but `k_outliers` of
  them (at most 1e-3): an edge-on splat's minor eigenvalue comes from a
  cancellation, and f32 rounding then dominates its k;
- 1e-4 on the sphere: its local frame is a central difference at
  0.001 * ymax of sin/cos, and XLA's and ATen's sin/cos differ in the last
  ulp on ~5% of arguments, which the difference divides by 2 * dt."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswt_renderer_tpu.core import Camera, CameraUniforms, UserData
from gswt_renderer_tpu.core.config import (
    RenderConfig, SelectiveMergeType, SurfaceType, TileSortType)
from gswt_renderer_tpu.io.synth import synthetic_scene_vec
from gswt_renderer_tpu.ops import project as jproj
from gswt_renderer_tpu.render.pipeline import Renderer as JaxRenderer
from gswt_renderer_tpu.render.pipeline import RendererConfig as JaxConfig
from gswt_renderer_tpu.render.uniforms import SceneParams
from gswt_renderer_tpu.tiles import WangTileEngine
from gswt_renderer_tpu_torch.render.pipeline import Renderer, RendererConfig

W = H = 128

CASES = {
    "flat_lod_blend": dict(
        ui=dict(surface_type=SurfaceType.NONE, lod_blending=True,
                lod_max_dist=3.0, lod_transition_width_ratio=0.3,
                tile_map_half_wh=(3, 3), tile_sort_type=TileSortType.GRAPH),
        cam=(0.5, -3.0, 2.5), target=(0.5, 2.0, 0.0), up=(0.0, 1.0, 0.0),
        k_rel=1e-5, k_outliers=0.005),
    "heightmap_merged": dict(
        ui=dict(surface_type=SurfaceType.HEIGHT_MAP,
                height_map_scale=(1.0, 0.3), height_map_wh=(8, 8),
                merge_type=SelectiveMergeType.EDGE, merge_dot_threshold=0.6,
                merge_topk=30, tile_map_half_wh=(3, 3), lod_max_dist=8.0,
                tile_sort_type=TileSortType.GRAPH),
        cam=(1.0, -5.0, 3.0), target=(1.0, 0.0, 0.5), up=(0.0, 0.0, 1.0),
        k_rel=1e-5, k_outliers=0.005),
    "sphere_lod_blend": dict(
        ui=dict(surface_type=SurfaceType.SPHERE, sphere_radius=15.0,
                tile_map_half_wh=(5, 2), lod_max_dist=30.0,
                lod_blending=True, lod_transition_width_ratio=0.3),
        cam=(30.0, 0.0, 8.0), target=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0),
        k_rel=1e-4, k_outliers=0.0),
}


@pytest.fixture(scope="module")
def wang():
    return WangTileEngine(synthetic_scene_vec(n_lod=2, splats_per_tile=64))


@pytest.mark.parametrize("case", sorted(CASES))
def test_assemble_and_project_matches_jax(wang, case):
    c = CASES[case]
    kw = dict(tile_map_half_wh=(2, 2), height_map_scale=(1.0, 0.0),
              merge_type=SelectiveMergeType.NONE,
              tile_sort_type=TileSortType.DISTANCE, lod_blending=False)
    kw.update(c["ui"])
    ud = UserData.from_ui(**kw)
    wang.configure(ud)
    cam_pos = np.asarray(c["cam"], np.float32)
    wang.build_tiles(cam_pos)
    camera = Camera((W, H), cam_pos, c["target"], c["up"],
                    np.deg2rad(60.0), 0.1, 200.0)
    dt = wang.sort_tiles(cam_pos, camera.view_proj())
    rc = RenderConfig.new(wang.n_tiles[0])
    sp = SceneParams.from_data(ud, wang.center_coord, rc)
    surface = int(sp.surface_type)

    jr = JaxRenderer(wang, JaxConfig(width=W, height=H, exact=True,
                                     max_draws=256, max_stream=1 << 15,
                                     min_stream=1 << 12, chunk=128))
    jr.configure(ud)
    staged = jr.stage(dt, camera, rc.culling_dist)
    uni = jnp.asarray(jr.pack_frame_uniforms(
        sp, CameraUniforms(camera), list(rc.lod_enable or [True] * 16),
        rc.culling_dist))
    scene, cam, lod_en, cdist, gs_en = jr.unpack_frame_uniforms(uni)
    with jax.default_matmul_precision("highest"):
        keep = jproj.cull_draws(staged["draw"], cam, cdist, lod_en)
        jp = jproj.assemble_and_project(
            staged["stream"]["blocks"], staged["stream"]["merged"], jr.panels,
            keep, jr.store_packed, scene, cam, jr.hm4, jr.height_map_wh,
            surface_type=surface, draw_mode=0, image_wh=(W, H),
            gs_enable=gs_en, interpret=True, exact=True)

    tr = Renderer(wang, RendererConfig(width=W, height=H, max_draws=256,
                                       max_stream=1 << 15, chunk=128),
                  device="cpu")
    tr.configure(ud)
    tstaged = tr.stage(dt, camera, rc.culling_dist)
    nb = tstaged["blocks"].shape[1]
    np.testing.assert_array_equal(tstaged["blocks"],
                                  staged["blocks_host"][:, :nb])
    tp = tr.project(tr.upload_plan(tstaged), camera, sp, rc)

    s = nb * 256
    valid = np.asarray(jp["valid"])
    assert not valid[s:].any()
    valid = valid[:s]
    np.testing.assert_array_equal(tp["valid"].numpy(), valid)
    assert valid.sum() > 100, "case should project visible splats"

    def pair(a, b):
        return np.asarray(a)[:s][valid], b.numpy()[valid]

    for k in ("cx", "cy"):
        np.testing.assert_allclose(*pair(jp[k], tp[k]), rtol=0, atol=1e-4,
                                   err_msg=k)
    for k in ("ext_x", "ext_y"):
        np.testing.assert_allclose(*pair(jp[k], tp[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    scale = np.maximum(np.abs(pair(jp["q"][0], tp["q"][0])[0]),
                       np.abs(pair(jp["q"][2], tp["q"][2])[0]))
    for i in range(3):
        a, b = pair(jp["q"][i], tp["q"][i])
        rel = np.abs(a - b) / scale
        assert np.mean(rel > c["k_rel"]) <= c["k_outliers"], (i, rel.max())
        assert rel.max() <= 1e-3, (i, rel.max())
    np.testing.assert_allclose(*pair(jp["z"], tp["z"]), rtol=0, atol=1e-6)
    for i in range(4):
        np.testing.assert_allclose(*pair(jp["color"][i], tp["color"][i]),
                                   rtol=0, atol=1e-6, err_msg=f"color{i}")
