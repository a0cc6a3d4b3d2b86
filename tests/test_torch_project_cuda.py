"""The projection kernel (csrc/project.cu) against its plain PyTorch version,
on the card.

Every test but the first needs a CUDA device and skips without one (the
kernel has no CPU mode). Like tests/test_torch_cuda.py this file imports
nothing of JAX:

    GSWT_TEST_TPU=1 python -m pytest tests/test_torch_project_cuda.py -q

Both versions get the same device tensors. Tolerances, as
tests/test_torch_project.py states them: the valid mask equal; on valid
lanes cx/cy within 1e-4 absolute (pixels), ext within 1e-4 absolute plus
1e-4 relative, z and colour within 1e-6 absolute, and k = (qa, qb, qc)
within `k_rel` of its scale max(|qa|, |qc|) on all lanes but `k_outliers`
of them, at most 1e-3 (an edge-on splat's k comes from a cancellation). The
kernel rounds each operation as the plain version does; only its divisions
by a Python number differ, by an ulp (PyTorch on the card multiplies by the
reciprocal), and the sphere's tangent frame, a central difference, amplifies
those."""

import collections
import json
import os
import tempfile

import numpy as np
import pytest
import torch

from gswt_renderer_tpu_torch.core import Camera, UserData
from gswt_renderer_tpu_torch.core.config import (
    RenderConfig, SelectiveMergeType, SurfaceType, TileSortType)
from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec
from gswt_renderer_tpu_torch.ops import kernels, project
from gswt_renderer_tpu_torch.render.pipeline import Renderer, RendererConfig
from gswt_renderer_tpu_torch.render.uniforms import SceneParams
from gswt_renderer_tpu_torch.tiles import WangTileEngine

W = H = 128

SCENES = {
    "flat_lod_blend": dict(
        ui=dict(surface_type=SurfaceType.NONE, lod_blending=True,
                lod_max_dist=3.0, lod_transition_width_ratio=0.3,
                tile_map_half_wh=(3, 3), tile_sort_type=TileSortType.GRAPH),
        cam=(0.5, -3.0, 2.5), target=(0.5, 2.0, 0.0), up=(0.0, 1.0, 0.0),
        exact=True, k_rel=1e-5, k_outliers=0.005),
    "heightmap_exact_merged": dict(
        ui=dict(surface_type=SurfaceType.HEIGHT_MAP,
                height_map_scale=(1.0, 0.3), height_map_wh=(8, 8),
                merge_type=SelectiveMergeType.EDGE, merge_dot_threshold=0.6,
                merge_topk=30, tile_map_half_wh=(3, 3), lod_max_dist=8.0,
                lod_blending=True, lod_transition_width_ratio=0.3,
                tile_sort_type=TileSortType.GRAPH),
        cam=(1.0, -5.0, 3.0), target=(1.0, 0.0, 0.5), up=(0.0, 0.0, 1.0),
        exact=True, k_rel=1e-5, k_outliers=0.005),
    # the fast profile without a source map: the patch gradient
    "heightmap_patch": dict(
        ui=dict(surface_type=SurfaceType.HEIGHT_MAP,
                height_map_scale=(1.0, 0.3), height_map_wh=(8, 8),
                tile_map_half_wh=(3, 3), lod_max_dist=8.0),
        cam=(1.0, -5.0, 3.0), target=(1.0, 0.0, 0.5), up=(0.0, 0.0, 1.0),
        exact=False, hm_src=False, k_rel=1e-5, k_outliers=0.005),
    # the benchmark's path: the fast profile on the 10x10 source map
    "heightmap_smallmap_merged": dict(
        ui=dict(surface_type=SurfaceType.HEIGHT_MAP,
                height_map_scale=(1.0, 0.3), height_map_wh=(10, 10),
                merge_type=SelectiveMergeType.EDGE, merge_dot_threshold=0.6,
                merge_topk=30, tile_map_half_wh=(3, 3), lod_max_dist=8.0,
                lod_blending=True, lod_transition_width_ratio=0.3,
                tile_sort_type=TileSortType.GRAPH),
        cam=(1.0, -5.0, 3.0), target=(1.0, 0.0, 0.5), up=(0.0, 0.0, 1.0),
        exact=False, k_rel=1e-5, k_outliers=0.005),
    "sphere_lod_blend": dict(
        ui=dict(surface_type=SurfaceType.SPHERE, sphere_radius=15.0,
                tile_map_half_wh=(5, 2), lod_max_dist=30.0,
                lod_blending=True, lod_transition_width_ratio=0.3),
        cam=(30.0, 0.0, 8.0), target=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0),
        exact=True, k_rel=1e-4, k_outliers=0.0),
}

# (scene, draw_mode, point_cloud, variant): every surface and height path,
# every draw mode, the point cloud with and without a draw mode, a 6-row
# plan, and the splats switched off
CASES = (
    [(name, 0, False, None) for name in sorted(SCENES)]
    + [("heightmap_smallmap_merged", m, False, None) for m in (1, 2, 3, 4)]
    + [("sphere_lod_blend", 1, False, None), ("flat_lod_blend", 2, False, None),
       ("heightmap_exact_merged", 0, True, None),
       ("heightmap_exact_merged", 3, True, None),
       ("heightmap_smallmap_merged", 0, False, "plan6"),
       ("heightmap_smallmap_merged", 0, False, "gs_off")]
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _frame(name, device, point_cloud=False):
    """A Renderer on `device` with one staged frame of SCENES[name], drawn
    as a point cloud if asked: (renderer, draw table, camera, scene params,
    render config)."""
    c = SCENES[name]
    wang = WangTileEngine(synthetic_scene_vec(n_lod=2, splats_per_tile=64))
    kw = dict(tile_map_half_wh=(2, 2), height_map_scale=(1.0, 0.0),
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
    rc.draw_point_cloud = point_cloud
    sp = SceneParams.from_data(ud, wang.center_coord, rc)
    r = Renderer(wang, RendererConfig(width=W, height=H, max_draws=256,
                                      max_stream=1 << 15, chunk=128,
                                      exact=c["exact"]), device=device)
    r.configure(ud)
    if c.get("hm_src", True) is False:
        r.hm_src = None
    elif not c["exact"] and c["ui"]["surface_type"] == SurfaceType.HEIGHT_MAP:
        assert r.hm_src is not None, "the fast profile should take the source map"
    return r, dt, camera, sp, rc


def scene_inputs(name, device, draw_mode=0, point_cloud=False, variant=None):
    """(args, kwargs) of assemble_and_project for one frame of SCENES[name]
    on `device`, as Renderer._project passes them (the frame's packed
    uniform block at args[5]); variant "plan6" adds a random first live lane
    per block, "gs_off" switches the splats off."""
    r, dt, camera, sp, rc = _frame(name, device, point_cloud)
    plan = r.upload_plan(r.stage(dt, camera, rc.culling_dist))
    blocks = plan["blocks"]
    if variant == "plan6":
        lo = np.random.default_rng(3).integers(0, 256, blocks.shape[1])
        blocks = torch.cat([blocks, torch.as_tensor(
            lo[None].astype(np.int32), device=blocks.device)]).contiguous()
    uniforms = r.pack_uniforms(camera, sp, rc, render_gs=variant != "gs_off")
    _, cam_d, lod_en, cdist, _ = r.unpack_frame_uniforms(uniforms)
    keep = project.cull_draws(plan["draw"], cam_d, cdist, lod_en)
    args = (blocks, plan["merged"], r.panels, keep, r.store_packed, uniforms,
            r.hm4, r.height_map_wh)
    kwargs = dict(surface_type=int(sp.surface_type), draw_mode=draw_mode,
                  image_wh=(W, H), point_cloud=point_cloud,
                  exact=SCENES[name]["exact"], hm_src=r.hm_src)
    return args, kwargs


def plain(args, kwargs):
    """assemble_and_project_plain on scene_inputs' inputs: the uniform
    block unpacked, as the wrapper's CPU branch unpacks it."""
    scene_d, cam_d, _, _, gs_en = project.unpack_uniform_block(args[5])
    return project.assemble_and_project_plain(
        *args[:5], scene_d, cam_d, *args[6:], gs_enable=gs_en, **kwargs)


def assert_projection_close(got, want, k_rel, k_outliers, expect_valid=True):
    """The tolerances of the module docstring, on numpy or torch outputs."""
    def np_(x):
        return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

    valid = np_(want["valid"])
    np.testing.assert_array_equal(np_(got["valid"]), valid)
    if expect_valid:
        assert valid.sum() > 100, "the case should project visible splats"

    def pair(a, b):
        return np_(a)[valid], np_(b)[valid]

    for k in ("cx", "cy"):
        np.testing.assert_allclose(*pair(got[k], want[k]), rtol=0, atol=1e-4,
                                   err_msg=k)
    for k in ("ext_x", "ext_y"):
        np.testing.assert_allclose(*pair(got[k], want[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    if valid.any():
        scale = np.maximum(np.abs(np_(want["q"][0])[valid]),
                           np.abs(np_(want["q"][2])[valid]))
        for i in range(3):
            a, b = pair(got["q"][i], want["q"][i])
            rel = np.abs(a - b) / scale
            assert np.mean(rel > k_rel) <= k_outliers, (i, rel.max())
            assert rel.max() <= 1e-3, (i, rel.max())
    np.testing.assert_allclose(*pair(got["z"], want["z"]), rtol=0, atol=1e-6)
    for i in range(4):
        # colour on every lane: a dead lane's is 0 in both
        np.testing.assert_allclose(np_(got["color"][i]), np_(want["color"][i]),
                                   rtol=0, atol=1e-6, err_msg=f"color{i}")


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper is the plain version and launches nothing."""
    args, kwargs = scene_inputs("heightmap_smallmap_merged", "cpu")
    before = kernels.LAUNCHES["project"]
    got = project.assemble_and_project(*args, **kwargs)
    want = plain(args, kwargs)
    assert kernels.LAUNCHES["project"] == before
    assert got.keys() == want.keys()
    for k, v in want.items():
        for a, b in zip(got[k] if isinstance(v, tuple) else (got[k],),
                        v if isinstance(v, tuple) else (v,)):
            assert torch.equal(a, b), k


@pytest.mark.parametrize("name,draw_mode,point_cloud,variant", CASES)
def test_project_kernel_matches_plain(cuda, name, draw_mode, point_cloud,
                                      variant):
    args, kwargs = scene_inputs(name, cuda, draw_mode, point_cloud, variant)
    before = kernels.LAUNCHES["project"]
    got = project.assemble_and_project(*args, **kwargs)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["project"] == before + 1
    want = plain(args, kwargs)
    c = SCENES[name]
    assert_projection_close(got, want, c["k_rel"], c["k_outliers"],
                            expect_valid=variant != "gs_off")
    if variant == "gs_off":
        assert not bool(got["valid"].any())
    for k in ("cx", "z", "ext_x"):
        assert bool((got[k][~got["valid"]] == 0).all()), k


def test_project_kernel_on_an_empty_stream(cuda):
    args, kwargs = scene_inputs("heightmap_smallmap_merged", cuda)
    args = (args[0][:, :0].contiguous(),) + args[1:]
    before = kernels.LAUNCHES["project"]
    got = project.assemble_and_project(*args, **kwargs)
    want = plain(args, kwargs)
    assert kernels.LAUNCHES["project"] == before
    for k in ("valid", "cx", "cy", "z", "ext_x", "ext_y"):
        assert got[k].shape == want[k].shape == (0,), k
    assert all(q.shape == (0,) for q in got["q"] + got["color"])


def test_project_kernel_rejects_bad_inputs(cuda):
    args, kwargs = scene_inputs("flat_lod_blend", cuda)
    with pytest.raises(ValueError):
        project.assemble_and_project(args[0].long(), *args[1:], **kwargs)
    with pytest.raises(ValueError):
        project.assemble_and_project(args[0], args[1], args[2].double(),
                                     *args[3:], **kwargs)
    with pytest.raises(ValueError):
        project.assemble_and_project(*args, **dict(kwargs, draw_mode=5))
    for bad in (args[5][:-1], args[5].double()):
        with pytest.raises(ValueError):
            project.assemble_and_project(*args[:5], bad, *args[6:], **kwargs)


def test_main_path_launches_project_once_and_no_block_gather(cuda):
    """One Renderer._project call adds exactly one `project` launch and no
    `block_gather` launch."""
    r, dt, camera, sp, rc = _frame("heightmap_smallmap_merged", cuda)
    plan = r.upload_plan(r.stage(dt, camera, rc.culling_dist))
    uniforms = r.pack_uniforms(camera, sp, rc)
    before = collections.Counter(kernels.LAUNCHES)
    p = r._project(plan, uniforms, r.unpack_frame_uniforms(uniforms), sp, rc)
    torch.cuda.synchronize()
    launched = kernels.LAUNCHES - before
    assert dict(launched) == {"project": 1}, launched
    assert int(p["valid"].sum()) > 100


def test_projection_section_launches_at_most_40_kernels(cuda):
    """The profiler counts at most 40 kernels launched inside
    gswt.render.front.project per frame (the draw cull, the uniforms and
    the projection kernel)."""
    from gswt_renderer_tpu_torch.core import hostprof

    r, dt, camera, sp, rc = _frame("heightmap_smallmap_merged", cuda)
    staged = r.stage(dt, camera, rc.culling_dist)
    for _ in range(2):
        r.render(None, camera, sp, rc, staged=staged, as_numpy=False)
    torch.cuda.synchronize()
    n_frames = 3
    hostprof.set_host_prof(True)
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n_frames):
                r.render(None, camera, sp, rc, staged=staged, as_numpy=False)
            torch.cuda.synchronize()
    finally:
        hostprof.set_host_prof(False)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    launch_at, kernels_, ranges = {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") == "kernel":
            kernels_.append(corr)
        elif e.get("cat") == "cuda_runtime" and corr is not None:
            launch_at[corr] = e["ts"]
        elif (e.get("cat") == "user_annotation"
              and e.get("name") == "gswt.render.front.project"):
            ranges.append((e["ts"], e["ts"] + e.get("dur", 0)))
    assert len(ranges) == n_frames, ranges
    inside = sum(1 for corr in kernels_ if corr in launch_at and any(
        a <= launch_at[corr] <= b for a, b in ranges))
    assert 1 <= inside / n_frames <= 40, inside / n_frames
