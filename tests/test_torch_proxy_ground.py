"""The port's proxy ground (ops/proxy.py render_proxy on its grid path, the
fast profile's) against the benchmark's plain ground
(gswt_bench/reference/background.py: each pixel's ray marched to the
stated ground mesh, PARITY.md #4, as a rasterizer meets it), on the CPU.

The witness is the paper's map (97x97 tiles of width 4 and a 10x10 random
height map scaled 0.3) at 480x270, so the ground at 240x135, at three poses
of the benchmark's fly path: the two grounds may disagree on at most
numel // 1000 pixels. With plane rows summed from products of absolute
pixel coordinates the port missed 242-296 of them, a band of thin far-ring
triangles near the horizon whose depth rounded past the far plane. One
straddling the camera plane and one large far-ring cell are each held to
the reference pixel for pixel, and the grid's triangle counters to the
triangles built."""

import json
import os

import numpy as np
import pytest
import torch

from gswt_bench.frozen.scene import bench_textures, mirrored_pose
from gswt_bench.reference import background, camera as rcam, store
from gswt_renderer_tpu_torch.core import Camera, UserData, hostprof
from gswt_renderer_tpu_torch.core.camera import CameraUniforms
from gswt_renderer_tpu_torch.core.config import RenderConfig, SurfaceType
from gswt_renderer_tpu_torch.engine import Engine
from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec
from gswt_renderer_tpu_torch.io.textures import build_mip_chain
from gswt_renderer_tpu_torch.ops import proxy as tprox
from gswt_renderer_tpu_torch.ops.project import pack_tex4
from gswt_renderer_tpu_torch.ops.texsample import pack_pyramid, sampler_pyramid
from gswt_renderer_tpu_torch.render import pipeline
from gswt_renderer_tpu_torch.render.pipeline import Renderer, RendererConfig
from gswt_renderer_tpu_torch.render.uniforms import SceneParams

W, H = 480, 270
HALF = 48
TW = 4.0
TRAFFIC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "gswt_bench", "traffic", "still.json")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ground():
    return _ground()


def _ground():
    """The inputs both grounds share: the height map (the reference's
    store.height_map, which the benchmark holds the program's to), the
    checker's mip chain packed for the fast profile's sampler, and the
    reference's pyramid."""
    hm, hm_wh = store.height_map((10, 10), TW, 0.3)
    _, checker = bench_textures()
    mips = build_mip_chain(np.asarray(checker, np.float32))
    atlas, meta = tprox.pack_mip_atlas(mips)
    pyr, pyr_meta, l_min = pack_pyramid(mips)
    return dict(hm=hm, hm_wh=hm_wh, meta=meta, mip_pyr=(pyr_meta, l_min),
                prox=dict(atlas=tprox.atlas_words(atlas),
                          mip_tab=tprox.mip_table(meta, "cpu"),
                          pyr=sampler_pyramid(torch.as_tensor(pyr).to(torch.bfloat16))),
                ref_pyramid=background.mip_pyramid(checker))


def _pose(t):
    with open(TRAFFIC) as f:
        return mirrored_pose(json.load(f)["keyframes"], t)


def _center(pos):
    return tuple(int(c) for c in np.floor(np.asarray(pos[:2]) / TW))


def _port(ground, pos, tgt, verts, tris, *, traced=False, wh=(W, H)):
    """The port's ground at half the resolution `wh`, as
    Renderer.proxy_pass renders it in the fast profile: (hit, aux); traced,
    with the host-section profiler on, so that aux holds the grid's
    triangle counts."""
    cam = Camera(wh, pos, tgt, (0, 0, 1), np.deg2rad(rcam.FOVY_DEG),
                 rcam.Z_NEAR, rcam.Z_FAR)
    ud = UserData.from_ui(tile_map_half_wh=(HALF, HALF), tile_width=TW,
                          surface_type=SurfaceType.HEIGHT_MAP,
                          height_map_wh=(10, 10), height_map_scale=(1.0, 0.3))
    sp = SceneParams.from_data(ud, _center(pos), RenderConfig())
    v = Renderer.pack_frame_uniforms(sp, CameraUniforms(cam), [True], 1.0)
    scene_d, cam_d, *_ = Renderer.unpack_frame_uniforms(torch.as_tensor(v))
    prox = dict(ground["prox"], verts=torch.as_tensor(verts),
                tris=torch.as_tensor(tris))
    pipeline.set_host_prof(traced)
    try:
        _, _, hit, aux = tprox.render_proxy(
            cam_d, scene_d, (wh[0] // 2, wh[1] // 2),
            torch.as_tensor(pack_tex4(ground["hm"], *ground["hm_wh"])),
            ground["hm_wh"], prox, (ground["meta"][0][0], ground["meta"][0][1]),
            surface_type=1, height_offset=background.PROXY_HEIGHT, brightness=1.0,
            black_background=False, use_clip=False, clip_height=0.0,
            mip_meta=ground["meta"], mip_pyr=ground["mip_pyr"], tile_wh=(64, 32),
            chunk=pipeline.PROXY_CHUNK, proxy_pairs=1 << 16)
    finally:
        pipeline.set_host_prof(False)
        hostprof.HOST_PROF.clear()
    assert not bool(aux["proxy_overflow"])
    assert ("proxy_tris_live" in aux) == traced
    return hit, aux


def _reference(ground, pos, tgt, monkeypatch=None, patches=None, wh=(W, H)):
    """The plain ground's hit mask at half the resolution `wh`; `patches`
    in place of the stated mesh's (background.ground_patches)."""
    if patches is not None:
        monkeypatch.setattr(background, "ground_patches", lambda *a: patches)
    scene = dict(map_half_wh=(HALF, HALF), tile_width=TW,
                 height_map_scale=np.array([1.0, 1.0, 0.3], np.float32),
                 center_coord=_center(pos))
    _, _, hit, _ = background.proxy(
        rcam.camera(pos, tgt, *wh), scene, torch.as_tensor(ground["hm"]),
        ground["hm_wh"], ground["ref_pyramid"], *wh, "cpu")
    return hit[::background.PROXY_RES_DIV, ::background.PROXY_RES_DIV]


@pytest.mark.parametrize("t", [2.0, 7.5, 12.0])
def test_grid_ground_covers_what_the_reference_ground_covers(ground, t):
    pos, tgt = _pose(t)
    verts, tris = tprox.make_map_grid((2 * HALF + 1,) * 2, (HALF, HALF), TW)
    hit, _ = _port(ground, pos, tgt, verts, tris)
    ref = _reference(ground, pos, tgt)
    assert hit.shape == ref.shape == (H // 2, W // 2)
    assert ref.float().mean() > 0.3, "the camera should see the ground"
    assert int((hit != ref).sum()) <= hit.numel() // 1000


def _vertex_w(pos, tgt, verts, z):
    """Each vertex's depth along the view direction (clip w)."""
    f = (np.asarray(tgt, np.float64) - pos) / np.linalg.norm(
        np.asarray(tgt, np.float64) - pos)
    c = np.asarray(_center(pos), np.float64) * TW
    rel = np.stack([verts[0] + c[0], verts[1] + c[1], z], axis=0) - pos[:, None]
    return f @ rel


def test_triangles_across_the_camera_plane_are_dropped_as_the_reference_drops_them(
        ground, monkeypatch):
    """One 8-unit cell under a camera looking steeply down: both of its
    triangles reach from behind the camera (clip w <= 0) into the bottom of
    the view, where a clipping rasterizer would draw them. The stated mesh
    drops such a triangle whole, and the port does: neither ground covers a
    pixel, and no triangle of the cell is live."""
    pos = np.array([0.5, 0.5, 3.0], np.float32)
    tgt = np.array([0.5, 3.5, -0.5], np.float32)
    patch = (-4.0, -6.0, 1, 8.0, None)
    verts, tris = tprox._grid_patch(*patch[:2], 1, 1, patch[3])
    z = np.full(verts.shape[1], background.PROXY_HEIGHT)
    w = _vertex_w(pos, tgt, verts, z)[tris]
    assert ((w.min(axis=0) < -1.0) & (w.max(axis=0) > 1.0)).all()
    # a part in front reaches the view: points spread over the triangles
    # (at the flat height) that project into the image
    cam = rcam.camera(pos, tgt, W, H)
    c = np.asarray(_center(pos), np.float64) * TW
    b = np.stack(np.meshgrid(np.linspace(0, 1, 41), np.linspace(0, 1, 41)), -1).reshape(-1, 2)
    b = np.concatenate([b, 1.0 - b.sum(1, keepdims=True)], 1)[b.sum(1) <= 1.0]
    xy = np.einsum("pv,cvt->pct", b, verts[:, tris]) + c[None, :, None]
    q = np.stack([xy[:, 0], xy[:, 1], np.full(xy[:, 0].shape, z[0]), np.ones(xy[:, 0].shape)])
    clip = np.einsum("ij,jpt->ipt", (rcam.OPENGL_TO_WGPU @ cam["projection"]) @ cam["view"], q)
    seen = (clip[3] > 0) & (np.abs(clip[0]) < clip[3]) & (np.abs(clip[1]) < clip[3])
    assert seen.any()
    hit, aux = _port(ground, pos, tgt, verts, tris, traced=True)
    ref = _reference(ground, pos, tgt, monkeypatch, [patch])
    assert not ref.any() and not hit.any()
    assert int(aux["proxy_tris_live"]) == 0


def test_a_large_far_ring_cell_is_covered_as_the_reference_covers_it(
        ground, monkeypatch):
    """A patch of cells of the outermost ring's size (256) from 1,344 units
    ahead to past the far plane and wider than the view (the reference
    marches each patch from edge to edge, so its edges lie out of sight):
    at 160x90 its triangles are slivers under a pixel of area whose depth
    lies a few hundred-thousandths below the far plane, and the raster
    covers exactly the pixels the reference's rays find on them (with plane
    rows summed from absolute pixel coordinates it missed 33 of 80)."""
    pos, tgt = _pose(2.0)
    patch = (-2560.0, 1344.0, 20, 256.0, None)
    verts, tris = tprox._grid_patch(*patch[:2], 20, 20, patch[3])
    hit, aux = _port(ground, pos, tgt, verts, tris, traced=True, wh=(160, 90))
    ref = _reference(ground, pos, tgt, monkeypatch, [patch], wh=(160, 90))
    assert int(ref.sum()) >= 50
    assert torch.equal(hit, ref)
    assert int(aux["proxy_tris_thin"]) == int(aux["proxy_tris_live"]) > 0


def test_grid_counts_match_the_triangles_built(ground):
    """proxy_tris_live and proxy_tris_thin against the triangles worked out
    in float64: a near patch of 4-unit cells (some off the image, none thin),
    a far patch of 256-unit slivers, and a patch behind the camera."""
    pos, tgt = _pose(2.0)
    parts = [tprox._grid_patch(-24.0, 8.0, 12, 6, TW),
             tprox._grid_patch(-640.0, 1600.0, 5, 1, 256.0),
             tprox._grid_patch(-8.0, -64.0, 4, 4, TW)]
    verts = np.concatenate([p[0] for p in parts], axis=1)
    base = np.cumsum([0] + [p[0].shape[1] for p in parts])
    tris = np.concatenate([p[1] + b for p, b in zip(parts, base)], axis=1)
    _, aux = _port(ground, pos, tgt, verts, tris, traced=True)

    cam = rcam.camera(pos, tgt, W // 2, H // 2)
    c = np.asarray(_center(pos), np.float64) * TW
    x, y = verts[0] + c[0], verts[1] + c[1]
    hm = torch.as_tensor(ground["hm"])
    half = HALF * TW
    span = (2 * HALF + 1) * TW
    from gswt_bench.reference.project import sample_height
    z = sample_height(hm, ground["hm_wh"], torch.as_tensor((x + half) / span),
                      torch.as_tensor((y + half) / span)).double().numpy() * 0.3 \
        + background.PROXY_HEIGHT
    p = np.stack([x, y, z, np.ones_like(x)])
    clip = (rcam.OPENGL_TO_WGPU.astype(np.float64) @ cam["projection"]) @ (cam["view"] @ p)
    px = (clip[0] / clip[3] * 0.5 + 0.5) * (W // 2)
    py = (0.5 - clip[1] / clip[3] * 0.5) * (H // 2)
    tx, ty, tw = px[tris], py[tris], clip[3][tris]
    area2 = np.abs((tx[1] - tx[0]) * (ty[2] - ty[0]) - (tx[2] - tx[0]) * (ty[1] - ty[0]))
    live = ((tw > 1e-6).all(axis=0) & (tx.max(0) >= 0) & (tx.min(0) < W // 2)
            & (ty.max(0) >= 0) & (ty.min(0) < H // 2))
    n_live, n_thin = int(live.sum()), int((live & (area2 < 2.0)).sum())
    assert 0 < n_thin < n_live < tris.shape[1]
    assert (int(aux["proxy_tris_live"]), int(aux["proxy_tris_thin"])) == (n_live, n_thin)


def test_the_frame_files_the_grid_counts_only_while_traced():
    """Through the Engine: with the host-section profiler on, each frame's
    grid counts are filed under its id beside its proxy pairs, and the
    ground's raster and shading are sections of their own inside
    render.front.proxy; off, the frame's counts hold no triangle counts."""
    eng = Engine(synthetic_scene_vec(n_lod=2, splats_per_tile=32),
                 viewport=(64, 64),
                 renderer_config=RendererConfig(width=64, height=64,
                                                max_draws=64, chunk=128),
                 synchronous=True, device="cpu")
    sky, checker = bench_textures((16, 32), 8, 4)
    eng.set_skybox(sky)
    eng.set_proxy(checker)
    eng.configure(UserData.from_ui(tile_map_half_wh=(2, 2), lod_max_dist=8.0,
                                   surface_type=SurfaceType.HEIGHT_MAP,
                                   height_map_wh=(4, 4), height_map_scale=(1.0, 0.3)))
    # looking down onto the small map: its cells in view, all in front
    eng.camera.set_view(np.array([0.0, 0.0, 5.0], np.float32),
                        np.array([0.0, 8.0, -0.5], np.float32),
                        np.array([0.0, 0.0, 1.0], np.float32))
    try:
        assert eng.frame() is not None
        assert "proxy_pairs" in eng.renderer.last_aux
        assert "proxy_tris_live" not in eng.renderer.last_aux
        pipeline.set_host_prof(True)
        eng.frame()
        pipeline.set_host_prof(False)
        tr = hostprof.trace()
    finally:
        pipeline.set_host_prof(False)
        hostprof.HOST_PROF.clear()
        eng.shutdown()
    counts = [c for c in tr.frames.values() if "proxy_tris_live" in c]
    assert len(counts) == 1
    c = counts[0]
    assert c["proxy_tris_live"] > 0 and 0 <= c["proxy_tris_thin"] <= c["proxy_tris_live"]
    assert c["proxy_pairs"] >= c["proxy_tris_live"]
    by_index = {i: s for i, s in enumerate(tr.spans)}
    for name in ("render.front.proxy.raster", "render.front.proxy.shade"):
        spans = [s for s in tr.spans if s.name == name]
        assert len(spans) == 1
        assert by_index[spans[0].parent].name == "render.front.proxy"
