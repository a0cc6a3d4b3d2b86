"""The port's fast profile (RendererConfig.exact=False, its default) held to
tests/test_fastmode.py: the counterparts of every test there, on the same
scenes, through the port's Renderer on the CPU.

Budgets are that file's own: against the per-pixel oracle max <= 8/255, at
most 0.5% of values over 2/255, mean <= 0.5/255; fast against exact at most
0.5% of values over 8/255 and mean <= 1/255. Against the JAX package's own
fast Renderer the port is held tighter (JAX_FAST_* below): both quantize the
pair table to the same values, so what separates them is the compositor's
exponent (the JAX kernel forms it from bf16 hi/lo halves, ~1e-3 absolute;
the port in f32), worth a cutoff flip (<= exp(-4) * alpha ~ 0.018) here and
there and ~1e-3 of each weight."""

import numpy as np
import pytest
import torch

from gswt_renderer_tpu.core import Camera, UserData
from gswt_renderer_tpu.core.config import (
    RenderConfig, SelectiveMergeType, SurfaceType, TileSortType)
from gswt_renderer_tpu.io.synth import synthetic_scene_vec
from gswt_renderer_tpu.refrender import render_oracle
from gswt_renderer_tpu.render.pipeline import Renderer as JaxRenderer
from gswt_renderer_tpu.render.pipeline import RendererConfig as JaxConfig
from gswt_renderer_tpu.render.uniforms import SceneParams, build_frame_inputs
from gswt_renderer_tpu.tiles import WangTileEngine
from gswt_renderer_tpu_torch.render.pipeline import Renderer, RendererConfig


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
JAX_FAST_MAX = 0.03
JAX_FAST_MEAN = 2e-4
JAX_FAST_FRAC = 0.002  # share of values more than 2/255 apart


def _scene(surface):
    sv = synthetic_scene_vec(n_lod=2, splats_per_tile=64)
    eng = WangTileEngine(sv)
    ud = UserData.from_ui(
        tile_map_half_wh=(2, 2), height_map_scale=(1.0, 0.25),
        height_map_wh=(8, 8), lod_max_dist=8.0, surface_type=surface,
        merge_type=SelectiveMergeType.EDGE, merge_dot_threshold=0.5,
        merge_topk=20, tile_sort_type=TileSortType.GRAPH, lod_blending=True)
    eng.configure(ud)
    cam_pos = np.array([0.5, -1.0, 3.0], np.float32)
    eng.build_tiles(cam_pos)
    camera = Camera((W, H), cam_pos, (0.3, 8.0, 0.8), (0.0, 0.0, 1.0),
                    np.deg2rad(50.0), 0.1, 200.0)
    dt = eng.sort_tiles(cam_pos, camera.view_proj())
    return eng, ud, dt, camera


def _port(eng, ud, **cfg):
    kw = dict(width=W, height=H, max_draws=128, max_stream=1 << 14, chunk=128)
    kw.update(cfg)
    r = Renderer(eng, RendererConfig(**kw), device="cpu")
    r.configure(ud)
    return r


def test_fast_is_the_default_profile():
    assert RendererConfig().exact is False
    assert RendererConfig().sat_cull is False
    assert RendererConfig().depth_cull is False
    assert RendererConfig().exact == JaxConfig().exact
    assert RendererConfig().sat_dilate == JaxConfig().sat_dilate


@pytest.mark.parametrize("surface",
                         [SurfaceType.HEIGHT_MAP, SurfaceType.NONE])
def test_fast_profile_within_quantization_budget(surface):
    """The port's fast frame inside the oracle budgets, and against the JAX
    package's fast Renderer on the same DrawTable within JAX_FAST_*."""
    eng, ud, dt, camera = _scene(surface)
    rc = RenderConfig.new(eng.n_tiles[0])
    ref = render_oracle(build_frame_inputs(eng, dt, camera, rc), W, H)
    sp = SceneParams.from_data(ud, eng.center_coord, rc)
    r = _port(eng, ud)
    assert r.cfg.exact is False
    if surface == SurfaceType.HEIGHT_MAP:
        assert tuple(r.hm_src.shape) == (8, 8), "the small-source-map branch"
    img = r.render(dt, camera, sp, rc)
    assert ref[..., 3].max() > 0.5
    d = np.abs(img - ref)
    assert d.max() <= 8.0 / 255.0, f"max dev {d.max():.5f}"
    assert (d > 2.0 / 255.0).mean() <= 0.005, (
        f"{(d > 2 / 255).mean():.4%} of values deviate > 2/255")
    assert d.mean() <= 0.5 / 255.0

    jr = JaxRenderer(eng, JaxConfig(
        width=W, height=H, max_draws=128, max_stream=1 << 14,
        min_stream=1 << 12, chunk=128, exact=False))
    jr.configure(ud)
    dj = np.abs(img - np.asarray(jr.render(dt, camera, sp, rc)))
    assert dj.max() <= JAX_FAST_MAX, dj.max()
    assert dj.mean() <= JAX_FAST_MEAN, dj.mean()
    assert (dj > 2.0 / 255.0).mean() <= JAX_FAST_FRAC


def _textures():
    sky = np.clip(np.linspace(0, 2, 16)[:, None, None]
                  * np.ones((16, 32, 3), np.float32), 0, 2)
    checker = np.kron(np.indices((8, 8)).sum(0) % 2,
                      np.ones((4, 4))).astype(np.float32)
    tex = np.stack([checker * 0.8 + 0.1, checker * 0.5 + 0.2,
                    checker * 0.3 + 0.1], axis=-1)
    return sky, tex


class _MatrixScene:
    """tests/test_fastmode.py's matrix scene, with the exact references
    rendered by the port's exact profile and cached."""

    MW = MH = 96

    def __init__(self):
        self.sky, self.tex = _textures()
        self.eng = WangTileEngine(
            synthetic_scene_vec(n_lod=2, splats_per_tile=48))
        self.ud = UserData.from_ui(
            tile_map_half_wh=(6, 6), height_map_scale=(1.0, 0.25),
            height_map_wh=(8, 8), lod_max_dist=24.0,
            surface_type=SurfaceType.HEIGHT_MAP,
            merge_type=SelectiveMergeType.NONE,
            tile_sort_type=TileSortType.DISTANCE, lod_blending=False)
        self.eng.configure(self.ud)
        self.rc = RenderConfig.new(self.eng.n_tiles[0])
        self.sp = SceneParams.from_data(self.ud, self.eng.center_coord,
                                        self.rc)
        self._dt = {}
        self._ref = {}

    def camera_dt(self, far, wh=None):
        wh = wh or (self.MW, self.MH)
        key = (far, wh)
        if key not in self._dt:
            cam_pos = (np.array([0.0, -20.0, 3.0], np.float32) if far
                       else np.array([0.5, -2.0, 2.0], np.float32))
            tgt = (0.0, 10.0, 0.0) if far else (0.3, 6.0, 0.8)
            self.eng.build_tiles(cam_pos)
            camera = Camera(wh, cam_pos, tgt, (0.0, 0.0, 1.0),
                            np.deg2rad(45.0), 0.1, 1000.0)
            self._dt[key] = (camera, self.eng.sort_tiles(
                cam_pos, camera.view_proj()))
        return self._dt[key]

    def renderer(self, exact, dc=False, sat=False, wh=None, div=1):
        w, h = wh or (self.MW, self.MH)
        # proxy_res_div=1 isolates depth, cull and quantization parity: the
        # fast profile's half-res proxy moves checker-edge pixels by full
        # texture contrast (its own test below)
        r = Renderer(self.eng, RendererConfig(
            width=w, height=h, max_draws=256, max_stream=1 << 15, chunk=128,
            exact=exact, depth_cull=dc, sat_cull=sat, proxy_res_div=div),
            device="cpu")
        r.configure(self.ud)
        r.set_skybox(self.sky, equirect=True)
        r.set_proxy(self.tex)
        return r

    def exact_ref(self, far, use_skybox, use_proxy):
        key = (far, use_skybox, use_proxy)
        if key not in self._ref:
            camera, dt = self.camera_dt(far)
            self._ref[key] = self.renderer(exact=True).render(
                dt, camera, self.sp, self.rc, use_skybox=use_skybox,
                use_proxy=use_proxy)
        return self._ref[key]


@pytest.fixture(scope="module")
def matrix_scene():
    return _MatrixScene()


def test_fast_proxy_visibility_matches_exact_at_range(matrix_scene):
    """Far-range proxy regression: at the reference default proxy_height
    every surface splat sits in front of the proxy by an NDC gap of ~1e-4.
    The fast profile FLOORS z to u16 steps, so `z < depth` keeps every splat
    the exact profile keeps; a nearest-rounded key resolved those ties to
    'behind' and replaced ~30% of the pixels with the proxy texture. Held,
    too, against a nearest-rounded bf16 key: that must break the budget here, or
    the scene proves nothing."""
    from gswt_renderer_tpu_torch.ops import binning

    ms = matrix_scene
    camera, dt = ms.camera_dt(True, (W, H))
    imgs = {}
    for exact in (True, False):
        r = ms.renderer(exact, wh=(W, H))
        imgs[exact] = r.render(dt, camera, ms.sp, ms.rc, use_skybox=True,
                               use_proxy=True)
    d = np.abs(imgs[False] - imgs[True])
    assert (d > 8.0 / 255.0).mean() <= 0.005, (
        f"{(d > 8 / 255.).mean():.4%} of values deviate > 8/255")
    assert d.mean() <= 1.0 / 255.0, f"mean dev {d.mean():.5f}"

    floor_key = binning.quantize_z
    try:
        import torch

        binning.quantize_z = lambda z: z.to(torch.bfloat16).to(torch.float32)
        coarse = ms.renderer(False, wh=(W, H)).render(
            dt, camera, ms.sp, ms.rc, use_skybox=True, use_proxy=True)
    finally:
        binning.quantize_z = floor_key
    assert (np.abs(coarse - imgs[True]) > 8.0 / 255.0).mean() > 0.02


@pytest.mark.parametrize("far", [False, True])
@pytest.mark.parametrize("use_skybox,use_proxy",
                         [(False, False), (True, False), (False, True),
                          (True, True)])
@pytest.mark.parametrize("culls", [False, True])
def test_fast_profile_matrix_every_shipped_variant(
        matrix_scene, far, use_skybox, use_proxy, culls):
    """Fast profile (+ the opt-in culls) against the exact profile over
    {skybox} x {proxy} x {near, far camera} x {culls off, depth + sat cull
    on}, within the 8/255 budget. Culled variants render three frames at the
    fixed camera so the saturation record engages, and compare the LAST."""
    ms = matrix_scene
    camera, dt = ms.camera_dt(far)
    ref = ms.exact_ref(far, use_skybox, use_proxy)
    r = ms.renderer(exact=False, dc=culls, sat=culls)
    for _ in range(3 if culls else 1):
        img = r.render(dt, camera, ms.sp, ms.rc, use_skybox=use_skybox,
                       use_proxy=use_proxy)
    assert (r.sat_zimg is not None) == culls
    d = np.abs(img - ref)
    assert (d > 8.0 / 255.0).mean() <= 0.005, (
        f"{(d > 8 / 255.).mean():.4%} of values deviate > 8/255 "
        f"(far={far} sky={use_skybox} proxy={use_proxy} culls={culls})")
    assert d.mean() <= 1.0 / 255.0, f"mean dev {d.mean():.5f}"


def test_fast_and_exact_agree_structurally():
    """Fast and exact render the same splats: alpha coverage masks agree
    except on quantization-thin fringes."""
    eng, ud, dt, camera = _scene(SurfaceType.HEIGHT_MAP)
    rc = RenderConfig.new(eng.n_tiles[0])
    sp = SceneParams.from_data(ud, eng.center_coord, rc)
    imgs = {exact: _port(eng, ud, exact=exact).render(dt, camera, sp, rc)
            for exact in (True, False)}
    assert ((imgs[True][..., 3] > 0.02)
            != (imgs[False][..., 3] > 0.02)).mean() < 0.002
    assert not np.array_equal(imgs[True], imgs[False])


def test_fast_profile_halves_the_proxy_resolution_by_default(matrix_scene):
    """proxy_res_div=0 means 2 in the fast profile and 1 in the exact one
    (and the fast profile samples the proxy through the pyramid)."""
    ms = matrix_scene
    camera, dt = ms.camera_dt(False)
    kw = dict(use_skybox=True, use_proxy=True)

    def frame(exact, div):
        return ms.renderer(exact, div=div).render(dt, camera, ms.sp, ms.rc,
                                                  **kw)

    auto_fast, auto_exact = frame(False, 0), frame(True, 0)
    np.testing.assert_array_equal(auto_fast, frame(False, 2))
    np.testing.assert_array_equal(auto_exact, ms.exact_ref(False, True, True))
    assert not np.array_equal(auto_fast, frame(False, 1))
    # over an opaque sky alpha is 1, but for the proxy's silhouette pixels:
    # the half-res colour (alpha included) is upsampled bilinearly, the hit
    # mask nearest, as in the JAX package
    assert (np.abs(auto_fast[..., 3] - 1.0) > 1e-5).mean() < 0.03
    assert np.abs(frame(False, 1)[..., 3] - 1.0).max() < 1e-5
    # half-res depth moves silhouettes by a pixel: a loose structural bound
    assert np.abs(auto_fast - auto_exact).mean() < 0.02
