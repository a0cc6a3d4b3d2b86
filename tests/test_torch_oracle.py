"""The port's oracle (gswt_renderer_tpu_torch/refrender/oracle.py, on the
CPU) against the JAX package's NumPy oracle on the same FrameInputs, built
from the scenes of tests/test_pipeline.py at 64x64; and the port's CPU
Renderer, exact profile, against the port's oracle.

Tolerances. Projected fields within rtol 1e-5 (they come out bit-equal:
the port keeps NumPy's dtypes, summation order and correctly rounded
sqrt), images within 1e-6 absolute (NumPy's and ATen's float32 exp differ
by an ulp on many arguments; a pixel sums a few dozen such terms).
Wider, and said where: the sphere surface, whose tangent frame is a
central difference of sin/cos (an ulp of sin, 6e-8, times the radius 15
over 2 dt = 0.032 moves the frame by 2.8e-5), and the TileID tint of merged
draws, a hash that multiplies sin by 43758.5453. For both a second check
swaps NumPy's sin/cos into the port and asks for equality, so that the
wider tolerance covers the transcendental functions and nothing else."""

import dataclasses
import enum
import functools

import numpy as np
import pytest
import torch

from gswt_renderer_tpu.core import Camera, UserData
from gswt_renderer_tpu.core.config import (
    DrawMode, RenderConfig, SelectiveMergeType, SurfaceType, TileSortType)
from gswt_renderer_tpu.io.synth import synthetic_scene_vec
from gswt_renderer_tpu.refrender import oracle as jo
from gswt_renderer_tpu.render import build_frame_inputs
from gswt_renderer_tpu.tiles import WangTileEngine
from gswt_renderer_tpu_torch import core as tcore
from gswt_renderer_tpu_torch.core import config as tconfig
from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec as t_synth
from gswt_renderer_tpu_torch.refrender import oracle as to
from gswt_renderer_tpu_torch.render.pipeline import Renderer, RendererConfig
from gswt_renderer_tpu_torch.render.uniforms import (
    SceneParams, build_frame_inputs as t_build_frame_inputs)
from gswt_renderer_tpu_torch.tiles import WangTileEngine as TWangTileEngine
from test_torch_pipeline import CASES, _assert_close


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for these small tensors: under the suite's
    parallel workers PyTorch's default pool (a thread per core in every
    worker) oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


W = H = 64
FIELD_RTOL = 1e-5
IMAGE_ATOL = 1e-6
# the sphere (module docstring): four ulps of sin/cos at radius 15, on the
# surface point and, through the central difference, on the tangent frame
SPHERE_POS_ATOL = 4e-6
SPHERE_FRAME_ATOL = 1.2e-4
# the sphere's projected extents: the frame's error carried through the
# covariance, on the quadratic form major major^T + minor minor^T (its
# eigenvectors turn freely where the splat is nearly round) and the lengths
SPHERE_EXTENT_RTOL = 2e-4
SPHERE_NDC_ATOL = 1e-6
SPHERE_IMAGE_ATOL = 5e-5

SCENES = dict(CASES, grazing=dict(ui={}, cam=(0.0, -6.0, 2.0),
                                  target=(0.0, 0.0, 0.5), up=(0.0, 1.0, 0.0)))
# (scene, RenderConfig fields), as tests/test_pipeline.py varies them
VARIANTS = {
    "flat": ("flat", {}),
    "grazing": ("grazing", {}),
    "heightmap": ("heightmap", {}),
    "sphere": ("sphere", {}),
    "edge_merge_lod_blend": ("edge_merge_lod_blend", {}),
    "tile_id": ("flat", dict(draw_mode=DrawMode.TILE_ID)),
    "tile_id_merged": ("edge_merge_lod_blend",
                       dict(draw_mode=DrawMode.TILE_ID)),
    "tile_lod": ("edge_merge_lod_blend", dict(draw_mode=DrawMode.TILE_LOD)),
    "lod": ("edge_merge_lod_blend", dict(draw_mode=DrawMode.LOD)),
    "view": ("flat", dict(draw_mode=DrawMode.VIEW)),
    "point_cloud": ("flat", dict(draw_point_cloud=True,
                                 point_cloud_radius=0.01)),
    "point_cloud_tile_lod": ("flat", dict(draw_point_cloud=True,
                                          point_cloud_radius=0.01,
                                          draw_mode=DrawMode.TILE_LOD)),
    "scales": ("flat", dict(splat_scale=1.5, scene_scale=(1.2, 0.9, 1.1))),
    "clip": ("heightmap", dict(use_clip=True, clip_height=0.2)),
    "lod_enable": ("edge_merge_lod_blend", dict(lod_enable=(True, False))),
}


def _ui(case):
    kw = dict(tile_map_half_wh=(2, 2), height_map_scale=(1.0, 0.0),
              lod_max_dist=8.0, surface_type=SurfaceType.NONE,
              merge_type=SelectiveMergeType.NONE,
              tile_sort_type=TileSortType.DISTANCE, lod_blending=False)
    kw.update(SCENES[case]["ui"])
    return kw


@functools.lru_cache(maxsize=None)
def _scene(case, size=W):
    c = SCENES[case]
    wang = WangTileEngine(synthetic_scene_vec(
        n_lod=2, splats_per_tile=c.get("splats", 96)))
    wang.configure(UserData.from_ui(**_ui(case)))
    cam_pos = np.asarray(c["cam"], np.float32)
    wang.build_tiles(cam_pos)
    camera = Camera((size, size), cam_pos, c["target"], c["up"],
                    np.deg2rad(60.0), 0.1, 200.0)
    return wang, camera, wang.sort_tiles(cam_pos, camera.view_proj())


@functools.lru_cache(maxsize=None)
def _inputs(variant):
    case, fields = VARIANTS[variant]
    wang, camera, dt = _scene(case)
    rc = dataclasses.replace(RenderConfig.new(wang.n_tiles[0]), **fields)
    return build_frame_inputs(wang, dt, camera, rc)


def _np_sin_rand(co):
    """The port's _rand with NumPy's float32 sin in place of ATen's."""
    x = co[..., 0] * 12.9898 + co[..., 1] * 78.233
    s = torch.from_numpy(np.sin(x.numpy()))
    return torch.remainder(torch.frac(s * 43758.5453), 1.0)


def _np_uv_to_pos(uv):
    """The port's _sphere_uv_to_pos with NumPy's float32 sin and cos."""
    u = uv.numpy()
    return torch.from_numpy(np.stack(
        [np.cos(u[:, 1]) * np.cos(u[:, 0]), np.cos(u[:, 1]) * np.sin(u[:, 0]),
         np.sin(u[:, 1])], axis=1).astype(np.float32))


def _numpy(d):
    return {k: v.numpy() for k, v in d.items()}


def test_sample_height_matches_jax():
    """Wrap and bilinear on a seeded non-square map, at u, v outside [0, 1)
    on both sides (negative texel indices wrap with Python's modulo)."""
    rng = np.random.default_rng(11)
    w, h = 13, 7
    hm = rng.uniform(-1.0, 1.0, w * h).astype(np.float32)
    u = rng.uniform(-2.5, 3.5, 4000).astype(np.float32)
    v = rng.uniform(-2.5, 3.5, 4000).astype(np.float32)
    ref = jo.sample_height(hm, (w, h), u, v)
    got = to.sample_height(torch.from_numpy(hm), (w, h), torch.from_numpy(u),
                           torch.from_numpy(v)).numpy()
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=FIELD_RTOL, atol=0)


def test_sqrt_is_correctly_rounded():
    """The oracle's float32 square root equals NumPy's, which is correctly
    rounded, on seeded inputs over many binades."""
    rng = np.random.default_rng(17)
    x = (10.0 ** rng.uniform(-8.0, 8.0, 100_000)).astype(np.float32)
    got = to._sqrt(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.sqrt(x))
    np.testing.assert_array_equal(
        got, np.sqrt(x.astype(np.float64)).astype(np.float32))


def _surface_inputs(variant, seed):
    """A seeded set of draws and their splats' world xy, as project_draw
    hands them to surface_mapping_gpu."""
    fi = _inputs(variant)
    s = jo.assemble_stream_np(fi)
    rng = np.random.default_rng(seed)
    rows = np.unique(s["draw_id"])
    rows = rng.choice(rows, size=min(6, rows.size), replace=False)
    out = []
    for r in rows:
        m = s["draw_id"] == r
        gs = s["gs_index"][m].astype(np.int64)
        xy = (fi.pos[gs] + fi.draw.offset[r])[:, :2].astype(np.float32)
        out.append((int(r), xy, s["map_id"][m].astype(np.int64)))
    return fi, out


@pytest.mark.parametrize("variant", ["flat", "heightmap", "sphere"])
def test_surface_mapping_matches_jax(variant, monkeypatch):
    fi, draws = _surface_inputs(variant, seed=3)
    assert draws
    for swap in (False, True):
        if swap:  # NumPy's sin/cos: the sphere must then be bit-equal
            if variant != "sphere":
                break
            monkeypatch.setattr(to, "_sphere_uv_to_pos", _np_uv_to_pos)
        for row, xy, mid in draws:
            pos, frame = jo.surface_mapping_gpu(fi, xy, mid, row)
            tpos, tframe = (x.numpy() for x in to.surface_mapping_gpu(
                fi, torch.from_numpy(xy), torch.from_numpy(mid), row))
            assert tpos.dtype == tframe.dtype == np.float32
            if variant == "sphere" and not swap:
                np.testing.assert_allclose(tpos, pos, rtol=0,
                                           atol=SPHERE_POS_ATOL)
                np.testing.assert_allclose(tframe, frame, rtol=0,
                                           atol=SPHERE_FRAME_ATOL)
            else:
                np.testing.assert_allclose(tpos, pos, rtol=FIELD_RTOL, atol=0)
                np.testing.assert_allclose(tframe, frame, rtol=FIELD_RTOL,
                                           atol=0)
    if variant == "heightmap":
        assert np.abs(frame[:, 2, :2]).max() > 0.0, "the map should tilt"


def test_rand_is_the_numpy_hash():
    """The TileID tint's hash: equal to the JAX oracle's wherever ATen's
    float32 sin equals NumPy's, and everywhere the NumPy hash of ATen's
    sin."""
    rng = np.random.default_rng(5)
    co = rng.uniform(-40.0, 40.0, (5000, 2)).astype(np.float32)
    got = to._rand(torch.from_numpy(co)).numpy()
    ref = jo._rand(co)
    x = co[..., 0] * np.float32(12.9898) + co[..., 1] * np.float32(78.233)
    aten_sin = torch.sin(torch.from_numpy(x)).numpy()
    same = aten_sin == np.sin(x)
    assert same.mean() > 0.5
    np.testing.assert_array_equal(got[same], ref[same])
    np.testing.assert_array_equal(
        got, np.modf(aten_sin * np.float32(43758.5453))[0] % np.float32(1.0))
    assert ((got >= 0.0) & (got < 1.0)).all()
    vec = to._random_vec3(torch.from_numpy(co)).numpy()
    assert vec.shape == (5000, 3)
    np.testing.assert_array_equal(vec[:, 0], got)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_assemble_stream_matches_jax(variant):
    fi = _inputs(variant)
    ref = jo.assemble_stream_np(fi)
    got = _numpy(to.assemble_stream(fi, device="cpu"))
    assert set(got) == set(ref)
    assert ref["gs_index"].size > 0
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k].astype(np.int64),
                                      err_msg=k)
    if variant == "lod_enable":
        full = jo.assemble_stream_np(_inputs("edge_merge_lod_blend"))
        assert ref["gs_index"].size < full["gs_index"].size


def _assert_fields(ref, got, variant):
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    v = ref["valid"]
    assert v.sum() > 50
    for k in ("center_ndc", "z_ndc", "major_px", "minor_px", "color"):
        assert got[k].dtype == ref[k].dtype == np.float32, k
    if variant == "sphere":
        np.testing.assert_allclose(got["center_ndc"][v], ref["center_ndc"][v],
                                   rtol=0, atol=SPHERE_NDC_ATOL)
        np.testing.assert_allclose(got["z_ndc"][v], ref["z_ndc"][v],
                                   rtol=FIELD_RTOL, atol=0)

        def form(p):
            a, b = p["major_px"][v], p["minor_px"][v]
            return a[:, :, None] * a[:, None, :] + b[:, :, None] * b[:, None, :]

        fr, fg = form(ref), form(got)
        scale = np.abs(fr).max(axis=(1, 2))
        assert (np.abs(fg - fr).max(axis=(1, 2)) <= SPHERE_EXTENT_RTOL * scale).all()
        for k in ("major_px", "minor_px"):
            np.testing.assert_allclose(
                np.linalg.norm(got[k][v], axis=1),
                np.linalg.norm(ref[k][v], axis=1), rtol=SPHERE_EXTENT_RTOL)
        np.testing.assert_allclose(got["color"][v], ref["color"][v],
                                   rtol=FIELD_RTOL, atol=0)
        return
    for k in ("center_ndc", "z_ndc", "major_px", "minor_px", "color"):
        np.testing.assert_allclose(got[k][v], ref[k][v], rtol=FIELD_RTOL,
                                   atol=0, err_msg=k)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_project_draw_matches_jax(variant, monkeypatch):
    fi = _inputs(variant)
    s = jo.assemble_stream_np(fi)
    ref = jo.project_draw_np(fi, **s)
    ts = {k: torch.from_numpy(x.astype(np.int64)) for k, x in s.items()}
    if variant == "tile_id_merged":
        assert fi.draw.single_draw.sum() > 0, "the case needs merged draws"
        # the hash of ATen's sin tints the merged draws otherwise
        monkeypatch.setattr(to, "_rand", _np_sin_rand)
    got = _numpy(to.project_draw(fi, **ts))
    _assert_fields(ref, got, variant)
    if variant == "sphere":
        monkeypatch.setattr(to, "_sphere_uv_to_pos", _np_uv_to_pos)
        got = _numpy(to.project_draw(fi, **ts))
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_project_draw_tile_id_tint_of_merged_draws():
    """With ATen's sin the merged draws' tint is the hash of ATen's sin:
    every colour off the JAX oracle's lies on a merged draw, and the
    unmerged ones are equal."""
    fi = _inputs("tile_id_merged")
    s = jo.assemble_stream_np(fi)
    ref = jo.project_draw_np(fi, **s)
    got = _numpy(to.project_draw(
        fi, **{k: torch.from_numpy(x.astype(np.int64)) for k, x in s.items()}))
    merged = fi.draw.single_draw[s["draw_id"]] == 1
    off = (got["color"] != ref["color"]).any(axis=1)
    assert not (off & ~merged).any()
    np.testing.assert_array_equal(got["color"][:, 3], ref["color"][:, 3])
    # the tint is a grey level times three hashes in [0, 1)
    assert np.abs(got["color"] - ref["color"]).max() <= 1.0


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_render_oracle_matches_jax(variant, monkeypatch):
    fi = _inputs(variant)
    ref = jo.render_oracle(fi, W, H)
    assert ref[..., 3].max() > 0.2, "scene should be visible"
    if variant == "tile_id_merged":
        monkeypatch.setattr(to, "_rand", _np_sin_rand)
    img = to.render_oracle(fi, W, H, device="cpu")
    assert img.dtype == torch.float32 and img.shape == (H, W, 4)
    atol = SPHERE_IMAGE_ATOL if variant == "sphere" else IMAGE_ATOL
    np.testing.assert_allclose(img.numpy(), ref, rtol=0, atol=atol)


def test_render_oracle_background_and_depth_match_jax():
    """A seeded background and a proxy depth that cuts some splats (the
    strict z < depth test), neither of which a JAX test passes."""
    fi = _inputs("heightmap")
    rng = np.random.default_rng(7)
    bg = rng.uniform(0.0, 1.0, (H, W, 4)).astype(np.float32)
    p = jo.project_draw_np(fi, **jo.assemble_stream_np(fi))
    z = p["z_ndc"][p["valid"]]
    lo, hi = np.quantile(z, [0.2, 0.8])
    depth = rng.uniform(lo, hi, (H, W)).astype(np.float32)

    ref = jo.render_oracle(fi, W, H, background=bg, depth=depth)
    got = to.render_oracle(fi, W, H, background=torch.from_numpy(bg),
                           depth=depth, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=IMAGE_ATOL)
    # the whole buffer at one splat's own depth: the test is strict, so
    # that splat is cut with everything behind it
    at = np.full((H, W), np.sort(z)[z.size // 2], np.float32)
    ref_at = jo.render_oracle(fi, W, H, depth=at)
    got_at = to.render_oracle(fi, W, H, depth=torch.from_numpy(at),
                              device="cpu").numpy()
    np.testing.assert_allclose(got_at, ref_at, rtol=0, atol=IMAGE_ATOL)
    bg_only = jo.render_oracle(fi, W, H, background=bg)
    cut = np.abs(ref - bg_only).max(axis=-1) > 1e-3
    assert cut.mean() > 0.05, "the depth should cut some splats"
    untouched = np.abs(ref - bg).max(axis=-1) == 0.0
    assert untouched.mean() > 0.05, "the background should show"
    np.testing.assert_array_equal(got[untouched], bg[untouched])


def test_ewa_project_cov_matches_jax():
    """Seeded SPD covariances at seeded centres in front of a seeded camera,
    float32 as project_draw passes them."""
    rng = np.random.default_rng(9)
    n = 3000
    L = rng.normal(0.0, 0.05, (n, 3, 3)).astype(np.float32)
    vrk = (L @ L.transpose(0, 2, 1)).astype(np.float32)
    center = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    center[:, 2] += 8.0
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    view3 = q.astype(np.float32)
    cam_pos = rng.uniform(-0.5, 0.5, 3).astype(np.float32)
    focal = np.array([70.0, 64.0], np.float32)
    htan = np.array([0.6, 0.55], np.float32)
    ref = jo.ewa_project_cov_np(vrk, center, view3, cam_pos, focal, htan)
    got = to.ewa_project_cov(torch.from_numpy(vrk), torch.from_numpy(center),
                             torch.from_numpy(view3), cam_pos, focal, htan)
    for name, r, g in zip(("cov2d", "lambda1", "lambda2", "major", "minor"),
                          ref, got):
        g = g.numpy()
        assert g.dtype == r.dtype == np.float32, name
        np.testing.assert_allclose(g, r, rtol=FIELD_RTOL, atol=0,
                                   err_msg=name)


def test_blend_fragments_matches_jax():
    """Seeded fragments at one pixel, some beyond the A < -4 discard;
    float64 as in the NumPy form. NumPy's and ATen's float64 exp may
    differ by an ulp: rtol 1e-12."""
    rng = np.random.default_rng(13)
    for _ in range(20):
        frags = [(tuple(rng.uniform(-2.5, 2.5, 2)), tuple(rng.uniform(0, 1, 3)),
                  float(rng.uniform(0, 1))) for _ in range(rng.integers(1, 9))]
        ref = jo.blend_fragments_np(frags)
        got = to.blend_fragments(frags, device="cpu")
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-15)


def _port_enum(v):
    """A JAX-package enum member as the port's own."""
    if isinstance(v, enum.Enum):
        return getattr(tconfig, type(v).__name__)[v.name]
    return v


def test_port_renderer_matches_port_oracle():
    """The port's CPU Renderer, exact profile, against the port's oracle on
    tests/test_torch_pipeline.py's height-map case at its 128x128 and
    budget: mean abs < 1e-4, at most 5e-4 of the pixels over 1e-3. Nothing
    of the JAX package renders here."""
    size = 128
    c = CASES["heightmap"]
    kw = {k: _port_enum(v) for k, v in _ui("heightmap").items()}
    ud = tcore.UserData.from_ui(**kw)
    wang = TWangTileEngine(t_synth(n_lod=2, splats_per_tile=96))
    wang.configure(ud)
    cam_pos = np.asarray(c["cam"], np.float32)
    wang.build_tiles(cam_pos)
    camera = tcore.Camera((size, size), cam_pos, c["target"], c["up"],
                          np.deg2rad(60.0), 0.1, 200.0)
    dt = wang.sort_tiles(cam_pos, camera.view_proj())
    rc = tconfig.RenderConfig.new(wang.n_tiles[0])
    ref = to.render_oracle(t_build_frame_inputs(wang, dt, camera, rc),
                           size, size, device="cpu").numpy()
    assert ref[..., 3].mean() > 0.2, "scene should be visible"
    r = Renderer(wang, RendererConfig(width=size, height=size, max_draws=128,
                                      max_stream=1 << 15, chunk=128,
                                      exact=True), device="cpu")
    r.configure(ud)
    img = r.render(dt, camera, SceneParams.from_data(ud, wang.center_coord,
                                                     rc), rc)
    _assert_close(ref, img)
