"""The port's fixed-camera and A/B benchmark scripts end to end on the CPU at
64x64 (their card runs are chip_smoke.py's [bench] lines), with the
counters two of them report held against the JAX Renderer and against the
plain compositor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswt_renderer_tpu.core import Camera as JaxCamera
from gswt_renderer_tpu.core import UserData as JaxUserData
from gswt_renderer_tpu.core.config import RenderConfig as JaxRenderConfig
from gswt_renderer_tpu.core.config import SurfaceType as JaxSurfaceType
from gswt_renderer_tpu.io.synth import synthetic_scene_vec as jax_synth
from gswt_renderer_tpu.ops import proxy as jax_proxy
from gswt_renderer_tpu.ops import trirast as jax_trirast
from gswt_renderer_tpu.render.pipeline import Renderer as JaxRenderer
from gswt_renderer_tpu.render.pipeline import RendererConfig as JaxConfig
from gswt_renderer_tpu.render.uniforms import SceneParams as JaxSceneParams
from gswt_renderer_tpu.tiles import WangTileEngine as JaxWang
from gswt_renderer_tpu_torch.benchmarks import (
    configs, cull_ab, depth_cull_ab, headline, inversion_ab, micro_background,
    profile_frame, proxydiv_ab, quick_full, saturation)
from gswt_renderer_tpu_torch.ops import raster

SMALL = ["--device", "cpu", "--width", "64", "--height", "64", "--splats",
         "32", "--lods", "2", "--map-half", "4"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _positive(s):
    assert s["n"] > 0 and 0 < s["min"] <= s["median"] <= s["max"], s


def test_profile_frame_times_and_profiles(tmp_path):
    res = profile_frame.main(SMALL + ["-n", "2", "--top", "5", "--trace",
                                      str(tmp_path)])
    _positive(res["frame_ms"])
    assert res["wall_profiled_ms"] > 0
    assert res["device_ops"] == []  # no device on the CPU
    assert len(res["host_ops"]) == 5 and res["host_ops"][0][0] > 0
    assert (tmp_path / "frame_trace.json").stat().st_size > 0


def test_quick_full_ab():
    rows = quick_full.main(SMALL + ["-n", "2", "--ab"])
    assert [r["sat_cull"] for r in rows] == [False, True, False]
    for r in rows:
        _positive(r["frame_ms"])
        assert 0 < r["n_pairs_kept"] <= r["n_pairs"] and r["proxy_pairs"] > 0


@pytest.mark.parametrize("flag", [[], ["--no-cull-exact"]])
def test_cull_ab_variants_and_cameras(flag):
    rows = cull_ab.main(SMALL + ["-n", "2"] + flag)
    assert [(r["variant"], r["cam"]) for r in rows] == [
        (v, c) for c in (0, 1) for v in ("off", "dc", "sat", "off2")]
    for r in rows:
        _positive(r["frame_ms"])
        assert r["cull_exact"] is (not flag)
        assert 0 < r["n_pairs_kept"] <= r["n_pairs"]
    by = {(r["variant"], r["cam"]): r for r in rows}
    for c in (0, 1):  # the same frame drawn twice counts the same pairs
        assert by[("off", c)]["n_pairs"] == by[("off2", c)]["n_pairs"]
        assert (by[("off", c)]["n_pairs_kept"]
                == by[("off2", c)]["n_pairs_kept"])
        assert by[("dc", c)]["n_pairs_kept"] <= by[("off", c)]["n_pairs_kept"]


def test_proxydiv_ab():
    rows = proxydiv_ab.main(SMALL + ["-n", "2", "--divs", "2", "4"])
    assert [r["div"] for r in rows] == [2, 4]
    for r in rows:
        _positive(r["frame_ms"])
    assert rows[1]["vs_div"] == 2 and 0 < rows[1]["max_diff"] <= 1.0
    assert 0 <= rows[1]["share_over_8"] <= 1.0
    assert rows[1]["mean_diff"] <= rows[1]["max_diff"]


def test_micro_background_passes():
    rows = micro_background.main(["--device", "cpu", "--width", "64",
                                  "--height", "64", "--map-half", "4",
                                  "--hm", "64", "-n", "2", "--reps", "2"])
    assert [r["library"] for r in rows] == [True] * 3 + [False] * 3
    assert [r["kernel"] for r in rows[3:]] == [
        "#5 bilinear", "#4 trirast + fold", "#6 mip_trilinear"]
    for r in rows:
        _positive(r)


def test_inversion_ab_domains():
    res = inversion_ab.main(["--device", "cpu", "--splats", "32", "--lods",
                             "2", "--map-half", "4", "-n", "2", "--res",
                             "64x36,128x72"])
    a, b = res["rows"]
    assert (a["res"], b["res"]) == ("64x36", "128x72")
    for row in (a, b):
        for v in ("gs", "gs+sky", "full"):
            _positive(row[v])
        assert 0 < row["n_pairs_kept"] <= row["n_pairs"]
        assert row["n_live"] > 0 and row["proxy_pairs"] > 0
        assert row["worklist_entries"] >= 1
    assert res["ratio"]["pixels"] == 4.0
    # the same sort at 4x the pixels: more tiles per splat, the same splats
    assert b["n_live"] == a["n_live"] and b["n_pairs"] >= a["n_pairs"]


def test_configs_rows():
    rows = configs.main(["--device", "cpu", "--width", "64", "--height",
                         "64", "--splats", "32", "--lods", "2", "--map-half",
                         "4", "--dense-splats", "256", "--quick"])
    assert [r["config"] for r in rows] == [
        "1_single_tile_512", "2_terrain_4x4_800x600", "3_infinite_1080p",
        "3d_dense_8k_5lod_1080p", "4_full_skybox_proxy_1080p",
        "4b_full_skybox_proxy_4k", "5_batched_cameras_1080p"]
    vp = {r["config"][:2]: r["viewport"] for r in rows}
    assert vp["3_"] == vp["4_"] == vp["5_"] == [64, 64]
    assert vp["4b"] == [128, 128], "4K is its own Engine at twice the size"
    for r in rows:
        assert r["frame_ms"] > 0 and r["fps"] > 0 and r["setup_s"] > 0
        assert r["frames"] == (3 if r["config"].startswith("5") else 5)
    assert rows[3]["n_pairs"] > 0 and rows[-1]["batch"] == 8


def _jax_aux(dc, wh):
    """The JAX Renderer's aux on the small scene of SMALL at the bench
    camera at wh, full config, fast profile, depth cull dc (interpret
    mode)."""
    wang = JaxWang(jax_synth(n_lod=2, splats_per_tile=32, seed=0))
    # headline.bench_user_data(4)'s settings
    ud = JaxUserData.from_ui(
        tile_map_half_wh=(4, 4), tile_width=4.0,
        surface_type=JaxSurfaceType.HEIGHT_MAP, height_map_wh=(10, 10),
        height_map_scale=(1.0, 0.3), lod_max_dist=96.0,
        lod_transition_width_ratio=0.05, merge_dot_threshold=0.2,
        merge_topk=100, cache_size=1024)
    wang.configure(ud)
    _, pos, target = headline.KEYFRAMES[0]
    pos = np.asarray(pos, np.float32)
    wang.build_tiles(pos)
    cam = JaxCamera(wh, pos, target, (0.0, 0.0, 1.0), np.deg2rad(45.0), 0.1,
                    1000.0)
    dt = wang.sort_tiles(pos, cam.view_proj())
    rc = JaxRenderConfig.new(wang.n_tiles[0])
    sp = JaxSceneParams.from_data(ud, wang.center_coord, rc)
    jr = JaxRenderer(wang, JaxConfig(
        width=wh[0], height=wh[1], exact=False, depth_cull=dc,
        sat_cull=False,
        cull_exact=True, proxy_res_div=0, max_stream=1 << 15,
        min_stream=1 << 11))
    jr.configure(ud)
    sky, checker = headline.bench_textures()
    jr.set_skybox(sky, equirect=True)
    jr.set_proxy(checker)
    jr.render(dt, cam, sp, rc, use_skybox=True, use_proxy=True)
    return {k: int(np.asarray(jr.last_aux[k]))
            for k in ("n_pairs", "n_pairs_kept", "n_live")}


def _planes_in_float64(xs, ys, zs, ws, attrs, valid):
    """The JAX package's triangle_planes with its rows evaluated in float64
    on the same float32 vertices, rounded once to float32."""
    def rows(*args):
        with jax.enable_x64(True):
            planes, _, _ = jax_trirast.triangle_planes(
                *(jnp.asarray(np.asarray(a, np.float64)) for a in args[:5]),
                jnp.asarray(args[5]))
        return np.asarray(planes, np.float32)

    _, ok, bbox = jax_trirast.triangle_planes(xs, ys, zs, ws, attrs, valid)
    planes = jax.pure_callback(
        rows, jax.ShapeDtypeStruct((24, xs.shape[1]), jnp.float32),
        xs, ys, zs, ws, attrs, valid)
    return planes, ok, bbox


def test_depth_cull_ab_counts_the_pairs_the_jax_renderer_counts(monkeypatch):
    """At 128x128: at 64x64 the frame's two 64x32 tiles both reach the sky
    (depth 1), so the cull has nothing to drop. The JAX package's ground
    rows sum products of absolute pixel coordinates in float32, and the
    depth they give is off by more than a splat's distance from the ground
    for a few pairs; with its rows evaluated in float64, the JAX renderer
    keeps exactly the port's pairs."""
    res = depth_cull_ab.main(SMALL[:2] + ["--width", "128", "--height", "128"]
                             + SMALL[6:] + ["-n", "2"])
    for side, dc in (("off", False), ("on", True)):
        _positive(res[side]["frame_ms"])
    jax_f32 = _jax_aux(True, (128, 128))
    monkeypatch.setattr(jax_proxy, "triangle_planes", _planes_in_float64)
    for side, dc in (("off", False), ("on", True)):
        jax_aux = _jax_aux(dc, (128, 128))
        for k in ("n_pairs", "n_pairs_kept", "n_live"):
            assert res[side][k] == jax_aux[k], (side, k, res[side], jax_aux)
    # the float32 rows move the cull by a few pairs, no more
    assert 0 <= jax_f32["n_pairs_kept"] - res["on"]["n_pairs_kept"] <= 4
    assert res["on"]["n_pairs_kept"] < res["off"]["n_pairs_kept"]
    assert res["speedup"] > 0


def test_saturation_counts_agree_with_the_plain_compositor():
    out = saturation.main(SMALL)
    assert out["pairs_total"] > 0 and out["n_entries"] > 0
    assert (out["pairs_total"] - out["pairs_in_skipped_entries"]
            == out["pairs_composited"])

    # finer tiles and chunks, denser splats: tiles that saturate
    bench = profile_frame.build(64, 64, splats=256, lods=2, map_half=4,
                                device="cpu")
    r, staged, cam = bench.renderer(tile_w=16, tile_h=16, chunk=32)
    binned, _, depth_tiles, _ = r.front(
        r.upload_plan(staged), cam, bench.sp, bench.rc, use_skybox=True,
        use_proxy=True)
    st = {}
    acc = raster.rasterize_plain(binned, depth_tiles, image_wh=(64, 64),
                                 tile_wh=(16, 16), chunk=32, use_depth=True,
                                 exact=False, stats=st)
    rs = binned["range_start"].numpy().astype(np.int64)
    re_ = binned["range_end"].numpy().astype(np.int64)
    runs = re_ - rs
    assert st["skipped"] > 0, "the scene must saturate some tile"
    assert st["pairs"] + st["skipped_pairs"] == runs.sum()
    entries = st["tile_entries"].numpy()
    needed = st["tile_needed"].numpy()
    tile_pairs = st["tile_pairs"].numpy()
    trans = 1.0 - acc[:, 3].numpy()  # alpha = 1 - T
    skipped = composited = 0
    for t in range(len(rs)):
        if runs[t] == 0:
            assert entries[t] == needed[t] == 0
            continue
        c0, c1 = rs[t] // 32, (re_[t] - 1) // 32
        assert entries[t] == c1 - c0 + 1
        # the composited chunks are the run's first needed[t] ones
        end = min(re_[t], (c0 + needed[t]) * 32)
        assert tile_pairs[t] == end - rs[t], t
        composited += end - rs[t]
        if needed[t] < entries[t]:  # saturated before its next chunk
            skipped += entries[t] - needed[t]
            assert trans[t].max() < raster.MIN_T + 1e-6, t
    assert skipped == st["skipped"] and composited == st["pairs"]

    z = binned["table"][6].numpy()
    zmax = depth_tiles.numpy().max(axis=1)
    occ = sum(int((z[rs[t]:re_[t]] >= zmax[t]).sum()) for t in range(len(rs)))
    assert saturation.occluded_pairs(binned, depth_tiles) == occ > 0
