"""The port's multi-device paths (parallel/batched.py) on the CPU: the over
operator against the JAX package's, the block plan's row 5 and binning's
per-block pair demand (the stream split's two inputs), the stream segments
folded on one device against the single-device frame and the JAX Renderer,
the cut's feedback, the dp batch's divisibility, a gloo world of one
(dp = sp = 1, bit-equal to the plain frame) and one spawned 4-rank gloo run
on a (2, 2) mesh.

Tolerances: the segments' fold against the port's own single frame, exact
profile, max |err| < 1e-3 (the over operator is associative; what differs is
f32 association and a later segment's restart at T = 1 past the single
frame's early exit); against the JAX Renderer, tests/test_pipeline.py's
budget (mean < 1e-4, at most 5e-4 of the pixels over 1e-3); the camera
batch and a world of one bit-equal (same code, same inputs); integers
exact."""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from gswt_renderer_tpu.core import Camera, UserData
from gswt_renderer_tpu.core.config import (
    RenderConfig, SelectiveMergeType, SurfaceType, TileSortType)
from gswt_renderer_tpu.io.synth import synthetic_scene_vec
from gswt_renderer_tpu.ops import binning as jbin
from gswt_renderer_tpu.parallel.batched import composite_over as jax_over
from gswt_renderer_tpu.render.pipeline import Renderer as JaxRenderer
from gswt_renderer_tpu.render.pipeline import RendererConfig as JaxConfig
from gswt_renderer_tpu.render.uniforms import SceneParams
from gswt_renderer_tpu.tiles import WangTileEngine
from gswt_renderer_tpu_torch.ops import binning as tbin
from gswt_renderer_tpu_torch.parallel import (
    composite_over, make_mesh, render_cameras_sharded, render_stream_sharded,
    render_stream_segments)
from gswt_renderer_tpu_torch.parallel.batched import (
    pack_camera_batch, segment_blocks, stream_cut)
from gswt_renderer_tpu_torch.render.pipeline import Renderer, RendererConfig
from test_torch_binning import IMAGE_WH, TILE_WH, _proj
from torch_dist_worker import CAM_POS, TARGET, UI, H, W, cameras, textures

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEG_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(_two_threads):
    """tests/test_parallel.py's scene on the JAX package's tile engine (so
    the JAX Renderer renders the same draw table), the port's exact CPU
    Renderer on it, gs-only, and a second one with the skybox and proxy."""
    wang = WangTileEngine(synthetic_scene_vec(n_lod=2, splats_per_tile=200))
    ud = UserData.from_ui(surface_type=SurfaceType.HEIGHT_MAP,
                          merge_type=SelectiveMergeType.EDGE,
                          tile_sort_type=TileSortType.GRAPH, **UI)
    wang.configure(ud)
    cam_pos = np.array(CAM_POS, np.float32)
    wang.build_tiles(cam_pos)
    camera = Camera((W, H), cam_pos, TARGET, (0.0, 0.0, 1.0),
                    np.deg2rad(45.0), 0.1, 200.0)
    dt = wang.sort_tiles(cam_pos, camera.view_proj())
    rc = RenderConfig.new(wang.n_tiles[0])
    sp = SceneParams.from_data(ud, wang.center_coord, rc)
    out = dict(wang=wang, ud=ud, dt=dt, camera=camera, rc=rc, sp=sp)
    for full in (False, True):
        r = Renderer(wang, RendererConfig(width=W, height=H, max_draws=128,
                                          max_stream=1 << 14, chunk=128,
                                          exact=True), device="cpu")
        r.configure(ud)
        if full:
            sky, checker = textures()
            r.set_skybox(sky, equirect=True)
            r.set_proxy(checker)
        staged = r.stage(dt)
        kw = dict(use_skybox=full, use_proxy=full)
        ref = r.render(None, camera, sp, rc, staged=staged, as_numpy=False,
                       **kw)
        out["full" if full else "gs"] = dict(
            r=r, staged=staged, ref=ref, kw=kw,
            kept=int(r.last_aux["n_pairs_kept"]))
    assert out["full"]["ref"][..., 3].min() > 0.99, "the sky must be opaque"
    return out


def test_composite_over_associative_and_matches_jax(rng):
    """The stream split rests on the associativity of the over operator
    for premultiplied (rgb, alpha) images."""
    a, b, c = (rng.random((5, 5, 4)).astype(np.float32) for _ in range(3))
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
    left = composite_over(composite_over(ta, tb), tc)
    right = composite_over(ta, composite_over(tb, tc))
    assert float((left - right).abs().max()) < 1e-5
    jl = np.asarray(jax_over(jax_over(a, b), c))
    np.testing.assert_allclose(left.numpy(), jl, rtol=0, atol=1e-6)


def test_composite_over_identity():
    """Fully transparent front or back is an identity: an empty segment
    does not alter the image."""
    img = torch.from_numpy(
        np.random.default_rng(1).random((4, 4, 4)).astype(np.float32))
    zero = torch.zeros_like(img)
    assert torch.equal(composite_over(zero, img), img)
    assert torch.equal(composite_over(img, zero), img)


def test_plan_row5_kills_the_lanes_below_lo(scene):
    """A 6-row plan gives assemble_and_project the 5-row plan's outputs,
    with the lanes below each block's lo dead (invalid, colour 0, as every
    dead lane)."""
    s = scene["gs"]
    r = s["r"]
    bh = s["staged"]["blocks"]
    plan = r.upload_plan(s["staged"])
    lo = np.random.default_rng(3).integers(0, 256, bh.shape[1])
    lo[0] = 0
    plan6 = dict(plan, blocks=torch.from_numpy(
        np.concatenate([bh, lo[None].astype(np.int32)])))
    uniforms = r.pack_uniforms(scene["camera"], scene["sp"], scene["rc"])
    unpacked = r.unpack_frame_uniforms(uniforms)
    p5 = r._project(plan, uniforms, unpacked, scene["sp"], scene["rc"])
    p6 = r._project(plan6, uniforms, unpacked, scene["sp"], scene["rc"])
    lane = torch.arange(256).repeat(bh.shape[1])
    alive = lane >= torch.from_numpy(lo).repeat_interleave(256)
    assert torch.equal(p6["valid"], p5["valid"] & alive)
    assert bool((p5["valid"] & ~alive).any()), "no live lane was cut"
    for c5, c6 in zip(p5["color"], p6["color"]):
        assert torch.equal(c6, c5 * alive.float())
    for k, v in p5.items():
        if k in ("valid", "color"):
            continue
        for a, b in zip(v if isinstance(v, tuple) else (v,),
                        p6[k] if isinstance(v, tuple) else (p6[k],)):
            assert torch.equal(a, b), k


def test_front_moves_block_demand_into_aux(scene):
    """Renderer.front(emit_block_demand=True) hands binning's per-block pair
    demand over in aux: one entry per 256-lane block of the plan, summing
    to the frame's bbox pair demand; without the flag there is none."""
    s = scene["full"]
    r = s["r"]
    plan = r.upload_plan(s["staged"])
    args = (plan, scene["camera"], scene["sp"], scene["rc"])
    binned, _, _, aux = r.front(*args, emit_block_demand=True, **s["kw"])
    bd = aux["block_demand"]
    assert tuple(bd.shape) == (s["staged"]["blocks"].shape[1],)
    assert int(bd.sum()) == aux["n_pairs"] and "block_demand" not in binned
    assert int(bd.min()) >= 0 and int(bd.max()) > 0
    assert "block_demand" not in r.front(*args, **s["kw"])[3]


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("seed,n", [(0, 2000), (1, 1536)])
def test_block_demand_matches_jax(exact, seed, n):
    image_wh, tile_wh = IMAGE_WH, TILE_WH
    p = _proj(n, seed)
    jb = jbin.bin_pairs(jax.tree_util.tree_map(jnp.asarray, p),
                        image_wh=image_wh, tile_wh=tile_wh,
                        max_pairs=1 << 15, chunk=128, exact=exact,
                        elem_paths=2, emit_block_demand=True)
    cap = tbin.fit_capacity(jb["n_pairs"], 128)
    tb = tbin.bin_pairs(jax.tree_util.tree_map(torch.from_numpy, p),
                        image_wh=image_wh, tile_wh=tile_wh, chunk=128,
                        exact=exact, emit_block_demand=True, capacity=cap)
    want = np.asarray(jb["block_demand"])
    assert want.shape == (-(-n // 256),)
    np.testing.assert_array_equal(tb["block_demand"].numpy(), want)
    assert int(want.sum()) == tb["n_pairs"]
    assert "block_demand" not in tbin.bin_pairs(
        jax.tree_util.tree_map(torch.from_numpy, p), image_wh=image_wh,
        tile_wh=tile_wh, chunk=128, exact=exact, capacity=cap)


def test_stream_segments_cross_draw_boundaries(scene):
    """The premise of the segment tests: at n_seg = 4 some boundary falls
    strictly inside a draw (a draw's lanes span two segments)."""
    bh = scene["gs"]["staged"]["blocks"]
    r = scene["gs"]["r"]
    r.__dict__.pop("_sp_feedback", None)
    bounds, entries = stream_cut(r, bh, 4)
    inside = []
    for lane in bounds[1:-1]:
        b = lane // 256
        if b >= bh.shape[1]:
            continue
        if (0 < lane % 256 < bh[3, b]) or (
                lane % 256 == 0 and b > 0 and bh[4, b - 1] == bh[4, b]):
            inside.append(lane)
    assert inside, f"every boundary {bounds} lies on a draw's edge"
    # the segments tile the live lanes once each
    covered = sorted((b * 256 + lo, b * 256 + nv)
                     for ents in entries for b, lo, nv in ents)
    live = sum(int(x) for x in bh[3])
    assert sum(e - s for s, e in covered) == live
    assert all(a[1] <= b[0] for a, b in zip(covered, covered[1:]))


@pytest.mark.parametrize("full", [False, True], ids=["gs_only", "full"])
@pytest.mark.parametrize("n_seg", [2, 3, 4])
def test_stream_segments_match_the_single_frame(scene, n_seg, full):
    s = scene["full" if full else "gs"]
    r = s["r"]
    r.__dict__.pop("_sp_feedback", None)
    for _ in range(2):  # the first cut, then the one the feedback sets
        img = render_stream_segments(r, s["staged"], scene["sp"],
                                     scene["camera"], n_seg, scene["rc"],
                                     **s["kw"])
        err = float((img - s["ref"]).abs().max())
        assert img.shape == (H, W, 4) and err < SEG_TOL, (n_seg, err)
        assert len(r.last_shard_pairs_kept) == n_seg
        assert len(r.last_sp_bounds) == n_seg + 1


def test_stream_segments_match_jax_renderer(scene):
    """The fold of four segments against the JAX Renderer's single frame
    (Pallas in interpret mode) within the parity budget."""
    s = scene["full"]
    jr = JaxRenderer(scene["wang"], JaxConfig(
        width=W, height=H, max_draws=128, max_stream=1 << 14,
        min_stream=1 << 11, chunk=128, exact=True))
    jr.configure(scene["ud"])
    sky, checker = textures()
    jr.set_skybox(sky, equirect=True)
    jr.set_proxy(checker)
    jimg = jr.render(scene["dt"], scene["camera"], scene["sp"], scene["rc"],
                     use_skybox=True, use_proxy=True)
    s["r"].__dict__.pop("_sp_feedback", None)
    img = render_stream_segments(s["r"], s["staged"], scene["sp"],
                                 scene["camera"], 4, scene["rc"],
                                 **s["kw"]).numpy()
    diff = np.abs(img - jimg).max(axis=-1)
    assert np.mean(diff) < 1e-4, np.mean(diff)
    assert np.mean(diff > 1e-3) <= 5e-4, diff.max()


@pytest.mark.parametrize("n_seg", [2, 4])
def test_pair_split_balances_after_feedback(scene, n_seg):
    """The cut's feedback balances the pairs per segment within 1.5x in at
    most 4 calls, and the segments keep the single frame's pairs within
    5% (__graft_entry__.py dryrun_multichip's limits)."""
    s = scene["full"]
    r = s["r"]
    r.__dict__.pop("_sp_feedback", None)
    for _ in range(4):
        render_stream_segments(r, s["staged"], scene["sp"], scene["camera"],
                               n_seg, scene["rc"], **s["kw"])
        pairs = r.last_shard_pairs_kept
        if min(pairs) > 0 and max(pairs) / min(pairs) <= 1.5:
            break
    assert min(pairs) > 0 and max(pairs) / min(pairs) <= 1.5, pairs
    assert abs(sum(pairs) - s["kept"]) <= 0.05 * s["kept"], (pairs, s["kept"])


def test_segment_without_entries_is_one_dead_padding_block(scene):
    bh = scene["gs"]["staged"]["blocks"]
    pad = segment_blocks(bh, [])
    assert pad.shape == (6, 1) and not pad.any()
    one = segment_blocks(bh, [(2, 17, 200)])
    np.testing.assert_array_equal(one[[0, 1, 2, 4], 0], bh[[0, 1, 2, 4], 2])
    assert (one[3, 0], one[5, 0]) == (200, 17)


class _TwoRankMesh:
    """A stand-in for a (2, 1) DeviceMesh, enough for the batch check that
    runs before any collective."""
    mesh_dim_names = ("dp", "sp")

    def size(self, dim):
        return (2, 1)[dim]

    def get_local_rank(self, name):
        return 0

    def get_group(self, name):
        return None


def test_camera_batch_must_divide_dp(scene):
    s = scene["gs"]
    cams = pack_camera_batch(s["r"], scene["sp"], [scene["camera"]] * 3,
                             scene["rc"])
    assert tuple(cams.shape) == (3, Renderer.UNIFORMS_LEN)
    with pytest.raises(ValueError, match="does not divide"):
        render_cameras_sharded(s["r"], s["staged"], scene["sp"], cams,
                               _TwoRankMesh(), scene["rc"])


def test_world_of_one_is_the_plain_frame(scene, tmp_path):
    """dp = sp = 1 through a real gloo group: a batch of distinct cameras
    and the stream path, each bit-equal to Renderer.render."""
    s = scene["full"]
    r = s["r"]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(device_type="cpu")
        with pytest.raises(ValueError, match="does not hold"):
            make_mesh((2, 1), device_type="cpu")
        cams = cameras(Camera, 3)
        batch = pack_camera_batch(r, scene["sp"], cams, scene["rc"])
        imgs = render_cameras_sharded(r, s["staged"], scene["sp"], batch,
                                      mesh, scene["rc"], **s["kw"])
        assert tuple(imgs.shape) == (3, H, W, 4)
        for i, c in enumerate(cams):
            ref = r.render(None, c, scene["sp"], scene["rc"],
                           staged=s["staged"], as_numpy=False, **s["kw"])
            assert torch.equal(imgs[i], ref), i
        img = render_stream_sharded(r, s["staged"], scene["sp"],
                                    scene["camera"], mesh, scene["rc"],
                                    **s["kw"])
        assert torch.equal(img, s["ref"])
        assert r.last_shard_pairs_kept == [s["kept"]]
    finally:
        dist.destroy_process_group()


def test_four_gloo_ranks_on_a_2x2_mesh(tmp_path):
    """One spawned run of four gloo ranks on a (2, 2) mesh: the camera batch
    all-gathered over dp, and the stream split over sp with its feedback,
    each against rank 0's single-device frames. Its own timeout: 240 s."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = tmp_path / "rank0.json"
    worker = ROOT / "tests" / "torch_dist_worker.py"
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(tmp_path / "pg"), str(rank), "4",
         str(out)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * 4, "\n".join(logs)
    res = json.loads(out.read_text())
    assert res["dp_shape"] == [4, H, W, 4]
    assert res["dp_err"] == [0.0] * 4
    assert "does not divide" in res["uneven"]
    assert res["sp_gs_err"] < SEG_TOL and res["sp_err"] < SEG_TOL, res
    pairs = [c["pairs"] for c in res["calls"]]
    assert all(len(p) == 2 for p in pairs)
    last = pairs[-1]
    assert min(last) > 0 and max(last) / min(last) <= 1.5, pairs
    assert abs(sum(last) - res["kept"]) <= 0.05 * res["kept"], (pairs, res)
