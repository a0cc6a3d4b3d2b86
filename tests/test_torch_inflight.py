"""The pipelined frame (Renderer.render(pipeline_depth=)) on the CPU at 64x64
with a synchronous builder: Engine frames at depth 2 equal depth-0 frames
bit for bit and stay within the parity budget of the JAX Engine at depth 2
(exact profile: mean abs < 1e-4, at most 5e-4 of the pixels over 1e-3);
both overflow policies of the pair budgets (depth 0 renders the frame
again, depth 2 counts it in overflow_frames and grows the budget); the
capacity expansion of the pairs against the JAX package's bin_pairs; a
pipelined frame enters none of the sections that used to wait for the
device inside a frame; and at a map half of 4, where 12 pixels differ from
the JAX Engine, a float64 witness shows each is a float32 depth rounded
just inside the far plane (the JAX frame's sky is the float64 answer)."""

import numpy as np
import pytest
import torch

from gswt_renderer_tpu.core import UserData as JaxUserData
from gswt_renderer_tpu.engine import Engine as JaxEngine
from gswt_renderer_tpu.io.synth import synthetic_scene_vec as jax_synth
from gswt_renderer_tpu.ops import binning as jbin
from gswt_renderer_tpu.render.pipeline import RendererConfig as JaxConfig
from gswt_renderer_tpu_torch.benchmarks import headline
from gswt_renderer_tpu_torch.core import UserData, hostprof
from gswt_renderer_tpu_torch.core.config import SurfaceType
from gswt_renderer_tpu_torch.engine import Engine
from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec
from gswt_renderer_tpu_torch.ops import binning as tbin
from gswt_renderer_tpu_torch.ops import proxy as tprox
from gswt_renderer_tpu_torch.render import pipeline
from gswt_renderer_tpu_torch.render.pipeline import RendererConfig

W = H = 64
UI = dict(tile_map_half_wh=(3, 3), lod_max_dist=8.0,
          surface_type=SurfaceType.HEIGHT_MAP, height_map_wh=(4, 4),
          height_map_scale=(1.0, 0.2))
STEP = np.array([0.05, 0.1, 0.0], np.float32)
N = 5
# the waits a frame made inside itself before it was pipelined
OLD_WAITS = ("sync.uniforms", "sync.upload_plan", "sync.bin_pairs",
             "sync.expand_bboxes", "sync.mip_levels")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(exact, **kw):
    return dict(width=W, height=H, max_draws=128, max_stream=1 << 15,
                chunk=128, exact=exact, proxy_tile_w=16, proxy_tile_h=16,
                **kw)


def _engine(exact=True, ui=UI):
    """A synchronous 64x64 full-config Engine (skybox + proxy ground)."""
    eng = Engine(synthetic_scene_vec(n_lod=2, splats_per_tile=48),
                 viewport=(W, H), renderer_config=RendererConfig(**_config(
                     exact)), synchronous=True, device="cpu")
    sky, checker = headline.bench_textures(sky_hw=(16, 32), cells=8, cell=4)
    eng.set_skybox(sky)
    eng.set_proxy(checker)
    eng.configure(UserData.from_ui(**ui))
    _look(eng)
    return eng


def _look(eng):
    """The camera of tests/test_torch_pipeline.py's full-config frames,
    which sees splats and ground."""
    eng.camera.set_view(np.array([1.0, -5.0, 3.0], np.float32),
                        np.array([1.0, 2.0, 0.5], np.float32),
                        np.array([0.0, 0.0, 1.0], np.float32))


def _move(eng, depth, n=N):
    """n frames without readback at `depth`, the camera stepping before
    each; the images once every frame is complete."""
    eng.pipeline_depth = depth
    imgs = []
    for _ in range(n):
        eng.camera.translate(STEP)
        imgs.append(eng.frame(readback=False))
    eng.renderer.drain()
    return [np.asarray(x) for x in imgs]


def _assert_close(ref, img, budget=1e-3, frac=5e-4):
    diff = np.abs(img - ref).max(axis=-1)
    assert np.mean(diff) < 1e-4, f"mean diff {np.mean(diff)}"
    assert np.mean(diff > budget) <= frac, (
        f"{np.mean(diff > budget):.2%} of pixels over {budget}; "
        f"max {diff.max()}")


@pytest.mark.parametrize("exact", [True, False])
def test_depth2_frames_equal_depth0_frames(exact):
    piped, eng = _engine(exact), _engine(exact)
    assert piped.pipeline_depth == 2
    a = _move(piped, 2)
    b = _move(eng, 0)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"frame {i}")
    assert x[..., 3].mean() > 0.5
    r = piped.renderer
    assert r.overflow_frames == 0 and not r._inflight
    # the last frame's counts land once it completes, as at depth 0
    assert r.last_aux == eng.renderer.last_aux and r.last_aux["n_pairs"] > 0
    piped.shutdown()
    eng.shutdown()


def test_depth2_frames_match_the_jax_engine_at_depth2():
    jeng = _jax_engine(UI)
    assert jeng.pipeline_depth == 2
    jimgs = _move(jeng, 2, n=3)
    imgs = _move(_engine(True), 2, n=3)
    for jimg, img in zip(jimgs, imgs):
        _assert_close(jimg, img)
    jeng.shutdown()


def _jax_engine(ui):
    jeng = JaxEngine(
        jax_synth(n_lod=2, splats_per_tile=48), viewport=(W, H),
        renderer_config=JaxConfig(min_stream=1 << 12, **_config(True)),
        synchronous=True)
    sky, checker = headline.bench_textures(sky_hw=(16, 32), cells=8, cell=4)
    jeng.set_skybox(sky)
    jeng.set_proxy(checker)
    jeng.configure(JaxUserData.from_ui(**ui))
    _look(jeng)
    return jeng


def _grid_depths(eng, uniforms, ys, xs, dtype):
    """[T, n]: the depth of each proxy-grid triangle at the centres of the
    pixels (ys, xs) where the triangle covers the centre at z >= 0 (inf
    elsewhere), with the grid projected, its planes made and evaluated in
    `dtype` (ops/proxy.py map_grid_planes; the evaluation order of the
    plain raster, ops/trirast.py)."""
    r = eng.renderer

    def cast(d):
        return {k: v.to(dtype) if v.is_floating_point() else v
                for k, v in d.items()}

    scene_d, cam_d = uniforms
    planes, ok, _ = tprox.map_grid_planes(
        cast(cam_d), cast(scene_d), (W, H), r.hm4.to(dtype),
        r.height_map_wh, r.proxy_verts.to(dtype), r.proxy_tris,
        surface_type=int(eng.scene_params.surface_type),
        height_offset=float(eng.render_config.proxy_height))
    px = torch.as_tensor(xs, dtype=dtype) + 0.5
    py = torch.as_tensor(ys, dtype=dtype) + 0.5

    def ev(k):
        return (planes[3 * k][:, None] * px + planes[3 * k + 1][:, None] * py
                + planes[3 * k + 2][:, None])

    b0, b1, z = ev(0), ev(1), ev(3)
    inside = ((b0 >= 0) & (b1 >= 0) & (1.0 - b0 - b1 >= 0) & ok[:, None]
              & (z >= 0))
    return torch.where(inside, z, torch.inf)


# At a map half of 4 the third frame's camera sees the far ring's edge at
# the far plane, along pixel row 4: measured against the JAX Engine, 12
# pixels of 4096 (0.29%, mean abs 0.0022) show the port's ground where the
# JAX frame shows the sky. A float64 witness sides with JAX there.
MAP4_FLIPS = 12
# how far below the far plane a float32 depth lands there (measured
# 1.8e-7, float64 has 1.0000108)
FAR_TIE = 2e-5


def test_map_half_4_differs_from_jax_only_at_far_plane_ties():
    """tile_map_half_wh=(4, 4), depth 2 on both sides. A pixel over the
    parity budget's 1e-3 is a far-plane tie when the port's float32 planes
    (which the JAX package's own float32 operations give bit for bit
    outside a jitted frame) put a grid triangle's depth within FAR_TIE
    below the far plane, so the port draws ground, while the same
    projection in float64 puts every triangle there at or beyond the far
    plane (no hit: the JAX frame's sky). There are at most MAP4_FLIPS ties,
    and the other pixels are within the parity budget (mean < 1e-4, at
    most 5e-4 of them over 1e-3)."""
    ui = dict(UI, tile_map_half_wh=(4, 4))
    jeng = _jax_engine(ui)
    jimgs = _move(jeng, 2, n=3)
    jeng.shutdown()
    eng = _engine(True, ui)
    eng.pipeline_depth = 2
    imgs, uniforms = [], []
    for _ in range(3):
        eng.camera.translate(STEP)
        imgs.append(eng.frame(readback=False))
        uniforms.append(eng.renderer.frame_uniforms(
            eng.camera, eng.scene_params, eng.render_config)[:2])
    eng.renderer.drain()
    ties = 0
    for jimg, img, uni in zip(jimgs, imgs, uniforms):
        diff = np.abs(np.asarray(img) - jimg).max(axis=-1)
        ys, xs = np.nonzero(diff > 1e-3)
        tie = np.zeros(diff.shape, bool)
        if len(ys):
            z32 = _grid_depths(eng, uni, ys, xs, torch.float32).amin(0)
            z64 = _grid_depths(eng, uni, ys, xs, torch.float64).amin(0)
            at_far = (z32 < 1.0) & (z32 >= 1.0 - FAR_TIE) & (z64 >= 1.0)
            tie[ys[at_far.numpy()], xs[at_far.numpy()]] = True
        ties += int(tie.sum())
        rest = np.where(tie, 0.0, diff)
        assert np.mean(rest) < 1e-4, f"mean diff {np.mean(rest)}"
        assert np.mean(rest > 1e-3) <= 5e-4, np.argwhere(rest > 1e-3)
    assert ties <= MAP4_FLIPS
    eng.shutdown()


def _forced(eng, demand=1):
    """Both pair budgets forced down to one chunk: the next frame
    overflows each of them."""
    eng.renderer.pair_budget.demand = demand
    eng.renderer.proxy_budget.demand = demand


def test_depth0_overflow_renders_the_frame_again():
    eng, ample = _engine(), _engine()
    _move(eng, 0, n=1)
    want = _move(ample, 0, n=2)[-1]
    aux = dict(eng.renderer.last_aux)
    # the forced capacities are a chunk each, below this frame's demand
    assert aux["n_pairs"] > 128 and aux["proxy_pairs"] > pipeline.PROXY_CHUNK
    _forced(eng)
    got = _move(eng, 0, n=1)[-1]
    r = eng.renderer
    assert r.last_overflow_retries == 1 and r.overflow_frames == 0
    np.testing.assert_array_equal(got, want)
    assert not r.last_aux["overflow"] and not r.last_aux["proxy_overflow"]
    assert r.pair_budget.demand == r.last_aux["n_pairs"]
    eng.shutdown()
    ample.shutdown()


def test_depth2_overflow_counts_and_grows_the_budget():
    eng, ample = _engine(), _engine()
    _move(eng, 2, n=1)
    want = _move(ample, 0, n=1 + N)
    _forced(eng)
    short = _move(eng, 2, n=1)[0]
    r = eng.renderer
    # rendered short (the back-most pairs dropped), counted, not retried
    assert r.overflow_frames == 1 and r.last_overflow_retries == 0
    assert r.last_aux["overflow"] and r.last_aux["proxy_overflow"]
    assert not np.array_equal(short, want[1])
    assert r.pair_budget.demand == r.last_aux["n_pairs"] > 128
    later = _move(eng, 2)
    assert r.overflow_frames == 1
    for i, (x, y) in enumerate(zip(later, want[2:])):
        np.testing.assert_array_equal(x, y, err_msg=f"frame {i}")
    eng.shutdown()
    ample.shutdown()


IMAGE_WH, TILE_WH, CHUNK = (256, 128), (64, 32), 128


def _proj(n, seed):
    w, h = IMAGE_WH
    rng = np.random.default_rng(seed)
    qa = rng.uniform(0.002, 0.1, n).astype(np.float32)
    qc = rng.uniform(0.002, 0.1, n).astype(np.float32)
    qb = (rng.uniform(-0.9, 0.9, n) * np.sqrt(qa * qc)).astype(np.float32)
    det = qa * qc - qb * qb
    col = rng.uniform(0.0, 1.0, (4, n)).astype(np.float32)
    return dict(
        cx=rng.uniform(-30, w + 30, n).astype(np.float32),
        cy=rng.uniform(-30, h + 30, n).astype(np.float32),
        ext_x=np.sqrt(4.0 * qc / det).astype(np.float32),
        ext_y=np.sqrt(4.0 * qa / det).astype(np.float32),
        q=(qa, qb, qc), color=tuple(col),
        z=rng.uniform(0.0, 1.0, n).astype(np.float32),
        valid=rng.random(n) > 0.4,
    )


def _tree(p, to):
    return {k: tuple(to(x) for x in v) if isinstance(v, tuple) else to(v)
            for k, v in p.items()}


@pytest.mark.parametrize("extra_chunks", [0, 1, 7])
@pytest.mark.parametrize("exact", [True, False])
def test_capacity_expansion_matches_jax(exact, extra_chunks):
    """bin_pairs into a capacity at or above the demand: the JAX package's
    ranges and each tile's run of slots and rows, the demand as a tensor,
    no overflow, and every slot past the runs dead."""
    import jax.numpy as jnp

    p = _proj(2000, 11)
    jb = jbin.bin_pairs(_tree(p, jnp.asarray), image_wh=IMAGE_WH,
                        tile_wh=TILE_WH, max_pairs=1 << 15, chunk=CHUNK,
                        exact=exact, cull_exact=True, elem_paths=2)
    assert not bool(jb["overflow"])
    demand = int(jb["n_pairs"])
    cap = (-(-demand // CHUNK) + extra_chunks) * CHUNK
    tb = tbin.bin_pairs(_tree(p, torch.from_numpy), image_wh=IMAGE_WH,
                        tile_wh=TILE_WH, chunk=CHUNK, exact=exact,
                        capacity=cap)
    assert isinstance(tb["n_pairs"], torch.Tensor)
    assert int(tb["n_pairs"]) == demand and not bool(tb["overflow"])
    tt, jt = tb["table"].numpy(), np.asarray(jb["table"])
    assert tt.shape == (16, cap)
    rs, re_ = np.asarray(jb["range_start"]), np.asarray(jb["range_end"])
    np.testing.assert_array_equal(tb["range_start"].numpy(), rs)
    np.testing.assert_array_equal(tb["range_end"].numpy(), re_)
    n_kept = int(jb["n_pairs_kept"])
    assert int(tb["n_pairs_kept"]) == n_kept
    assert [tt[12, a:b].tolist() for a, b in zip(rs, re_)] == \
        [jt[12, a:b].tolist() for a, b in zip(rs, re_)]
    # the rows within tests/test_torch_binning.py's tolerances of JAX's
    if exact:
        np.testing.assert_allclose(tt[:13, :n_kept], jt[:13, :n_kept],
                                   rtol=1e-5, atol=0)
    else:
        for row in (6, 8, 9, 10, 12):
            np.testing.assert_array_equal(tt[row, :n_kept], jt[row, :n_kept])
        np.testing.assert_allclose(tt[11, :n_kept], jt[11, :n_kept],
                                   rtol=3e-7, atol=0)
        for row in range(6):
            scale = np.abs(jt[row, :n_kept]).max()
            np.testing.assert_allclose(tt[row, :n_kept], jt[row, :n_kept],
                                       rtol=1e-5, atol=1e-5 * scale)
    # and bit-equal to the table sized to the demand
    tight = tbin.bin_pairs(_tree(p, torch.from_numpy), image_wh=IMAGE_WH,
                           tile_wh=TILE_WH, chunk=CHUNK, exact=exact,
                           capacity=tbin.fit_capacity(demand, CHUNK))
    assert torch.equal(tight["table"][:, :n_kept], tb["table"][:, :n_kept])
    assert np.all(tt[5, n_kept:] == np.float32(-1e30))
    assert np.all(np.isneginf(tt[11, n_kept:]))


@pytest.mark.parametrize("cap", [1, 37, 256])
def test_expansion_past_the_capacity_keeps_the_front_most_pairs(cap):
    """Primitive-major slots: a capacity below the demand keeps the first
    `cap` pairs of the exact enumeration (the front-most splats' pairs),
    kills the rest, and flags the overflow."""
    rng = np.random.default_rng(5)
    n, ntx, nty = 300, 6, 4
    x0 = torch.from_numpy(rng.integers(0, ntx, n))
    y0 = torch.from_numpy(rng.integers(0, nty, n))
    nx = torch.from_numpy(rng.integers(0, 3, n) * (rng.random(n) > 0.2))
    count = nx * torch.from_numpy(rng.integers(1, 3, n))
    prim, tile, total, over = tbin._expand(
        x0, y0, nx, count, ntx=ntx, n_tiles=ntx * nty,
        capacity=int(count.sum()))
    assert prim.shape[0] == int(total) > 256 and not bool(over)
    p_c, t_c, tot_c, over_c = tbin._expand(x0, y0, nx, count, ntx=ntx,
                                           n_tiles=ntx * nty, capacity=cap)
    assert int(tot_c) == int(total) and bool(over_c)
    assert torch.equal(p_c, prim[:cap]) and torch.equal(t_c, tile[:cap])
    # and past the demand every slot is dead
    p_d, t_d, _, over_d = tbin._expand(x0, y0, nx, count, ntx=ntx,
                                       n_tiles=ntx * nty,
                                       capacity=int(total) + 50)
    assert not bool(over_d) and torch.equal(t_d[:int(total)], tile)
    assert bool((t_d[int(total):] == ntx * nty).all())


@pytest.mark.parametrize("capacity", [CHUNK, 256])
def test_an_empty_stream_bins_into_dead_slots(capacity):
    """A plan with no live draw projects no lane: the capacity's slots
    are all dead, the demand 0, every tile empty."""
    e = torch.zeros(0)
    p = dict(cx=e, cy=e, ext_x=e, ext_y=e, q=(e, e, e), color=(e,) * 4, z=e,
             valid=torch.zeros(0, dtype=torch.bool))
    b = tbin.bin_pairs(p, image_wh=IMAGE_WH, tile_wh=TILE_WH, chunk=CHUNK,
                       capacity=capacity, emit_block_demand=True)
    assert tuple(b["table"].shape) == (16, capacity)
    assert int(b["n_pairs"]) == 0 and not bool(b["overflow"])
    assert int(b["n_pairs_kept"]) == 0 and int(b["n_live"]) == 0
    assert not bool((b["range_end"] > b["range_start"]).any())
    assert b["block_demand"].shape == (0,)


@pytest.mark.parametrize("exact", [True, False])
def test_pipelined_frame_enters_no_wait_of_the_old_frame(exact):
    eng = _engine(exact)
    _move(eng, 2, n=2)
    hostprof.HOST_PROF.clear()
    pipeline.set_host_prof(True)
    try:
        eng.pipeline_depth = 2
        for _ in range(N):
            eng.camera.translate(STEP)
            assert eng.frame(readback=False) is not None
    finally:
        pipeline.set_host_prof(False)
    prof = dict(hostprof.HOST_PROF)
    hostprof.HOST_PROF.clear()
    eng.renderer.drain()
    eng.shutdown()
    for name in OLD_WAITS + ("sync.aux", "sync.readback"):
        assert name not in prof, (name, prof[name])
    # every frame launched its counts' copy and completed the frame two
    # behind it; each moved frame uploaded a new plan without a wait
    for name in ("render.uniforms", "render.aux", "render.drain",
                 "render.plan"):
        assert prof[name][0] == N, (name, prof.get(name))
