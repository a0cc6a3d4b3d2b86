"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode). This file imports nothing of JAX, so it also runs on a
GPU host without JAX:

    GSWT_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -q

(GSWT_TEST_TPU=1 keeps tests/conftest.py from importing jax.)
Tolerances: the block gather is bit-exact; the compositor within 1e-4 per
channel in its exact and its fast variant (the plain version walks a chunk's
pairs in the kernel's order, so T and the bf16-rounded weights agree and only
the FP32 order of the colour sums differs) and its saturation-slot record
EQUAL (integers + 0.5); the triangle raster's z
bit-equal and its attributes within 1e-5 relative (the kernel rounds every
multiply and add as the plain version does; only the order of a tie's sum
can differ); the bilinear sampler bit-equal (same operations, each rounded
on its own, in the same order); the mip sampler within 1e-6 (log2f against
torch.log2 in the level).

The triangle raster's card tests run its two kernels (the entries and the
fold) on adversarial triangles from tests/torch_tables.py, which imports no
jax either."""

import collections
import time

import numpy as np
import pytest
import torch

from gswt_renderer_tpu_torch.ops import binning, kernels, raster, texsample, trirast
from gswt_renderer_tpu_torch.ops.blockgather import block_gather, block_gather_plain
from torch_tables import fitted, opaque_splats

TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_stream_ptr_is_the_current_stream(cuda):
    """Every wrapper launches on PyTorch's current stream, a side stream
    included."""
    x = torch.zeros(4, device=cuda)
    assert kernels.stream_ptr(x) == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert kernels.stream_ptr(x) == side.cuda_stream
        got = block_gather(torch.ones((16, 512), device=cuda),
                           torch.zeros(3, dtype=torch.int32, device=cuda))
    side.synchronize()
    assert bool((got == 1.0).all())


def _payload_table(rng, n_blocks):
    t = rng.standard_normal((16, n_blocks * 256)).astype(np.float32)
    t[9:12] = rng.integers(0, 2**32, (3, n_blocks * 256),
                           dtype=np.uint64).astype(np.uint32).view(np.float32)
    special = np.array([0x7FC00001, 0x7F800001, 0xFFFFFFFF, 0x00000001],
                       np.uint32).view(np.float32)
    t[9:12, :4] = special
    return torch.from_numpy(t)


def test_block_gather_bit_exact(cuda):
    rng = np.random.default_rng(0)
    panels = _payload_table(rng, 40).to(cuda)
    scratch = _payload_table(rng, 9).to(cuda)
    src = torch.from_numpy(rng.integers(0, 49, 300).astype(np.int32)).to(cuda)
    before = kernels.LAUNCHES["block_gather"]
    got = block_gather(panels, src, scratch)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["block_gather"] == before + 1
    want = block_gather_plain(panels, src, scratch)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # a single source: the panel table alone
    assert torch.equal(block_gather(panels, src % 40).view(torch.int32),
                       block_gather_plain(panels, src % 40).view(torch.int32))


def test_block_gather_rejects_bad_inputs(cuda):
    panels = torch.zeros((16, 512), device=cuda)
    with pytest.raises(ValueError):
        block_gather(panels, torch.zeros(2, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        block_gather(panels.double(), torch.zeros(2, dtype=torch.int32,
                                                  device=cuda))


def _saturating_binned(chunk, rs0, alpha, device):
    """Two 64x32 tiles; tile 0's run starts off a chunk boundary and its
    max T falls just under MIN_T at the first global chunk boundary."""
    n_dom = 8 * chunk
    table = np.zeros((16, n_dom), np.float32)
    table[5] = -1e30
    table[11] = -np.inf
    rng = np.random.default_rng(5)
    rs, re_ = [], []
    for lo, hi, a in ((rs0, rs0 + 300, alpha), (rs0 + 300, rs0 + 600, 0.02)):
        m = hi - lo
        table[5, lo:hi] = 0.0
        table[6, lo:hi] = rng.uniform(0.0, 1.0, m)
        table[8:11, lo:hi] = rng.uniform(0.2, 1.0, (3, m))
        table[11, lo:hi] = np.log(a)
        rs.append(lo)
        re_.append(hi)
    return dict(table=torch.from_numpy(table).to(device),
                range_start=torch.tensor(rs, dtype=torch.int32, device=device),
                range_end=torch.tensor(re_, dtype=torch.int32, device=device))


@pytest.mark.parametrize("use_depth", [False, True])
def test_raster_early_exit_on_global_chunk_boundaries(cuda, use_depth):
    chunk, rs0 = 128, 100
    alpha = 1.0 - 1.5e-3 ** (1.0 / (chunk - rs0))
    b = _saturating_binned(chunk, rs0, alpha, cuda)
    rng = np.random.default_rng(8)
    depth = torch.from_numpy(
        rng.uniform(0.0, 1.0, (2, 64 * 32)).astype(np.float32)).to(cuda)
    kw = dict(image_wh=(128, 32), tile_wh=(64, 32), chunk=chunk,
              use_depth=use_depth)
    before = kernels.LAUNCHES["raster"]
    got = raster.rasterize(b, depth, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["raster"] == before + 1
    want = raster.rasterize_plain(b, depth, **kw)
    assert float((got - want).abs().max()) <= TOL
    if not use_depth:
        t_cut = (1.0 - alpha) ** (chunk - rs0)
        assert abs(float(got[0, 3].min()) - (1.0 - t_cut)) < 1e-5


@pytest.mark.parametrize("seed", [0, 1])
def test_raster_on_binned_random_splats(cuda, seed):
    image_wh, tile_wh, chunk = (256, 128), (64, 32), 256
    rng = np.random.default_rng(seed)
    n = 4000
    qa = rng.uniform(0.002, 0.1, n).astype(np.float32)
    qc = rng.uniform(0.002, 0.1, n).astype(np.float32)
    qb = (rng.uniform(-0.9, 0.9, n) * np.sqrt(qa * qc)).astype(np.float32)
    det = qa * qc - qb * qb
    col = rng.uniform(0.0, 1.0, (4, n)).astype(np.float32)
    p = dict(
        cx=rng.uniform(-30, 286, n), cy=rng.uniform(-30, 158, n),
        ext_x=np.sqrt(4.0 * qc / det), ext_y=np.sqrt(4.0 * qa / det),
        z=rng.uniform(0.0, 1.0, n), valid=rng.random(n) > 0.2)
    p = {k: torch.from_numpy(np.asarray(v, np.float32) if k != "valid" else v)
         .to(cuda) for k, v in p.items()}
    p["q"] = tuple(torch.from_numpy(x).to(cuda) for x in (qa, qb, qc))
    p["color"] = tuple(torch.from_numpy(x).to(cuda) for x in col)
    b = fitted(lambda cap: binning.bin_pairs(
        p, image_wh=image_wh, tile_wh=tile_wh, chunk=chunk, capacity=cap),
        lambda b: b["n_pairs"], chunk)
    depth = torch.rand((16, 64 * 32), device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(seed))
    for use_depth in (False, True):
        kw = dict(image_wh=image_wh, tile_wh=tile_wh, chunk=chunk,
                  use_depth=use_depth)
        got = raster.rasterize(b, depth, **kw)
        want = raster.rasterize_plain(b, depth, **kw)
        assert float((got - want).abs().max()) <= TOL
        assert float(got[:, 3].max()) > 0.5


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("seed", [2, 3])
def test_raster_zcut_variant_equals_plain(cuda, seed, exact):
    """emit_zcut: the kernel's record equals the plain version's, entry for
    entry, the colour stays within TOL, and emitting the record does not
    change the colour the kernel writes."""
    image_wh, tile_wh, chunk = (256, 128), (64, 32), 128
    p = opaque_splats(1024, seed, cuda)
    b = fitted(lambda cap: binning.bin_pairs(
        p, image_wh=image_wh, tile_wh=tile_wh, chunk=chunk, exact=exact,
        cull_exact=False, capacity=cap), lambda b: b["n_pairs"], chunk)
    depth = torch.ones((16, 64 * 32), device=cuda)
    kw = dict(image_wh=image_wh, tile_wh=tile_wh, chunk=chunk,
              use_depth=False, exact=exact)
    before = kernels.LAUNCHES["raster"]
    got, zcut = raster.rasterize(b, depth, emit_zcut=True, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["raster"] == before + 1
    want, zwant = raster.rasterize_plain(b, depth, emit_zcut=True, **kw)
    assert tuple(zcut.shape) == (16, raster.SAT_BANDS)
    assert torch.equal(zcut, zwant)
    assert int((zcut < raster.SAT_NOCUT).sum()) >= 4
    assert float((got - want).abs().max()) <= TOL
    assert torch.equal(got, raster.rasterize(b, depth, **kw))


def test_raster_zcut_folds_remainder_rows_and_marks_empty_tiles(cuda):
    """A tile height not divisible by SAT_BANDS folds its last rows into the
    last band; a tile without pairs is all SAT_NOCUT."""
    b = _saturating_binned(128, 0, 0.9, cuda)
    b["table"][12] = torch.arange(b["table"].shape[1], device=cuda)
    b["range_start"] = torch.tensor([0, 300, 0], dtype=torch.int32,
                                    device=cuda)
    b["range_end"] = torch.tensor([300, 600, 0], dtype=torch.int32,
                                  device=cuda)
    kw = dict(image_wh=(192, 30), tile_wh=(64, 30), chunk=128,
              use_depth=False)
    depth = torch.ones((3, 64 * 30), device=cuda)
    got, zcut = raster.rasterize(b, depth, emit_zcut=True, **kw)
    want, zwant = raster.rasterize_plain(b, depth, emit_zcut=True, **kw)
    assert torch.equal(zcut, zwant)
    assert float((got - want).abs().max()) <= TOL
    assert bool((zcut[0] < raster.SAT_NOCUT).all()), "tile 0 saturates"
    assert bool((zcut[1:] == raster.SAT_NOCUT).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_raster_fast_variant_matches_plain(cuda, seed):
    """exact=False on the fast profile's own table: weights and colours
    rounded to bf16 before the f32 accumulate, in the kernel as in the plain
    version, within TOL; and the rounding is really there (the variant
    differs from the exact one by up to a bf16 step)."""
    image_wh, tile_wh, chunk = (256, 128), (64, 32), 256
    p = opaque_splats(3000, seed, cuda)
    p["color"] = p["color"][:3] + (p["color"][3] * 0.4,)
    b = fitted(lambda cap: binning.bin_pairs(
        p, image_wh=image_wh, tile_wh=tile_wh, chunk=chunk, exact=False,
        capacity=cap), lambda b: b["n_pairs"], chunk)
    depth = 0.1 + 0.8 * torch.rand(
        (16, 64 * 32), device=cuda,
        generator=torch.Generator(device=cuda).manual_seed(seed))
    for use_depth in (False, True):
        kw = dict(image_wh=image_wh, tile_wh=tile_wh, chunk=chunk,
                  use_depth=use_depth)
        got = raster.rasterize(b, depth, exact=False, **kw)
        want = raster.rasterize_plain(b, depth, exact=False, **kw)
        assert float((got - want).abs().max()) <= TOL
        assert float(got[:, 3].max()) > 0.5
        step = float((got - raster.rasterize(b, depth, **kw)).abs().max())
        assert 1e-5 < step <= 2.0 ** -8


@pytest.mark.parametrize("sat_cull", [False, True])
def test_fast_renderer_frames_match_cpu_path(cuda, sat_cull):
    """The default (fast) profile on the card against the CPU path, gs-only
    and with skybox + proxy (half-res proxy through the pyramid sampler
    kernel), over three frames at a fixed camera; with sat_cull the carried
    saturation-slot image must be the CPU path's. Budget: the exact
    profile's (mean < 1e-4, at most 5e-4 of the pixels over 1e-3) gs-only;
    with the proxy, at most 0.2% of the pixels, for an edge pixel of the
    half-res triangle raster that falls to the other side on one ulp and
    covers four pixels of the frame."""
    from gswt_renderer_tpu_torch.core import Camera, UserData
    from gswt_renderer_tpu_torch.core.config import RenderConfig, SurfaceType
    from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec
    from gswt_renderer_tpu_torch.render.pipeline import Renderer, RendererConfig
    from gswt_renderer_tpu_torch.render.uniforms import SceneParams
    from gswt_renderer_tpu_torch.tiles import WangTileEngine

    wang = WangTileEngine(synthetic_scene_vec(n_lod=2, splats_per_tile=256))
    ud = UserData.from_ui(tile_map_half_wh=(2, 2), height_map_scale=(1.0, 0.3),
                          height_map_wh=(8, 8), lod_max_dist=8.0,
                          surface_type=SurfaceType.HEIGHT_MAP)
    wang.configure(ud)
    cam_pos = np.array([0.0, -4.0, 2.5], np.float32)
    wang.build_tiles(cam_pos)
    camera = Camera((128, 128), cam_pos, (0.0, 2.0, 0.0), (0.0, 0.0, 1.0),
                    np.deg2rad(45.0), 0.1, 200.0)
    dt = wang.sort_tiles(cam_pos, camera.view_proj())
    rc = RenderConfig.new(wang.n_tiles[0])
    sp = SceneParams.from_data(ud, wang.center_coord, rc)
    sky = np.linspace(0, 2, 16, dtype=np.float32)[:, None, None] * np.ones(
        (16, 32, 3), np.float32)
    checker = np.kron(np.indices((8, 8)).sum(0) % 2,
                      np.ones((4, 4))).astype(np.float32)
    tex = np.stack([checker * 0.8 + 0.1, checker * 0.5 + 0.2,
                    checker * 0.3 + 0.1], axis=-1)
    for full in (False, True):
        rs = []
        for device in (cuda, "cpu"):
            r = Renderer(wang, RendererConfig(
                width=128, height=128, max_draws=128, max_stream=1 << 15,
                chunk=128, tile_w=32, tile_h=32, sat_cull=sat_cull),
                device=device)
            assert r.cfg.exact is False
            r.configure(ud)
            r.set_skybox(sky)
            r.set_proxy(tex)
            rs.append(r)
        before = dict(kernels.LAUNCHES)
        for _ in range(3):
            gpu, cpu = (r.render(dt, camera, sp, rc, use_skybox=full,
                                 use_proxy=full) for r in rs)
        diff = np.abs(gpu - cpu).max(axis=-1)
        assert diff.mean() < 1e-4
        assert np.mean(diff > 1e-3) <= (2e-3 if full else 5e-4)
        assert kernels.LAUNCHES["raster"] == before.get("raster", 0) + 3
        if full:
            assert (kernels.LAUNCHES["mip_trilinear"]
                    == before.get("mip_trilinear", 0) + 3)
        if sat_cull:
            assert torch.equal(rs[0].sat_zimg.cpu(), rs[1].sat_zimg)
            assert int((rs[1].sat_zimg < raster.SAT_NOCUT).sum()) > 0
        else:
            assert rs[0].sat_zimg is None


def test_renderer_frame_matches_cpu_path(cuda):
    from gswt_renderer_tpu_torch.core import Camera, UserData
    from gswt_renderer_tpu_torch.core.config import RenderConfig, SurfaceType
    from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec
    from gswt_renderer_tpu_torch.render.pipeline import Renderer, RendererConfig
    from gswt_renderer_tpu_torch.render.uniforms import SceneParams
    from gswt_renderer_tpu_torch.tiles import WangTileEngine

    wang = WangTileEngine(synthetic_scene_vec(n_lod=2, splats_per_tile=96))
    ud = UserData.from_ui(tile_map_half_wh=(2, 2), height_map_scale=(1.0, 0.3),
                          height_map_wh=(8, 8), lod_max_dist=8.0,
                          surface_type=SurfaceType.HEIGHT_MAP)
    wang.configure(ud)
    cam_pos = np.array([1.0, -5.0, 3.0], np.float32)
    wang.build_tiles(cam_pos)
    camera = Camera((128, 128), cam_pos, (1.0, 0.0, 0.5), (0.0, 1.0, 0.0),
                    np.deg2rad(60.0), 0.1, 200.0)
    dt = wang.sort_tiles(cam_pos, camera.view_proj())
    rc = RenderConfig.new(wang.n_tiles[0])
    sp = SceneParams.from_data(ud, wang.center_coord, rc)
    imgs = []
    for device in (cuda, "cpu"):
        r = Renderer(wang, RendererConfig(width=128, height=128, max_draws=128,
                                          max_stream=1 << 15, chunk=128,
                                          exact=True),
                     device=device)
        r.configure(ud)
        imgs.append(r.render(dt, camera, sp, rc))
    diff = np.abs(imgs[0] - imgs[1]).max(axis=-1)
    assert diff.mean() < 1e-4 and np.mean(diff > 1e-3) <= 5e-4


# the oracle on the card against its own CPU run: the card's float32 exp,
# sin and cos, and PyTorch's division by a host number (its reciprocal times
# the tensor on the card), differ from the CPU's by an ulp; the sphere's
# tangent frame amplifies sin/cos as in tests/test_torch_oracle.py. A pixel
# at a splat's A = -4 discard edge may fall to the other side on such an
# ulp and move by up to exp(-4) times the splat's alpha: at most
# ORACLE_CARD_EDGE of the pixels may lie past the tolerance, none past
# exp(-4) (on an H100 the sphere frame had 4 of 9216 pixels past 1e-4, the
# largest at 7.4e-3, with every splat's validity and depth the CPU's).
ORACLE_CARD_TOL = {"flat": 1e-5, "heightmap": 1e-5, "sphere": 5e-5}
ORACLE_CARD_EDGE = 2e-3


@pytest.mark.parametrize("surface", sorted(ORACLE_CARD_TOL))
def test_oracle_on_the_card_matches_its_cpu_run(cuda, surface):
    from gswt_renderer_tpu_torch.core import Camera, UserData
    from gswt_renderer_tpu_torch.core.config import RenderConfig, SurfaceType
    from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec
    from gswt_renderer_tpu_torch.refrender import assemble_stream, render_oracle
    from gswt_renderer_tpu_torch.render.uniforms import build_frame_inputs
    from gswt_renderer_tpu_torch.tiles import WangTileEngine

    ui = dict(tile_map_half_wh=(2, 2), lod_max_dist=8.0)
    cam, target, up = (2.0, 2.0, 6.0), (2.0, 2.0, 0.0), (0.0, 1.0, 0.0)
    if surface == "heightmap":
        ui.update(height_map_scale=(1.0, 0.3), height_map_wh=(8, 8),
                  surface_type=SurfaceType.HEIGHT_MAP)
        cam, target = (1.0, -5.0, 3.0), (1.0, 0.0, 0.5)
    elif surface == "sphere":
        ui.update(tile_map_half_wh=(5, 2), surface_type=SurfaceType.SPHERE,
                  sphere_radius=15.0, lod_max_dist=30.0)
        cam, target, up = (30.0, 0.0, 8.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0)
    wang = WangTileEngine(synthetic_scene_vec(n_lod=2, splats_per_tile=64))
    wang.configure(UserData.from_ui(**ui))
    cam_pos = np.asarray(cam, np.float32)
    wang.build_tiles(cam_pos)
    camera = Camera((96, 96), cam_pos, target, up, np.deg2rad(60.0), 0.1,
                    200.0)
    dt = wang.sort_tiles(cam_pos, camera.view_proj())
    fi = build_frame_inputs(wang, dt, camera, RenderConfig.new(wang.n_tiles[0]))
    for k, v in assemble_stream(fi, cuda).items():
        assert torch.equal(v.cpu(), assemble_stream(fi, "cpu")[k]), k
    img = render_oracle(fi, 96, 96, device=cuda)
    assert img.is_cuda
    ref = render_oracle(fi, 96, 96, device="cpu")
    assert float(ref[..., 3].max()) > 0.2
    err = (img.cpu() - ref).abs().amax(dim=-1)
    assert float(err.max()) <= np.exp(-4.0), float(err.max())
    share = float((err > ORACLE_CARD_TOL[surface]).float().mean())
    assert share <= ORACLE_CARD_EDGE, share


# ---------------------------------------------------------------------- #
# the samplers and the triangle raster
# ---------------------------------------------------------------------- #
SAMPLER_TOL = 1e-6


@pytest.mark.parametrize("wrap_x", [False, True])
@pytest.mark.parametrize("wrap_y", [False, True])
@pytest.mark.parametrize("shape,p", [((3, 12, 20), 5000),
                                     ((3, 64, 128), 1920 * 1080),
                                     ((3, 700, 1400), 50000)])
def test_bilinear_kernel_matches_plain(cuda, wrap_x, wrap_y, shape, p):
    """Bit-equal to the plain version, so a contracted multiply-add in the
    kernel fails. The first samples sit on texel centres, half texels, the
    edges, and past the range of an int32."""
    rng = np.random.default_rng(0)
    tex = torch.from_numpy(rng.uniform(0, 4, shape).astype(np.float32)).to(cuda)
    _, ht, wt = shape
    x = rng.uniform(-2.0 * wt, 3.0 * wt, p).astype(np.float32)
    y = rng.uniform(-2.0 * ht, 3.0 * ht, p).astype(np.float32)
    x[:8] = [0.0, -0.5, wt - 1.0, wt - 0.5, wt, -wt, 3e9, -3e9]
    y[:8] = [0.0, -0.5, ht - 1.0, ht - 0.5, ht, -ht, -3e9, 3e9]
    x, y = torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)
    before = kernels.LAUNCHES["bilinear"]
    got = texsample.factored_bilinear(tex, x, y, wrap_x=wrap_x, wrap_y=wrap_y)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bilinear"] == before + 1
    want = texsample.factored_bilinear_plain(tex, x, y, wrap_x=wrap_x,
                                             wrap_y=wrap_y)
    assert got.shape == want.shape == (3, p)
    assert torch.equal(got, want)


def test_equirect_over_the_small_texture_limit_takes_the_kernel(cuda):
    """The card samples an equirect of any size through the bilinear kernel;
    the result agrees with the CPU path's four indexed taps to the last
    ulps of a value up to 4."""
    from gswt_renderer_tpu_torch.ops import skybox

    rng = np.random.default_rng(4)
    tex = torch.from_numpy(
        rng.uniform(0.5, 4.0, (600, 1200, 3)).astype(np.float32))
    assert not texsample.factored_fits((3, 600, 1200))
    d = torch.from_numpy(rng.normal(size=(4000, 3)).astype(np.float32))
    before = kernels.LAUNCHES["bilinear"]
    got = skybox._sample_equirect(tex.to(cuda), d.to(cuda))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bilinear"] == before + 1
    want = skybox._sample_equirect(tex, d)
    # atan2/asin differ in the last ulp between the card and the CPU, times
    # the texture width in texels, times a texel-to-texel step of up to 3.5
    assert float((got.cpu() - want).abs().max()) <= 1e-3
    assert float((got.cpu() - want).abs().mean()) <= 1e-5


def test_bilinear_kernel_rejects_bad_inputs(cuda):
    tex = torch.zeros((3, 4, 4), device=cuda)
    x = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError):
        texsample.factored_bilinear(tex.double(), x, x, wrap_x=True, wrap_y=True)
    with pytest.raises(ValueError):
        texsample.factored_bilinear(tex, x, x[:4], wrap_x=True, wrap_y=True)
    with pytest.raises(ValueError):
        texsample.factored_bilinear(tex, x.cpu(), x, wrap_x=True, wrap_y=True)


def _pyramid(size, seed, device):
    """A size x size (or size = (w, h)) chain packed: (planes, meta, l_min,
    number of levels)."""
    from gswt_renderer_tpu_torch.io.textures import build_mip_chain

    w, h = (size, size) if isinstance(size, int) else size
    rng = np.random.default_rng(seed)
    mips = build_mip_chain(rng.uniform(size=(h, w, 3)).astype(np.float32))
    planes, meta, l_min = texsample.pack_pyramid(mips)
    return (torch.from_numpy(planes).to(device).to(torch.bfloat16), meta,
            l_min, len(mips))


@pytest.mark.parametrize("size,p", [(64, 20000), (512, 1920 * 1080)])
def test_mip_trilinear_kernel_matches_plain(cuda, size, p):
    """Every level band, the l_min clamp (512 -> level 2), and the
    coinciding-tap cases: rho far past the coarsest level (l0 == l1, whose
    1x1 level has x0 == x1 and y0 == y1) in the first samples."""
    planes, meta, l_min, n_lv = _pyramid(size, 1, cuda)
    rng = np.random.default_rng(2)
    u = torch.from_numpy(rng.uniform(-3, 4, p).astype(np.float32)).to(cuda)
    v = torch.from_numpy(rng.uniform(-3, 4, p).astype(np.float32)).to(cuda)
    rho = (2.0 ** rng.uniform(-2.0, n_lv + 2.0, p)).astype(np.float32)
    rho[:64] = 1e7
    rho[64:128] = float(2 ** (n_lv - 2))  # exactly the 2x2 level: frac = 0
    rho = torch.from_numpy(rho).to(cuda)
    before = kernels.LAUNCHES["mip_trilinear"]
    got = texsample.factored_mip_trilinear(
        texsample.sampler_pyramid(planes), meta, l_min, u, v, rho, n_ch=3)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mip_trilinear"] == before + 1
    want = texsample.factored_mip_trilinear_plain(planes, meta, l_min, u, v,
                                                  rho)
    assert float((got - want).abs().max()) <= SAMPLER_TOL
    texel = planes[:, meta[-1][2], meta[-1][3]].to(torch.float32) / 255.0
    assert float((got[:, :64] - texel[:, None]).abs().max()) <= 1e-6


@pytest.mark.parametrize("wh", [(64, 64), (128, 8), (512, 512)])
def test_mip_trilinear_kernel_on_interleaved_texels(cuda, wh):
    """The interleaved texels through the kernel: negative and very large
    uv (the integer wrap below 2^24, the float one above), 1-wide levels of
    a non-square chain, l0 == l1, the l_min clamp of a 512 chain, against
    the plain spec and the texel plain form; one launch per call."""
    planes, meta, l_min, n_lv = _pyramid(wh, 3, cuda)
    texels = texsample.interleave_pyramid(planes)
    assert texels.shape == planes.shape[1:] + (4,)
    rng = np.random.default_rng(5)
    p = 30000
    u = rng.uniform(-3, 4, p).astype(np.float32)
    v = rng.uniform(-3, 4, p).astype(np.float32)
    u[:3000] *= -1e4
    v[3000:6000] *= 1e5
    u[6000:9000] = rng.uniform(-1e9, 1e9, 3000)
    rho = (2.0 ** rng.uniform(-3.0, n_lv + 2.0, p)).astype(np.float32)
    rho[9000:9500] = 1e7                 # l0 == l1
    t = lambda a: torch.from_numpy(a).to(cuda)
    args = (meta, l_min, t(u), t(v), t(rho))
    before = kernels.LAUNCHES["mip_trilinear"]
    assert torch.equal(texsample.sampler_pyramid(planes), texels)
    got = texsample.factored_mip_trilinear(texels, *args, n_ch=3)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mip_trilinear"] == before + 1
    finite = slice(0, 6000)   # the plain version indexes raw taps: keep
    want = texsample.factored_mip_trilinear_plain(   # it to finite wraps
        planes, *(a[finite] if torch.is_tensor(a) else a for a in args))
    assert float((got[:, finite] - want).abs().max()) <= SAMPLER_TOL
    rest = slice(9000, p)
    want = texsample.factored_mip_trilinear_plain(
        planes, *(a[rest] if torch.is_tensor(a) else a for a in args))
    assert float((got[:, rest] - want).abs().max()) <= SAMPLER_TOL
    tex_form = texsample.factored_mip_trilinear_texels_plain(
        texels, 3, *(a[rest] if torch.is_tensor(a) else a for a in args))
    assert torch.equal(tex_form, want)
    # astronomically large uv: finite, in range, no fault
    assert bool(torch.isfinite(got).all())
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


def test_mip_trilinear_rejects_bad_texels(cuda):
    """On the card the sampler takes the interleaved texels alone, with
    their channel count: the planes, another dtype or width, a strided
    view, a missing or impossible n_ch and unequal sample counts raise."""
    planes, meta, l_min, _ = _pyramid(64, 1, cuda)
    texels = texsample.interleave_pyramid(planes)
    u = torch.zeros(10, device=cuda)
    for bad in (planes, texels.float(), texels[..., :3].contiguous(),
                texels.transpose(0, 1)):
        with pytest.raises(ValueError):
            texsample.factored_mip_trilinear(bad, meta, l_min, u, u, u + 1,
                                             n_ch=3)
    for n_ch in (None, 0, 5):
        with pytest.raises(ValueError):
            texsample.factored_mip_trilinear(texels, meta, l_min, u, u,
                                             u + 1, n_ch=n_ch)
    with pytest.raises(ValueError):
        texsample.factored_mip_trilinear(texels, meta, l_min, u, u[:5], u,
                                         n_ch=3)


def _tri_rows(xs, ys, zs, attrs, device, image_wh, tile_wh):
    n = xs.shape[1]
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    planes, ok, bbox = trirast.triangle_planes(
        t(xs), t(ys), t(zs), torch.ones((3, n), device=device), t(attrs),
        torch.ones(n, dtype=torch.bool, device=device))
    return fitted(lambda cap: trirast.bin_triangles(
        planes, bbox, ok, image_wh=image_wh, tile_wh=tile_wh, capacity=cap),
        lambda out: out[3])


def _assert_trirast_equal(rows, rs, re_, image_wh, tile_wh, chunk=128):
    kw = dict(image_wh=image_wh, tile_wh=tile_wh, chunk=chunk)
    before = dict(kernels.LAUNCHES)
    got = trirast.rasterize_pair_rows(rows, rs, re_, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["trirast"] == before.get("trirast", 0) + 1
    assert (kernels.LAUNCHES["trirast_fold"]
            == before.get("trirast_fold", 0) + 1)
    want = trirast.rasterize_triangles_plain(rows, rs, re_, **kw)
    assert torch.equal(got[:, 0], want[:, 0]), "z must be bit-equal"
    err = (got[:, 1:] - want[:, 1:]).abs()
    assert bool((err <= 1e-5 * want[:, 1:].abs() + 1e-7).all())
    return got


@pytest.mark.parametrize("n,image_wh", [(300, (128, 96)), (3000, (1920, 1080))])
def test_trirast_kernel_matches_plain(cuda, n, image_wh):
    rng = np.random.default_rng(3)
    w, h = image_wh
    cx = rng.uniform(0, w, n)
    cy = rng.uniform(0, h, n)
    xs = (cx + rng.uniform(-60, 60, (3, n))).astype(np.float32)
    ys = (cy + rng.uniform(-40, 40, (3, n))).astype(np.float32)
    zs = rng.uniform(-0.1, 1.1, (3, n)).astype(np.float32)
    attrs = rng.uniform(-1, 1, (3, 3, n)).astype(np.float32)
    rows, rs, re_, total = _tri_rows(xs, ys, zs, attrs, cuda, image_wh, (64, 32))
    assert total > n
    got = _assert_trirast_equal(rows, rs, re_, image_wh, (64, 32))
    assert float((got[:, 0] < 1.0).float().mean()) > 0.2


def test_trirast_kernel_on_pixel_centre_edges_and_ties(cuda):
    """The FMA-sensitive case: a fan of triangles whose shared edges pass
    exactly through pixel centres (vertices at half-integer coordinates), so
    barycentrics are exactly 0 along them and a contracted a*px + b*py + c
    would move those pixels between triangles or into a hole; and coincident
    triangles across a chunk boundary (the tie rule)."""
    image_wh, tile_wh = (128, 64), (64, 32)
    hub = (40.5, 20.5)
    rim = [(8.5, 4.5), (72.5, 4.5), (100.5, 20.5), (72.5, 52.5), (8.5, 52.5),
           (0.5, 20.5)]
    tris = [(hub, rim[i], rim[(i + 1) % 6]) for i in range(6)]
    tris = tris * 30  # 180 coincident copies: runs cross the 128-pair chunk
    xs = np.array([[t[k][0] for t in tris] for k in range(3)], np.float32)
    ys = np.array([[t[k][1] for t in tris] for k in range(3)], np.float32)
    zs = np.full((3, len(tris)), 0.5, np.float32)
    attrs = np.zeros((3, 3, len(tris)), np.float32)
    attrs[0] = np.arange(len(tris), dtype=np.float32)[None, :]
    rows, rs, re_, _ = _tri_rows(xs, ys, zs, attrs, cuda, image_wh, tile_wh)
    assert int((re_ - rs).max()) > 128
    got = _assert_trirast_equal(rows, rs, re_, image_wh, tile_wh)
    z, _ = trirast.tiles_to_maps(got, image_wh=image_wh, tile_wh=tile_wh)
    # no hole inside the fan: the hexagon's interior rows are fully covered
    assert bool((z[21, 1:100] < 1.0).all())


@pytest.mark.parametrize("chunk", [32, 128])
@pytest.mark.parametrize("seed", [0, 1])
def test_trirast_kernel_on_adversarial_triangles(cuda, seed, chunk):
    """Slivers, vertices 1e4 px off-screen, edges through pixel centres,
    near- and far-plane crossings, ties within and across chunk
    boundaries, runs starting mid-chunk, empty tiles (tests/torch_tables.py
    adversarial_triangles): z and the hit mask bit-equal to the plain spec,
    attributes within 1e-5 relative."""
    from torch_tables import adversarial_triangles, binned_triangles

    rows, rs, re_, _ = binned_triangles(adversarial_triangles(seed),
                                        device=cuda)
    assert int(((re_ - rs) == 0).sum()) >= 6   # the empty bottom row
    got = _assert_trirast_equal(rows, rs, re_, (384, 256), (64, 32), chunk)
    assert bool((got[-6:, 0] == 1.0).all()) and not got[-6:, 1:].any()
    # the kernels' split, emulated on the card by the plain split
    split = trirast.rasterize_split_plain(rows, rs, re_, image_wh=(384, 256),
                                          tile_wh=(64, 32), chunk=chunk)
    assert torch.equal(got[:, 0], split[:, 0])


@pytest.mark.parametrize("tile_wh", [(64, 32), (100, 20)])
def test_trirast_single_tile_of_five_chunks(cuda, tile_wh):
    """One tile whose run starts mid-chunk and spans 5 chunks of 128 (the
    other tiles empty), coincident copies tying across every boundary and a
    nearer triangle in the fourth chunk; the block layout (64x32) and the
    flat one (100x20)."""
    rng = np.random.default_rng(4)
    n = 560
    tw, th = tile_wh
    xs = np.tile(np.array([[2.5], [tw - 3.5], [2.5]], np.float32), (1, n))
    ys = np.tile(np.array([[1.5], [1.5], [th - 2.5]], np.float32), (1, n))
    xs = xs + rng.uniform(0, 2, (1, n)).astype(np.float32) * (np.arange(n) % 3 == 0)
    zs = np.full((3, n), 0.5, np.float32)
    zs[:, 420:430] = 0.25
    attrs = rng.uniform(-1, 1, (3, 3, n)).astype(np.float32)
    rows, rs, re_, total = _tri_rows(xs, ys, zs, attrs, cuda,
                                     (2 * tw, th), tile_wh)
    assert total == n
    # move the run to start 40 pairs into a chunk: 40 dead columns first
    rows = torch.cat([torch.zeros((24, 40), device=cuda), rows], 1)
    rows = rows.contiguous()
    live = (re_ > rs).int()
    rs, re_ = (rs + 40 * live).int(), (re_ + 40 * live).int()
    assert int((re_ - rs).max()) == n and int(rs.max()) == 40
    c0, c1 = 40 // 128, (40 + n - 1) // 128
    assert c1 - c0 + 1 == 5
    got = _assert_trirast_equal(rows, rs, re_, (2 * tw, th), tile_wh)
    assert bool((got[1, 0] == 1.0).all())
    assert float((got[0, 0] < 1.0).float().mean()) > 0.3


def test_full_config_frame_matches_cpu_path(cuda):
    from gswt_renderer_tpu_torch.core import Camera, UserData
    from gswt_renderer_tpu_torch.core.config import RenderConfig, SurfaceType
    from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec
    from gswt_renderer_tpu_torch.render.pipeline import Renderer, RendererConfig
    from gswt_renderer_tpu_torch.render.uniforms import SceneParams
    from gswt_renderer_tpu_torch.tiles import WangTileEngine

    wang = WangTileEngine(synthetic_scene_vec(n_lod=2, splats_per_tile=96))
    ud = UserData.from_ui(tile_map_half_wh=(2, 2), height_map_scale=(1.0, 0.3),
                          height_map_wh=(8, 8), lod_max_dist=8.0,
                          surface_type=SurfaceType.HEIGHT_MAP)
    wang.configure(ud)
    cam_pos = np.array([1.0, -5.0, 3.0], np.float32)
    wang.build_tiles(cam_pos)
    camera = Camera((128, 128), cam_pos, (1.0, 0.0, 0.5), (0.0, 1.0, 0.0),
                    np.deg2rad(60.0), 0.1, 200.0)
    dt = wang.sort_tiles(cam_pos, camera.view_proj())
    rc = RenderConfig.new(wang.n_tiles[0])
    sp = SceneParams.from_data(ud, wang.center_coord, rc)
    sky = np.linspace(0, 4, 16 * 32 * 3, dtype=np.float32).reshape(16, 32, 3)
    tex = np.random.default_rng(0).uniform(size=(32, 32, 3)).astype(np.float32)
    imgs = []
    for device in (cuda, "cpu"):
        r = Renderer(wang, RendererConfig(width=128, height=128, max_draws=128,
                                          max_stream=1 << 15, chunk=128,
                                          depth_cull=True, exact=True),
                     device=device)
        r.configure(ud)
        r.set_skybox(sky)
        r.set_proxy(tex)
        imgs.append(r.render(dt, camera, sp, rc, use_skybox=True,
                             use_proxy=True))
    diff = np.abs(imgs[0] - imgs[1]).max(axis=-1)
    assert diff.mean() < 1e-4 and np.mean(diff > 1e-3) <= 5e-4
    assert np.abs(imgs[0][..., 3] - 1.0).max() < 1e-5


# ---------------------------------------------------------------------- #
# the benchmarks sub-package's kernels: sorted merge, micro-raster
# variants, micro block gathers. Merge and gathers move raw words: bit-equal.
# Micro-raster: 1e-4 per channel in every variant, as the compositor (its
# plain version walks a chunk's pairs in the kernel's order and evaluates
# the exponent with the same roundings, so T, the cutoff and the bf16
# rounding of the weights decide alike).
# ---------------------------------------------------------------------- #
def _merge_table(keys, rows=4):
    k = np.asarray(keys, np.int32)
    t = [k.view(np.float32)]
    for r in range(rows - 1):
        t.append((k.astype(np.float64) * (r + 0.5)).astype(np.float32))
    t = np.stack(t)
    # NaN and denormal patterns in the last payload row
    t[-1, ::7] = np.array([0x7FC00001], np.uint32).view(np.float32)[0]
    t[-1, 3::11] = np.array([0x00000001], np.uint32).view(np.float32)[0]
    return torch.from_numpy(t)


def _merge_cases():
    rng = np.random.default_rng(4)
    keys = (rng.choice(np.int64(1) << 31, size=9000, replace=False)
            - (np.int64(1) << 30)).astype(np.int32)
    n = 3000
    return {
        "random": (np.sort(keys[:5000]), np.sort(keys[5000:])),
        "uneven": (np.sort(keys[:64]), np.sort(keys[64:])),
        "a_below_b": (np.arange(n, dtype=np.int32) - 5000,
                      np.arange(n, dtype=np.int32) + 7),
        "b_below_a": (np.arange(n, dtype=np.int32) + 7,
                      np.arange(n, dtype=np.int32) - 5000),
        "interleaved": (np.arange(0, 2 * n, 2, dtype=np.int32),
                        np.arange(1, 2 * n, 2, dtype=np.int32)),
        "empty_b": (np.sort(keys[:700]), keys[:0]),
    }


@pytest.mark.parametrize("block", [2048, 512, 96])
@pytest.mark.parametrize("case", ["random", "uneven", "a_below_b",
                                  "b_below_a", "interleaved", "empty_b"])
def test_merge_sorted_pair_kernel_bit_equal(cuda, case, block):
    from gswt_renderer_tpu_torch.benchmarks import mergesorted as ms

    a, b = _merge_cases()[case]
    ta, tb = _merge_table(a).to(cuda), _merge_table(b).to(cuda)
    before = kernels.LAUNCHES["merge_sorted_pair"]
    got = ms.merge_sorted_pair(ta, tb, block=block)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["merge_sorted_pair"] == before + 1
    want = ms.merge_sorted_pair_plain(ta, tb, block=block)
    assert got.shape == want.shape and got.shape[1] % block == 0
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    n = a.size + b.size
    merged = np.sort(np.concatenate([a, b]))
    assert np.array_equal(got[0, :n].view(torch.int32).cpu().numpy(), merged)
    tail = got[:, n:].view(torch.int32)
    assert bool((tail[0] == ms.SENTINEL).all()) and not bool(tail[1:].any())
    # the split kernel against its plain version, one boundary past the end
    n_b = got.shape[1] // block + 1
    ka, kb = ta[0].view(torch.int32), tb[0].view(torch.int32)
    assert torch.equal(
        ms.merge_path_splits(ka, kb, block=block, n_blocks=n_b),
        ms.merge_path_splits_plain(ka, kb, block=block, n_blocks=n_b))


def test_merge_sorted_tournament_kernel(cuda):
    from gswt_renderer_tpu_torch.benchmarks import mergesorted as ms

    rng = np.random.default_rng(6)
    keys = rng.choice(np.int64(1) << 30, size=50000, replace=False)
    parts = [np.sort(p) for p in np.array_split(keys.astype(np.int32), 5)]
    tabs = [_merge_table(p, rows=7).to(cuda) for p in parts]
    before = kernels.LAUNCHES["merge_sorted_pair"]
    got = ms.merge_sorted(tabs, block=2048)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["merge_sorted_pair"] == before + 4
    want = ms.merge_sorted([t.cpu() for t in tabs], block=2048)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    with pytest.raises(ValueError):
        ms.merge_sorted_pair(tabs[0], tabs[1], block=ms.MAX_BLOCK + 1)
    with pytest.raises(ValueError):
        ms.merge_sorted_pair(tabs[0], tabs[1].double())


@pytest.mark.parametrize("k,nb", [(11, 300), (16, 17), (3, 1)])
def test_micro_strided_gather_bit_exact(cuda, k, nb):
    from gswt_renderer_tpu_torch.benchmarks import micro_blockgather as bg

    rng = np.random.default_rng(k)
    table = _payload_table(rng, 40)[:k].contiguous().to(cuda)
    src = torch.from_numpy(rng.integers(0, 40, nb).astype(np.int32)).to(cuda)
    before = kernels.LAUNCHES["micro_blockgather_strided"]
    got = bg.gather_strided(table, src)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["micro_blockgather_strided"] == before + 1
    assert torch.equal(got.view(torch.int32),
                       bg.gather_strided_plain(table, src).view(torch.int32))
    with pytest.raises(ValueError):
        bg.gather_strided(table, src.long())


@pytest.mark.parametrize("group,nb", [(8, 64), (8, 61), (1, 9), (5, 3)])
def test_micro_contig_gather_bit_exact(cuda, group, nb):
    """`group` need not divide the panel count: the last CTA walks fewer."""
    from gswt_renderer_tpu_torch.benchmarks import micro_blockgather as bg

    rng = np.random.default_rng(group * 100 + nb)
    table = _payload_table(rng, 30).reshape(16, 30, 256).permute(1, 0, 2)
    table = table.contiguous().to(cuda)
    src = torch.from_numpy(rng.integers(0, 30, nb).astype(np.int32)).to(cuda)
    before = kernels.LAUNCHES["micro_blockgather_contig"]
    got = bg.gather_contig(table, src, group=group)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["micro_blockgather_contig"] == before + 1
    assert torch.equal(got.view(torch.int32),
                       bg.gather_contig_plain(table, src).view(torch.int32))


@pytest.mark.parametrize("name", ["A", "B", "C", "C2", "D"])
@pytest.mark.parametrize("size", ["small", "tiles_2048px"])
def test_micro_raster_variant_matches_plain(cuda, name, size):
    from gswt_renderer_tpu_torch.benchmarks import micro_raster as mr

    image_wh, tile_wh, chunk, pairs = {
        "small": ((128, 64), (32, 16), 128, 1 << 14),
        "tiles_2048px": ((256, 96), (64, 32), 256, 1 << 16),
    }[size]
    binned = mr.make_binned(pairs, image_wh, tile_wh, seed=3, device=cuda)
    n_tiles = binned["range_start"].shape[0]
    depth = 0.3 + 0.7 * torch.rand(
        (n_tiles, tile_wh[0] * tile_wh[1]), device=cuda,
        generator=torch.Generator(device=cuda).manual_seed(1))
    depth[:n_tiles * 3 // 4] = 1.0  # these tiles saturate and leave early
    b, kw = mr.variant_inputs(binned, name, image_wh=image_wh, tile_wh=tile_wh)
    kw.update(image_wh=image_wh, tile_wh=tile_wh, chunk=chunk)
    before = kernels.LAUNCHES["micro_raster"]
    got = mr.composite(b, depth, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["micro_raster"] == before + 1
    stats = {}
    want = mr.composite_plain(b, depth, stats=stats, **kw)
    # the early exit must have fired for the comparison to cover it
    assert 0 < stats["pairs"] < int((binned["key"] < n_tiles).sum())
    assert bool(torch.isfinite(got).all()) and float(got[:, 3].mean()) > 0.3
    _assert_micro_close(name, got, want, stats)


def _assert_micro_close(name, got, want, stats):
    """The micro-raster tolerance: absolute wherever a pixel's sum of |w|
    stays at 1, every pixel of A, B, C and C2. D's bf16 exponent can come
    out positive, g exceeds 1, T changes sign, and such a pixel's sums are
    signed terms far outside [0, 1] that partly cancel: those pixels alone
    are held relative to their own sum of |w|, which bounds the f32
    rounding of the sums. The plain version's mask, which the kernel's
    mirrors, leaves out no kept pair-pixel."""
    assert stats["missed"] == 0
    mag = stats["mag"][:, None, :]
    blown = mag > 1.01
    if name != "D":
        assert not bool(blown.any())
    assert float(blown.float().mean()) < 0.5
    diff = (got - want).abs()
    assert float(diff[~blown.expand_as(diff)].max()) <= TOL
    assert float((diff / mag.clamp(min=1.0)).max()) <= TOL


@pytest.mark.parametrize("chunk", [256, 128, 32])
@pytest.mark.parametrize("name", ["A", "B", "C", "C2", "D"])
def test_micro_raster_on_adversarial_tables(cuda, name, chunk):
    """The kernel's warp-block mask (the variant's own margin), warp-uniform
    skip and bulk-copy ring against the plain version on needle-thin,
    edge-on, sub-pixel, tile-sized, off-tile, non-definite and dead pairs,
    half of them peaking just around the cutoff in the variant's own
    precision: the 16x4-block layout (64x32) and the flat one (100x20),
    under depth 1 and a random depth."""
    from gswt_renderer_tpu_torch.benchmarks import micro_raster as mr
    from torch_tables import adversarial_micro_binned

    for tile_wh in ((64, 32), (100, 20)):
        b, image_wh, kw = adversarial_micro_binned(5, name, tile_wh)
        b = {k: v.to(cuda) for k, v in b.items()}
        n_tiles, p_n = b["range_start"].shape[0], tile_wh[0] * tile_wh[1]
        kw.update(image_wh=image_wh, tile_wh=tile_wh, chunk=chunk)
        rand = torch.rand((n_tiles, p_n), device=cuda,
                          generator=torch.Generator(device=cuda).manual_seed(2))
        for depth in (torch.ones_like(rand), rand):
            before = kernels.LAUNCHES["micro_raster"]
            got = mr.composite(b, depth, **kw)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["micro_raster"] == before + 1
            stats = {}
            want = mr.composite_plain(b, depth, stats=stats, **kw)
            assert bool(torch.isfinite(got).all())
            assert float(want[:, 3].max()) > 0.5
            _assert_micro_close(name, got, want, stats)


def test_micro_raster_rejects_tables_it_cannot_stage(cuda):
    """The staging copies move whole 16-B aligned chunks: chunk must be a
    multiple of 4, dom a multiple of chunk and the table 16-B aligned."""
    from gswt_renderer_tpu_torch.benchmarks import micro_raster as mr

    image_wh, tile_wh = (128, 64), (64, 32)
    binned = mr.make_binned(1 << 12, image_wh, tile_wh, seed=1, device=cuda)
    depth = torch.ones((4, 2048), device=cuda)
    kw = dict(image_wh=image_wh, tile_wh=tile_wh, local=False,
              prec="highest", bf2=False)
    table = binned["table"]
    with pytest.raises(ValueError):
        mr.composite(binned, depth, chunk=126, **kw)
    with pytest.raises(ValueError):
        mr.composite(dict(binned, table=table[:, :1000].contiguous()),
                     depth, chunk=128, **kw)
    shifted = torch.empty(16 * table.shape[1] + 1, device=cuda)[1:]
    shifted = shifted.view(16, table.shape[1])
    shifted.copy_(table)
    with pytest.raises(ValueError):
        mr.composite(dict(binned, table=shifted), depth, chunk=128, **kw)
    before = kernels.LAUNCHES["micro_raster"]
    mr.composite(binned, depth, chunk=128, **kw)
    assert kernels.LAUNCHES["micro_raster"] == before + 1


# the compositor's warp-block mask and staging ring (csrc/raster.cu) on
# tables built to break them, and the bulk-copy contiguous gather

_VARIANTS = [(True, False), (False, False), (True, True), (False, True)]


@pytest.mark.parametrize("tile_wh", [(64, 32), (64, 30), (48, 40), (100, 20)])
@pytest.mark.parametrize("exact,emit_zcut", _VARIANTS)
def test_raster_on_adversarial_tables(cuda, tile_wh, exact, emit_zcut):
    """All four variants against the plain version on needle-thin, edge-on,
    sub-pixel, tile-sized, off-tile, non-definite and dead pairs (peaks
    moved to around the cutoff), in the 16x4-block warp layout (64x32; 64x30
    with partial blocks; 48x40 with warps without pixels) and the flat one
    (100x20): within TOL, the saturation-slot record equal."""
    from torch_tables import adversarial_binned

    b, image_wh = adversarial_binned(7, tile_wh, exact=exact)
    b = {k: v.to(cuda) for k, v in b.items()}
    n_px = tile_wh[0] * tile_wh[1]
    depth = torch.rand((4, n_px), device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(2))
    for use_depth in (False, True):
        kw = dict(image_wh=image_wh, tile_wh=tile_wh, chunk=128,
                  use_depth=use_depth, exact=exact, emit_zcut=emit_zcut)
        before = kernels.LAUNCHES["raster"]
        got = raster.rasterize(b, depth, **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["raster"] == before + 1
        want = raster.rasterize_plain(b, depth, **kw)
        if emit_zcut:
            (got, zcut), (want, zwant) = got, want
            assert torch.equal(zcut, zwant)
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= TOL
        assert float(want[:, 3].max()) > 0.5


@pytest.mark.parametrize("tile_wh", [(100, 20), (32, 16)])
@pytest.mark.parametrize("exact,emit_zcut", _VARIANTS)
def test_raster_on_binned_splats_other_tile_sizes(cuda, tile_wh, exact,
                                                  emit_zcut):
    """bin_pairs' own table at tile sizes RendererConfig accepts besides
    64x32: 100x20 (the flat warp layout) and 32x16 (eight 16x4 blocks,
    24 warps without pixels), chunk 256, under a random depth."""
    image_wh = (3 * tile_wh[0], 4 * tile_wh[1])
    p = opaque_splats(2500, 4, cuda)
    p["cx"] = p["cx"] * (image_wh[0] / 256)
    p["cy"] = p["cy"] * (image_wh[1] / 128)
    p["color"] = p["color"][:3] + (p["color"][3] * 0.5,)
    b = fitted(lambda cap: binning.bin_pairs(
        p, image_wh=image_wh, tile_wh=tile_wh, chunk=256, exact=exact,
        capacity=cap), lambda b: b["n_pairs"], 256)
    n_tiles = b["range_start"].shape[0]
    depth = 0.1 + 0.9 * torch.rand(
        (n_tiles, tile_wh[0] * tile_wh[1]), device=cuda,
        generator=torch.Generator(device=cuda).manual_seed(3))
    kw = dict(image_wh=image_wh, tile_wh=tile_wh, chunk=256, use_depth=True,
              exact=exact, emit_zcut=emit_zcut)
    got = raster.rasterize(b, depth, **kw)
    want = raster.rasterize_plain(b, depth, **kw)
    if emit_zcut:
        (got, zcut), (want, zwant) = got, want
        assert torch.equal(zcut, zwant)
    assert float((got - want).abs().max()) <= TOL
    assert float(got[:, 3].max()) > 0.5


def test_raster_rejects_tables_it_cannot_stage(cuda):
    """The staging copies move whole 16-B aligned chunks: chunk must be a
    multiple of 4 and dom a multiple of chunk."""
    b = _saturating_binned(128, 0, 0.5, cuda)
    depth = torch.ones((2, 2048), device=cuda)
    kw = dict(image_wh=(128, 32), tile_wh=(64, 32), use_depth=False)
    with pytest.raises(ValueError):
        raster.rasterize(b, depth, chunk=126, **kw)
    with pytest.raises(ValueError):
        raster.rasterize(dict(b, table=b["table"][:, :1000].contiguous()),
                         depth, chunk=128, **kw)


@pytest.mark.parametrize("k,b_cols,group,nb", [
    (16, 256, 8, 61),   # 16 KiB panels, the last CTA walks five
    (16, 256, 7, 50),   # group larger than the 4-stage ring
    (16, 256, 1, 1),    # a single panel
    (16, 256, 4, 1),    # a single panel, its id outside the table
    (40, 256, 3, 10),   # 40 KiB panels: three pieces each
    (1, 4, 5, 33),      # 16-byte panels
])
def test_micro_contig_gather_out_of_range_and_shapes(cuda, k, b_cols, group,
                                                     nb):
    """The bulk-copy gather, bit-exact: ids outside the table (negative and
    past the end) write zeros, every other panel is the plain version's."""
    from gswt_renderer_tpu_torch.benchmarks import micro_blockgather as bg

    rng = np.random.default_rng(k * 1000 + nb)
    npb = 23
    words = rng.integers(0, 2**32, (npb, k, b_cols),
                         dtype=np.uint64).astype(np.uint32)
    table = torch.from_numpy(words.view(np.float32)).to(cuda)
    ids = rng.integers(0, npb, nb).astype(np.int32)
    bad = ids[group % 4::4]  # a view: group 4 puts the first id out
    bad[:] = rng.choice(np.array([-1, -7, npb, npb + 100], np.int32),
                        len(bad))
    src = torch.from_numpy(ids).to(cuda)
    before = kernels.LAUNCHES["micro_blockgather_contig"]
    got = bg.gather_contig(table, src, group=group)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["micro_blockgather_contig"] == before + 1
    inside = (src >= 0) & (src < npb)
    want = torch.zeros_like(got).view(torch.int32)
    want[inside] = bg.gather_contig_plain(table, src[inside]).view(torch.int32)
    if nb > 1:
        assert bool((~inside).any()) and bool(inside.any())
    assert torch.equal(got.view(torch.int32), want)
    with pytest.raises(ValueError):
        bg.gather_contig(table.view(-1)[1:].view(-1)[:4 * (npb - 1)]
                         .view(npb - 1, 1, 4), src, group=group)


# ---------------------------------------------------------------------- #
# the stream segments, the process group of one and the viewer on the card

MIN_T = 0.5 / 255.0


@pytest.fixture(scope="module")
def bench_frame():
    """The bench scene's first 1080p camera on an exact-profile Renderer on
    the card, with the skybox and proxy, and its staged plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from gswt_renderer_tpu_torch.benchmarks import headline
    from gswt_renderer_tpu_torch.core import Camera
    from gswt_renderer_tpu_torch.core.config import RenderConfig
    from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec
    from gswt_renderer_tpu_torch.render.pipeline import Renderer, RendererConfig
    from gswt_renderer_tpu_torch.render.uniforms import SceneParams
    from gswt_renderer_tpu_torch.tiles import WangTileEngine

    wang = WangTileEngine(synthetic_scene_vec(n_lod=3, splats_per_tile=512,
                                              lod_decay=2, seed=0))
    ud = headline.bench_user_data()
    wang.configure(ud)
    _, pos, target = headline.KEYFRAMES[0]
    cam_pos = np.asarray(pos, np.float32)
    wang.build_tiles(cam_pos)

    def camera(dx=0.0):
        return Camera((1920, 1080), cam_pos + np.float32([dx, 0, 0]),
                      np.asarray(target, np.float32) + np.float32([dx, 0, 0]),
                      (0.0, 0.0, 1.0), np.deg2rad(45.0), 0.1, 1000.0)

    dt = wang.sort_tiles(cam_pos, camera().view_proj())
    r = Renderer(wang, RendererConfig(width=1920, height=1080, exact=True),
                 device="cuda")
    r.configure(ud)
    sky, checker = headline.bench_textures()
    r.set_skybox(sky, equirect=True)
    r.set_proxy(checker)
    rc = RenderConfig.new(wang.n_tiles[0])
    sp = SceneParams.from_data(ud, wang.center_coord, rc)
    return dict(r=r, rc=rc, sp=sp, staged=r.stage(dt, camera(), rc.culling_dist),
                camera=camera, full=dict(use_skybox=True, use_proxy=True))


def test_stream_segments_fold_at_1080p(bench_frame):
    """Four stream segments in turn on the card, folded, against the single
    exact frame: max |err| <= 1e-3 + MIN_T (a later segment's restart at
    T = 1 composites tail pairs the single frame's early exit skipped),
    mean < 1e-4; the pairs split within 1.5x after the feedback and sum
    within 5% of the frame's; every segment ran the kernels."""
    from gswt_renderer_tpu_torch.parallel import render_stream_segments

    f = bench_frame
    r = f["r"]
    ref = r.render(None, f["camera"](), f["sp"], f["rc"], staged=f["staged"],
                   as_numpy=False, **f["full"])
    kept = int(r.last_aux["n_pairs_kept"])
    r.__dict__.pop("_sp_feedback", None)
    for _ in range(4):
        before = collections.Counter(kernels.LAUNCHES)
        img = render_stream_segments(r, f["staged"], f["sp"], f["camera"](),
                                     4, f["rc"], **f["full"])
        torch.cuda.synchronize()
        pairs = r.last_shard_pairs_kept
        if max(pairs) <= 1.5 * min(pairs):
            break
    launched = kernels.LAUNCHES - before
    for name in ("project", "raster"):
        assert launched[name] == 4, launched
    assert launched["block_gather"] == 0, launched
    for name in ("trirast", "bilinear"):
        assert launched[name] >= 1, launched
    diff = (img - ref).abs()
    assert float(diff.max()) <= 1e-3 + MIN_T and float(diff.mean()) < 1e-4
    assert min(pairs) > 0 and max(pairs) <= 1.5 * min(pairs), pairs
    assert abs(sum(pairs) - kept) <= 0.05 * kept, (pairs, kept)


def test_nccl_group_of_one_is_the_plain_frame(bench_frame):
    """dp = sp = 1 through a real NCCL group: a batch of distinct cameras
    and the stream path, each bit-equal to Renderer.render (same kernels,
    same inputs)."""
    from gswt_renderer_tpu_torch.parallel import (
        render_cameras_sharded, render_stream_sharded)
    from gswt_renderer_tpu_torch.parallel.batched import (
        group_of_one, pack_camera_batch)

    f = bench_frame
    r = f["r"]
    cams = [f["camera"](0.5 * i) for i in range(2)]
    with group_of_one("cuda") as mesh:
        assert torch.distributed.get_backend() == "nccl"
        imgs = render_cameras_sharded(
            r, f["staged"], f["sp"], pack_camera_batch(r, f["sp"], cams, f["rc"]),
            mesh, f["rc"], **f["full"])
        img = render_stream_sharded(r, f["staged"], f["sp"], cams[0], mesh,
                                    f["rc"], **f["full"])
    for i, c in enumerate(cams):
        ref = r.render(None, c, f["sp"], f["rc"], staged=f["staged"],
                       as_numpy=False, **f["full"])
        assert torch.equal(imgs[i], ref), i
        if i == 0:
            assert torch.equal(img, ref)


def test_pipelined_frames_equal_depth0_frames_at_1080p(bench_frame):
    """Frames at pipeline_depth 2, completed by drain(), bit-equal to the
    depth-0 frames of the same cameras and plan once the budgets have grown
    (the depth-0 pass grows them); two frames in flight at most."""
    f = bench_frame
    r = f["r"]
    cams = [f["camera"](0.25 * i) for i in range(4)]

    def frames(depth):
        out = []
        for c in cams:
            out.append(r.render(None, c, f["sp"], f["rc"], staged=f["staged"],
                                as_numpy=False, pipeline_depth=depth,
                                **f["full"]))
            assert len(r._inflight) <= depth
        return out

    ref = frames(0)
    before = r.overflow_frames
    piped = frames(2)
    assert len(r._inflight) == 2
    r.drain()
    assert not r._inflight and r.overflow_frames == before
    for i, (a, b) in enumerate(zip(ref, piped)):
        assert torch.equal(a, b), i


def test_pipelined_frame_makes_no_wait_under_sync_debug_error(bench_frame):
    """A pipelined 1080p full-config frame under PyTorch's sync debug mode
    "error": no tensor operation of the frame waits for the device (the
    drain of the oldest frame is an event's synchronize, which the mode
    does not see)."""
    f = bench_frame
    r = f["r"]
    r.render(None, f["camera"](), f["sp"], f["rc"], staged=f["staged"],
             as_numpy=False, **f["full"])  # budgets grown, plan uploaded
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(3):
            img = r.render(None, f["camera"](0.1 * i), f["sp"], f["rc"],
                           staged=f["staged"], as_numpy=False,
                           pipeline_depth=2, **f["full"])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    r.drain()
    assert tuple(img.shape) == (1080, 1920, 4)
    assert bool(torch.isfinite(img).all())


def test_pinned_pool_stops_growing_over_pipelined_frames(bench_frame):
    """500 pipelined 1080p full-config frames at depth 2, each uploading its
    uniforms and (alternating between two copies of the staged plan) its
    plan from a freshly allocated pinned buffer (render/pipeline.py
    upload_parts): PyTorch's caching host allocator hands each buffer out
    again once its copy has completed, so after 50 frames of warm-up the
    pinned pool takes no new block and its bytes stay flat."""
    f = bench_frame
    r = f["r"]
    plans = [f["staged"], dict(f["staged"])]

    def frames(first, n):
        for i in range(first, first + n):
            r.render(None, f["camera"](0.01 * (i % 7)), f["sp"], f["rc"],
                     staged=plans[i % 2], as_numpy=False, pipeline_depth=2,
                     **f["full"])

    def pool():
        s = torch.cuda.host_memory_stats()
        key = ("reserved_bytes.current" if "reserved_bytes.current" in s
               else "allocated_bytes.current")
        return s[key], s["num_host_alloc"]

    frames(0, 50)
    warm = pool()
    frames(50, 450)
    r.drain()
    assert warm[0] > 0
    assert pool() == warm, (warm, pool())


def test_server_streams_a_frame_jpg(cuda):
    """One /frame.jpg from the viewer over an Engine on the card, decoded,
    and no render-loop error on /hud."""
    import io
    import json
    import threading
    import urllib.error
    import urllib.request

    from PIL import Image

    from gswt_renderer_tpu_torch.core import UserData
    from gswt_renderer_tpu_torch.engine import Engine
    from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec
    from gswt_renderer_tpu_torch.render.pipeline import RendererConfig
    from gswt_renderer_tpu_torch.viewer.server import serve

    eng = Engine(synthetic_scene_vec(n_lod=2, splats_per_tile=48),
                 viewport=(128, 96),
                 renderer_config=RendererConfig(width=128, height=96,
                                                max_draws=64, chunk=128),
                 synchronous=False, device="cuda")
    eng.configure(UserData.from_ui(tile_map_half_wh=(2, 2), lod_max_dist=8.0))
    try:
        assert eng.wait_ready(timeout_s=120)
        stop, bound = threading.Event(), {}
        ready = threading.Event()
        t = threading.Thread(target=serve, args=(eng, "127.0.0.1", 0),
                             kwargs=dict(stream_ms=20.0, stop_event=stop,
                                         on_bound=lambda p: (bound.update(p=p),
                                                             ready.set())),
                             daemon=True)
        t.start()
        assert ready.wait(30)
        url = f"http://127.0.0.1:{bound['p']}"
        jpg = b""
        for _ in range(200):
            try:
                with urllib.request.urlopen(url + "/frame.jpg", timeout=10) as resp:
                    jpg = resp.read()
                break
            except urllib.error.HTTPError:  # 503 before the first grab
                time.sleep(0.05)
        assert Image.open(io.BytesIO(jpg)).size == (64, 48)
        with urllib.request.urlopen(url + "/hud", timeout=10) as resp:
            assert json.loads(resp.read())["render_errors"] == 0
        urllib.request.urlopen(urllib.request.Request(
            url + "/quit", data=b"{}", method="POST"), timeout=10).close()
        t.join(15)
        assert not t.is_alive()
    finally:
        eng.shutdown()


def test_span_log_on_the_card(cuda):
    """The host-section profiler's span log on the card (core/hostprof.py):
    every device-timed span starts on the device before it ends, each
    section's span lies inside its frame's on the host's clock and on the
    device's, and a planted .item() in a section no sync.* name covers
    counts as the one hidden wait of the run."""
    from gswt_renderer_tpu_torch.core import UserData, hostprof
    from gswt_renderer_tpu_torch.core.config import SurfaceType
    from gswt_renderer_tpu_torch.engine import Engine
    from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec
    from gswt_renderer_tpu_torch.render.pipeline import RendererConfig

    eng = Engine(synthetic_scene_vec(n_lod=2, splats_per_tile=64),
                 viewport=(128, 128),
                 renderer_config=RendererConfig(width=128, height=128,
                                                max_draws=64, chunk=128),
                 synchronous=True, device=cuda)
    eng.configure(UserData.from_ui(
        tile_map_half_wh=(2, 2), lod_max_dist=8.0,
        surface_type=SurfaceType.HEIGHT_MAP, height_map_wh=(4, 4),
        height_map_scale=(1.0, 0.3)))
    try:
        assert eng.wait_ready(timeout_s=120)
        eng.renderer.drain()
        hostprof.set_host_prof(True)
        try:
            for _ in range(4):
                eng.frame(readback=False)
            with hostprof._hprof("planted"):
                torch.ones(1, device=cuda).sum().item()
            eng.renderer.drain()
        finally:
            hostprof.set_host_prof(False)
    finally:
        eng.shutdown()
    tr = hostprof.trace()
    assert tr.syncs_counted and tr.dropped == 0
    frames = {s.frame: s for s in tr.spans if s.name == "frame"}
    assert len(frames) == 4
    timed = [s for s in tr.spans if s.device_start is not None]
    assert {s.name for s in timed} >= {
        "frame", "render.uniforms", "render.front.project",
        "render.front.background", "render.front.bin", "render.back",
        "render.aux"}
    for s in timed:
        assert s.device_start <= s.device_end, s
        f = frames[s.frame]
        assert f.host_start <= s.host_start <= s.host_end <= f.host_end, s
        assert f.device_start <= s.device_start <= s.device_end <= f.device_end, s
    assert [s.syncs for s in tr.spans if s.name == "planted"] == [1]
    hidden = tr.unsectioned_syncs + sum(
        s.syncs for s in tr.spans
        if not (s.name.startswith("sync.") or s.name == "render.drain"))
    assert hidden == 1, tr.sync_sites
    assert torch.cuda.get_sync_debug_mode() == 0
