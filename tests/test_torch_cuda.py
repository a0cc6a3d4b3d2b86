"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode). This file imports nothing of JAX, so it also runs on a
GPU host without JAX:

    GSWT_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -q

(GSWT_TEST_TPU=1 keeps tests/conftest.py from importing jax.)
Tolerances: the block gather is bit-exact; the compositor within 1e-4 per
channel (FP32 summation order, expf vs torch.exp)."""

import numpy as np
import pytest
import torch

from gswt_renderer_tpu_torch.ops import binning, kernels, raster
from gswt_renderer_tpu_torch.ops.blockgather import block_gather, block_gather_plain

TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


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
    b = binning.bin_pairs(p, image_wh=image_wh, tile_wh=tile_wh, chunk=chunk)
    depth = torch.rand((16, 64 * 32), device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(seed))
    for use_depth in (False, True):
        kw = dict(image_wh=image_wh, tile_wh=tile_wh, chunk=chunk,
                  use_depth=use_depth)
        got = raster.rasterize(b, depth, **kw)
        want = raster.rasterize_plain(b, depth, **kw)
        assert float((got - want).abs().max()) <= TOL
        assert float(got[:, 3].max()) > 0.5


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
                                          max_stream=1 << 15, chunk=128),
                     device=device)
        r.configure(ud)
        imgs.append(r.render(dt, camera, sp, rc))
    diff = np.abs(imgs[0] - imgs[1]).max(axis=-1)
    assert diff.mean() < 1e-4 and np.mean(diff > 1e-3) <= 5e-4
