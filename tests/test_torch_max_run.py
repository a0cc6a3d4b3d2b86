"""The frame's longest tile run (binning's max_run) from the plain binning
through the pipeline's counts, and the pair-by-pair walk that the card
tests of the compositor's cluster (tests/test_torch_raster_cluster.py) hold
the kernel to, against the plain compositor. CPU only; imports no jax."""

import numpy as np
import pytest
import torch

from gswt_renderer_tpu_torch.core import UserData, hostprof
from gswt_renderer_tpu_torch.core.config import SurfaceType
from gswt_renderer_tpu_torch.engine import Engine
from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec
from gswt_renderer_tpu_torch.ops import binning, raster
from gswt_renderer_tpu_torch.render import pipeline
from gswt_renderer_tpu_torch.render.pipeline import RendererConfig
from torch_tables import (adversarial_binned, adversarial_stream,
                          composite_walk, cover_splats, one_rank_splats,
                          rank_splats, runs_binned, warp_rank)

IMAGE_WH, TILE_WH, CHUNK = (256, 128), (64, 32), 128


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cull_exact", [True, False])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_max_run_is_the_longest_run(seed, exact, cull_exact):
    """On adversarial conics with a pile of splats on one point: max_run is
    the longest range_end - range_start, a 0-d int64, and the pile's tile
    holds it."""
    p = adversarial_stream(seed, IMAGE_WH)
    kw = dict(image_wh=IMAGE_WH, tile_wh=TILE_WH, chunk=CHUNK, exact=exact,
              cull_exact=cull_exact)
    demand = binning.bin_pairs_plain(p, capacity=CHUNK, **kw)["n_pairs"]
    b = binning.bin_pairs_plain(
        p, capacity=binning.fit_capacity(demand, CHUNK), **kw)
    runs = (b["range_end"] - b["range_start"]).long()
    assert b["max_run"].dtype == torch.int64 and b["max_run"].shape == ()
    assert int(b["max_run"]) == int(runs.max())
    ntx = binning.grid_dims(IMAGE_WH, TILE_WH)[0]
    pile = int(0.6 * IMAGE_WH[1]) // TILE_WH[1] * ntx + int(
        0.3 * IMAGE_WH[0]) // TILE_WH[0]
    assert int(runs.argmax()) == pile and int(b["max_run"]) >= 200


def test_plain_max_run_of_an_overflow_and_an_empty_stream():
    """Past the capacity the kept pairs' runs still give max_run; an empty
    stream's is 0."""
    p = adversarial_stream(2, IMAGE_WH)
    kw = dict(image_wh=IMAGE_WH, tile_wh=TILE_WH, chunk=CHUNK)
    b = binning.bin_pairs_plain(p, capacity=2 * CHUNK, **kw)
    assert bool(b["overflow"])
    runs = b["range_end"] - b["range_start"]
    assert 0 < int(b["max_run"]) == int(runs.max()) <= 2 * CHUNK
    empty = {k: (tuple(x[:0] for x in v) if isinstance(v, tuple) else v[:0])
             for k, v in p.items()}
    assert int(binning.bin_pairs_plain(empty, capacity=CHUNK,
                                       **kw)["max_run"]) == 0


@pytest.mark.parametrize("readback", [True, False], ids=["depth0", "depth2"])
def test_max_run_reaches_last_aux_and_the_span_log(readback):
    """Every frame's max_run is filed under its id in trace().frames and is
    last_aux's when the frame completes (at depth 2, two frames later): the
    frame's longest run, at most its kept pairs."""
    eng = Engine(synthetic_scene_vec(n_lod=2, splats_per_tile=32),
                 viewport=(64, 64),
                 renderer_config=RendererConfig(width=64, height=64,
                                                max_draws=64, chunk=128),
                 synchronous=True, device="cpu")
    eng.configure(UserData.from_ui(
        tile_map_half_wh=(2, 2), lod_max_dist=8.0,
        surface_type=SurfaceType.HEIGHT_MAP, height_map_wh=(4, 4),
        height_map_scale=(1.0, 0.3)))
    eng.camera.set_view(np.array([1.0, -5.0, 3.0], np.float32),
                        np.array([1.0, 2.0, 0.5], np.float32),
                        np.array([0.0, 0.0, 1.0], np.float32))
    try:
        assert eng.wait_ready(timeout_s=120)
        eng.renderer.drain()
        pipeline.set_host_prof(True)
        ids, auxes = [], []
        for _ in range(4):
            eng.camera.translate(np.array([0.05, 0.1, 0.0], np.float32))
            eng.frame(readback=readback)
            ids.append(eng.frame_id)
            auxes.append(eng.renderer.last_aux)
        eng.renderer.drain()
        tr = hostprof.trace()
    finally:
        pipeline.set_host_prof(False)
        eng.shutdown()
    lag = 0 if readback else eng.pipeline_depth
    for i in range(lag, len(ids)):
        assert auxes[i]["max_run"] == tr.frames[ids[i - lag]]["max_run"]
    for f in ids:
        c = tr.frames[f]
        assert 0 < c["max_run"] <= c["n_pairs_kept"]


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("tile_wh", [(64, 32), (100, 20)])
def test_walk_matches_the_plain_compositor(tile_wh, exact):
    """composite_walk against rasterize_plain on adversarial tables and on
    a run of tight splats over one block of the cluster followed by a cover
    that saturates the tile: within the card tests' TOL (the plain version
    sums colours as a matrix product)."""
    b, image_wh = adversarial_binned(3, tile_wh, exact=exact)
    rank = torch.cat([rank_splats(2, 1, tile_wh, 2),
                      cover_splats(400, 2, tile_wh)], 1)
    s = runs_binned([rank], 64, offset=37)
    for b, image_wh, chunk in ((b, image_wh, 128), (s, tile_wh, 64)):
        n_tiles = b["range_start"].shape[0]
        depth = torch.rand((n_tiles, tile_wh[0] * tile_wh[1]),
                           generator=torch.Generator().manual_seed(4))
        for use_depth in (False, True):
            want = raster.rasterize_plain(
                b, depth, image_wh=image_wh, tile_wh=tile_wh, chunk=chunk,
                use_depth=use_depth, exact=exact)
            got = composite_walk(b, depth, tile_wh=tile_wh, chunk=chunk,
                                 use_depth=use_depth, exact=exact)
            assert float((got - want).abs().max()) <= 1e-4
            assert float(want[:, 3].max()) > 0.5


@pytest.mark.parametrize("tile_wh", [(64, 32), (48, 40), (16, 8)])
def test_the_ranks_checkerboard_and_its_tight_splats(tile_wh):
    """Each of the cluster's four blocks holds 8 of the tile's 32 warps,
    one of each group of four; in the 16x4-block layout one_rank_splats
    reach the warp blocks of their block alone (the plain mask), and
    rank_splats saturate the pixels of their block."""
    w = torch.arange(32)
    assert [int((warp_rank(w) == r).sum()) for r in range(4)] == [8] * 4
    assert all(sorted(int(x) for x in warp_rank(w[4 * g:4 * g + 4]))
               == [0, 1, 2, 3] for g in range(8))
    rects, warp = raster.warp_layout(tile_wh)
    for r in range(4):
        if not bool((warp_rank(warp) == r).any()):
            continue
        cols = one_rank_splats(200, r, tile_wh, r)
        reach = raster.pair_block_mask(tuple(cols[:6]), cols[6], rects)
        assert bool((reach.any(1)).all())
        assert not bool((reach & (warp_rank(w) != r)).any())
        b = runs_binned([rank_splats(8, r, tile_wh, r)], 128)
        alpha = raster.rasterize_plain(
            b, torch.ones((1, tile_wh[0] * tile_wh[1])), image_wh=tile_wh,
            tile_wh=tile_wh, chunk=128, use_depth=False)[0, 3]
        assert float(alpha[warp_rank(warp) == r].min()) > 1 - raster.MIN_T
