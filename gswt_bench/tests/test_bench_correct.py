"""`correct` on the small cells (CPU): sound runs pass; the control and
each fault the cells can have, planted under the harness, fail.

On the card, test_control_fails_at_cell_size runs the control at each
cell's own size on three seeds:

    python -m pytest gswt_bench/tests/test_bench_correct.py -m card -q
"""

import os

import numpy as np
import pytest
import torch

from gswt_bench import harness


def _run(checkout, cell, seed, **kw):
    return harness.run_cell(cell, seed, 3.0, False, device="cpu", root=checkout,
                            here=os.path.join(checkout, "gswt_bench"), **kw)


@pytest.mark.parametrize("cell", ["small.fly", "small.still"])
def test_sound_run_is_correct(checkout, cell):
    out = _run(checkout, cell, 4294967311)
    assert out["correct"], out["compared"]


def test_control_is_not_correct(checkout):
    out = _run(checkout, "small.still", 4294967311, control=True)
    assert not out["correct"]
    assert out["compared"]["frame_mean_abs"]["value"] > out["compared"]["frame_mean_abs"]["limit"]


def _stale(eng):
    """A frame that returns the state it had: the previous frame's image."""
    render, prev = eng.renderer.render, []

    def stale(*a, **k):
        img = render(*a, **k)
        out = prev[0] if prev else img
        prev[:] = [img]
        return out
    eng.renderer.render = stale


def _altered(eng):
    """Every frame's colour altered where it is produced (10% darker)."""
    render = eng.renderer.render

    def altered(*a, **k):
        img = render(*a, **k)
        return torch.cat([img[..., :3] * 0.9, img[..., 3:]], dim=-1)
    eng.renderer.render = altered


def _half_draws(eng):
    """Half of the draw list left out of every staged plan."""
    import dataclasses
    stage_vp = eng.renderer.stage_vp

    def half(dt, *a, **k):
        return stage_vp(dataclasses.replace(dt, n_draws=dt.n_draws // 2), *a, **k)
    eng.renderer.stage_vp = half


def _merged_streams(eng, change):
    """Every merged stream of every sort changed by `change(dt, row, seg)`."""
    sort = eng.wang.sort_tiles

    def changed(*a, **k):
        dt = sort(*a, **k)
        for name in ("stream_gs_index", "stream_map_id", "stream_lod_id", "splat_count"):
            setattr(dt, name, getattr(dt, name).copy())
        for r in np.where(dt.stream_start[:dt.n_draws] >= 0)[0]:
            s0 = int(dt.stream_start[r])
            change(dt, r, slice(s0, s0 + int(dt.splat_count[r])))
        return dt
    eng.wang.sort_tiles = changed


def _reversed_streams(eng):
    """Each merged stream drawn front to back."""
    def rev(dt, r, seg):
        for name in ("stream_gs_index", "stream_map_id", "stream_lod_id"):
            getattr(dt, name)[seg] = getattr(dt, name)[seg][::-1].copy()
    _merged_streams(eng, rev)


def _truncated_streams(eng):
    """Each merged stream cut to its first half."""
    def cut(dt, r, seg):
        dt.splat_count[r] = (seg.stop - seg.start) // 2
    _merged_streams(eng, cut)


@pytest.mark.parametrize("fault,cell", [(_stale, "small.fly"), (_altered, "small.still"),
                                        (_half_draws, "small.still"),
                                        (_reversed_streams, "small.still"),
                                        (_truncated_streams, "small.fly")],
                         ids=["stale_frame", "altered_frame", "half_the_draws",
                              "reversed_merged_streams", "truncated_merged_streams"])
def test_fault_is_not_correct(checkout, fault, cell):
    out = _run(checkout, cell, 4294967311, engine_hook=fault)
    assert not out["correct"], out["compared"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["dense_tiles_1080p.still", "paper_sky_1080p.still"])
def test_control_fails_at_cell_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for seed in (5000000011, 5000000021, 5000000031):
        out = harness.run_cell(cell, seed, 3.0, False, control=True)
        assert not out["correct"], (seed, out["compared"])


def test_reference_ground_matches_the_ports_marched_ground(checkout):
    """The reference's ground (the port's stated mesh, as a rasterizer
    meets it) against the port's own ray-marched ground, hit for hit, on a
    small cell with the ground on. The port's rasterized ground is the
    one that misses pixels (PERF.md, Open questions 1)."""
    import gswt_renderer_tpu_torch.render.pipeline as P
    from gswt_bench.frozen import synth
    from gswt_bench.reference import background, camera
    from gswt_bench.reference import frame as ref_frame

    here = os.path.join(checkout, "gswt_bench")
    cfg = dict(harness.config("small", here), proxy=True, width=192, height=108)
    trf = harness.traffic("fly", here)
    raw = synth.tile_set(n_lod=cfg["n_lod"], n_center_options=1, tile_width=cfg["tile_width"],
                         splats_per_tile=cfg["splats_per_tile"], seed=11,
                         lod_decay=cfg["lod_decay"])
    calls, render_proxy = [], P.render_proxy

    def spy(*a, **k):
        calls.append((a, k))
        return render_proxy(*a, **k)
    P.render_proxy = spy
    try:
        eng = harness.build_engine(cfg, raw, torch.device("cpu"))
        eng.render_gs = False
        harness._set_pose(eng, trf, 7.5, [])
        for _ in range(10):
            eng.frame(readback=False)
        eng.renderer.drain()
        a, k = calls[-1]
        hit_march = render_proxy(*a, **dict(k, use_grid=False))[2]
        inputs = ref_frame.frame_inputs(cfg, raw, harness.preload_arrays(eng.wang),
                                        torch.device("cpu"))
        scene = dict(inputs["scene"],
                     center_coord=tuple(int(v) for v in eng.cur_scene.center_coord))
        eng.shutdown()
    finally:
        P.render_proxy = render_proxy
    cam = camera.camera(*harness.pose_at(trf, 7.5), cfg["width"], cfg["height"])
    hit_ref = background.proxy(cam, scene, torch.as_tensor(inputs["height_map"]),
                               inputs["height_map_wh"], inputs["pyramid"], cfg["width"],
                               cfg["height"], "cpu")[2][::2, ::2]
    assert hit_ref.any() and (~hit_ref).any()
    assert int((hit_ref ^ hit_march).sum()) <= hit_ref.numel() // 1000
