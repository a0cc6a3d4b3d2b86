"""The cell with the proxy ground, paper_full_1080p.still: its per-layer
readers on synthetic span logs, and `correct` on a small cell with the
ground on (CPU: the paper's 97x97 map at 192x108, 32 splats per tile); on
the card, the control fails the cell at its own size:

    python -m pytest gswt_bench/tests/test_bench_ground.py -q
    python -m pytest gswt_bench/tests/test_bench_ground.py -m card -q
"""

import json
import os

import pytest
import torch

from conftest import SMALL_LIMITS, make_checkout
from gswt_bench import harness

CELL = "paper_full_1080p.still"
SEED = 4294967311
# the small cell: the paper's map (its far rings are where the ground lost
# triangles) at a size the CPU renders in about a minute
SMALL_GROUND = dict(proxy=True, width=192, height=108, tile_map_half=48,
                    renderer={"max_stream": 1 << 19, "max_draws": 16384, "chunk": 128})
# read from CPU runs: the sound ground's far-ground difference 0.018-0.026
# (seeds 4294967311, 7, 2200000013; splat edges at the map's far border,
# which the margin around the far ground takes in at this size), the thin
# triangles dropped whole 0.14
SMALL_GROUND_LIMITS = dict(SMALL_LIMITS, far_ground_mean_abs=0.05)


def _span(name, frame):
    from gswt_renderer_tpu_torch.core.hostprof import Span
    return Span(name, frame, 1, None, 0.0, 1.0, 1.0, None, None, 0, {})


def _trace(spans, frames):
    from gswt_renderer_tpu_torch.core.hostprof import Trace
    return Trace(tuple(spans), frames, 0, False, 0, {})


def test_pair_use_reads_the_windows_ground_frames(monkeypatch):
    """proxy.pairs_used_pct: the window's frames only, those with both
    counts, summed before the ratio; nothing where no frame drew the
    ground or the program has no log."""
    from gswt_renderer_tpu_torch.core import hostprof
    read = harness.reader("proxy.pairs_used_pct")
    frames = {1: dict(proxy_pairs=90, proxy_capacity=300),   # before the window
              2: dict(proxy_pairs=100, proxy_capacity=150),
              3: dict(proxy_pairs=50, proxy_capacity=150),
              4: dict(n_pairs=7, capacity=9)}                 # no ground
    spans = [_span("frame", f) for f in (2, 3, 4)]
    monkeypatch.setattr(hostprof, "trace", lambda: _trace(spans, frames))
    assert read({}) == pytest.approx(50.0)
    monkeypatch.setattr(hostprof, "trace", lambda: _trace(spans, {4: frames[4]}))
    assert read({}) is None
    monkeypatch.delattr(hostprof, "trace")
    assert read({}) is None


def test_host_ms_reads_the_ground_section_with_its_children():
    """proxy.host_ms: the section's total (its children's time in it) per
    frame of the window; nothing without the section or a traced window."""
    read = harness.reader("proxy.host_ms")
    hp = {"render.front.proxy": [40, 0.2, 0.05],
          "render.front.proxy.raster": [40, 0.1, 0.1],
          "render.front.proxy.shade": [40, 0.05, 0.05]}
    assert read(dict(win=dict(host_prof=hp), n_frames=40)) == pytest.approx(5.0)
    assert read(dict(win=dict(host_prof={"frame": [4, 1.0, 1.0]}), n_frames=4)) is None
    assert read(dict(win=dict(host_prof=None), n_frames=4)) is None


def test_the_cell_lists_its_ground_metrics():
    bench = harness.benchmark()
    cell = harness.cell_of(bench, CELL)
    names = [m["name"] for m in harness.metrics_of(bench, cell, True)]
    assert {"proxy.host_ms", "proxy.pairs_used_pct", "raster.roofline_pct"} <= set(names)
    assert harness.config(cell["config"])["proxy"] is True
    assert harness.config(cell["config"])["reduced"] == []


@pytest.fixture
def ground_checkout(tmp_path):
    """The small checkout (conftest) with the cell small_ground.still."""
    dst = make_checkout(str(tmp_path / "checkout"))
    here = os.path.join(dst, "gswt_bench")
    cfg = dict(harness.config("small", here), name="small_ground", **SMALL_GROUND)
    with open(os.path.join(here, "configs", "small_ground.json"), "w") as f:
        json.dump(cfg, f)
    bench = harness.benchmark(dst)
    bench["configs"].append(dict(name="small_ground", source="tests", reduced=[],
                                 file="gswt_bench/configs/small_ground.json", why="tests"))
    bench["workloads"].append(dict(name="small_ground.still", config="small_ground",
                                   traffic="still", chips=1, why="tests"))
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    with open(os.path.join(here, "limits", "small_ground.still.json"), "w") as f:
        json.dump(SMALL_GROUND_LIMITS, f)
    return dst


def _run(checkout, **kw):
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        return harness.run_cell("small_ground.still", SEED, 3.0, False, device="cpu",
                                root=checkout, here=os.path.join(checkout, "gswt_bench"),
                                **kw)
    finally:
        torch.set_num_threads(threads)


def _ground_pass_spy(eng, calls):
    """Record every call of the renderer's ground pass."""
    import gswt_renderer_tpu_torch.render.pipeline as P
    render_proxy = P.render_proxy

    def spy(*a, **k):
        out = render_proxy(*a, **k)
        calls.append((a, k, out[2]))
        return out
    P.render_proxy = spy
    eng._restore_ground = lambda: setattr(P, "render_proxy", render_proxy)


def _thin_dropped(eng):
    """The fault the cell's limits must catch: the ground's triangles under
    a pixel of area dropped whole (the band of far-ring slivers the ground
    lost to rounding)."""
    import gswt_renderer_tpu_torch.ops.proxy as P
    planes_of = P.triangle_planes

    def dropped(*a, **k):
        planes, ok, bbox = planes_of(*a, **k)
        inv_area2 = planes[0] * planes[4] - planes[1] * planes[3]
        return planes, ok & (inv_area2.abs() <= 0.5), bbox
    P.triangle_planes = dropped
    eng._restore_ground = lambda: setattr(P, "triangle_planes", planes_of)


@pytest.mark.parametrize("fault", [None, _thin_dropped], ids=["sound", "thin_triangles_dropped"])
def test_the_ground_cell_is_correct_and_a_holed_ground_is_not(ground_checkout, fault):
    """The sound program's run is correct, and its grid ground covers what
    the reference's covers at the judged pose but numel // 1000 pixels; a
    ground that drops its thin triangles whole is not correct."""
    from gswt_bench.reference import background, camera
    from gswt_bench.reference import frame as ref_frame

    calls, hooks = [], []

    def hook(eng):
        _ground_pass_spy(eng, calls)
        hooks.append(eng._restore_ground)
        if fault is not None:
            fault(eng)
            hooks.append(eng._restore_ground)

    judged = []
    render = ref_frame.render

    def keep(inputs, record, **kw):
        judged.append((inputs, record))
        return render(inputs, record, **kw)
    ref_frame.render = keep
    try:
        out = _run(ground_checkout, engine_hook=hook)
    finally:
        ref_frame.render = render
        for restore in reversed(hooks):
            restore()
    if fault is not None:
        assert not out["correct"], out["compared"]
        assert (out["compared"]["far_ground_mean_abs"]["value"]
                > out["compared"]["far_ground_mean_abs"]["limit"])
        return
    assert out["correct"], out["compared"]
    inputs, record = judged[0]
    cfg = harness.config("small_ground", os.path.join(ground_checkout, "gswt_bench"))
    cam = camera.camera(record["position"], record["target"], cfg["width"], cfg["height"])
    scene = dict(inputs["scene"], center_coord=tuple(int(v) for v in record["center_coord"]))
    hit_ref = background.proxy(cam, scene, torch.as_tensor(inputs["height_map"]),
                               inputs["height_map_wh"], inputs["pyramid"], cfg["width"],
                               cfg["height"], "cpu")[2][::2, ::2]
    hit = calls[-1][2]
    assert hit_ref.float().mean() > 0.2
    assert int((hit != hit_ref).sum()) <= hit.numel() // 1000


@pytest.mark.card
def test_control_fails_the_ground_cell():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for seed in (5000000011, 5000000021, 5000000031):
        out = harness.run_cell(CELL, seed, 3.0, False, control=True)
        assert not out["correct"], (seed, out["compared"])
