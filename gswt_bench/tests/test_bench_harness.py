"""The harness's own arithmetic and its look-up by name (CPU)."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REPO, make_checkout
from gswt_bench import harness
from gswt_bench.frozen import peaks

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keeps_its_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["gswt_bench"] and b["command"][1].startswith("gswt_bench/")
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert os.path.isfile(os.path.join(REPO, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in names and w["chips"] == 1 and len(w["why"]) <= 200
        harness.traffic(w["traffic"])
        harness.limits(w["name"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        harness.reader(m["name"])
    for m in b["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_config_traffic_metric_are_found_as_added_files(tmp_path):
    dst = make_checkout(str(tmp_path / "co"), with_program=False)
    here = os.path.join(dst, "gswt_bench")
    before = _digest(here)
    bench = json.load(open(os.path.join(dst, "BENCHMARK.json")))
    shutil.copy(os.path.join(here, "traffic", "still.json"), os.path.join(here, "traffic", "hover.json"))
    with open(os.path.join(here, "metrics", "extra.count.py"), "w") as f:
        f.write("def read(ctx):\n    return 7.0\n")
    shutil.copy(os.path.join(here, "limits", "small.still.json"),
                os.path.join(here, "limits", "small.hover.json"))
    bench["workloads"].append(dict(name="small.hover", config="small", traffic="hover",
                                   chips=1, why="t"))
    bench["per_layer"].append(dict(name="extra.count", unit="n", better="lower",
                                   source="program_counter", layer="device", moves="frame_ms",
                                   workloads=["small.hover"]))
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = harness.cell_of(harness.benchmark(dst), "small.hover")
    assert harness.config(cell["config"], here)["width"] == 96
    assert harness.traffic(cell["traffic"], here)["moving"] is False
    assert harness.limits("small.hover", here)["frame_mean_abs"] > 0
    got = [m["name"] for m in harness.metrics_of(harness.benchmark(dst), cell, True)]
    assert "extra.count" in got and "builder.sort_ms" not in got
    assert harness.reader("extra.count", here)({}) == 7.0
    after = _digest(here)
    assert all(after[k] == v for k, v in before.items())  # no file was edited


def test_per_layer_metrics_follow_their_workloads():
    # a fly cell and a metric that lists it, added as a later PR would
    b = _bench()
    b["workloads"].append(dict(name="paper_sky_1080p.fly", config="paper_sky_1080p",
                               traffic="fly", chips=1, why="t"))
    b["per_layer"].append(dict(name="builder.sort_ms", unit="ms", better="lower",
                               source="program_counter", layer="builder thread",
                               moves="frame_ms", workloads=["paper_sky_1080p.fly"]))
    fly = harness.cell_of(b, "paper_sky_1080p.fly")
    still = harness.cell_of(b, "paper_sky_1080p.still")
    assert [m["name"] for m in harness.metrics_of(b, fly, False)] == [
        "frame_ms", "frame_p95_ms", "latency_p95_ms", "setup_s"]
    assert "builder.sort_ms" in [m["name"] for m in harness.metrics_of(b, fly, True)]
    assert "builder.sort_ms" not in [m["name"] for m in harness.metrics_of(b, still, True)]


def _ctx(ret, t_end, enter=None, done=None):
    ret = np.asarray(ret, float)
    enter = ret - 0.001 if enter is None else np.asarray(enter, float)
    win = dict(t_start=0.0, t_end=t_end, ret=ret, enter=enter, done=done)
    return dict(win=win, n_frames=len(ret))


@pytest.mark.parametrize("stall", [False, True])
def test_frame_time_and_its_tail_are_taken_over_every_frame(stall):
    gaps = np.full(100, 0.05)
    if stall:
        gaps[::10] = 0.5  # a stall on every tenth frame
    ret = np.cumsum(gaps)
    ctx = _ctx(ret, ret[-1] + 0.02)
    frame_ms = harness.reader("frame_ms")(ctx)
    p95 = harness.reader("frame_p95_ms")(ctx)
    assert frame_ms == pytest.approx((ret[-1] + 0.02) / 100 * 1e3)
    assert p95 == pytest.approx(np.percentile(gaps, 95) * 1e3)
    if stall:
        assert frame_ms > 90.0 and p95 == pytest.approx(500.0)
    else:
        assert frame_ms < 51.0 and p95 == pytest.approx(50.0)


def test_latency_places_device_completion_on_the_host_clock():
    done = harness.completion_times(100.0, [5.0, 20.0, 31.0])
    assert np.allclose(done, [100.005, 100.020, 100.031])
    enter = np.array([99.990, 99.995, 100.001])
    ctx = _ctx([99.991, 99.996, 100.002], 100.04, enter=enter, done=done)
    lat = harness.reader("latency_p95_ms")(ctx)
    assert lat == pytest.approx(np.percentile(done - enter, 95) * 1e3)
    assert 25.0 < lat < 31.0


def test_compositor_bound_against_hand_worked_numbers():
    s, by = peaks.raster_bound_s(kept=10**9, rows=10**6, pixels=1920 * 1080, use_depth=True)
    assert by == "operations" and s == pytest.approx(24e9 / 67e12)
    s, by = peaks.raster_bound_s(kept=10, rows=10**6, pixels=1920 * 1080, use_depth=False)
    assert by == "bytes"
    assert s == pytest.approx(4 * (10**6 * 11 + 1920 * 1080 * 4) / 3.35e12)
    s, by = peaks.raster_bound_s(kept=10**9, rows=0, pixels=0, use_depth=False, ops=1)
    assert by == "sfu" and s == pytest.approx(10**9 / (132 * 16 * 1.98e9))


def test_refuses_to_measure_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    r = subprocess.run([sys.executable, "gswt_bench/run.py", "--workload", "paper_sky_1080p.still",
                        "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "no CUDA device" in r.stderr


def test_refuses_in_a_checkout_of_only_the_benchmark(tmp_path):
    dst = str(tmp_path / "bare")
    os.makedirs(dst)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(REPO, "gswt_bench"), os.path.join(dst, "gswt_bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "gswt_bench/run.py", "--workload", "paper_sky_1080p.still",
                        "--seed", "7", "--seconds", "1", "--trace", "1"],
                       cwd=dst, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_sequential_compositor_in_float32_matches_the_reference_blend():
    from gswt_bench.reference import composite
    g = torch.Generator().manual_seed(3)
    n, w, h = 300, 48, 40
    table = dict(valid=torch.ones(n, dtype=torch.bool),
                 center_ndc=torch.rand(n, 2, generator=g) * 2.0 - 1.0,
                 z_ndc=torch.rand(n, generator=g),
                 major_px=torch.randn(n, 2, generator=g) * 4.0,
                 minor_px=torch.randn(n, 2, generator=g) * 2.0,
                 color=torch.rand(n, 4, generator=g))
    bg = torch.rand(h, w, 4, generator=g)
    ref = composite.composite(table, w, h, bg)[0]
    seq = composite.composite_sequential(table, w, h, bg, dtype=torch.float32)
    assert float((seq - ref).abs().max()) < 1e-5
    low = composite.composite_sequential(table, w, h, bg, dtype=torch.bfloat16)
    assert float((low - ref).abs().mean()) > 1e-3


def test_candidate_poses_follow_the_builders_lag_and_update_distance():
    p = [np.array(v, np.float32) for v in
         ([0, 0, 5], [0.5, 0, 5], [3, 0, 5], [3.2, 0, 5], [3.4, 0, 5], [9, 0, 5])]
    log = [(-np.inf, p[0]), (1.0, p[1]), (5.0, p[2]), (9.0, p[3]), (10.0, p[4]), (20.0, p[5])]
    # the poses of the last 2 s, and the one in effect 2 s before
    build, sort = harness.candidate_poses(log, 10.5, lag_s=2.0, update_dist=1.0)
    assert {tuple(x) for x in sort} == {tuple(p[2]), tuple(p[3]), tuple(p[4])}
    assert {tuple(x) for x in build} == {tuple(p[2]), tuple(p[3]), tuple(p[4])}
    build, sort = harness.candidate_poses(log, 3.5, lag_s=2.0, update_dist=1.0)
    assert {tuple(x) for x in sort} == {tuple(p[1])}
    assert {tuple(x) for x in build} == {tuple(p[0]), tuple(p[1])}
    # a pose held for longer than the lag stays the candidate
    build, sort = harness.candidate_poses(log[:2], 30.0, lag_s=2.0, update_dist=1.0)
    assert {tuple(x) for x in sort} == {tuple(p[1])}
    assert {tuple(x) for x in build} == {tuple(p[0]), tuple(p[1])}


def test_wang_tiling_check_counts_each_mismatched_edge():
    from gswt_bench.reference import drawlist
    # colours W, N, E, S = bits 8, 4, 2, 1 of the tile id
    ok = np.array([[0b0000, 0b0000], [0b0000, 0b0000]])
    assert drawlist._wang_off(ok.reshape(-1), 2, 2, 16, 1) == 0
    bad = ok.copy()
    bad[0, 0] = 0b0010  # east colour 1 against its east neighbour's west 0
    assert drawlist._wang_off(bad.reshape(-1), 2, 2, 16, 1) == 1
    bad[0, 1] = 16  # a centre option the configuration does not offer
    assert drawlist._wang_off(bad.reshape(-1), 2, 2, 32, 1) == 2
