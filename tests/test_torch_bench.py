"""The port's bench entry: Engine.run_benchmark / hud_text /
format_benchmark against the JAX Engine's on the same scene and fly path,
and the headline script at a small size on the CPU.

Times are the host's and differ between the two packages; what is compared
is the contract: the keys of the result, the frame count under the same
`max_frames`, the arithmetic of the windowed statistics."""

import json

import numpy as np
import pytest
import torch

from gswt_renderer_tpu.core import UserData as JUserData
from gswt_renderer_tpu.core.config import (
    SelectiveMergeType as JMerge, SurfaceType as JSurface, TileSortType as JSort)
from gswt_renderer_tpu.engine import (
    Engine as JEngine, FlyPathControl as JFlyPathControl,
    FlyPathFrame as JFlyPathFrame)
from gswt_renderer_tpu.io.synth import synthetic_scene_vec as j_scene_vec
from gswt_renderer_tpu.render.pipeline import RendererConfig as JRendererConfig
from gswt_renderer_tpu_torch.benchmarks import headline
from gswt_renderer_tpu_torch.core import UserData
from gswt_renderer_tpu_torch.core.config import (
    SelectiveMergeType, SurfaceType, TileSortType)
from gswt_renderer_tpu_torch.engine import Engine, FlyPathControl, FlyPathFrame
from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec
from gswt_renderer_tpu_torch.render.pipeline import RendererConfig

KEYS = {"frames", "wall_ms", "fps", "median_frame_ms", "clean_frame_ms",
        "n_windows", "stall_windows", "frame_ms", "sort_ms", "build_ms",
        "sort_trigger", "build_trigger", "builder_load"}
UI = dict(tile_map_half_wh=(2, 2), height_map_scale=(1.0, 0.0),
          lod_max_dist=8.0)
PATH = [(0.0, (0, 0, 5), (0, 1, 5)), (30.0, (2, 0, 5), (2, 1, 5))]


def _engine():
    eng = Engine(synthetic_scene_vec(n_lod=2, splats_per_tile=48),
                 viewport=(64, 64),
                 renderer_config=RendererConfig(width=64, height=64,
                                                max_draws=64, chunk=128),
                 synchronous=True, device="cpu")
    eng.configure(UserData.from_ui(
        surface_type=SurfaceType.NONE, merge_type=SelectiveMergeType.NONE,
        tile_sort_type=TileSortType.DISTANCE, lod_blending=False, **UI))
    return eng


def _jax_engine():
    eng = JEngine(j_scene_vec(n_lod=2, splats_per_tile=48), viewport=(64, 64),
                  renderer_config=JRendererConfig(
                      width=64, height=64, max_draws=64, max_stream=1 << 13,
                      min_stream=1 << 11, chunk=128),
                  synchronous=True)
    eng.configure(JUserData.from_ui(
        surface_type=JSurface.NONE, merge_type=JMerge.NONE,
        tile_sort_type=JSort.DISTANCE, lod_blending=False, **UI))
    return eng


def _path(control, frame):
    fp = control()
    fp.keyframes = [frame(t, np.array(p, np.float32), np.array(tgt, np.float32))
                    for t, p, tgt in PATH]
    return fp


def test_run_benchmark_has_the_jax_engines_contract():
    """Same keys, same frame count under the same max_frames on a path
    longer than the run, and format_benchmark's text built the same way."""
    eng, jeng = _engine(), _jax_engine()
    r = eng.run_benchmark(_path(FlyPathControl, FlyPathFrame), max_frames=20)
    jr = jeng.run_benchmark(_path(JFlyPathControl, JFlyPathFrame),
                            max_frames=20)
    # the port's result also counts the frames that overflowed a pair
    # budget, which bench.py reads off the JAX Renderer
    assert set(r) == KEYS | {"overflow_frames"} and set(jr) == KEYS
    assert r["overflow_frames"] == 0
    assert r["frames"] == jr["frames"] == 20
    assert r["n_windows"] == jr["n_windows"] == 1
    assert r["fps"] > 0 and r["median_frame_ms"] > 0
    assert r["stall_windows"] == 0
    assert r["clean_frame_ms"] == pytest.approx(r["median_frame_ms"])
    # the path replays in real time, so how far the camera gets, and with
    # it the rebuild count, is the host's; a synchronous engine sorts on
    # every frame that moved and builds at least on the first
    for res in (r, jr):
        assert res["sort_trigger"] == 1.0
        assert 1.0 / 20 <= res["build_trigger"] <= 1.0
    assert r["builder_load"] == pytest.approx(
        (r["sort_ms"][0] * r["sort_trigger"]
         + r["build_ms"][0] * r["build_trigger"]) / r["median_frame_ms"])
    assert eng.camera_control == "keyboard"
    out, jout = Engine.format_benchmark(r), JEngine.format_benchmark(jr)
    assert "\\pm" in out
    assert out.splitlines()[0] == jout.splitlines()[0]
    assert Engine.format_benchmark(jr) == jout
    assert out.splitlines()[-1] == "overflow_frames 0"
    eng.shutdown()
    jeng.shutdown()


def test_run_benchmark_ends_with_the_path():
    eng = _engine()
    fp = FlyPathControl()
    fp.keyframes = [
        FlyPathFrame(0.0, np.array([0, 0, 5], np.float32),
                     np.array([0, 1, 5], np.float32)),
        FlyPathFrame(0.3, np.array([2, 0, 5], np.float32),
                     np.array([2, 1, 5], np.float32)),
    ]
    r = eng.run_benchmark(fp)
    assert fp.finished and r["frames"] > 0 and r["wall_ms"] >= 300.0
    assert r["fps"] == pytest.approx(r["frames"] / (r["wall_ms"] / 1e3))
    # fewer than 16 frames or more: the median falls back to the mean
    # frame time when no window is full
    if r["n_windows"] == 0:
        assert r["median_frame_ms"] == pytest.approx(r["wall_ms"] / r["frames"])
    eng.shutdown()


def test_hud_text():
    eng, jeng = _engine(), _jax_engine()
    eng.frame()
    jeng.frame()
    text = eng.hud_text()
    assert "fps" in text and "splats" in text and "tiles/lod" in text
    # the counters after the first frame are the JAX engine's
    assert text.split("splats")[1] == jeng.hud_text().split("splats")[1]
    eng.shutdown()
    jeng.shutdown()


def test_renderer_drain_is_a_no_op_on_the_cpu():
    eng = _engine()
    eng.frame()
    assert eng.renderer.drain() is None
    eng.shutdown()


def test_fly_path_legs_and_cut():
    """60 s: four legs forth and back, no keyframe twice; a length inside a
    leg ends the path at the pose the full path has there."""
    fp = headline.fly_path()
    ts = [k.timestamp for k in fp.keyframes]
    assert ts == sorted(set(ts)) and ts[0] == 0.0 and ts[-1] == 60.0
    np.testing.assert_array_equal(fp.keyframes[0].position,
                                  fp.keyframes[-1].position)
    assert len(headline.fly_path(15.0).keyframes) == len(headline.KEYFRAMES)
    from gswt_renderer_tpu_torch.core import Camera

    cut = headline.fly_path(7.0)
    assert cut.keyframes[-1].timestamp == 7.0 and len(cut.keyframes) == 3
    cam = Camera.default((16, 16))
    fp.reset_path()
    fp.start_path()
    fp.handle_events(cam, now_ms=7000.0)
    np.testing.assert_allclose(cut.keyframes[-1].position, cam.position)


SMALL = ["--width", "64", "--height", "64", "--splats", "32", "--lods", "2",
         "--seconds", "0.5", "--map-half", "6", "--device", "cpu"]


def test_headline_small_on_the_cpu(capsys):
    out = headline.main(SMALL + ["--repeats", "2", "--dense-splats", "0"])
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert last == json.loads(json.dumps(out))
    assert set(last) == {"metric", "value", "unit", "meta"}
    meta = last["meta"]
    assert last["unit"] == "fps" and last["value"] > 0
    assert len(meta["median_frame_ms"]) == 2 and len(meta["frames"]) == 2
    assert meta["spread"]["min"] == min(meta["median_frame_ms"])
    assert meta["spread"]["max"] == max(meta["median_frame_ms"])
    assert last["value"] == pytest.approx(
        1000.0 / sorted(meta["median_frame_ms"])[0])
    assert min(meta["frames"]) > 0 and meta["n_pairs"] > 0
    assert meta["device"] == "cpu" and meta["dense"] is None
    assert meta["launches_per_frame"] == {}  # no kernel launches on the CPU
    for key in ("sort_ms", "build_ms", "sort_trigger", "builder_load",
                "setup_s", "interactive_latency_ms"):
        assert np.isfinite(meta[key]), key
    assert meta["interactive_latency_ms"] > 0
    assert sum(ln.startswith("[bench] run ") for ln in lines) == 2
    assert all(ln.startswith("[bench]") for ln in lines[:-1])


def test_dense_row_small_on_the_cpu():
    d = headline.dense_row(64, 64, torch.device("cpu"), splats=64, n_lod=2,
                           map_half=6, n_frames=8)
    assert set(d) == {"fps", "frame_ms", "n_pairs", "stall_discards",
                      "setup_s"}
    assert d["fps"] > 0 and d["n_pairs"] > 0 and d["stall_discards"] == 0
