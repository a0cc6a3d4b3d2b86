"""The port's host-section profiler (core/hostprof.py, re-exported by
render/pipeline.py) on the CPU at 64x64: off it records nothing and changes
no bit of the frame; on it records the frame loop's sections, once per
frame, and the sections both packages name alike count alike over the same
frames of the same scene; profile_hostloop accounts for a frame's wall time
with them."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from gswt_renderer_tpu.core import UserData as JaxUserData
from gswt_renderer_tpu.engine import Engine as JaxEngine
from gswt_renderer_tpu.io.synth import synthetic_scene_vec as jax_synth
from gswt_renderer_tpu.render import pipeline as jpipe
from gswt_renderer_tpu.render.pipeline import RendererConfig as JaxConfig
from gswt_renderer_tpu_torch.benchmarks import headline, profile_hostloop
from gswt_renderer_tpu_torch.core import UserData, hostprof
from gswt_renderer_tpu_torch.core.config import SurfaceType
from gswt_renderer_tpu_torch.engine import Engine
from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec
from gswt_renderer_tpu_torch.render import pipeline
from gswt_renderer_tpu_torch.render.pipeline import RendererConfig

UI = dict(tile_map_half_wh=(2, 2), lod_max_dist=8.0,
          surface_type=SurfaceType.HEIGHT_MAP, height_map_wh=(4, 4),
          height_map_scale=(1.0, 0.3))
FRONT = ("render.front.project", "render.front.skybox", "render.front.proxy",
         "render.front.bin")
N = 3
STEP = np.array([0.05, 0.1, 0.0], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _profiler_off():
    hostprof.HOST_PROF.clear()
    yield
    pipeline.set_host_prof(False)
    hostprof.HOST_PROF.clear()


def _frames(prof_on: bool):
    """N full-config frames of a small synchronous Engine, the camera
    stepping before each; the profiler on or off while they render."""
    eng = Engine(synthetic_scene_vec(n_lod=2, splats_per_tile=32),
                 viewport=(64, 64),
                 renderer_config=RendererConfig(width=64, height=64,
                                                max_draws=64, chunk=128),
                 synchronous=True, device="cpu")
    sky, checker = headline.bench_textures(sky_hw=(16, 32), cells=8, cell=4)
    eng.set_skybox(sky)
    eng.set_proxy(checker)
    eng.configure(UserData.from_ui(**UI))
    assert eng.frame() is not None
    pipeline.set_host_prof(prof_on)
    imgs = []
    for _ in range(N):
        eng.camera.translate(STEP)
        imgs.append(eng.frame())
    pipeline.set_host_prof(False)
    eng.shutdown()
    return imgs


def test_profiler_off_records_nothing_and_on_counts_each_frame():
    off = _frames(False)
    assert pipeline.HOST_PROF == {}
    on = _frames(True)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    prof = pipeline.HOST_PROF
    assert pipeline.HOST_PROF is hostprof.HOST_PROF
    # each frame read back: its plan uploaded, its counts sent to the host
    # after its last launch and read at its end (depth 0)
    for name in ("frame.update_pump", "frame.stage", "stage.plan",
                 "stage.prep", "render.uniforms", "render.plan",
                 "render.back", "sync.readback", "render.aux",
                 "sync.aux") + FRONT:
        assert prof[name][0] == N, (name, prof.get(name))
    for n, total, own in prof.values():
        assert n > 0 and total >= own >= 0.0
    # a section holds what is nested in it: the stage's plan and prep
    assert prof["frame.stage"][1] >= prof["stage.plan"][1] + prof["stage.prep"][1]
    report = pipeline.host_prof_report().splitlines()
    assert len(report) == len(prof)
    assert report[0].split()[0] == max(prof, key=lambda k: prof[k][1])


def test_the_profiler_reads_the_host_clock_only():
    """A section cannot synchronize the device: the profiler's module
    imports nothing but the standard library's threading and time."""
    tree = ast.parse(pathlib.Path(hostprof.__file__).read_text())
    names = {a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names}
    names |= {node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom)}
    assert names <= {"__future__", "threading", "time"}, names


def test_nested_sections_count_self_time_per_thread():
    pipeline.set_host_prof(True)
    with hostprof._hprof("outer"):
        assert hostprof.open_sections() == ("outer",)
        with hostprof._hprof("inner"):
            assert hostprof.open_sections() == ("outer", "inner")
            sum(range(20000))
    pipeline.set_host_prof(False)
    with hostprof._hprof("off"):
        assert hostprof.open_sections() == ()
    prof = pipeline.HOST_PROF
    assert set(prof) == {"outer", "inner"}
    n, total, own = prof["outer"]
    assert n == 1 and own == pytest.approx(total - prof["inner"][1], abs=1e-9)


def test_frame_sections_count_as_in_the_jax_engine(monkeypatch):
    """The same frames of the same scene through the JAX Engine with its
    profiler on (its module global _PROF_ON, which _hprof reads at each
    section) and through the port's: the sections named alike count
    alike."""
    counts = {}
    jax_prof = {}
    monkeypatch.setattr(jpipe, "HOST_PROF", jax_prof)
    monkeypatch.setattr(jpipe, "_PROF_ON", True)
    jeng = JaxEngine(jax_synth(n_lod=2, splats_per_tile=32), viewport=(64, 64),
                     renderer_config=JaxConfig(
                         width=64, height=64, max_draws=64,
                         max_stream=1 << 13, min_stream=1 << 11, chunk=128),
                     synchronous=True)
    jeng.configure(JaxUserData.from_ui(**UI))
    retries = 0
    for _ in range(N + 1):
        jeng.camera.translate(STEP)
        assert jeng.frame() is not None
        retries += int(getattr(jeng.renderer, "last_overflow_retries", 0))
    jeng.shutdown()
    counts["jax"] = {k: v[0] for k, v in jax_prof.items()}

    pipeline.set_host_prof(True)
    eng = Engine(synthetic_scene_vec(n_lod=2, splats_per_tile=32),
                 viewport=(64, 64),
                 renderer_config=RendererConfig(width=64, height=64,
                                                max_draws=64, chunk=128),
                 synchronous=True, device="cpu")
    eng.configure(UserData.from_ui(**UI))
    for _ in range(N + 1):
        eng.camera.translate(STEP)
        assert eng.frame() is not None
    eng.shutdown()
    pipeline.set_host_prof(False)
    counts["port"] = {k: v[0] for k, v in pipeline.HOST_PROF.items()}
    for name in ("frame.update_pump", "frame.stage", "stage.plan",
                 "stage.prep"):
        assert counts["port"][name] == counts["jax"][name] == N + 1, (
            name, counts, f"JAX retried {retries} overflowed frames")


def test_profile_hostloop_accounts_for_the_frame():
    res = profile_hostloop.main([
        "--device", "cpu", "--width", "64", "--height", "64", "--splats",
        "32", "--lods", "2", "--map-half", "4", "-n", "6",
        "--warm-stride", "5"])
    assert not hostprof._PROF_ON, "the script turns the profiler off again"
    assert res["frames"] == 6 and res["wall_ms"] > 0 and res["gap_ms"] > 0
    sec = res["sections"]
    for name in ("frame.update_pump", "render.uniforms", "render.back",
                 "render.aux") + FRONT:
        assert sec[name]["n"] == 6, (name, sec.get(name))
    # pipelined frames (depth 2): each completes the frames beyond the
    # depth, the script's drain the rest; none reads its counts at its end
    assert res["depth"] == 2 and sec["render.drain"]["n"] == 6 + 1
    assert "sync.aux" not in sec and res["overflow_frames"] >= 0
    # the builder thread stages the sorts; the render thread never does
    assert "frame.stage" not in sec and sec["stage.plan"]["n"] >= 1
    assert res["accounted_ms"] == pytest.approx(
        res["sync_ms"] + res["rest_ms"])
    assert res["accounted_ms"] + res["unaccounted_ms"] == pytest.approx(
        res["wall_ms"])
    # the sections cover nearly all of a frame's wall time
    assert 0 < res["accounted_ms"] <= res["wall_ms"] * 1.01
    assert res["unaccounted_ms"] < 0.25 * res["wall_ms"], res
    assert res["builder_ms"] > 0 and res["n_pairs_kept"] > 0
    assert res["builder_load"] >= 0
