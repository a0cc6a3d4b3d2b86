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
    """A section cannot synchronize the device: it reads the host clock and
    records events, and nothing in it waits (no synchronize, elapsed_time,
    query, item, tolist or cpu); only turning the profiler on and off does.
    The module imports the standard library, and torch only when the
    profiler is turned on."""
    tree = ast.parse(pathlib.Path(hostprof.__file__).read_text())
    top = {a.name for node in tree.body if isinstance(node, ast.Import)
           for a in node.names}
    top |= {node.module for node in tree.body
            if isinstance(node, ast.ImportFrom)}
    assert top <= {"__future__", "threading", "time", "warnings",
                   "collections"}, top
    waits = {"synchronize", "elapsed_time", "query", "item", "tolist", "cpu"}
    section = {node.name: node for node in ast.walk(tree)
               if isinstance(node, (ast.ClassDef, ast.FunctionDef))}
    for name in ("_hprof", "_event", "_current_stream", "_show",
                 "count_frame", "add", "annotate"):
        called = {n.func.attr for n in ast.walk(section[name])
                  if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
        assert not called & waits, (name, called & waits)


def test_nested_sections_count_self_time_per_thread(monkeypatch):
    """A section's self time is its time less that of the sections nested
    in it, each with the profiler's own work around it (its record, events
    and range): on a clock that ticks once a reading, the outer section
    reads 2 ticks to its inner one's entry and 2 from its exit, and the 2
    ticks of the inner section's own bookkeeping count in neither."""
    ticks = iter(range(1, 100))
    monkeypatch.setattr(hostprof, "time",
                        type("Clock", (), {"perf_counter": lambda: next(ticks)}))
    pipeline.set_host_prof(True)
    # outer: its work from tick 1, in at 2, out at 7; inner: its work from
    # 3, in at 4, out at 5, its work until 6
    with hostprof._hprof("outer"):
        assert hostprof.open_sections() == ("outer",)
        with hostprof._hprof("inner"):
            assert hostprof.open_sections() == ("outer", "inner")
    pipeline.set_host_prof(False)
    with hostprof._hprof("off"):
        assert hostprof.open_sections() == ()
    assert pipeline.HOST_PROF == {"outer": [1, 5, 2], "inner": [1, 1, 1]}
    assert [s.self_s for s in hostprof.trace().spans] == [2, 1]


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
    # the span log along the leg: the builder's sorts, drawn after they end
    assert res["sorts"] >= 1 and res["merged_groups"] >= 0
    assert res["sort_to_screen_ms"] > 0 and res["sort_to_screen_frames"] >= 0
    assert 0 < res["pairs_used_pct"] <= 100
    assert 0 < res["proxy_pairs_used_pct"] <= 100


def _span(name, frame, host=(0.0, 1.0), device=(None, None), **counters):
    return hostprof.Span(name, frame, 1, None, host[0], host[1], 0.0,
                         device[0], device[1], 0, counters)


def test_span_counts_reads_the_sorts_and_the_pair_counts():
    """profile_hostloop.span_counts on a planted log: two sorts, one drawn
    by a frame with device times (its device end counts), one never drawn;
    the pair shares over every frame's filed counts."""
    spans = (
        _span("frame", 1, (0.0, 0.010), (0.005, 0.030)),
        _span("stage.sort", 1, (0.001, 0.004), merged_groups=4, lru_hits=3,
              lru_misses=1, exact_splats=100, drawn_frame=3),
        _span("frame", 3, (0.020, 0.030), (0.040, 0.054)),
        _span("stage.sort", 3, (0.021, 0.025), merged_groups=2, lru_hits=0,
              lru_misses=2, exact_splats=300),
    )
    frames = {1: dict(n_pairs=30, capacity=60, proxy_pairs=5, proxy_capacity=10),
              3: dict(n_pairs=45, capacity=90)}
    got = profile_hostloop.span_counts(hostprof.Trace(spans, frames, 0, False, 0, {}))
    assert got == dict(sorts=2, merged_groups=3.0, exact_splats=200.0,
                       lru_hit_pct=50.0,
                       sort_to_screen_ms=pytest.approx(50.0),
                       sort_to_screen_frames=2.0, pairs_used_pct=50.0,
                       proxy_pairs_used_pct=50.0)
    empty = profile_hostloop.span_counts(hostprof.Trace((), {}, 0, False, 0, {}))
    assert empty["sorts"] == 0
    assert all(v is None for k, v in empty.items() if k != "sorts")


def test_add_counts_on_the_innermost_open_section():
    hostprof.add(lost=1)  # off: nothing to count on
    pipeline.set_host_prof(True)
    hostprof.add(lost=1)  # no section open
    with hostprof._hprof("outer") as outer:
        with hostprof._hprof("inner"):
            hostprof.add(hits=1, misses=0)
            hostprof.add(hits=2)
        hostprof.add(groups=5)
    hostprof.annotate(outer.span(), drawn_frame=7)
    pipeline.set_host_prof(False)
    assert [(s.name, s.counters) for s in hostprof.trace().spans] == [
        ("outer", {"groups": 5, "drawn_frame": 7}),
        ("inner", {"hits": 3, "misses": 0})]


# ---------------------------------------------------------------------- #
# the span log (hostprof.trace())


def _engine(synchronous: bool):
    eng = Engine(synthetic_scene_vec(n_lod=2, splats_per_tile=32),
                 viewport=(64, 64),
                 renderer_config=RendererConfig(width=64, height=64,
                                                max_draws=64, chunk=128),
                 synchronous=synchronous, device="cpu")
    sky, checker = headline.bench_textures(sky_hw=(16, 32), cells=8, cell=4)
    eng.set_skybox(sky)
    eng.set_proxy(checker)
    eng.configure(UserData.from_ui(**UI))
    assert eng.wait_ready(timeout_s=120)
    eng.renderer.drain()
    return eng


def _traced(eng, n=N, readback=False, move=lambda i: True):
    """n frames with the profiler on, the camera stepping before each frame
    i where move(i) and the builder given the pose only in those; returns
    (the trace, the frames' ids, last_aux after each frame)."""
    pipeline.set_host_prof(True)
    ids, auxes = [], []
    try:
        for i in range(n):
            if move(i):
                eng.camera.translate(STEP)
            eng.frame(update_worker=move(i), readback=readback)
            ids.append(eng.frame_id)
            auxes.append(eng.renderer.last_aux)
        eng.renderer.drain()
    finally:
        pipeline.set_host_prof(False)
    return hostprof.trace(), ids, auxes


def test_off_the_span_log_stays_empty():
    pipeline.set_host_prof(True)
    pipeline.set_host_prof(False)  # clears the log
    first = hostprof.current_frame()
    _frames(False)
    tr = hostprof.trace()
    assert tr.spans == () and tr.frames == {} and tr.dropped == 0
    assert tr.sync_sites == {} and pipeline.HOST_PROF == {}
    # the frames are still numbered: the Engine's configure frame and N
    assert hostprof.current_frame() == first + N + 1


def test_every_span_carries_its_frame_and_nests_in_it():
    eng = _engine(synchronous=True)
    try:
        tr, ids, _ = _traced(eng)
    finally:
        eng.shutdown()
    assert ids == list(range(ids[0], ids[0] + N))
    frames = {s.frame: i for i, s in enumerate(tr.spans) if s.name == "frame"}
    assert sorted(frames) == ids
    for i, s in enumerate(tr.spans):
        assert s.host_start <= s.host_end and 0.0 <= s.self_s
        assert s.device_start is None and s.syncs == 0  # no card
        if s.name == "render.drain" and s.parent is None:
            continue  # the drain after the last frame
        # its parents lie around it, back to its frame's span
        j, k = i, s.parent
        while k is not None:
            p = tr.spans[k]
            assert p.frame == s.frame and k < j
            assert p.host_start <= tr.spans[j].host_start <= tr.spans[j].host_end <= p.host_end
            j, k = k, p.parent
        assert j == frames[s.frame], (s.name, tr.spans[j].name)
    names = {s.name for s in tr.spans}
    assert {"render.front.project", "render.front.background",
            "render.front.skybox", "render.front.proxy", "render.front.bin",
            "render.back", "render.aux", "stage.sort"} <= names


def test_the_log_counts_and_self_times_equal_host_prof():
    eng = _engine(synchronous=False)
    try:
        tr, _, _ = _traced(eng)
    finally:
        eng.shutdown()
    assert tr.dropped == 0
    by = {}
    for s in tr.spans:
        n, own = by.get(s.name, (0, 0.0))
        by[s.name] = (n + 1, own + s.self_s)
    assert set(by) == set(pipeline.HOST_PROF)
    for name, (n, own) in by.items():
        assert n == pipeline.HOST_PROF[name][0], name
        assert own == pytest.approx(pipeline.HOST_PROF[name][2], rel=1e-9,
                                    abs=1e-12), name
    # two threads: the builder's stage.* spans apart from the render thread's
    render = {s.thread for s in tr.spans if s.name == "frame"}
    builder = {s.thread for s in tr.spans if s.name == "stage.sort"}
    assert len(render) == 1 and builder and not builder & render


@pytest.mark.parametrize("synchronous", [True, False], ids=["sync", "threaded"])
def test_builder_spans_carry_the_frame_whose_pose_they_were_given(synchronous):
    """The camera moves, and the builder is given its pose, only in every
    other frame: each sort and build works from such a frame's pose,
    carries its id, and is first drawn by a frame no earlier than it."""
    eng = _engine(synchronous)
    try:
        tr, ids, _ = _traced(eng, n=6, move=lambda i: i % 2 == 0)
    finally:
        eng.shutdown()
    moved = set(ids[0::2])
    sorts = [s for s in tr.spans if s.name == "stage.sort"]
    assert sorts and {s.frame for s in sorts} <= moved
    assert {s.frame for s in tr.spans if s.name == "stage.build"} <= moved
    for s in sorts:
        assert set(s.counters) >= {"merged_groups", "lru_hits", "lru_misses",
                                   "exact_splats"}
        assert s.counters["lru_hits"] + s.counters["lru_misses"] <= s.counters["merged_groups"]
    drawn = [s for s in sorts if "drawn_frame" in s.counters]
    assert drawn and all(s.counters["drawn_frame"] >= s.frame for s in drawn)
    if synchronous:  # sorted and drawn in the frame that moved
        assert {s.frame for s in sorts} == moved
        assert all(s.counters["drawn_frame"] == s.frame for s in sorts)
        # the staging of each sort on the render thread, in the same frame
        assert {s.frame for s in tr.spans if s.name == "stage.plan"} == moved


@pytest.mark.parametrize("readback", [True, False], ids=["depth0", "depth2"])
def test_each_frames_counts_are_its_last_aux(readback):
    """The counts filed under a frame's id are the ones it produced: at
    depth 0 last_aux right after it, at depth 2 last_aux two frames later,
    with the capacity its pair expansions were launched with."""
    eng = _engine(synchronous=True)
    try:
        tr, ids, auxes = _traced(eng, n=5, readback=readback,
                                 move=lambda i: False)
    finally:
        eng.shutdown()
    lag = 0 if readback else eng.pipeline_depth
    for i in range(lag, len(ids)):
        got = tr.frames[ids[i - lag]]
        assert {k: got[k] for k in auxes[i]} == auxes[i]
    for f in ids:
        c = tr.frames[f]
        assert c["capacity"] >= c["n_pairs"] > 0 and c["proxy_capacity"] > 0
        assert c["capacity"] % eng.renderer.cfg.chunk == 0


def test_flagged_syncs_count_on_the_innermost_section_every_time(monkeypatch):
    """The counting of PyTorch's flagged synchronising calls (on the card
    only; here its warnings planted): every occurrence from one line counts,
    each on the innermost section open on its thread or as unsectioned; the
    warning filters, showwarning and the debug mode are restored after."""
    import warnings
    modes = ["off"]
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    filters, show = list(warnings.filters), warnings.showwarning
    pipeline.set_host_prof(True)
    hostprof._count_syncs(True)
    try:
        def flag():
            warnings.warn(hostprof.SYNC_WARNING + " (planted)", UserWarning)
        with hostprof._hprof("outer"):
            flag()
            with hostprof._hprof("sync.known"):
                for _ in range(3):
                    flag()
            with warnings.catch_warnings(record=True) as other:
                warnings.simplefilter("always")
                warnings.warn("another warning", UserWarning)
        flag()
    finally:
        hostprof._count_syncs(False)
        pipeline.set_host_prof(False)
    assert modes == ["off", "warn", 0]
    assert warnings.filters == filters and warnings.showwarning is show
    tr = hostprof.trace()
    syncs = {s.name: s.syncs for s in tr.spans}
    assert syncs == {"outer": 1, "sync.known": 3}
    assert tr.unsectioned_syncs == 1 and sum(tr.sync_sites.values()) == 5
    assert {k[0] for k in tr.sync_sites} == {"outer", "sync.known", None}
    assert len(other) == 1  # other warnings pass through


def test_the_log_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(hostprof, "LOG_CAP", 3)
    pipeline.set_host_prof(True)
    with hostprof._hprof("outer"):
        for _ in range(4):
            with hostprof._hprof("inner"):
                pass
    pipeline.set_host_prof(False)
    tr = hostprof.trace()
    assert [s.name for s in tr.spans] == ["outer", "inner", "inner"]
    assert tr.dropped == 2 and [s.parent for s in tr.spans] == [None, 0, 0]
    assert pipeline.HOST_PROF["inner"][0] == 4  # the aggregates keep all
