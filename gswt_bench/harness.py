"""Runs one cell of the benchmark once and prints its result line.

A cell (an entry of ``workloads`` in BENCHMARK.json) names a configuration
(``configs/<name>.json``), a traffic mix (``traffic/<name>.json``) and the
chips it needs; its limits are ``limits/<cell>.json``; every metric is read
by ``metrics/<metric>.py``. All of them are found by name, so a cell, a mix
or a metric is added as files and entries, with no edit here.

The loop is closed: one viewer, and a frame is dispatched as soon as the
previous ``Engine.frame(readback=False)`` returns (two frames in flight).
The camera follows the mix's path in real time. The window runs for
``--seconds`` and then drains. After it, a sample of the window's own frames,
drawn from the seed, is worked out again by the reference (reference/) and
compared; the run is `correct` when every compared number is within its
limit.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
# top-level modules that may not be loaded in the process that prints
FORBIDDEN = ("jax", "jaxlib", "flax", "gswt_renderer_tpu")
# the fly mix's warm-up steps along the path before the settle, seconds
WARM_STEP_S = 1.0
# still views: the builder is done once its draw list has not changed for
# this long (and at least STILL_FRAMES frames)
STILL_QUIET_S = 1.0
STILL_FRAMES = 10
# the traced slice of the window, as shares of it
TRACE_SLICE = (0.4, 0.6)
RASTER_KERNEL = re.compile(r"\braster_kernel\b")
# the builder's lag: a judged frame's draw list was sorted from a pose the
# viewer had at most this long before the frame
LAG_S = 2.0
# the builder rebuilds the map once the camera has moved this far from the
# last build (the user data's default, structure.rs:70-99)
UPDATE_DIST = 1.0
# the control's compositor type: the precision below the float32 that the
# configurations state for the composite
CONTROL_DTYPE = "bfloat16"


class Refused(Exception):
    """The run cannot measure (no card, too few cards, an unknown cell)."""


# ------------------------------------------------------------------ #
# names to files
# ------------------------------------------------------------------ #
def load_json(*parts):
    path = os.path.join(*parts)
    if not os.path.isfile(path):
        raise Refused(f"missing {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT) -> dict:
    return load_json(root, "BENCHMARK.json")


def cell_of(bench, workload) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise Refused(f"no workload {workload!r} in BENCHMARK.json")


def config(name, here=HERE) -> dict:
    return load_json(here, "configs", f"{name}.json")


def traffic(name, here=HERE) -> dict:
    return load_json(here, "traffic", f"{name}.json")


def limits(cell, here=HERE) -> dict:
    return load_json(here, "limits", f"{cell}.json")


def reader(metric, here=HERE):
    """The `read(ctx)` of metrics/<metric>.py."""
    path = os.path.join(here, "metrics", f"{metric}.py")
    if not os.path.isfile(path):
        raise Refused(f"no reader metrics/{metric}.py")
    spec = importlib.util.spec_from_file_location(f"gswt_bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench, cell, trace: bool) -> list:
    """The metrics a run of `cell` reports: its end-to-end ones, or with a
    trace its per-layer ones (those listing it, or, without a list, those
    that move an end-to-end metric it reports)."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]


# ------------------------------------------------------------------ #
# the run
# ------------------------------------------------------------------ #
def process_start_s() -> float:
    """This process's start on the time.time() clock (Linux /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def pose_at(trf, t):
    from .frozen.scene import mirrored_pose
    return mirrored_pose(trf["keyframes"], t)


def build_engine(cfg, raw, device):
    """The program under test, set up from the benchmark's inputs through
    its public entry points."""
    from gswt_renderer_tpu_torch.core import UserData
    from gswt_renderer_tpu_torch.core.config import SurfaceType
    from gswt_renderer_tpu_torch.engine import Engine
    from gswt_renderer_tpu_torch.io.ply import Scene, pack_splats
    from gswt_renderer_tpu_torch.render.pipeline import RendererConfig

    from .frozen.scene import bench_textures

    scene_vec = [[Scene(splat_count=d["position"].shape[0],
                        buffer=pack_splats(d["position"], d["log_scale"], d["color_dc"],
                                           d["alpha_logit"], d["rotation"]))
                  for d in lod] for lod in raw]
    w, h = cfg["width"], cfg["height"]
    eng = Engine(scene_vec, viewport=(w, h),
                 renderer_config=RendererConfig(width=w, height=h, **cfg["renderer"]),
                 synchronous=False, device=device)
    eng.pipeline_depth = int(cfg["pipeline_depth"])
    sky, checker = bench_textures((cfg["sky_h"], cfg["sky_w"]), cfg["checker_cells"],
                                  cfg["checker_cell"])
    if cfg["skybox"]:
        eng.set_skybox(sky, equirect=True)
    if cfg["proxy"]:
        eng.set_proxy(checker)
    half = cfg["tile_map_half"]
    eng.configure(UserData.from_ui(
        tile_map_half_wh=(half, half), tile_width=cfg["tile_width"],
        surface_type=SurfaceType.HEIGHT_MAP,
        height_map_wh=(cfg["height_map_w"], cfg["height_map_h"]),
        height_map_scale=(cfg["height_map_scale_xy"], cfg["height_map_scale_z"]),
        lod_max_dist=cfg["lod_max_dist"],
        lod_transition_width_ratio=cfg["lod_transition_width_ratio"],
        merge_dot_threshold=cfg["merge_dot_threshold"], merge_topk=cfg["merge_topk"],
        cache_size=cfg["cache_size"]))
    if not eng.wait_ready(timeout_s=600.0):
        eng.shutdown()
        raise RuntimeError("the engine produced no frame")
    return eng


def _set_pose(eng, trf, t, log):
    pos, tgt = pose_at(trf, t)
    eng.camera.set_view(pos, tgt, np.array([0.0, 0.0, 1.0], np.float32))
    log.append((time.perf_counter(), pos))


def candidate_poses(log, t, lag_s=LAG_S, update_dist=UPDATE_DIST):
    """The camera positions the builder may have worked from for the frame
    that started at `t`: its sort from a pose the viewer had within `lag_s`
    before (or the one in effect then), its build from any earlier pose
    within `update_dist` of those (a build waits until the camera has moved
    that far). `log`: (time, position) of every pose set, the startup pose
    first. Returns (build [K, 3], sort [K', 3])."""
    times = np.array([e[0] for e in log])
    pos = np.stack([e[1] for e in log]).astype(np.float32)
    upto = times <= t
    recent = upto & (times >= t - lag_s)
    before = np.where(upto & (times < t - lag_s))[0]
    if before.shape[0]:
        recent[before[-1]] = True
    sort = np.unique(pos[recent], axis=0)
    near = np.linalg.norm(pos[upto][:, None, :] - sort[None, :, :], axis=2).min(axis=1) \
        <= update_dist
    return np.unique(pos[upto][near], axis=0), sort


def warm_up(eng, trf, t0, log):
    """Set-up's frames: a still view waits for the builder to settle; a
    path is flown once through its whole period in steps, then over
    `settle_s` up to the window's start, so that every pair budget has
    grown and every kernel has run before the window."""
    if not trf["moving"]:
        _set_pose(eng, trf, t0, log)
        last, since, n = None, time.perf_counter(), 0
        while True:
            eng.frame(readback=False)
            n += 1
            if eng.cur_sort is not last:
                last, since = eng.cur_sort, time.perf_counter()
            if n >= STILL_FRAMES and time.perf_counter() - since >= STILL_QUIET_S:
                break
        eng.renderer.drain()
        return
    period = 2.0 * float(trf["keyframes"][-1][0] - trf["keyframes"][0][0])
    for t in np.arange(0.0, period, WARM_STEP_S):
        _set_pose(eng, trf, t0 + float(t), log)
        eng.frame(readback=False)
    for t in np.arange(-float(trf["settle_s"]), 0.0, float(trf["settle_step_s"])):
        _set_pose(eng, trf, t0 + float(t), log)
        eng.frame(readback=False)
    eng.renderer.drain()


def draw_arrays(dt) -> dict:
    """A frame's draw list as plain arrays (the program's DrawTable)."""
    keys = ("single_draw", "valid_lod_id", "changing", "changing_to_lower", "tile_lod",
            "offset", "corner_pos", "has_corners", "splat_count", "stream_start",
            "base_lod", "base_tile", "base_view", "stream_gs_index", "stream_map_id",
            "stream_lod_id", "tile_id", "map_coord")
    out = {k: (None if getattr(dt, k) is None else np.array(getattr(dt, k)))
           for k in keys}
    out["n_draws"] = int(dt.n_draws)
    return out


def preload_arrays(wang) -> dict:
    """The program's presorted (lod, tile, view) lists, flattened."""
    n_lod, n_tile, n_view = wang.n_tiles
    off = np.zeros((n_lod, n_tile, n_view), np.int64)
    cnt = np.zeros_like(off)
    idx, lod, p = [], [], 0
    for l in range(n_lod):
        for t in range(n_tile):
            for v in range(n_view):
                bd = wang.tile_base_data[l][t][v]
                off[l, t, v], cnt[l, t, v] = p, bd.splat_count
                idx.append(np.asarray(bd.gs_index))
                lod.append(np.asarray(bd.gs_lod_id))
                p += bd.splat_count
    return dict(index=np.concatenate(idx).astype(np.int64),
                lod=np.concatenate(lod).astype(np.int64), offset=off, count=cnt)


def _profiler():
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def run_window(eng, trf, t0, seconds, sample_at, trace, device, log):
    """The measured window. Returns the frame stamps, the judged frames'
    records and, with a trace, what was traced."""
    import torch

    from gswt_renderer_tpu_torch.core import hostprof

    cuda = device.type == "cuda"
    for ma in (eng.sort_time_ma, eng.sort_trigger_ma, eng.build_time_ma,
               eng.build_trigger_ma):
        ma.clear()
    overflow0 = eng.renderer.overflow_frames
    enter, ret, events, records = [], [], [], []
    samples = sorted(sample_at)
    prof, prof_frames, raised, last = None, [None, None], 0, None
    if trace:
        # a first session initialises the profiler outside the window
        with _profiler():
            eng.frame(readback=False)
        eng.renderer.drain()
        hostprof.HOST_PROF.clear()
        hostprof.set_host_prof(True)
    if cuda:
        torch.cuda.synchronize()
        anchor = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        anchor.record()
        anchor.synchronize()
        h1 = time.perf_counter()
        anchor_host = 0.5 * (h0 + h1)
    t_start = time.perf_counter()
    while True:
        now = time.perf_counter()
        el = now - t_start
        if el >= seconds:
            break
        if trace and prof is None and el >= TRACE_SLICE[0] * seconds and prof_frames[0] is None:
            prof = _profiler()
            prof.__enter__()
            prof_frames[0] = len(enter)
        if prof is not None and prof_frames[1] is None and el >= TRACE_SLICE[1] * seconds:
            prof.__exit__(None, None, None)
            prof_frames[1] = len(enter)
        now = time.perf_counter()
        enter.append(now)
        if trf["moving"]:
            _set_pose(eng, trf, t0 + (now - t_start), log)
        try:
            img = eng.frame(readback=False)
        except Exception as exc:  # a frame that raises counts as failed
            raised += 1
            print(f"[bench] frame {len(enter) - 1} raised: {exc!r}", file=sys.stderr)
            img = None
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        ret.append(time.perf_counter())
        if img is not None:
            last = dict(index=len(enter) - 1, t=now, image=img,
                        position=eng.camera.position.copy(),
                        target=eng.camera.target.copy(), draw=eng.cur_sort,
                        center_coord=np.array(eng.cur_scene.center_coord))
            if samples and el >= samples[0]:
                samples.pop(0)
                records.append(last)
    if prof is not None and prof_frames[1] is None:
        prof.__exit__(None, None, None)
        prof_frames[1] = len(enter)
    eng.renderer.drain()
    t_end = time.perf_counter()
    # a sample drawn after the last frame's start judges the last frame
    if samples and last is not None and (not records or records[-1] is not last):
        records.append(last)
    for r in records:
        r["draw"] = draw_arrays(r["draw"])
    if trace:
        hostprof.set_host_prof(False)
    done = None
    if cuda:
        done = completion_times(anchor_host, [anchor.elapsed_time(ev) for ev in events])
    return dict(
        t_start=t_start, t_end=t_end, enter=np.array(enter), ret=np.array(ret),
        done=done,
        overflow=eng.renderer.overflow_frames - overflow0, raised=raised,
        records=records, prof=prof, prof_frames=prof_frames,
        host_prof={k: list(v) for k, v in hostprof.HOST_PROF.items()} if trace else None,
        sort_ms=eng.sort_time_ma.calc()[0] if eng.sort_trigger_ma.calc()[0] > 0 else None,
    )


def completion_times(anchor_host, elapsed_ms):
    """Device completion of each frame on the host clock: the anchor's host
    time plus each frame's event's milliseconds after the anchor event."""
    return anchor_host + np.asarray(elapsed_ms, float) / 1e3


def read_trace(prof) -> dict:
    """The traced slice's device operations (name, start, duration, in
    seconds), sorted by start, and its stage annotations on the host."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    dev_ops, launches, stages = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev_ops.append((e.get("name", ""), e["ts"] * 1e-6, e.get("dur", 0) * 1e-6,
                            e.get("args", {}).get("correlation"), cat == "kernel"))
        elif cat == "cuda_runtime":
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = e["ts"] * 1e-6
        elif cat == "user_annotation" and str(e.get("name", "")).startswith("gswt."):
            stages.append((e["name"], e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6))
    dev_ops.sort(key=lambda o: o[1])
    return dict(ops=dev_ops, launches=launches, stages=stages)


def device_summary(tr) -> dict:
    """Busy and window seconds of the traced slice, and the breakdown: the
    device operations that took most time, and the longest idle gaps named
    by the stage the host was dispatching when the gap ended."""
    ops = tr["ops"]
    if not ops:
        return dict(busy_s=0.0, window_s=0.0, kernels=0, breakdown=None)
    start = ops[0][1]
    end = max(o[1] + o[2] for o in ops)
    busy, cur_s, cur_e = 0.0, ops[0][1], ops[0][1] + ops[0][2]
    gaps = []
    for name, s, d, corr, _ in ops[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((s - cur_e, corr, name))
            cur_s, cur_e = s, s + d
        else:
            cur_e = max(cur_e, s + d)
    busy += cur_e - cur_s
    by_name = {}
    for name, _, d, _, _ in ops:
        by_name[name] = by_name.get(name, 0.0) + d
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    named = {}
    for g, corr, name in gaps:
        t = tr["launches"].get(corr)
        label = None
        if t is not None:
            inner = [s for s in tr["stages"] if s[1] <= t <= s[2]]
            if inner:
                label = min(inner, key=lambda s: s[2] - s[1])[0]
        label = label or f"before {name[:80]}"
        named.setdefault(label, []).append(g)
    top_gaps = sorted(((k, max(v)) for k, v in named.items()), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy, window_s=end - start,
                kernels=sum(1 for o in ops if o[4]),
                breakdown=dict(device_ops=[[n[:160], s] for n, s in top_ops],
                               idle_gaps=[[n, s] for n, s in top_gaps]),
                raster_s=[o[2] for o in ops if RASTER_KERNEL.search(o[0])])


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(workload, seed, seconds, trace, *, device="cuda", root=ROOT, here=HERE,
             t_process=None, engine_hook=None, control=False) -> dict:
    """One run of a cell; returns the result line's object. `engine_hook`
    (tests only) gets the Engine before the warm-up. With `control` the
    judged frames are replaced by the control: the reference itself with a
    compositor that carries each pixel's transmittance and colour front to
    back in CONTROL_DTYPE (control.py)."""
    import torch

    from .frozen import peaks, synth
    from .reference import camera as ref_camera
    from .reference import drawlist as ref_drawlist
    from .reference import frame as ref_frame
    from .reference import store as ref_store

    t_process = time.time() if t_process is None else t_process
    bench = benchmark(root)
    cell = cell_of(bench, workload)
    cfg = config(cell["config"], here)
    trf = traffic(cell["traffic"], here)
    lim = limits(workload, here)
    mets = metrics_of(bench, cell, trace)
    dev = torch.device(device)
    rng = np.random.default_rng(int(seed))
    t0 = float(rng.uniform(*trf["pose_s"])) + (float(trf["settle_s"]) if trf["moving"] else 0.0)
    n_judge = int(trf["judged_frames"])
    lo, hi = TRACE_SLICE if trace else (0.0, 1.0)
    # judged frames at times drawn from the seed, inside the traced slice
    # when there is one (their pair tables give the compositor's bound)
    sample_at = sorted(float(seconds) * (lo + (hi - lo) * u) for u in rng.uniform(0.05, 0.95, n_judge))

    t_in = time.time()
    raw = synth.tile_set(n_lod=cfg["n_lod"], n_center_options=cfg["n_center_options"],
                         tile_width=cfg["tile_width"], splats_per_tile=cfg["splats_per_tile"],
                         seed=int(seed), lod_decay=cfg["lod_decay"])
    t_tiles = time.time()
    eng = build_engine(cfg, raw, dev)
    t_engine = time.time()
    try:
        if engine_hook is not None:
            engine_hook(eng)
        log = [(-np.inf, np.asarray(ref_camera.STARTUP_POSITION, np.float32))]
        warm_up(eng, trf, t0, log)
        setup_s = time.time() - t_process
        # where set-up went: start-up and imports, the tile set, the engine
        # (kernels loaded, presort, first build), the warm-up
        print(f"[bench] setup: start {t_in - t_process:.2f} s, tiles {t_tiles - t_in:.2f} s, "
              f"engine {t_engine - t_tiles:.2f} s, "
              f"warm-up {setup_s - (t_engine - t_process):.2f} s", file=sys.stderr)
        win = run_window(eng, trf, t0, float(seconds), sample_at, trace, dev, log)
        mem_peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
        preload = preload_arrays(eng.wang)
        prog_store = eng.wang.tile_splats_merged
        if prog_store.pos is None:
            prog_store.generate_arrays()
        prog_store = (np.array(prog_store.pos), np.array(prog_store.cov),
                      np.array(prog_store.rgba))
        prog_hm = np.array(eng.config_user_data.height_map)
        records = win.pop("records")
        for r in records:
            r["image"] = r["image"].detach().to("cpu")
        prof = win.pop("prof")
    finally:
        eng.shutdown()
    del eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    dev_sum = device_summary(read_trace(prof)) if prof is not None else None
    prof = None

    # --- the reference, once the program's state is freed ---
    t_ref = time.time()
    inputs = ref_frame.frame_inputs(cfg, raw, preload, dev)
    st = inputs["store"]
    compared = {}
    compared["store_rows_off"] = float(
        (st["pos"].shape[0] != prog_store[0].shape[0])
        or int(np.sum(np.any(st["pos"] != prog_store[0], axis=1)
                      | np.any(st["cov"] != prog_store[1], axis=1)
                      | np.any(st["rgba"] != prog_store[2], axis=1))))
    compared["height_map_off"] = float(np.abs(inputs["height_map"] - prog_hm).max()) \
        if prog_hm.shape == inputs["height_map"].shape else float("inf")
    bad_lists, inversions = ref_store.presort_inversions(
        st, preload["index"], preload["lod"], preload["offset"], preload["count"])
    compared["presort_lists_off"] = float(bad_lists)
    compared["presort_inversions"] = float(inversions)
    # each judged frame's draw list, held to the tile engine's semantics
    # before the reference renders from it (with its own tile corners)
    for k in ref_drawlist.NUMBERS:
        compared[k] = 0.0 if records else float("inf")
    for r in records:
        build, sort = candidate_poses(log, r["t"])
        scene = dict(inputs["scene"], center_coord=tuple(int(v) for v in r["center_coord"]))
        nums, corners = ref_drawlist.check(
            r["draw"], st, scene, inputs["height_map"], inputs["height_map_wh"],
            int(cfg["n_center_options"]), build, sort)
        for k, v in nums.items():
            compared[k] = max(compared[k], v)
        r["draw"]["corner_pos"] = corners
        r["draw"]["has_corners"] = np.ones(corners.shape[0], np.uint8)
    worst = {k: 0.0 for k in ref_frame.IMAGE_NUMBERS}
    bounds, judged = [], []
    for r in records:
        ref, kept, rows, far = ref_frame.render(
            inputs, r, min_t=peaks.MIN_T if trace else None)
        if control:
            r["image"] = ref_frame.render(inputs, r, control=getattr(torch, CONTROL_DTYPE))[0]
        nums = ref_frame.image_numbers(r["image"].to(dev), ref, far)
        for k in worst:
            worst[k] = max(worst[k], nums[k])
        judged.append(r["index"])
        if trace:
            bounds.append(peaks.raster_bound_s(kept, rows, cfg["width"] * cfg["height"],
                                               bool(cfg["proxy"]))[0])
        del ref, far
    for k, v in worst.items():
        compared[k] = v if records else float("inf")
    print(f"[bench] reference: {len(records)} frames judged in {time.time() - t_ref:.1f} s",
          file=sys.stderr)

    n_frames = int(win["enter"].shape[0])
    failed = int(win["overflow"]) + int(win["raised"])
    ctx = dict(win=win, cfg=cfg, trf=trf, seconds=float(seconds), setup_s=setup_s,
               n_frames=n_frames, device=dev_sum, judged=judged, bounds=bounds)
    metrics = {}
    for m in mets:
        v = reader(m["name"], here)(ctx)
        if v is not None:
            metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    check = {k: dict(value=v, limit=float(lim[k])) for k, v in compared.items()}
    correct = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in check.values())
    correct = correct and len(records) > 0
    device_info = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                       kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                       count=1, memory_peak_bytes=mem_peak)
    out = dict(correct=bool(correct), attempted=n_frames, failed=failed,
               metrics=metrics, device=device_info)
    if trace and dev_sum is not None:
        device_info["busy_s"] = dev_sum["busy_s"]
        device_info["window_s"] = dev_sum["window_s"]
        if dev_sum["breakdown"] is not None:
            out["breakdown"] = dev_sum["breakdown"]
    out["compared"] = check
    return out


def main(argv=None, t_process=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_process = process_start_s() if t_process is None else t_process
    try:
        cell = cell_of(benchmark(), args.workload)
        import torch
        if not torch.cuda.is_available():
            raise Refused("no CUDA device: the benchmark measures only on the card")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise Refused(f"{args.workload} needs {cell['chips']} cards, "
                          f"{torch.cuda.device_count()} present")
        out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                       t_process=t_process)
    except Refused as exc:
        print(f"[bench] refused: {exc}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"[bench] refused: the process has loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for k, c in out["compared"].items():
        print(f"[bench] compared {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
