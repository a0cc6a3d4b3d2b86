#!/usr/bin/env python
"""Host-section profile of the pipelined bench frame loop.

    python -m gswt_renderer_tpu_torch.benchmarks.profile_hostloop [-n 48]
        [--depth 2] [--frozen]

Runs the headline's Engine (full config, the fast profile, the builder
thread on; ``headline.make_engine``), warms up on the fly path's first 15 s
leg, then renders `-n` frames along that leg without readback, as the
headline does, at Engine.pipeline_depth `--depth` (2, the Engine's: two
frames in flight; 0: each frame read at its end), with the host-section
profiler on (``render.pipeline.
set_host_prof``; it is off again when the script returns). Prints the wall
ms per frame (the clock stopped after a synchronize), the median gap
between two frames' dispatch, ``host_prof_report()``, and per frame the
render thread's host time the sections account for: the ``sync.*``
sections and ``render.drain`` (where the host waits for the device) apart
from the rest, and
the remainder no section covers; beside them the builder thread's work
(``stage.build``, ``stage.sort``, ``stage.plan``, ``stage.prep``), which
overlaps the frames, its load and
the pairs the last frame kept, and the profiled frames that overflowed a
pair budget (depth 2) or were rendered again for it (depth 0). From the
span log (``core/hostprof.py`` ``trace()``, ``span_counts``) it prints the
builder's sorts along the leg with their merge counters (merged groups, the
LRU's hits, splats sorted exactly), the time from a sort to the end of the
frame that first draws it, and the share of the pair slots the frames'
splat and proxy expansions were launched with that held a pair. --frozen
renders the same frames with the
builder frozen (Engine.lock_tile and lock_sort: no build, no sort, the
last sort drawn), which shows what the builder's work beside the frames
costs them. Runs on the card unless given --device cpu; the size arguments
exist so a test can run it small.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..core import hostprof
from ..io.synth import synthetic_scene_vec
from ..render import pipeline
from .headline import LEG_S, fly_path, make_engine
from .profile_frame import scene_args
from .timing import open_device

# the sections the builder thread records when the Engine has one
BUILDER_SECTIONS = ("stage.build", "stage.sort", "stage.plan", "stage.prep")


def account(prof: dict, n_frames: int, wall_ms: float) -> dict:
    """Per frame (ms), from HOST_PROF-shaped entries {name: [n, total_s,
    self_s]}: the render thread's accounted host time (the self time of
    every section but the builder's; frame.stage's nested staging counts
    to the render thread), its sync.* and render.drain waits, the rest,
    the unaccounted remainder of the wall time, and the builder's staging."""
    def per(s):
        return s * 1e3 / n_frames

    builder = sum(prof[k][2] for k in BUILDER_SECTIONS if k in prof)
    if "frame.stage" in prof:  # staging on the render thread
        builder -= prof["frame.stage"][1] - prof["frame.stage"][2]
    accounted = sum(e[2] for e in prof.values()) - builder
    waits = sum(e[2] for k, e in prof.items()
                if k.startswith("sync.") or k == "render.drain")
    return dict(accounted_ms=per(accounted), sync_ms=per(waits),
                rest_ms=per(accounted - waits),
                unaccounted_ms=wall_ms - per(accounted),
                builder_ms=per(builder))


def span_counts(tr) -> dict:
    """From a span log read after the profiler was turned off
    (hostprof.trace()): the builder's sorts (spans stage.sort), their mean
    merged groups and splats sorted exactly, the share of the merged groups
    the LRU served (%), the median time from a sort's end to the end of the
    frame that first drew it (the frame's device end on the card, else its
    host end; ms, and in frame ids from the frame whose pose it sorted
    for), and over the frames' filed counts the share of the launched pair
    slots that held a pair, splats and proxy (%). None where nothing was
    recorded."""
    def mean(v):
        return float(np.mean(v)) if v else None

    def share(num, den):
        pairs = [(c[num], c[den]) for c in tr.frames.values()
                 if c.get(den) and c.get(num) is not None]
        cap = sum(d for _, d in pairs)
        return sum(n for n, _ in pairs) / cap * 100.0 if cap else None

    frames = {s.frame: s for s in tr.spans if s.name == "frame"}
    sorts = [s for s in tr.spans if s.name == "stage.sort"]
    hits = sum(s.counters.get("lru_hits", 0) for s in sorts)
    looked = hits + sum(s.counters.get("lru_misses", 0) for s in sorts)
    ms, lag = [], []
    for s in sorts:
        f = frames.get(s.counters.get("drawn_frame"))
        if f is not None:
            end = f.host_end if f.device_end is None else f.device_end
            ms.append((end - s.host_end) * 1e3)
            lag.append(f.frame - s.frame)
    return dict(
        sorts=len(sorts),
        merged_groups=mean([s.counters["merged_groups"] for s in sorts
                            if "merged_groups" in s.counters]),
        exact_splats=mean([s.counters["exact_splats"] for s in sorts
                           if "exact_splats" in s.counters]),
        lru_hit_pct=hits / looked * 100.0 if looked else None,
        sort_to_screen_ms=float(np.median(ms)) if ms else None,
        sort_to_screen_frames=float(np.median(lag)) if lag else None,
        pairs_used_pct=share("n_pairs", "capacity"),
        proxy_pairs_used_pct=share("proxy_pairs", "proxy_capacity"))


def _fmt(v, spec=".3f"):
    return "-" if v is None else format(v, spec)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", type=int, default=48, help="profiled frames")
    ap.add_argument("--warm-stride", type=float, default=0.5,
                    help="seconds of path between warm-up frames")
    ap.add_argument("--frozen", action="store_true",
                    help="freeze the builder for the profiled frames")
    ap.add_argument("--depth", type=int, default=2,
                    help="frames in flight (Engine.pipeline_depth)")
    scene_args(ap)
    args = ap.parse_args(argv)
    device = open_device(args.device, "[hostloop]")
    eng = make_engine(synthetic_scene_vec(
        n_lod=args.lods, splats_per_tile=args.splats, lod_decay=2, seed=0),
        args.width, args.height, device, map_half=args.map_half)
    eng.pipeline_depth = args.depth
    try:
        fp = fly_path(LEG_S)
        fp.reset_path()
        fp.start_path()
        for t in np.arange(0.0, LEG_S + 0.01, args.warm_stride):
            fp.handle_events(eng.camera, now_ms=float(t) * 1000.0)
            eng.frame(readback=False)
        eng.renderer.drain()

        for ma in (eng.sort_time_ma, eng.build_time_ma, eng.sort_trigger_ma,
                   eng.build_trigger_ma):
            ma.clear()
        eng.lock_tile = eng.lock_sort = args.frozen
        overflow0, retries = eng.renderer.overflow_frames, 0
        pipeline.HOST_PROF.clear()
        pipeline.set_host_prof(True)
        try:
            fp.reset_path()
            fp.start_path()
            t0 = time.perf_counter()
            stamps = [t0]
            for i in range(args.n):
                fp.handle_events(eng.camera,
                                 now_ms=LEG_S * 1000.0 * i / args.n)
                eng.frame(readback=False)
                retries += eng.renderer.last_overflow_retries
                stamps.append(time.perf_counter())
            eng.renderer.drain()
            wall_ms = (time.perf_counter() - t0) * 1e3 / args.n
        finally:
            pipeline.set_host_prof(False)
        prof = {k: list(v) for k, v in pipeline.HOST_PROF.items()}
        spans = span_counts(hostprof.trace())
        gap_ms = float(np.median(np.diff(stamps))) * 1e3
        acc = account(prof, args.n, wall_ms)
        s_avg, s_trig = eng.sort_time_ma.calc()[0], eng.sort_trigger_ma.calc()[0]
        b_avg, b_trig = (eng.build_time_ma.calc()[0],
                         eng.build_trigger_ma.calc()[0])
        load = (s_avg * s_trig + b_avg * b_trig) / wall_ms
        kept = int(eng.renderer.last_aux["n_pairs_kept"])
        overflow = eng.renderer.overflow_frames - overflow0
    finally:
        eng.shutdown()
    print(f"[hostloop] {args.width}x{args.height}, {args.n} frames at depth "
          f"{args.depth}{', the builder frozen' if args.frozen else ''}: wall "
          f"{wall_ms:.3f} ms/frame (median dispatch gap {gap_ms:.3f} ms)")
    print(pipeline.host_prof_report())
    print(f"[hostloop] render thread per frame: sections "
          f"{acc['accounted_ms']:.3f} ms = sync waits {acc['sync_ms']:.3f} + "
          f"the rest {acc['rest_ms']:.3f}; unaccounted "
          f"{acc['unaccounted_ms']:.3f} ms; builder thread work "
          f"{acc['builder_ms']:.3f} ms/frame (overlapped)")
    print(f"[hostloop] builder_load {load:.3f}, n_pairs_kept {kept}, "
          f"overflow_frames {overflow}, overflow retries {retries}")
    print(f"[hostloop] builder: {spans['sorts']} sorts, merged groups "
          f"{_fmt(spans['merged_groups'], '.1f')}/sort, LRU hits "
          f"{_fmt(spans['lru_hit_pct'], '.1f')}%, splats sorted exactly "
          f"{_fmt(spans['exact_splats'], '.0f')}/sort; sort to screen "
          f"{_fmt(spans['sort_to_screen_ms'])} ms "
          f"({_fmt(spans['sort_to_screen_frames'], '.1f')} frames); pair "
          f"slots used {_fmt(spans['pairs_used_pct'], '.2f')}% splats, "
          f"{_fmt(spans['proxy_pairs_used_pct'], '.2f')}% proxy", flush=True)
    return dict(frames=args.n, frozen=args.frozen, depth=args.depth,
                wall_ms=wall_ms, overflow_frames=overflow,
                overflow_retries=retries,
                gap_ms=gap_ms,
                sections={k: dict(n=e[0], total_ms=e[1] * 1e3,
                                  self_ms=e[2] * 1e3)
                          for k, e in prof.items()},
                builder_load=load, n_pairs_kept=kept, **acc, **spans)


if __name__ == "__main__":
    main()
