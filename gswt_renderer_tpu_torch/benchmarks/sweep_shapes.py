#!/usr/bin/env python
"""Same-session sweep of the raster tile shape, chunk and ellipse-tile cull
on the headline's full frame (1080p, skybox + proxy, 512-splat tiles, the
fast profile).

    python -m gswt_renderer_tpu_torch.benchmarks.sweep_shapes [--grid 64x32x256,32x16x128c]

A grid entry is tile_w x tile_h x chunk; a trailing "c" asks for the exact
ellipse-tile cull (RendererConfig.cull_exact), which an entry without it
turns off. Why jointly: the compositor's per-pair work scales with the tile's
area, so smaller tiles cut it, but they grow the pair count, the binning
sort and the tiles' runs.

Method: one Engine per entry (the builder thread on), a warm-up walk of the
headline's first 15 s leg, a settle over its first 3 s, then `--frames`
pipelined frames along 3-15 s, stamped at dispatch and timed over 8-frame
windows, the clock stopped after a device synchronize. Per entry it prints
one `[sweep]` JSON line (median and mean window, pairs, set-up seconds, the
kernels' launches per timed frame) and at the end one JSON object of all of
them. An entry that raises fails the run. Runs on the card unless given
--device cpu; the size arguments exist so a test can run it small.
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import numpy as np

from ..engine import Engine
from ..io.synth import synthetic_scene_vec
from ..ops import kernels
from ..render.pipeline import RendererConfig
from .headline import LEG_S, bench_textures, bench_user_data, fly_path
from .timing import open_device

DEFAULT_GRID = ("64x32x256,64x32x256c,32x32x256,32x16x128,32x16x128c,"
                "16x16x128,16x16x128c")


def parse_grid(grid: str):
    """[(tile_w, tile_h, chunk, cull_exact)] of a comma-separated grid."""
    out = []
    for item in grid.split(","):
        item = item.strip()
        if not item:
            continue
        tw, th, ch = (int(x) for x in item.rstrip("c").split("x"))
        out.append((tw, th, ch, item.endswith("c")))
    return out


def run_config(scene_vec, tile_w, tile_h, chunk, cull, *, width, height,
               n_frames, map_half, warm_stride, device):
    t0 = time.time()
    eng = Engine(scene_vec, viewport=(width, height),
                 renderer_config=RendererConfig(
                     width=width, height=height, tile_w=tile_w,
                     tile_h=tile_h, chunk=chunk, cull_exact=cull),
                 synchronous=False, device=device)
    try:
        sky, checker = bench_textures()
        eng.set_skybox(sky, equirect=True)
        eng.set_proxy(checker)
        eng.configure(bench_user_data(map_half))
        if not eng.wait_ready(timeout_s=900):
            raise RuntimeError("the engine produced no frame")
        fp = fly_path(LEG_S)
        # warm-up walk: first launches, allocator pools
        fp.reset_path()
        fp.start_path()
        for t in np.arange(0.0, LEG_S + 0.01, warm_stride):
            fp.handle_events(eng.camera, now_ms=float(t) * 1000.0)
            eng.frame(readback=False)
        eng.renderer.drain()
        # settle the teleport's transition wave outside the timed window
        fp.reset_path()
        fp.start_path()
        for t in np.arange(0.0, 3.01, 0.25):
            fp.handle_events(eng.camera, now_ms=float(t) * 1000.0)
            eng.frame(readback=False)
        eng.renderer.drain()
        setup_s = time.time() - t0

        before = collections.Counter(kernels.LAUNCHES)
        stamps = [time.perf_counter()]
        for t in np.linspace(3.0, LEG_S, n_frames):
            fp.handle_events(eng.camera, now_ms=float(t) * 1000.0)
            eng.frame(readback=False)
            stamps.append(time.perf_counter())
        eng.renderer.drain()
        stamps.append(time.perf_counter())
        launches = kernels.LAUNCHES - before
        win = min(8, max(len(stamps) - 2, 1))
        wins = [(stamps[i + win] - stamps[i]) / win * 1e3
                for i in range(0, len(stamps) - win, win)]
        med = float(np.median(wins))
        aux = eng.renderer.last_aux
        return dict(
            frame_ms_median=med,
            frame_ms_mean=float(np.mean(wins)),
            fps=1000.0 / med if med > 0 else 0.0,
            n_windows=len(wins),
            n_pairs=int(aux["n_pairs"]),
            n_pairs_kept=int(aux["n_pairs_kept"]),
            setup_s=setup_s,
            launches_per_frame={k: v / n_frames
                                for k, v in sorted(launches.items())},
        )
    finally:
        eng.shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", default=DEFAULT_GRID,
                    help="tile_w x tile_h x chunk[c], comma-separated")
    ap.add_argument("--frames", type=int, default=96,
                    help="timed frames per entry")
    ap.add_argument("--warm-stride", type=float, default=0.5,
                    help="seconds of path between warm-up frames")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--splats", type=int, default=512)
    ap.add_argument("--lods", type=int, default=3)
    ap.add_argument("--map-half", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = open_device(args.device, "[sweep]")
    configs = parse_grid(args.grid)
    if not configs:
        ap.error("--grid names no entry")
    scene_vec = synthetic_scene_vec(n_lod=args.lods,
                                    splats_per_tile=args.splats,
                                    lod_decay=2, seed=0)
    results = {}
    for tw, th, ch, cull in configs:
        key = f"{tw}x{th}x{ch}" + ("c" if cull else "")
        res = run_config(scene_vec, tw, th, ch, cull, width=args.width,
                         height=args.height, n_frames=args.frames,
                         map_half=args.map_half,
                         warm_stride=args.warm_stride, device=device)
        results[key] = res
        print(f"[sweep] {key}: {json.dumps(res)}", flush=True)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
