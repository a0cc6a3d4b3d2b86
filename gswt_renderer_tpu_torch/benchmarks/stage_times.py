#!/usr/bin/env python
"""Stage split of the fixed-camera bench frame's splat path, by cumulative
sub-pipelines.

    python -m gswt_renderer_tpu_torch.benchmarks.stage_times [-n 10]

On ``profile_frame.build``'s scene and the plan staged once, it times:

  P   = cull_draws + assemble_and_project (block_gather),
  PB  = P + bin_pairs,
  PBR = PB + the compositor (raster; no proxy depth),

each over `-n` device-complete runs after warm-up: the host clock stopped
after a synchronize, and CUDA events around the same run (on the CPU the
host clock alone). The differences give each stage's cost. Prints their
medians with the min-max spread and returns them. Runs on the card unless
given --device cpu; the size arguments exist so a test can run it small.
"""

from __future__ import annotations

import argparse

import torch

from ..ops import raster
from .profile_frame import build_from, scene_args
from .timing import device_complete_ms, event_ms, open_device, spread


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", type=int, default=10, help="timed runs")
    scene_args(ap)
    args = ap.parse_args(argv)
    device = open_device(args.device, "[stage_times]")
    bench = build_from(args, device)
    r, staged, cam = bench.renderer()
    c = r.cfg
    image_wh, tile_wh = (c.width, c.height), (c.tile_w, c.tile_h)
    plan = r.upload_plan(staged)
    unpacked = r.unpack_frame_uniforms(r.pack_uniforms(cam, bench.sp,
                                                       bench.rc))
    depth_tiles = raster.image_to_depth_tiles(
        torch.ones((c.height, c.width), device=device), image_wh=image_wh,
        tile_wh=tile_wh)

    def p():
        return r._project(plan, unpacked, bench.sp, bench.rc)

    def pb():
        return r.bin_pairs(p(), depth_tiles, use_proxy=False)[0]

    def pbr():
        return raster.rasterize(pb(), depth_tiles, image_wh=image_wh,
                                tile_wh=tile_wh, chunk=c.chunk,
                                use_depth=False, exact=c.exact)

    rows = {}
    for name, fn in (("P", p), ("PB", pb), ("PBR", pbr)):
        wall = spread(device_complete_ms(fn, r.drain, args.n))
        ev = spread(event_ms(fn, args.n, device))
        rows[name] = dict(wall=wall, events=ev)
        print(f"[stage_times] {name:3s}: host wall median "
              f"{wall['median']:.3f} ms ({wall['min']:.3f}-{wall['max']:.3f}),"
              f" events median {ev['median']:.3f} ms ({ev['min']:.3f}-"
              f"{ev['max']:.3f}), n {args.n}", flush=True)
    for label, a, b in (("project", None, "P"), ("binning", "P", "PB"),
                        ("raster", "PB", "PBR")):
        d = {k: rows[b][k]["median"] - (rows[a][k]["median"] if a else 0.0)
             for k in ("wall", "events")}
        rows[label] = d
        print(f"[stage_times] {label:8s} host wall {d['wall']:.3f} ms, "
              f"events {d['events']:.3f} ms (medians' difference)")
    return rows


if __name__ == "__main__":
    main()
