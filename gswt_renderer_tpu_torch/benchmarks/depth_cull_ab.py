#!/usr/bin/env python
"""Same-session A/B of the proxy-depth occlusion cull (RendererConfig.
depth_cull) on the full-config frame (skybox + proxy ground + splats, the
fast profile).

    python -m gswt_renderer_tpu_torch.benchmarks.depth_cull_ab [--dense] [-n 12]

Two Renderers, depth_cull off and on, over the one tile engine and the one
sort of ``profile_frame.build`` (--dense: the headline's dense tiles, 8192
splats per tile over 5 LODs), the plan staged once and drawn by both: 3
untimed frames each, then `-n` device-complete frames (host clock, stopped
after a synchronize). Prints and returns one JSON object: each side's
median and min-max spread, the speed-up of the medians, binning's n_pairs,
n_pairs_kept and n_live on both sides, and the image's mean alpha. Runs on
the card unless given --device cpu; the size arguments exist so a test can
run it small.
"""

from __future__ import annotations

import argparse
import json

from .profile_frame import build_from, scene_args
from .timing import device_complete_ms, open_device, spread


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", type=int, default=12, help="timed frames")
    ap.add_argument("--dense", action="store_true",
                    help="8192 splats per tile over 5 LODs")
    scene_args(ap)
    args = ap.parse_args(argv)
    device = open_device(args.device, "[depth_cull_ab]")
    bench = build_from(args, device, dense=args.dense)
    staged = None
    side = {}
    for dc in (False, True):
        r, own, _ = bench.renderer(depth_cull=dc)
        staged = staged or own  # one staged plan for both
        ts = spread(device_complete_ms(lambda: bench.frame(r, staged),
                                       r.drain, args.n, warm=3))
        img = bench.frame(r, staged)
        aux = r.last_aux
        side[dc] = dict(frame_ms=ts, n_pairs=int(aux["n_pairs"]),
                        n_pairs_kept=int(aux["n_pairs_kept"]),
                        n_live=int(aux["n_live"]),
                        alpha_mean=float(img[..., 3].mean()))
    off, on = side[False], side[True]
    out = dict(scene="dense" if args.dense else "headline",
               width=args.width, height=args.height, off=off, on=on,
               speedup=off["frame_ms"]["median"] / on["frame_ms"]["median"])
    print(f"[depth_cull_ab] {json.dumps(out)}", flush=True)
    return out


if __name__ == "__main__":
    main()
