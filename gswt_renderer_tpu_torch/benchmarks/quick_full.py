#!/usr/bin/env python
"""Quick fixed-camera timer of the full-config frame (skybox + proxy ground
+ splats, the fast profile) for same-session A/Bs.

    python -m gswt_renderer_tpu_torch.benchmarks.quick_full [-n 12] [--small] [--ab]

On ``profile_frame.build``'s scene (1080p; 960x540 with --small), a
Renderer of RendererConfig(width, height) renders the staged sort: a first
frame and 3 more untimed, then `-n` device-complete frames (host clock,
stopped after a synchronize). Prints the median with the min-max spread and
the frame's pair counts. --ab measures the sat cull off, on, then off
again, in that order: the second "off" shows the session's drift. Returns
one row per measurement. Runs on the card unless given --device cpu; the
size arguments exist so a test can run it small.
"""

from __future__ import annotations

import argparse

from ..render.pipeline import RendererConfig
from .profile_frame import build_from, scene_args
from .timing import device_complete_ms, fmt, open_device, spread


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", type=int, default=12, help="timed frames")
    ap.add_argument("--small", action="store_true", help="960x540")
    ap.add_argument("--ab", action="store_true",
                    help="sat cull off, on, off again")
    scene_args(ap)
    args = ap.parse_args(argv)
    if args.small:
        args.width, args.height = 960, 540
    device = open_device(args.device, "[quick_full]")
    bench = build_from(args, device)
    rows = []
    for sat in ((False, True, False) if args.ab
                else (RendererConfig.sat_cull,)):
        r, staged, _ = bench.renderer(sat_cull=sat)
        ts = spread(device_complete_ms(lambda: bench.frame(r, staged),
                                       r.drain, args.n, warm=4))
        aux = r.last_aux
        row = dict(sat_cull=sat, frame_ms=ts, n_pairs=int(aux["n_pairs"]),
                   n_pairs_kept=int(aux["n_pairs_kept"]),
                   n_live=int(aux["n_live"]),
                   proxy_pairs=int(aux["proxy_pairs"]))
        rows.append(row)
        print(f"[quick_full] {args.width}x{args.height} sat_cull={sat}: "
              f"{fmt(ts)}; pairs {row['n_pairs']}, kept "
              f"{row['n_pairs_kept']}, live {row['n_live']}, proxy pairs "
              f"{row['proxy_pairs']}", flush=True)
    return rows


if __name__ == "__main__":
    main()
