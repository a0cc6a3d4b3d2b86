#!/usr/bin/env python
"""Same-session A/B of the work-reduction culls on the full-config frame
(skybox + proxy ground + splats, the fast profile).

    python -m gswt_renderer_tpu_torch.benchmarks.cull_ab [-n 16] [--no-cull-exact]

At two cameras, the fly path's t = 0 pose and a mid-path one (its t = 10 s
key frame), the tiles of ``profile_frame.build``'s engine rebuilt and
re-sorted at each, four variants in turn, each a Renderer of its own: "off"
(depth_cull and sat_cull off), "dc" (depth_cull: the proxy-depth occlusion
cull), "sat" (depth_cull and sat_cull: the temporal saturation cull on
top), and "off2", the first again for the session's drift. Each takes 7
untimed frames first (the sat cut converges at a static camera,
the cull's best case), then `-n` device-complete frames (host clock,
stopped after a synchronize). --no-cull-exact turns off the exact
ellipse-tile cull (RendererConfig.cull_exact, on by default) in every
variant. Prints one JSON line per variant and camera: the median, the
min-max spread, and binning's n_pairs and n_pairs_kept. Runs on the card
unless given --device cpu; the size arguments exist so a test can run it
small.
"""

from __future__ import annotations

import argparse
import json

from .headline import KEYFRAMES
from .profile_frame import build_from, scene_args
from .timing import device_complete_ms, open_device, spread

VARIANTS = (("off", False, False), ("dc", True, False), ("sat", True, True),
            ("off2", False, False))
CAMERAS = (KEYFRAMES[0][1:], KEYFRAMES[2][1:])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", type=int, default=16, help="timed frames")
    ap.add_argument("--no-cull-exact", action="store_true",
                    help="turn off the exact ellipse-tile cull")
    scene_args(ap)
    args = ap.parse_args(argv)
    device = open_device(args.device, "[cull_ab]")
    bench = build_from(args, device)
    cull = not args.no_cull_exact
    rends = {name: bench.renderer(depth_cull=dc, sat_cull=sat,
                                  cull_exact=cull)[0]
             for name, dc, sat in VARIANTS}
    rows = []
    for ci, (pos, target) in enumerate(CAMERAS):
        bench.at(pos, target)
        for name, _, _ in VARIANTS:
            r = rends[name]
            staged = r.stage(bench.dt, bench.camera, bench.rc.culling_dist)
            ts = spread(device_complete_ms(lambda: bench.frame(r, staged),
                                           r.drain, args.n, warm=7))
            aux = r.last_aux
            row = dict(variant=name, cam=ci, cull_exact=cull, frame_ms=ts,
                       n_pairs=int(aux["n_pairs"]),
                       n_pairs_kept=int(aux["n_pairs_kept"]))
            rows.append(row)
            print(f"[cull_ab] {json.dumps(row)}", flush=True)
    return rows


if __name__ == "__main__":
    main()
