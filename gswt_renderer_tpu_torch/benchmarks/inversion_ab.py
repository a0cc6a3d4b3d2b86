#!/usr/bin/env python
"""Does the frame time scale with the pixels and the pairs? 1080p against 4K
in one session, on one tile engine and one sort.

    python -m gswt_renderer_tpu_torch.benchmarks.inversion_ab [-n 8] [--res 1920x1080,3840x2160]

On ``profile_frame.build``'s scene, the tiles sorted once at the fly path's
t = 0 pose, one Renderer per resolution (RendererConfig(width, height), the
fast profile; the camera's pose the same at each, 16:9 at both) draws that
sort three ways: gs-only, gs + skybox, and the full config (+ the proxy
ground); each 1 untimed frame, then `-n` device-complete frames (host
clock, stopped after a synchronize). Per resolution it prints one JSON line:
each variant's median and min-max spread, and the full frame's live domains:
binning's n_pairs, n_pairs_kept and n_live, the compositor's (tile, chunk)
worklist entries and the proxy's pairs; the last line compares the last
resolution with the first (time, pixels, pairs). Runs on the card unless
given --device cpu; the size arguments exist so a test can run it small.
"""

from __future__ import annotations

import argparse
import json

from ..ops.binning import build_worklist
from .profile_frame import build_from, scene_args
from .timing import device_complete_ms, open_device, spread

VARIANTS = (("gs", False, False), ("gs+sky", True, False),
            ("full", True, True))


def parse_res(res: str):
    out = []
    for tok in res.split(","):
        wd, ht = tok.lower().split("x")
        out.append((int(wd), int(ht)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", type=int, default=8, help="timed frames")
    ap.add_argument("--res", default="1920x1080,3840x2160",
                    help="comma list of WxH to compare")
    scene_args(ap, sized=False)
    args = ap.parse_args(argv)
    device = open_device(args.device, "[inversion_ab]")
    resolutions = parse_res(args.res)
    bench = build_from(args, device, *resolutions[0])
    rows = []
    for w, h in resolutions:
        r, staged, cam = bench.renderer(w, h)
        row = dict(res=f"{w}x{h}", pixels=w * h)
        for name, sky, prox in VARIANTS:
            row[name] = spread(device_complete_ms(
                lambda: bench.frame(r, staged, cam, skybox=sky, proxy=prox),
                r.drain, args.n, warm=1))
        binned, _, _, aux = r.front(r.upload_plan(staged), cam, bench.sp,
                                    bench.rc, use_skybox=True, use_proxy=True)
        row.update(
            n_pairs=int(aux["n_pairs"]), n_pairs_kept=int(aux["n_pairs_kept"]),
            n_live=int(aux["n_live"]), proxy_pairs=int(aux["proxy_pairs"]),
            worklist_entries=int(build_worklist(
                binned["range_start"], binned["range_end"],
                chunk=r.cfg.chunk)["entry_tile"].numel()))
        rows.append(row)
        print(f"[inversion_ab] {json.dumps(row)}", flush=True)
        del r, binned
    a, b = rows[0], rows[-1]
    ratio = dict(full_ms=b["full"]["median"] / a["full"]["median"],
                 gs_ms=b["gs"]["median"] / a["gs"]["median"],
                 pixels=b["pixels"] / a["pixels"],
                 pairs_kept=b["n_pairs_kept"] / max(a["n_pairs_kept"], 1))
    print(f"[inversion_ab] {b['res']} against {a['res']}: "
          + ", ".join(f"{k} x{v:.3f}" for k, v in ratio.items()), flush=True)
    return dict(rows=rows, ratio=ratio)


if __name__ == "__main__":
    main()
