#!/usr/bin/env python
"""Same-session A/B of the proxy pass's resolution divisor
(RendererConfig.proxy_res_div) in the fast profile.

    python -m gswt_renderer_tpu_torch.benchmarks.proxydiv_ab [-n 12] [--divs 2 4]

The fast profile renders the proxy ground (triangle raster, mip-pyramid
sampler) at 1/div of the frame's resolution and upsamples it; its auto
divisor is 2. On ``profile_frame.build``'s scene, one Renderer per divisor
draws the staged sort: 4 untimed frames, then `-n` device-complete frames
(host clock, stopped after a synchronize). Prints each divisor's median with
the min-max spread, and each later divisor's image against the first one's:
max and mean |diff| and the share of pixels off by more than 8/255. Returns
one row per divisor. Runs on the card unless given --device cpu; the size
arguments exist so a test can run it small.
"""

from __future__ import annotations

import argparse

from .profile_frame import build_from, scene_args
from .timing import device_complete_ms, fmt, open_device, spread


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", type=int, default=12, help="timed frames")
    ap.add_argument("--divs", type=int, nargs="+", default=[2, 4])
    scene_args(ap)
    args = ap.parse_args(argv)
    device = open_device(args.device, "[proxydiv_ab]")
    bench = build_from(args, device)
    rows, base = [], None
    for div in args.divs:
        r, staged, _ = bench.renderer(proxy_res_div=div)
        ts = spread(device_complete_ms(lambda: bench.frame(r, staged),
                                       r.drain, args.n, warm=4))
        img = bench.frame(r, staged)
        row = dict(div=div, frame_ms=ts,
                   proxy_pairs=int(r.last_aux["proxy_pairs"]))
        if base is None:
            base = img
        else:
            diff = (img - base).abs()
            row.update(vs_div=args.divs[0], max_diff=float(diff.max()),
                       mean_diff=float(diff.mean()),
                       share_over_8=float(
                           (diff.amax(dim=-1) > 8 / 255).float().mean()))
        rows.append(row)
        print(f"[proxydiv_ab] div {div}: {fmt(ts)}; proxy pairs "
              f"{row['proxy_pairs']}"
              + (f"; against div {args.divs[0]}: max |diff| "
                 f"{row['max_diff']:.4f} ({row['max_diff'] * 255:.1f}/255), "
                 f"mean |diff| {row['mean_diff']:.6f}, pixels over 8/255 "
                 f"{row['share_over_8']:.3%}" if "max_diff" in row else ""),
              flush=True)
    return rows


if __name__ == "__main__":
    main()
