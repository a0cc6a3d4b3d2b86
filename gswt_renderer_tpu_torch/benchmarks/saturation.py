#!/usr/bin/env python
"""The compositor's per-tile saturation and occlusion on one staged frame.

    python -m gswt_renderer_tpu_torch.benchmarks.saturation [--dense]

On ``profile_frame.build``'s scene (--dense: the headline's dense tiles),
one full-config frame (skybox + proxy ground + splats, the fast profile) is
rendered, then its front half again (``Renderer.front``: the pair table and
the proxy depth the compositor tests against), and the plain compositor
(``ops/raster.py rasterize_plain``, the kernel's decisions) walks the table
with its load recorded. Prints and returns one JSON object:
  - the (tile, chunk) worklist entries the early exit skips (every pixel of
    the tile already below MIN_T) and the pairs of the tiles' runs inside
    them;
  - per tile with a run of at least 4 entries, the share of its entries
    composited before it saturates (p10, p50, p90, mean);
  - the pairs whose z is at or behind the tile's largest proxy depth: they
    fail the depth test at every pixel, the most a pair-level depth cull
    could drop.
Runs on the card unless given --device cpu; the size arguments exist so a
test can run it small.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import raster
from .profile_frame import build_from, scene_args
from .timing import open_device


def occluded_pairs(binned, depth_tiles) -> int:
    """Pairs of the tiles' runs with z >= the tile's largest proxy depth."""
    rs = binned["range_start"].long()
    runs = binned["range_end"].long() - rs
    tile = torch.repeat_interleave(torch.arange(runs.numel(),
                                                device=runs.device), runs)
    first = torch.cumsum(runs, 0) - runs
    col = rs[tile] + torch.arange(tile.numel(), device=runs.device) - first[tile]
    z = binned["table"][6, col]
    return int((z >= depth_tiles.amax(dim=1)[tile]).sum())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dense", action="store_true",
                    help="8192 splats per tile over 5 LODs")
    scene_args(ap)
    args = ap.parse_args(argv)
    device = open_device(args.device, "[saturation]")
    bench = build_from(args, device, dense=args.dense)
    r, staged, cam = bench.renderer()
    bench.frame(r, staged)
    binned, _, depth_tiles, _ = r.front(
        r.upload_plan(staged), cam, bench.sp, bench.rc, use_skybox=True,
        use_proxy=True)
    c = r.cfg
    st = {}
    raster.rasterize_plain(
        binned, depth_tiles, image_wh=(c.width, c.height),
        tile_wh=(c.tile_w, c.tile_h), chunk=c.chunk, use_depth=True,
        exact=c.exact, stats=st)
    total = int(st["runs"].sum())
    occ = occluded_pairs(binned, depth_tiles)
    n_e = st["tile_entries"].cpu().numpy()
    needed = st["tile_needed"].cpu().numpy()
    long_ = n_e >= 4
    fracs = needed[long_] / n_e[long_]
    out = {
        "scene": "dense" if args.dense else "headline",
        "n_entries": st["entries"],
        "entries_skipped_by_saturation": st["skipped"],
        "skip_frac_entries": st["skipped"] / max(st["entries"], 1),
        "pairs_total": total,
        "pairs_composited": st["pairs"],
        "pairs_in_skipped_entries": st["skipped_pairs"],
        "skip_frac_pairs": st["skipped_pairs"] / max(total, 1),
        "pairs_fully_proxy_occluded": occ,
        "occ_frac_pairs": occ / max(total, 1),
        "tiles_with_runs_ge4_entries": int(long_.sum()),
        "needed_frac_per_tile": dict(
            p10=float(np.percentile(fracs, 10)),
            p50=float(np.percentile(fracs, 50)),
            p90=float(np.percentile(fracs, 90)),
            mean=float(fracs.mean())) if fracs.size else None,
    }
    print(f"[saturation] {json.dumps(out)}", flush=True)
    return out


if __name__ == "__main__":
    main()
