#!/usr/bin/env python
"""Micro-benchmark of the background passes the full config adds to the
frame, each alone, and of raw gathers as reference points.

    python -m gswt_renderer_tpu_torch.benchmarks.micro_background [-n 8] [--reps 10]

At 1920x1080 (the size arguments change it), the camera at the fly path's
t = 0 pose, timed with CUDA events (the host clock on the CPU) as `-n`
windows of `--reps` back-to-back calls after a warm-up call, each window's
ms per call, reported as the median with the min-max:
  - three raw gathers (``table[idx]``), library calls and marked so:
    W*H indices into a 2^20 table of 1 and of 4 components, W*H/4 of 4;
  - ``ops/skybox.render_skybox`` of the bench skybox (the ray directions
    and the bilinear sampler kernel);
  - the proxy grid raster alone (``ops/proxy.raster_map_grid``: the grid's
    plane set-up, the pair expansion, the triangle raster kernel and its
    fold) on the 97x97 map over a random 1024x1024 height map;
  - the mip sampler alone (``ops/texsample.factored_mip_trilinear``, the
    pyramid kernel) of the bench proxy texture at a random uv field.
Prints one line per pass and returns the rows. Runs on the card unless
given --device cpu; the size arguments exist so a test can run it small.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core import Camera
from ..core.camera import CameraUniforms
from ..core.config import RenderConfig
from ..io.textures import build_mip_chain
from ..ops.binning import fit_capacity
from ..ops.proxy import _uv_footprint, make_map_grid, raster_map_grid
from ..ops.skybox import render_skybox
from ..ops.texsample import (
    factored_mip_trilinear, pack_pyramid, sampler_pyramid)
from ..render.pipeline import Renderer
from ..render.uniforms import SceneParams
from .headline import KEYFRAMES, bench_textures, bench_user_data
from .timing import event_ms, open_device, spread


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", type=int, default=8, help="timed windows")
    ap.add_argument("--reps", type=int, default=10, help="calls a window")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--map-half", type=int, default=48)
    ap.add_argument("--hm", type=int, default=1024,
                    help="side of the random height map")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = open_device(args.device, "[micro_background]")
    w, h = args.width, args.height
    rng = np.random.default_rng(0)

    def dev(a):
        return torch.as_tensor(a).to(device)

    ud = bench_user_data(args.map_half)
    _, pos, target = KEYFRAMES[0]
    cam = Camera((w, h), np.asarray(pos, np.float32), target,
                 (0.0, 0.0, 1.0), np.deg2rad(45.0), 0.1, 2400.0)
    rc = RenderConfig.new(1)
    sp = SceneParams.from_data(ud, np.zeros(2, np.int64), rc)
    scene_d, cam_d = Renderer.unpack_frame_uniforms(dev(
        Renderer.pack_frame_uniforms(sp, CameraUniforms(cam), [True] * 16,
                                     rc.culling_dist)))[:2]
    sky, checker = bench_textures()
    sky = dev(np.asarray(sky, np.float32))
    gv, gt = make_map_grid(ud.tile_map_wh, ud.tile_map_half_wh,
                           ud.tile_width)
    gv, gt = dev(gv), dev(gt)
    hm4 = dev(rng.random((4, args.hm * args.hm), np.float32))
    pyr, pyr_meta, l_min = pack_pyramid(build_mip_chain(checker))
    pyr = sampler_pyramid(dev(pyr).to(torch.bfloat16))
    u = dev(rng.random((h, w), np.float32) * 4)
    v = dev(rng.random((h, w), np.float32) * 4)
    rho = _uv_footprint(u, v, float(checker.shape[1]), float(checker.shape[0]))
    p = w * h
    idx = dev(rng.integers(0, 1 << 20, p).astype(np.int64))
    tab1 = dev(rng.random(1 << 20, np.float32))
    tab4 = dev(rng.random((4, 1 << 20), np.float32))
    idx4 = idx[: p // 4]

    grid = dict(surface_type=1, height_offset=0.0, tile_wh=(64, 32),
                chunk=128)
    # the grid raster into the slots of its demand (a first call reads it)
    grid["capacity"] = fit_capacity(raster_map_grid(
        cam_d, scene_d, (w, h), hm4, (args.hm, args.hm), gv, gt,
        capacity=128, **grid)[5], 128)

    passes = (
        (f"gather {p} idx x 1 comp", True, None, lambda: tab1[idx]),
        (f"gather {p} idx x 4 comp", True, None, lambda: tab4[:, idx]),
        (f"gather {p // 4} idx x 4 comp", True, None, lambda: tab4[:, idx4]),
        (f"skybox equirect {w}x{h}", False, "#5 bilinear",
         lambda: render_skybox(cam_d, (w, h), sky, equirect=True)),
        (f"proxy grid raster (z+uv) {w}x{h}", False, "#4 trirast + fold",
         lambda: raster_map_grid(
             cam_d, scene_d, (w, h), hm4, (args.hm, args.hm), gv, gt,
             **grid)),
        (f"mip trilinear sample {w}x{h}", False, "#6 mip_trilinear",
         lambda: factored_mip_trilinear(pyr, pyr_meta, l_min, u, v, rho,
                                        n_ch=3)),
    )
    rows = []
    for name, library, kernel, fn in passes:
        s = spread(event_ms(fn, args.n, device, reps=args.reps))
        rows.append(dict(name=name, library=library, kernel=kernel, **s))
        what = "library call" if library else f"touches {kernel}"
        print(f"[micro_background] {name}: median {s['median']:.4f} ms "
              f"(min-max {s['min']:.4f}-{s['max']:.4f}, {s['n']} windows of "
              f"{args.reps}); {what}", flush=True)
    return rows


if __name__ == "__main__":
    main()
