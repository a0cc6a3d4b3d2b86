#!/usr/bin/env python
"""Camera batch and stream segments against the interactive frame, in one
session, gs-only 1080p on the bench scene.

    python -m gswt_renderer_tpu_torch.benchmarks.batched_ab [-b 4] [-n 8]

Times, each device-complete (host clock around the call and a synchronize),
the median over `-n` calls after warm-up calls:
  - interactive: Renderer.render per camera;
  - batch_same / batch_diff: render_cameras_sharded over a process group of
    one (dp = 1) on a batch of B identical / distinct cameras, per camera;
  - segments<N>: render_stream_segments, the frame cut into N stream
    segments rendered in turn on the one device and folded, after the cut's
    feedback has settled (four calls), with the pairs per segment and the
    max |err| against the single frame;
  - interactive2: the interactive frame again, for drift.
Prints one JSON line per variant and returns them. Runs on the card unless
given --device cpu; the size arguments exist so a test can run it small.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..core import Camera
from ..core.config import RenderConfig
from ..io.synth import synthetic_scene_vec
from ..parallel.batched import (
    group_of_one, pack_camera_batch, render_cameras_sharded,
    render_stream_segments)
from ..render.pipeline import Renderer, RendererConfig
from ..render.uniforms import SceneParams
from ..tiles import WangTileEngine
from .headline import bench_user_data
from .timing import device_complete_ms, open_device, spread


def _median_ms(fn, drain, n, warm=2):
    return spread(device_complete_ms(fn, drain, n, warm))["median"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-b", type=int, default=4, help="camera batch")
    ap.add_argument("-n", type=int, default=8, help="timed calls")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--splats", type=int, default=512)
    ap.add_argument("--lods", type=int, default=3)
    ap.add_argument("--map-half", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = open_device(args.device, "[batched_ab]")

    width, height = args.width, args.height
    eng = WangTileEngine(synthetic_scene_vec(
        n_lod=args.lods, splats_per_tile=args.splats, seed=0))
    ud = bench_user_data(args.map_half)
    eng.configure(ud)
    cam_pos = np.array([0.0, 0.0, 5.0], np.float32)
    eng.build_tiles(cam_pos)

    def camera_at(i):
        return Camera((width, height),
                      np.array([0.5 * i, 0.3 * i, 5.0], np.float32),
                      (0.5 * i, 30.0, 2.0), (0.0, 0.0, 1.0),
                      np.deg2rad(45.0), 0.1, 1000.0)

    camera = camera_at(0)
    dt = eng.sort_tiles(cam_pos, camera.view_proj())
    r = Renderer(eng, RendererConfig(width=width, height=height),
                 device=device)
    r.configure(ud)
    rc = RenderConfig.new(eng.n_tiles[0])
    sp = SceneParams.from_data(ud, eng.center_coord, rc)
    staged = r.stage(dt, camera, rc.culling_dist)
    results = []

    def emit(**row):
        results.append(row)
        print(json.dumps(row), flush=True)

    def iframe():
        return r.render(None, camera, sp, rc, staged=staged, as_numpy=False)

    inter_ms = _median_ms(iframe, r.drain, args.n, warm=3)
    single = iframe()
    emit(variant="interactive", ms_per_cam=inter_ms,
         n_pairs_kept=int(r.last_aux["n_pairs_kept"]))

    b = args.b
    with group_of_one(device.type) as mesh:
        for name, cams in (("batch_same", [camera] * b),
                           ("batch_diff", [camera_at(i) for i in range(b)])):
            cb = pack_camera_batch(r, sp, cams, rc)
            ms = _median_ms(lambda: render_cameras_sharded(
                r, staged, sp, cb, mesh, rc), r.drain, args.n) / b
            emit(variant=name, ms_per_cam=ms, batch=b,
                 vs_interactive=ms / inter_ms)

    for n_seg in (2, 4):
        for _ in range(4):  # the cut's feedback settles call over call
            img = render_stream_segments(r, staged, sp, camera, n_seg, rc)
        ms = _median_ms(lambda: render_stream_segments(
            r, staged, sp, camera, n_seg, rc), r.drain, args.n, warm=0)
        emit(variant=f"segments{n_seg}", ms=ms, vs_interactive=ms / inter_ms,
             pairs=r.last_shard_pairs_kept, bounds=r.last_sp_bounds,
             max_err=float((img - single).abs().max()))

    emit(variant="interactive2",
         ms_per_cam=_median_ms(iframe, r.drain, args.n))
    return results


if __name__ == "__main__":
    main()
