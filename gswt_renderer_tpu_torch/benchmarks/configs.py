#!/usr/bin/env python
"""The five BASELINE.md configurations, plus the dense-tile row (3d) and the
full config at 4K (4b), each through an Engine of its own at its own
viewport.

    python -m gswt_renderer_tpu_torch.benchmarks.configs [--quick]

1. a single Wang tile's scale, fixed camera, 512x512;
2. a 5x5 tile map, no merging, no LOD blending, 800x600;
3. the infinite terrain with selective merging, 1080p (97x97 map);
3d. as 3 over dense tiles (8192 splats per tile, 5 LODs, decay 4; the
   headline's dense row's stream budget, 1 << 23 lanes);
4. the full paper configuration, 3 plus the skybox and the proxy ground,
   1080p;
4b. 4 at 3840x2160;
5. batched cameras: 16 cameras (8 with --quick) of 3's scene at 1080p
   through parallel.batched.render_cameras_sharded over a process group of
   one (dp = 1, the one card), per camera, over 3 timed batches.

Each Engine is synchronous (its frame builds and sorts when the camera
moved) in the fast profile, RendererConfig(width, height) (3d: with the
larger stream budget); 512 splats per tile over 3 LODs. A row times 3
untimed frames, then 20 frames (5 with --quick), each after a small camera
step, each device-complete (host clock, stopped after a synchronize); 1's
camera stands still. Each prints one JSON line with the JAX script's keys
(config, frame_ms, fps, frames; 3d n_pairs; 5 batch, devices), frame_ms the
median, beside its min-max spread and the Engine's set-up seconds. Returns the rows. Runs on the card
unless given --device cpu; the size arguments exist so a test can run it
small (--width/--height stand for 1080p, the other viewports scale with
them).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..core import Camera, UserData
from ..core.config import (
    RenderConfig, SelectiveMergeType, SurfaceType, TileSortType)
from ..engine import Engine
from ..io.synth import synthetic_scene_vec
from ..parallel.batched import (
    group_of_one, pack_camera_batch, render_cameras_sharded)
from ..render.pipeline import RendererConfig
from ..render.uniforms import SceneParams
from .headline import bench_textures
from .profile_frame import scene_args
from .timing import open_device, spread

SMALL_MAP = dict(surface_type=SurfaceType.NONE,
                 merge_type=SelectiveMergeType.NONE,
                 tile_sort_type=TileSortType.DISTANCE, lod_blending=False,
                 lod_max_dist=8.0, height_map_scale=(1.0, 0.0))


def terrain(map_half):
    return dict(tile_map_half_wh=(map_half, map_half),
                surface_type=SurfaceType.HEIGHT_MAP, height_map_wh=(10, 10),
                height_map_scale=(1.0, 0.3), lod_max_dist=96.0,
                merge_dot_threshold=0.2, merge_topk=100)


def make_engine(scene_vec, viewport, device, *, full=False, **ud_kw):
    """A synchronous Engine at `viewport` in the fast profile, ready to
    render; with full, the skybox and the proxy ground set."""
    max_stream = ud_kw.pop("max_stream", RendererConfig.max_stream)
    eng = Engine(scene_vec, viewport=viewport, renderer_config=RendererConfig(
        width=viewport[0], height=viewport[1], max_stream=max_stream),
        synchronous=True, device=device)
    if full:
        sky, checker = bench_textures()
        eng.set_skybox(sky, equirect=True)
        eng.set_proxy(checker)
    eng.configure(UserData.from_ui(**ud_kw))
    if not eng.wait_ready(timeout_s=900.0):
        eng.shutdown()
        raise RuntimeError("the engine produced no frame")
    return eng


def time_frames(eng, move, n, warm=3) -> list:
    """Device-complete ms of n frames, each after the camera stepped by
    `move`, after `warm` untimed frames."""
    for _ in range(warm):
        eng.frame(readback=False)
    eng.renderer.drain()
    ts = []
    for _ in range(n):
        eng.camera.translate(move)
        t0 = time.perf_counter()
        if eng.frame(readback=False) is None:
            raise RuntimeError("the engine produced no frame")
        eng.renderer.drain()
        ts.append((time.perf_counter() - t0) * 1e3)
    return ts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="5 frames a row, 8 cameras in row 5")
    ap.add_argument("--dense-splats", type=int, default=8192,
                    help="splats per tile of row 3d")
    scene_args(ap)
    args = ap.parse_args(argv)
    device = open_device(args.device, "[configs]")
    n = 5 if args.quick else 20
    w, h = args.width, args.height

    def scaled(sw, sh):  # a viewport given at 1080p, scaled with --width
        return (max(sw * w // 1920, 16), max(sh * h // 1080, 16))

    sv = synthetic_scene_vec(n_lod=args.lods, splats_per_tile=args.splats,
                             seed=0)
    move = np.array([0.05, 0.1, 0.0], np.float32)
    still = np.zeros(3, np.float32)
    rows = []

    def emit(name, eng, ts, **extra):
        s = spread(ts)
        row = dict(config=name, frame_ms=s["median"],
                   fps=1000.0 / s["median"] if s["median"] > 0 else 0.0,
                   frames=s["n"], spread=dict(min=s["min"], max=s["max"]),
                   viewport=list(eng.camera.viewport), **extra)
        rows.append(row)
        print(f"[configs] {json.dumps(row)}", flush=True)

    runs = (
        ("1_single_tile_512", scaled(512, 512), sv,
         dict(tile_map_half_wh=(1, 1), **SMALL_MAP), False, still),
        ("2_terrain_4x4_800x600", scaled(800, 600), sv,
         dict(tile_map_half_wh=(2, 2), **SMALL_MAP), False, move),
        ("3_infinite_1080p", (w, h), sv, terrain(args.map_half), False,
         move),
        ("3d_dense_8k_5lod_1080p", (w, h), None,
         dict(terrain(args.map_half), max_stream=1 << 23), False, move),
        ("4_full_skybox_proxy_1080p", (w, h), sv, terrain(args.map_half),
         True, move),
        ("4b_full_skybox_proxy_4k", (2 * w, 2 * h), sv,
         terrain(args.map_half), True, move),
    )
    for name, vp, scene, ud_kw, full, step in runs:
        if scene is None:
            scene = synthetic_scene_vec(n_lod=5,
                                        splats_per_tile=args.dense_splats,
                                        lod_decay=4)
        t0 = time.perf_counter()
        eng = make_engine(scene, vp, device, full=full, **ud_kw)
        try:
            extra = dict(setup_s=time.perf_counter() - t0)
            ts = time_frames(eng, step, n)
            if name.startswith("3d"):
                extra["n_pairs"] = int(eng.renderer.last_aux["n_pairs"])
            emit(name, eng, ts, **extra)
        finally:
            eng.shutdown()
            del eng
            if device.type == "cuda":
                torch.cuda.empty_cache()

    # 5: its own 1080p Engine; the raster grid is the Renderer's, not the
    # cameras' viewport, so an engine of another size would render frames
    # of that size under this row's label
    b = 8 if args.quick else 16
    t0 = time.perf_counter()
    eng = make_engine(sv, (w, h), device, **terrain(args.map_half))
    setup_s = time.perf_counter() - t0
    try:
        r = eng.renderer
        rc = RenderConfig.new(eng.wang.n_tiles[0])
        sp = SceneParams.from_data(eng.config_user_data,
                                   eng.wang.center_coord, rc)
        cams = [Camera((w, h), np.array([i * 0.5, 0.0, 5.0], np.float32),
                       (i * 0.5, 30.0, 2.0), (0.0, 0.0, 1.0),
                       np.deg2rad(45.0), 0.1, 2400.0) for i in range(b)]
        cb = pack_camera_batch(r, sp, cams, rc)
        staged = eng._staged
        with group_of_one(device.type) as mesh:
            def batch():
                return render_cameras_sharded(r, staged, sp, cb, mesh, rc)
            batch()
            r.drain()
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                imgs = batch()
                r.drain()
                ts.append((time.perf_counter() - t0) * 1e3 / b)
        if tuple(imgs.shape) != (b, h, w, 4):
            raise RuntimeError(f"row 5 rendered {tuple(imgs.shape)}")
        emit("5_batched_cameras_1080p", eng, ts, batch=b, devices=1,
             setup_s=setup_s)
    finally:
        eng.shutdown()
    return rows


if __name__ == "__main__":
    main()
