#!/usr/bin/env python
"""Headline benchmark: 1080p full-config (skybox + proxy ground) infinite-
terrain fly-through, frames per second on one device.

    python -m gswt_renderer_tpu_torch.benchmarks.headline [--repeats 3]

The reference's fly-path benchmark harness (gui.rs:955-997) on the paper's
full default configuration -- 97x97 tile map, tile width 4, Graph tile sort,
Edge merge topk=100 dot=0.2, LRU 1024, LOD blending (structure.rs:70-99) --
plus the skybox and proxy ground passes the reference's frame includes
(state.rs:384-401), over a synthetic Wang tile set (512 splats per tile, 3
LODs), in the renderer's default (fast) profile with the builder thread
running. A 60 s scripted path, four 15 s legs flown forth and back so the
camera never teleports inside a run, is replayed in real time through
``Engine.run_benchmark`` ``--repeats`` times in one process, each run after a
``settle`` that lets the teleport back to the start die down.

Prints ``[bench]`` lines (set-up, each run's median, the median and the
min-max spread over the runs, the interactive latency, the dense row: 8192
splats per tile, 5 LODs, splats only) and, as the last line, one JSON object
``{"metric", "value", "unit", "meta"}`` whose value is frames per second from
the median of the runs' median frame times. Frame times are host-clock spans
of 16-frame windows; the clock of a run stops after a device synchronize.
Runs on the card unless given ``--device cpu``; the size arguments exist so a
test can run it small.
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import numpy as np
import torch

from ..core import Camera, UserData
from ..core.config import SurfaceType
from ..engine import Engine, FlyPathControl, FlyPathFrame
from ..io.synth import synthetic_scene_vec
from ..ops import kernels
from ..render.pipeline import RendererConfig
from .timing import device_label

# one 15 s leg: (seconds, camera position, camera target)
KEYFRAMES = [
    (0.0, (0.0, 0.0, 5.0), (0.0, 30.0, 2.0)),
    (5.0, (6.0, 18.0, 5.0), (10.0, 48.0, 2.0)),
    (10.0, (2.0, 40.0, 6.0), (-20.0, 60.0, 1.0)),
    (15.0, (-10.0, 55.0, 5.0), (-30.0, 80.0, 2.0)),
]
LEG_S = KEYFRAMES[-1][0]


def bench_textures(sky_hw=(64, 128), cells=64, cell=8):
    """The skybox (a vertical HDR ramp, equirect [H, W, 3]) and the proxy
    ground texture (a checker of `cells` x `cells` cells of `cell` texels)."""
    sky = np.clip(
        np.linspace(0, 4, sky_hw[0])[:, None, None]
        * np.ones(tuple(sky_hw) + (3,), np.float32), 0, 4)
    c = np.kron(np.indices((cells, cells)).sum(0) % 2,
                np.ones((cell, cell))).astype(np.float32)
    return sky, np.stack([c * 0.8 + 0.1, c * 0.5 + 0.2, c * 0.3 + 0.1],
                         axis=-1)


def bench_user_data(map_half: int = 48) -> UserData:
    """The paper's default benchmark configuration (structure.rs:70-99,
    123-137), the height amplitude scaled for the synthetic set."""
    return UserData.from_ui(
        tile_map_half_wh=(map_half, map_half), tile_width=4.0,
        surface_type=SurfaceType.HEIGHT_MAP, height_map_wh=(10, 10),
        height_map_scale=(1.0, 0.3), lod_max_dist=96.0,
        lod_transition_width_ratio=0.05, merge_dot_threshold=0.2,
        merge_topk=100, cache_size=1024,
    )


def fly_path(seconds: float = 4 * LEG_S) -> FlyPathControl:
    """The scripted path: the leg of KEYFRAMES flown forth and back until
    `seconds` are covered. A length that ends inside a leg cuts the path
    there, at the pose the full path has at that time."""
    legs = max(int(np.ceil(seconds / LEG_S)), 1)
    path = []
    for r in range(legs):
        seg = KEYFRAMES if r % 2 == 0 else [
            (LEG_S - t, p, tgt) for (t, p, tgt) in reversed(KEYFRAMES)]
        for t, p, tgt in seg:
            tt = LEG_S * r + t
            if path and tt <= path[-1][0]:
                continue
            path.append((tt, p, tgt))
    fp = FlyPathControl()
    fp.keyframes = [FlyPathFrame(t, np.array(p, np.float32),
                                 np.array(tgt, np.float32))
                    for t, p, tgt in path]
    if seconds < path[-1][0]:
        cam = Camera.default((16, 16))
        fp.reset_path()
        fp.start_path()
        fp.handle_events(cam, now_ms=seconds * 1000.0)
        fp.keyframes = [k for k in fp.keyframes if k.timestamp < seconds]
        fp.keyframes.append(FlyPathFrame(seconds, cam.position.copy(),
                                         cam.target.copy()))
    fp.reset_path()
    return fp


def make_engine(scene_vec, width, height, device, *, map_half=48):
    """An asynchronous Engine on the benchmark configuration with the skybox
    and the proxy ground set, ready to render, in the fast profile
    (RendererConfig given the size and nothing else)."""
    eng = Engine(scene_vec, viewport=(width, height),
                 renderer_config=RendererConfig(width=width, height=height),
                 synchronous=False, device=device)
    sky, checker = bench_textures()
    eng.set_skybox(sky, equirect=True)
    eng.set_proxy(checker)
    eng.configure(bench_user_data(map_half))
    if not eng.wait_ready(timeout_s=300.0):
        eng.shutdown()
        raise RuntimeError("engine did not produce a frame")
    return eng


def settle(eng, fp, seconds: float = 6.0):
    """Replay the path's head until the teleport's LOD-transition wave has
    died down: every timed run takes the camera back to t = 0, which
    mass-triggers transitions (both LODs live at once) and can double the
    live splats for a few frames. Settling keeps that out of the timing."""
    fp.reset_path()
    fp.start_path()
    for t in np.arange(0.0, seconds + 0.01, 0.25):
        fp.handle_events(eng.camera, now_ms=float(t) * 1000.0)
        eng.frame(readback=False)
    eng.renderer.drain()
    fp.pause_path()


def check_frame(img, width: int, height: int) -> float:
    """Raise unless img is a finite [height, width, 4] frame with coverage.
    Returns the share of pixels whose alpha is not 1: over the opaque sky it
    is the half-res proxy's silhouette (its colour, alpha included, is
    upsampled bilinearly, its hit mask nearest)."""
    if img is None or tuple(img.shape) != (height, width, 4):
        raise RuntimeError("the last frame is missing or misshapen")
    if not bool(torch.isfinite(img).all()):
        raise RuntimeError("the last frame has non-finite pixels")
    if float(img[..., 3].mean()) <= 0.0:
        raise RuntimeError("the last frame has no coverage")
    return float(((img[..., 3] - 1.0).abs() > 1e-5).float().mean())


def interactive_latency_ms(eng, fp, n: int = 16) -> float:
    """What a viewer's user waits per displayed frame, up to the encoder:
    camera input -> rendered frame -> device-side 2x downscale and u8 cast
    -> copy to the host, each iteration serialized. Median of n."""
    fp.reset_path()
    fp.start_path()
    lat = []
    for i in range(n):
        t0 = time.perf_counter()
        fp.handle_events(eng.camera, now_ms=float(i) * 100.0)
        img = eng.frame(readback=False)
        small = torch.clamp(img[::2, ::2, :3] * 255.0, 0, 255).to(torch.uint8)
        small.cpu().numpy()
        lat.append((time.perf_counter() - t0) * 1e3)
    eng.renderer.drain()
    return float(np.median(lat))


def dense_row(width, height, device, *, splats=8192, n_lod=5, map_half=48,
              n_frames=64):
    """The density row: `splats` per tile over `n_lod` LODs (decay 4),
    splats only (no skybox, no proxy ground, unlike the headline's frame),
    with twice the default stream budget (the dense scene's visible stream
    is past the default 1 << 22 lanes and would be truncated), 12 warm-up
    and n_frames timed frames of a slow drift, timed over 8-frame windows
    like the headline."""
    t0 = time.time()
    sv = synthetic_scene_vec(n_lod=n_lod, splats_per_tile=splats, lod_decay=4)
    eng = Engine(sv, viewport=(width, height),
                 renderer_config=RendererConfig(width=width, height=height,
                                                max_stream=1 << 23),
                 synchronous=False, device=device)
    eng.configure(UserData.from_ui(
        tile_map_half_wh=(map_half, map_half),
        surface_type=SurfaceType.HEIGHT_MAP, height_map_wh=(10, 10),
        height_map_scale=(1.0, 0.3), lod_max_dist=96.0,
        merge_dot_threshold=0.2, merge_topk=100))
    if not eng.wait_ready(timeout_s=900.0):
        eng.shutdown()
        raise RuntimeError("the dense engine did not produce a frame")
    move = np.array([0.05, 0.1, 0.0], np.float32)
    for _ in range(12):
        eng.camera.translate(move)
        eng.frame(readback=False)
    eng.renderer.drain()
    t_warm = time.time()
    stamps = [time.perf_counter()]
    for _ in range(n_frames):
        eng.camera.translate(move)
        eng.frame(readback=False)
        stamps.append(time.perf_counter())
    eng.renderer.drain()
    stamps.append(time.perf_counter())
    win = 8
    wins = [(stamps[i + win] - stamps[i]) / win * 1e3
            for i in range(0, len(stamps) - win, win)]
    med = float(np.median(wins)) if wins else 0.0
    kept = [w for w in wins if w <= 3.0 * med] or wins
    ms = float(np.mean(kept)) if kept else med
    n_pairs = int(eng.renderer.last_aux["n_pairs"])
    eng.shutdown()
    return dict(fps=1000.0 / ms if ms > 0 else 0.0, frame_ms=ms,
                n_pairs=n_pairs, stall_discards=len(wins) - len(kept),
                setup_s=t_warm - t0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--splats", type=int, default=512,
                    help="splats per tile at LOD 0")
    ap.add_argument("--lods", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=4 * LEG_S,
                    help="length of the fly path (legs of 15 s)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed runs of the path")
    ap.add_argument("--map-half", type=int, default=48,
                    help="tile map half size (48: the 97x97 map)")
    ap.add_argument("--dense-splats", type=int, default=8192,
                    help="splats per tile of the dense row; 0 skips the row")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.repeats < 1:
        ap.error("--repeats must be at least 1")
    t_start = time.time()
    device = kernels.resolve_device(args.device)
    label = device_label(device)
    print(f"[bench] device: {label}", flush=True)
    if device.type == "cuda":
        kernels.build_all()

    scene_vec = synthetic_scene_vec(
        n_lod=args.lods, splats_per_tile=args.splats, lod_decay=2, seed=0)
    eng = make_engine(scene_vec, args.width, args.height, device,
                      map_half=args.map_half)
    fp = fly_path(args.seconds)
    settle(eng, fp)  # also the warm-up: first launches, allocator pools
    setup_s = time.time() - t_start
    print(f"[bench] {args.width}x{args.height}, {args.splats} splats/tile, "
          f"{args.lods} LODs, path {fp.keyframes[-1].timestamp:.1f} s; "
          f"set-up {setup_s:.1f} s", flush=True)

    runs, launches = [], collections.Counter()
    for i in range(args.repeats):
        if i:
            settle(eng, fp)
        before = collections.Counter(kernels.LAUNCHES)
        r = eng.run_benchmark(fp, readback=False)
        launches.update(kernels.LAUNCHES - before)  # the timed frames' only
        runs.append(r)
        print(f"[bench] run {i + 1}/{args.repeats}: median "
              f"{r['median_frame_ms']:.2f} ms over {r['n_windows']} windows "
              f"(clean mean {r['clean_frame_ms']:.2f}, {r['stall_windows']} "
              f"stall windows), {r['frames']} frames, {r['fps']:.2f} fps by "
              f"the wall clock; sort {r['sort_ms'][0]:.2f} ms x "
              f"{r['sort_trigger']:.3f}, build {r['build_ms'][0]:.2f} ms x "
              f"{r['build_trigger']:.3f}, builder load "
              f"{r['builder_load']:.3f}, overflow frames "
              f"{r['overflow_frames']}", flush=True)
    frames = sum(r["frames"] for r in runs)
    n_pairs = int(eng.renderer.last_aux["n_pairs"])
    alpha_off = check_frame(eng.last_image, args.width, args.height)
    print(f"[bench] {eng.hud_text()}")
    medians = [r["median_frame_ms"] for r in runs]
    # the run in the middle (the lower one of an even count) stands for them
    # all: its builder figures are reported beside its median
    mid = runs[int(np.argsort(medians)[(len(runs) - 1) // 2])]
    med = mid["median_frame_ms"]
    fps = 1000.0 / med if med > 0 else mid["fps"]
    print(f"[bench] {args.repeats} runs: median of the medians {med:.2f} ms "
          f"({fps:.2f} fps), spread {min(medians):.2f}-{max(medians):.2f} ms, "
          f"{n_pairs} pairs in the last frame, alpha off 1 on "
          f"{alpha_off:.2e} of its pixels", flush=True)

    latency = interactive_latency_ms(eng, fp)
    print(f"[bench] interactive latency (frame, 2x downscale, u8, copy to "
          f"the host) {latency:.2f} ms", flush=True)
    eng.shutdown()
    del eng
    if device.type == "cuda":
        torch.cuda.empty_cache()

    dense = None
    if args.dense_splats > 0:
        dense = dense_row(args.width, args.height, device,
                          splats=args.dense_splats, map_half=args.map_half)
        print(f"[bench] dense row ({args.dense_splats} splats/tile, 5 LODs, "
              f"splats only): {dense['frame_ms']:.2f} ms "
              f"({dense['fps']:.2f} fps), {dense['n_pairs']} pairs, set-up "
              f"{dense['setup_s']:.1f} s", flush=True)

    out = {
        "metric": (f"{args.width}x{args.height} full-config (skybox+proxy) "
                   "infinite-terrain fly-through FPS (device-complete)"),
        "value": fps,
        "unit": "fps",
        "meta": dict(
            device=label,
            median_frame_ms=medians,
            spread=dict(min=min(medians), max=max(medians)),
            frames=[r["frames"] for r in runs],
            fps_wall=[r["fps"] for r in runs],
            stall_windows=[r["stall_windows"] for r in runs],
            overflow_frames=[r["overflow_frames"] for r in runs],
            n_pairs=n_pairs,
            alpha_off_share=alpha_off,
            splats_per_tile=args.splats,
            sort_ms=mid["sort_ms"][0],
            build_ms=mid["build_ms"][0],
            sort_trigger=mid["sort_trigger"],
            build_trigger=mid["build_trigger"],
            builder_load=mid["builder_load"],
            setup_s=setup_s,
            interactive_latency_ms=latency,
            dense=dense,
            launches_per_frame={k: v / frames for k, v in launches.items()}
            if frames else {},
        ),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
