#!/usr/bin/env python
"""Per-kernel profile of the fixed-camera bench frame, and the fixed-camera
bench scene the other A/B scripts share (``build``).

    python -m gswt_renderer_tpu_torch.benchmarks.profile_frame [-n 10] [--trace DIR]

The scene: the headline's (synthetic Wang tiles, 512 splats, 3 LODs; the
97x97 map of ``headline.bench_user_data``; its skybox and proxy texture),
its tiles built and sorted once at the fly path's t = 0 pose, 1920x1080,
``RendererConfig(width, height)`` (the fast profile), the full config
(skybox + proxy ground + splats: all five frame kernels).

It times `-n` device-complete frames (host clock, stopped after a
synchronize), then profiles 3 frames under ``torch.profiler`` and prints
the 25 device ops with the most self time, each attributed to the
host-section profiler's stage range (gswt.render.front.project, .skybox,
.proxy, .bin, gswt.render.back; the profiler is on while they are
profiled) whose device range holds it, and the host (CPU) ops with the most
self time. ``--trace DIR`` also writes
the profiler's Chrome trace there. Runs on the card unless given --device
cpu; the size arguments exist so a test can run it small.
"""

from __future__ import annotations

import argparse
import collections
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core import Camera, UserData, hostprof
from ..core.config import RenderConfig
from ..io.synth import synthetic_scene_vec
from ..render.pipeline import Renderer, RendererConfig
from ..render.uniforms import SceneParams
from ..tiles import WangTileEngine
from .headline import KEYFRAMES, bench_textures, bench_user_data
from .timing import device_complete_ms, fmt, open_device, spread

STAGES = ("gswt.render.front.project", "gswt.render.front.skybox",
          "gswt.render.front.proxy", "gswt.render.front.bin",
          "gswt.render.back")


def bench_camera(width, height, pos, target) -> Camera:
    return Camera((width, height), np.asarray(pos, np.float32), target,
                  (0.0, 0.0, 1.0), np.deg2rad(45.0), 0.1, 1000.0)


@dataclass
class Bench:
    """The fixed-camera bench scene: a configured tile engine, its tiles
    built and sorted at one camera pose, and what a Renderer needs to draw
    that sort."""
    wang: WangTileEngine
    ud: UserData
    rc: RenderConfig
    sp: SceneParams
    camera: Camera
    dt: object  # the sort's DrawTable
    device: torch.device
    max_stream: int

    def at(self, pos, target):
        """Move to another pose: rebuild the tiles there and sort them."""
        self.camera = bench_camera(*self.camera.viewport, pos, target)
        pos = self.camera.position
        self.wang.build_tiles(pos)
        self.dt = self.wang.sort_tiles(pos, self.camera.view_proj())
        self.sp = SceneParams.from_data(self.ud, self.wang.center_coord,
                                        self.rc)

    def camera_for(self, width, height) -> Camera:
        """The bench's pose at another viewport."""
        return bench_camera(width, height, self.camera.position,
                            self.camera.target)

    def renderer(self, width=None, height=None, **cfg):
        """A Renderer of RendererConfig(width, height, **cfg) (the fast
        profile unless cfg says exact=True; the bench's viewport by default)
        with the bench textures, and the bench's sort staged for it.
        Returns (renderer, staged, camera)."""
        width = width or self.camera.viewport[0]
        height = height or self.camera.viewport[1]
        cfg.setdefault("max_stream", self.max_stream)
        r = Renderer(self.wang, RendererConfig(width=width, height=height,
                                               **cfg), device=self.device)
        r.configure(self.ud)
        sky, checker = bench_textures()
        r.set_skybox(sky, equirect=True)
        r.set_proxy(checker)
        cam = self.camera_for(width, height)
        return r, r.stage(self.dt, cam, self.rc.culling_dist), cam

    def frame(self, r, staged, camera=None, *, skybox=True, proxy=True):
        """One frame of the bench's sort as a device tensor (enqueued; not
        waited for)."""
        return r.render(None, camera or self.camera, self.sp, self.rc,
                        staged=staged, as_numpy=False, use_skybox=skybox,
                        use_proxy=proxy)


def build(width=1920, height=1080, *, splats=512, lods=3, map_half=48,
          dense=False, device="cuda") -> Bench:
    """The fixed-camera bench scene at the fly path's t = 0 pose. dense:
    the headline's dense row's tiles (8192 splats per tile, 5 LODs, decay
    4) and its stream budget (1 << 23 lanes) in place of splats and lods."""
    if dense:
        sv = synthetic_scene_vec(n_lod=5, splats_per_tile=8192, lod_decay=4)
    else:
        sv = synthetic_scene_vec(n_lod=lods, splats_per_tile=splats, seed=0)
    wang = WangTileEngine(sv)
    ud = bench_user_data(map_half)
    wang.configure(ud)
    rc = RenderConfig.new(wang.n_tiles[0])
    _, pos, target = KEYFRAMES[0]
    b = Bench(wang=wang, ud=ud, rc=rc, sp=None, camera=bench_camera(
        width, height, pos, target), dt=None,
        device=torch.device(device),
        max_stream=(1 << 23) if dense else RendererConfig.max_stream)
    b.at(pos, target)
    return b


def scene_args(ap: argparse.ArgumentParser, sized: bool = True):
    """The scene's size arguments (the viewport unless not `sized`) and
    --device, shared by the scripts."""
    if sized:
        ap.add_argument("--width", type=int, default=1920)
        ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--splats", type=int, default=512,
                    help="splats per tile at LOD 0")
    ap.add_argument("--lods", type=int, default=3)
    ap.add_argument("--map-half", type=int, default=48,
                    help="tile map half size (48: the 97x97 map)")
    ap.add_argument("--device", default="cuda")


def build_from(args, device, width=None, height=None, **kw) -> Bench:
    return build(width or args.width, height or args.height,
                 splats=args.splats, lods=args.lods, map_half=args.map_half,
                 device=device, **kw)


def _stage_of(t, ranges):
    for name, t0, t1 in ranges:
        if t0 <= t <= t1:
            return name
    return "-"


def profile_ops(bench, r, staged, device, n=3, top=25, trace=None):
    """Profile n frames; returns (device rows, host rows, wall ms per frame):
    device rows (self ms per frame, calls per frame, stage, name) of the
    `top` device ops by self time, each in the gswt.* stage whose device
    range holds its start; host rows (self ms per frame, calls per frame,
    name) of the `top` host ops. The host-section profiler is on while they
    are profiled (its ranges name the stages), off again after."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    r.drain()
    hostprof.set_host_prof(True)
    try:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                bench.frame(r, staged)
            r.drain()
            wall = (time.perf_counter() - t0) * 1e3 / n
    finally:
        hostprof.set_host_prof(False)
    if trace:
        os.makedirs(trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace, "frame_trace.json"))
    events = prof.events()
    on_dev = [e for e in events if str(e.device_type).endswith("CUDA")]
    ranges = [(e.name, e.time_range.start, e.time_range.end)
              for e in on_dev if e.name in STAGES]
    dev_ops = collections.defaultdict(lambda: [0.0, 0, collections.Counter()])
    for e in on_dev:
        if e.name.startswith("gswt."):
            continue
        d = dev_ops[e.name]
        d[0] += e.time_range.elapsed_us()
        d[1] += 1
        d[2][_stage_of(e.time_range.start, ranges)] += 1
    dev_rows = sorted(
        ((us / 1e3 / n, k / n, st.most_common(1)[0][0], name)
         for name, (us, k, st) in dev_ops.items()), reverse=True)[:top]
    host = [e for e in prof.key_averages()
            if not str(e.device_type).endswith("CUDA")
            and not e.key.startswith("gswt.")]
    host_rows = sorted(
        ((e.self_cpu_time_total / 1e3 / n, e.count / n, e.key) for e in host),
        reverse=True)[:top]
    return dev_rows, host_rows, wall


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", type=int, default=10, help="timed frames")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--trace", default=None,
                    help="write the profiler's Chrome trace into DIR")
    scene_args(ap)
    args = ap.parse_args(argv)
    device = open_device(args.device, "[profile_frame]")
    bench = build_from(args, device)
    r, staged, _ = bench.renderer()
    ts = spread(device_complete_ms(lambda: bench.frame(r, staged), r.drain,
                                   args.n))
    aux = r.last_aux
    print(f"[profile_frame] {args.width}x{args.height} full-config frame, "
          f"device-complete: {fmt(ts)}; pairs {int(aux['n_pairs'])}, kept "
          f"{int(aux['n_pairs_kept'])}, proxy pairs {aux['proxy_pairs']}",
          flush=True)
    dev_rows, host_rows, wall = profile_ops(bench, r, staged, device,
                                            top=args.top, trace=args.trace)
    busy = sum(row[0] for row in dev_rows)
    print(f"[profile_frame] 3 frames under the profiler: wall {wall:.3f} "
          f"ms/frame; the top {len(dev_rows)} device ops {busy:.3f} "
          f"ms/frame")
    for ms, k, stage, name in dev_rows:
        print(f"[profile_frame] device {ms:9.4f} ms/frame x{k:6.1f} "
              f"{stage:13s} {name[:80]}")
    for ms, k, name in host_rows:
        print(f"[profile_frame] host   {ms:9.4f} ms/frame x{k:6.1f} "
              f"{name[:80]}")
    return dict(frame_ms=ts, wall_profiled_ms=wall, device_ops=dev_rows,
                host_ops=host_rows)


if __name__ == "__main__":
    main()
