#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gswt_renderer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises (non-zero exit):
1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel of the main path from csrc/, one nvcc each,
   all at once;
3. reference: a small frame rendered on the card against the port's CPU
   path (the plain PyTorch versions the CPU tests hold against the JAX
   package), within the JAX parity budget;
4. kernels: on the first 1080p frame of the bench scene, each kernel against
   its plain version on the same inputs (block gather bit-exact, compositor
   <= 1e-4 per channel, with and without a random depth test), timed with
   CUDA events beside its bound and, where one exists, a library call;
5. main path: >= 20 gs-only 1080p frames along the bench fly path through
   Engine, with the launch counters zeroed just before and read just after.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Needs a CUDA device and the repository's
package; imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM rate and non-tensor FP32 rate.
# SFU rate: 132 SMs x 16 transcendental results per clock x 1.98 GHz boost
# (Hopper architecture white paper).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9
# per pair-pixel work of the compositor loop (csrc/raster.cu): 22 FP32
# operations and one exp
RASTER_FP32_OPS = 22

RASTER_TOL = 1e-4  # per channel: FP32 summation order and expf vs torch.exp
BENCH_KEYFRAMES = [  # bench.py fly path
    (0.0, (0.0, 0.0, 5.0), (0.0, 30.0, 2.0)),
    (5.0, (6.0, 18.0, 5.0), (10.0, 48.0, 2.0)),
    (10.0, (2.0, 40.0, 6.0), (-20.0, 60.0, 1.0)),
    (15.0, (-10.0, 55.0, 5.0), (-30.0, 80.0, 2.0)),
]
N_FRAMES = 24


def _time_ms(torch, fn, reps: int) -> float:
    """Mean device time of fn over `reps` back-to-back calls (CUDA events,
    after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _close(ref, img):
    """tests/test_pipeline.py's budget: mean < 1e-4 and at most 5e-4 of the
    pixels over 1e-3."""
    diff = np.abs(img - ref).max(axis=-1)
    return float(np.mean(diff)) < 1e-4 and float(np.mean(diff > 1e-3)) <= 5e-4


def phase_reference(torch):
    """A small frame on the card against the port's CPU path."""
    from gswt_renderer_tpu_torch.core import Camera, UserData
    from gswt_renderer_tpu_torch.core.config import (
        RenderConfig, SelectiveMergeType, SurfaceType, TileSortType)
    from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec
    from gswt_renderer_tpu_torch.render.pipeline import Renderer, RendererConfig
    from gswt_renderer_tpu_torch.render.uniforms import SceneParams
    from gswt_renderer_tpu_torch.tiles import WangTileEngine

    w = h = 128
    wang = WangTileEngine(synthetic_scene_vec(n_lod=2, splats_per_tile=96))
    cases = [
        dict(surface_type=SurfaceType.NONE, cam=(2.0, 2.0, 6.0),
             target=(2.0, 2.0, 0.0)),
        dict(surface_type=SurfaceType.HEIGHT_MAP, height_map_scale=(1.0, 0.3),
             height_map_wh=(8, 8), cam=(1.0, -5.0, 3.0),
             target=(1.0, 0.0, 0.5)),
    ]
    for case in cases:
        cam_pos = np.asarray(case.pop("cam"), np.float32)
        target = case.pop("target")
        kw = dict(tile_map_half_wh=(2, 2), height_map_scale=(1.0, 0.0),
                  lod_max_dist=8.0, merge_type=SelectiveMergeType.NONE,
                  tile_sort_type=TileSortType.DISTANCE, lod_blending=False)
        kw.update(case)
        ud = UserData.from_ui(**kw)
        wang.configure(ud)
        wang.build_tiles(cam_pos)
        camera = Camera((w, h), cam_pos, target, (0.0, 1.0, 0.0),
                        np.deg2rad(60.0), 0.1, 200.0)
        dt = wang.sort_tiles(cam_pos, camera.view_proj())
        rc = RenderConfig.new(wang.n_tiles[0])
        sp = SceneParams.from_data(ud, wang.center_coord, rc)
        imgs = []
        for device in ("cuda", "cpu"):
            r = Renderer(wang, RendererConfig(width=w, height=h, max_draws=128,
                                              max_stream=1 << 15, chunk=128),
                         device=device)
            r.configure(ud)
            imgs.append(r.render(dt, camera, sp, rc))
        gpu, cpu = imgs
        diff = np.abs(gpu - cpu).max(axis=-1)
        print(f"[reference] {int(kw['surface_type'])} 128x128: mean diff "
              f"{diff.mean():.3e} max {diff.max():.3e} alpha "
              f"{gpu[..., 3].mean():.3f}")
        if not (np.isfinite(gpu).all() and gpu[..., 3].mean() > 0.1
                and _close(cpu, gpu)):
            raise RuntimeError("card frame disagrees with the CPU reference")


def phase_profile(torch, eng, fp, n: int = 6):
    """Where a frame's time goes: device time per pipeline stage (the
    renderer's gswt.* profiler ranges) and per kernel, over n frames along
    the fly path, beside the frame's wall time."""
    from torch.profiler import ProfilerActivity, profile

    fp.reset_path()
    fp.start_path()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            fp.handle_events(eng.camera, now_ms=15000.0 * (i + 0.5) / n)
            eng.frame(readback=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = prof.key_averages()

    def per_frame(e, attr):
        v = getattr(e, attr.replace("cuda", "device"), None)
        if v is None:
            v = getattr(e, attr, 0)
        return v / 1e3 / n

    on_device = [e for e in events if str(e.device_type).endswith("CUDA")]
    kernels_ = [e for e in on_device if not e.key.startswith("gswt.")]
    busy = sum(per_frame(e, "self_cuda_time_total") for e in kernels_)
    print(f"[profile] {n} frames under the profiler: wall {wall_ms:.2f} "
          f"ms/frame, device busy {busy:.2f} ms/frame, idle share "
          f"{1.0 - busy / wall_ms:.3f}")
    # a stage's device span (first to last kernel, gaps included) comes
    # from its range on the device timeline; the device busy time linked
    # to its host range misses kernels launched outside PyTorch's
    # dispatcher (the ctypes-launched CUDA kernels)
    for stage in ("gswt.project", "gswt.bin", "gswt.raster"):
        span = sum(per_frame(e, "cuda_time_total") for e in on_device
                   if e.key == stage)
        host = [e for e in events if e.key == stage
                and not str(e.device_type).endswith("CUDA")]
        print(f"[profile] stage {stage}: device span {span:.3f} ms/frame, "
              f"host {sum(e.cpu_time_total for e in host) / 1e3 / n:.3f} "
              f"ms/frame, aten-linked device "
              f"{sum(per_frame(e, 'cuda_time_total') for e in host):.3f} "
              f"ms/frame")
    top = sorted(kernels_, key=lambda e: per_frame(e, "self_cuda_time_total"),
                 reverse=True)[:12]
    for e in top:
        print(f"[profile] kernel {per_frame(e, 'self_cuda_time_total'):8.3f} "
              f"ms/frame x{e.count / n:5.1f}  {e.key[:90]}")
    print(f"[profile] kernels launched: {sum(e.count for e in kernels_) / n:.0f}"
          f" per frame")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gswt_renderer_tpu_torch.core import UserData
    from gswt_renderer_tpu_torch.core.config import SurfaceType
    from gswt_renderer_tpu_torch.engine import Engine, FlyPathControl, FlyPathFrame
    from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec
    from gswt_renderer_tpu_torch.ops import kernels, project, raster
    from gswt_renderer_tpu_torch.ops.blockgather import (
        block_gather, block_gather_plain)
    from gswt_renderer_tpu_torch.render.pipeline import RendererConfig

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {kind} x{torch.cuda.device_count()} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    print(smi)

    # 2. build
    t0 = time.time()
    reports = kernels.build_all()
    print(f"[build] {len(reports)} kernels in {time.time() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # 3. reference on a small input
    phase_reference(torch)

    # the bench scene at 1080p through Engine (exact profile, gs-only)
    t_setup = time.time()
    width, height = 1920, 1080
    sv = synthetic_scene_vec(n_lod=3, splats_per_tile=512, lod_decay=2, seed=0)
    eng = Engine(sv, viewport=(width, height),
                 renderer_config=RendererConfig(width=width, height=height,
                                                exact=True),
                 synchronous=False, device="cuda")
    ud = UserData.from_ui(
        tile_map_half_wh=(48, 48), tile_width=4.0,
        surface_type=SurfaceType.HEIGHT_MAP, height_map_wh=(10, 10),
        height_map_scale=(1.0, 0.3), lod_max_dist=96.0,
        lod_transition_width_ratio=0.05, merge_dot_threshold=0.2,
        merge_topk=100, cache_size=1024,
    )
    fp = FlyPathControl()
    for t, p, tgt in BENCH_KEYFRAMES:
        fp.keyframes.append(FlyPathFrame(
            t, np.array(p, np.float32), np.array(tgt, np.float32)))
    fp.reset_path()
    fp.start_path()
    fp.handle_events(eng.camera, now_ms=0.0)
    eng.configure(ud)
    if not eng.wait_ready(timeout_s=300):
        raise RuntimeError("engine produced no frame")
    torch.cuda.synchronize()
    setup_s = time.time() - t_setup
    print(f"[setup] bench scene ready in {setup_s:.1f} s")

    # 4. kernels against their plain versions on the first frame's inputs
    r = eng.renderer
    plan = r.upload_plan(eng._staged)
    binned = r.front(plan, eng.camera, eng.scene_params, eng.render_config)
    scratch = project.merged_scratch(plan["merged"], r.store_packed,
                                     r.panels.shape[0])
    src = plan["blocks"][0].contiguous()
    nb = src.shape[0]

    out_k = block_gather(r.panels, src, scratch)
    out_p = block_gather_plain(r.panels, src, scratch)
    if not torch.equal(out_k.view(torch.int32), out_p.view(torch.int32)):
        raise RuntimeError("block_gather kernel disagrees with its plain version")
    combined = torch.cat([r.panels, scratch], dim=1).view(16, -1, 256)
    bg = dict(
        name="block_gather", route="cuda",
        source="gswt_renderer_tpu_torch/csrc/blockgather.cu",
        replaces="gswt_renderer_tpu/ops/blockgather.py:87",
        max_abs_err=0.0,
        ms=_time_ms(torch, lambda: block_gather(r.panels, src, scratch), 50),
        plain_ms=_time_ms(
            torch, lambda: block_gather_plain(r.panels, src, scratch), 10),
        library_ms=_time_ms(
            torch, lambda: torch.index_select(combined, 1, src), 50),
        # each input read once (panel table, scratch, panel ids), the
        # output written once
        bound_ms=(4 * (r.panels.numel() + scratch.numel() + nb)
                  + out_k.numel() * 4) / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
    )
    print(f"[kernel] block_gather {nb} panels: bit-exact, {bg['ms']:.4f} ms "
          f"(plain {bg['plain_ms']:.4f}, index_select {bg['library_ms']:.4f}, "
          f"bound {bg['bound_ms']:.4f})")

    image_wh, tile_wh = (width, height), (r.cfg.tile_w, r.cfg.tile_h)
    n_tiles = -(-width // tile_wh[0]) * -(-height // tile_wh[1])
    p_n = tile_wh[0] * tile_wh[1]
    ones = torch.ones((n_tiles, p_n), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    kept = binned["table"][6, :int(binned["n_pairs_kept"])]
    lo, hi = (float(x) for x in torch.quantile(
        kept[:1 << 20], torch.tensor([0.05, 0.95], device="cuda")))
    rand_depth = lo + (hi - lo) * torch.rand(
        (n_tiles, p_n), generator=gen, device="cuda")
    err = 0.0
    main_kw = dict(image_wh=image_wh, tile_wh=tile_wh, chunk=r.cfg.chunk,
                   use_depth=False)
    stats = {}
    for depth, use_depth in ((ones, False), (rand_depth, True)):
        kw = dict(main_kw, use_depth=use_depth)
        k_out = raster.rasterize(binned, depth, **kw)
        p_out = raster.rasterize_plain(
            binned, depth, stats=stats if not use_depth else None, **kw)
        e = float((k_out - p_out).abs().amax())
        print(f"[kernel] raster use_depth={use_depth}: max abs diff {e:.3e} "
              f"alpha {float(k_out[:, 3].mean()):.4f}")
        if not (e <= RASTER_TOL and torch.isfinite(k_out).all()):
            raise RuntimeError("raster kernel disagrees with its plain version")
        err = max(err, e)
    pairs = stats["pairs"]
    pp = pairs * p_n  # pair-pixels the frame composites
    rs = dict(
        name="raster", route="cuda",
        source="gswt_renderer_tpu_torch/csrc/raster.cu",
        replaces="gswt_renderer_tpu/ops/raster.py:735",
        max_abs_err=err,
        ms=_time_ms(torch, lambda: raster.rasterize(binned, ones, **main_kw), 10),
        plain_ms=_time_ms(
            torch, lambda: raster.rasterize_plain(binned, ones, **main_kw), 2),
        library_ms=None,
        bound_ms=max(pp * RASTER_FP32_OPS / FP32_OPS_PER_S,
                     pp / SFU_OPS_PER_S) * 1e3,
        bound_by="operations",
    )
    print(f"[kernel] raster {pairs} pairs x {p_n} px: {rs['ms']:.3f} ms "
          f"(plain {rs['plain_ms']:.3f}, bound {rs['bound_ms']:.3f})")

    # 5. the main path: gs-only 1080p frames along the bench fly path
    kernels.LAUNCHES.clear()
    frame_ms, pairs_per_frame = [], []
    for i in range(N_FRAMES):
        fp.handle_events(eng.camera, now_ms=15000.0 * i / N_FRAMES)
        t0 = time.perf_counter()
        img = eng.frame(readback=False)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if img is None or tuple(img.shape) != (height, width, 4):
            raise RuntimeError(f"frame {i} missing or misshapen")
        if not bool(torch.isfinite(img).all()):
            raise RuntimeError(f"frame {i} has non-finite pixels")
        if float(img[..., 3].mean()) <= 0.0:
            raise RuntimeError(f"frame {i} has no coverage")
        pairs_per_frame.append(eng.renderer.last_aux["n_pairs"])
    launches = dict(kernels.LAUNCHES)
    phase_profile(torch, eng, fp)
    eng.shutdown()
    for k in (bg, rs):
        k["launches"] = launches.get(k["name"], 0)
        if k["launches"] < N_FRAMES:
            raise RuntimeError(f"{k['name']} launched {k['launches']} times "
                               f"in {N_FRAMES} frames")
    q1, q2, q3 = np.percentile(frame_ms, [25, 50, 75])
    print(f"[main] {N_FRAMES} gs-only 1080p frames: median {q2:.2f} ms "
          f"(quartiles {q1:.2f}, {q3:.2f}; first {frame_ms[0]:.2f}), "
          f"pairs/frame median "
          f"{int(np.median(pairs_per_frame))}, setup {setup_s:.1f} s, "
          f"launches {launches}")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: d[k] for k in keys} for d in (bg, rs)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
