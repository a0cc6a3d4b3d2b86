#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gswt_renderer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises (non-zero exit):
1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel of the main paths from csrc/ (eight sources, the
   compositor in eight compile-time variants, the micro-raster in twelve),
   one nvcc each, all at once, with each kernel's registers and spills;
3. reference: small frames rendered on the card against the port's CPU
   path (the plain PyTorch versions the CPU tests hold against the JAX
   package): gs-only and with skybox + proxy, in the exact profile within
   the JAX parity budget and in the fast profile (the default) within the
   stated one, plus three sat-culled frames whose carried cut image must be
   the CPU path's;
4. kernels: on 1080p frames of the bench scene, each kernel against its
   plain version on the same inputs (block gather bit-exact; compositor
   <= 1e-4 per channel in the exact variant, without a depth test, with a
   random one and on the full-config frame's pairs against the proxy's
   depth, and in the fast variant on the fast frame's own pair table under
   its proxy depth, with the saturation-slot record EQUAL; triangle raster
   (its entry kernel and its fold) z and hit mask bit-equal and attributes
   <= 1e-5 relative, on adversarial triangles and at full and at the fast
   profile's half resolution, with its load ([load] trirast: run lengths,
   chunks per tile, pair-pixels in the bbox, inside, in the warp blocks the
   mask keeps; failing if the mask would leave out a hit), its covered-only
   bound and its longest run alone, the fold alone against its plain
   version; bilinear sampler bit-equal, mip sampler <= 1e-6 at both
   resolutions, by events, by its own device time and by the wrapper's
   host time per call), timed with CUDA events beside its bound
   and, where one exists, a library call (the bilinear sampler and
   grid_sample also by their own device time in one profiler window); for
   the compositor also the load it carries (the share of composited
   pair-pixels kept, the share of (pair, warp block) visits its mask
   leaves, run lengths per tile), failing if the mask would leave out a
   kept pair-pixel;
5. main paths, each with the launch counters zeroed just before and read
   just after: 4 gs-only and 8 full-config 1080p frames along the bench fly
   path through Engine in the exact profile (the earlier slices' paths, at
   a cut depth); 24 full-config frames through an Engine built with
   RendererConfig(width, height) and nothing else, as bench.py builds it
   (the fast profile, both culls off: the frame bench.py times); 6 frames
   of the same Engine with sat_cull on at a fixed camera beside 6 without;
6. profile: where the frame's time goes, per stage and kernel, in the exact
   and in the fast profile;
7. the benchmarks sub-package: its kernels against their plain versions at
   the micro-benchmarks' own shapes (sorted merge: keys equal to numpy's
   merge, payload rows and the sentinel tail bit-equal; micro-raster A, B, C,
   C2, D at 1 << 22 pairs on 1080p: <= 1e-4 per channel each, with each
   instantiation's registers and spill, each variant's share of (pair, warp
   block) visits its mask keeps and the kept pair-pixels the mask leaves
   out, counted on the card's tensors, failing unless 0; both micro
   block gathers bit-equal), then the three micro-benchmark scripts and the
   headline fly-through (1920x1080, 512 splats, 3 LODs, fast profile, 2
   repeats of the first 15 s leg through Engine.run_benchmark) through their
   main(), each in a launch-count window of its own.

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
# operations and one exp; the fast variant adds the weight's round to bf16
# and back (2); the saturation-slot record adds nothing per pair-pixel.
# Its bound counts this work on the pair-pixels that pass the cutoff and the
# depth test only (a pair-pixel that fails has g = 0 and needs none of it),
# beside the table rows read once for the composited pairs (11, 12 with the
# slot), the depth read once and the output written once; the bound is the
# largest of the FP32, SFU and byte terms. The older convention, every
# composited pair-pixel counted in full, is printed beside it.
RASTER_FP32_OPS = 22
RASTER_FAST_FP32_OPS = 24
RASTER_ROWS = 11

# per pair-pixel work of the triangle raster loop (csrc/trirast.cu): three
# plane evaluations (b0, b1, z) of two multiplies and two adds, and two
# subtractions for b2; the attribute planes are evaluated only for a pair
# that is its pixel's nearest so far and are not counted. Its bound counts
# this work on what the run's data needs: the pair-pixels of the warp blocks
# the kernel's mask keeps (covered-only; a pair cannot put a pixel centre of
# another block inside). The older convention, every pair-pixel of every
# pair's tile, is printed beside it.
TRIRAST_FP32_OPS = 14

# per channel, every variant: the plain version walks a chunk's pairs in the
# kernel's order (w = g T, T *= 1 - g), so T, the early exit, the bf16
# rounding of the fast variant's weights and the saturation record decide
# alike; what is left is the FP32 order of the colour sums
RASTER_TOL = 1e-4
MIN_T = 0.5 / 255.0
# the mip sampler: same operations in the same order as the plain version,
# but the level's log2f against torch.log2. The bilinear sampler has no such
# call and is held bit-equal.
SAMPLER_TOL = 1e-6
# the triangle raster's attributes, relative: a tie's sum may be taken in
# another order
TRIRAST_ATTR_RTOL = 1e-5
N_FRAMES = 24      # the main path: fast-profile full-config frames
N_FRAMES_EXACT = 8  # exact-profile full-config frames (slice 2's path, cut)
N_FRAMES_GS = 4    # exact-profile gs-only frames (slice 1's path, cut)
N_FRAMES_SAT = 6   # fixed-camera frames with and without the sat cull


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


def phase_reference(torch):
    """Small frames on the card against the port's CPU path, in both
    profiles. Budget: tests/test_pipeline.py's (mean < 1e-4 and at most 5e-4
    of the pixels over 1e-3), four times that share with the half-res
    proxy."""
    from gswt_renderer_tpu_torch.core import Camera, UserData
    from gswt_renderer_tpu_torch.core.config import (
        RenderConfig, SelectiveMergeType, SurfaceType, TileSortType)
    from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec
    from gswt_renderer_tpu_torch.render.pipeline import Renderer, RendererConfig
    from gswt_renderer_tpu_torch.render.uniforms import SceneParams
    from gswt_renderer_tpu_torch.benchmarks.headline import bench_textures
    from gswt_renderer_tpu_torch.tiles import WangTileEngine

    w = h = 128
    wang = WangTileEngine(synthetic_scene_vec(n_lod=2, splats_per_tile=96))
    sky, checker = bench_textures(sky_hw=(16, 32), cells=8, cell=4)
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
        for exact in (True, False):
            rs = {}
            for device in ("cuda", "cpu"):
                r = Renderer(wang, RendererConfig(
                    width=w, height=h, max_draws=128, max_stream=1 << 15,
                    chunk=128, exact=exact, sat_cull=not exact),
                    device=device)
                r.configure(ud)
                r.set_skybox(sky)
                r.set_proxy(checker)
                rs[device] = r
            profile = "exact" if exact else "fast+sat_cull"
            for full in (False, True):
                # three frames at the fixed camera: with the sat cull
                # (fast profile) the second and third cull by the record
                for _ in range(1 if exact else 3):
                    gpu, cpu = (rs[d].render(
                        dt, camera, sp, rc, use_skybox=full, use_proxy=full)
                        for d in ("cuda", "cpu"))
                diff = np.abs(gpu - cpu).max(axis=-1)
                print(f"[reference] {profile} surface "
                      f"{int(kw['surface_type'])} "
                      f"{'skybox+proxy' if full else 'gs-only'} 128x128: mean "
                      f"diff {diff.mean():.3e} max {diff.max():.3e} over 1e-3 "
                      f"{np.mean(diff > 1e-3):.2e} alpha "
                      f"{gpu[..., 3].mean():.3f}")
                # the fast profile's half-res proxy: a triangle-edge pixel
                # that falls to the other side on one ulp covers four
                # pixels of the frame, so its share may be four times the
                # exact profile's
                frac = 5e-4 if exact or not full else 2e-3
                if not (np.isfinite(gpu).all() and gpu[..., 3].mean() > 0.1
                        and diff.mean() < 1e-4
                        and np.mean(diff > 1e-3) <= frac):
                    raise RuntimeError(
                        "card frame disagrees with the CPU reference")
            if not exact and not torch.equal(rs["cuda"].sat_zimg.cpu(),
                                             rs["cpu"].sat_zimg):
                raise RuntimeError("the card's saturation-slot image is not "
                                   "the CPU path's")


def phase_profile(torch, eng, fp, label, n: int = 4):
    """Where a frame's time goes: device time per pipeline stage (the
    renderer's gswt.* profiler ranges) and per kernel, over n frames along
    the fly path, beside the frame's wall time. Lines start with
    `[profile] <label>`."""
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
    tag = f"[profile] {label}"
    print(f"{tag} {n} frames under the profiler: wall {wall_ms:.2f} "
          f"ms/frame, device busy {busy:.2f} ms/frame, idle share "
          f"{1.0 - busy / wall_ms:.3f}")
    # a stage's device span (first to last kernel, gaps included) comes
    # from its range on the device timeline; the device busy time linked
    # to its host range misses kernels launched outside PyTorch's
    # dispatcher (the ctypes-launched CUDA kernels)
    for stage in ("gswt.skybox", "gswt.proxy", "gswt.project", "gswt.bin",
                  "gswt.raster"):
        span = sum(per_frame(e, "cuda_time_total") for e in on_device
                   if e.key == stage)
        host = [e for e in events if e.key == stage
                and not str(e.device_type).endswith("CUDA")]
        print(f"{tag} stage {stage}: device span {span:.3f} ms/frame, "
              f"host {sum(e.cpu_time_total for e in host) / 1e3 / n:.3f} "
              f"ms/frame, aten-linked device "
              f"{sum(per_frame(e, 'cuda_time_total') for e in host):.3f} "
              f"ms/frame")
    top = sorted(kernels_, key=lambda e: per_frame(e, "self_cuda_time_total"),
                 reverse=True)[:8]
    for e in top:
        print(f"{tag} kernel {per_frame(e, 'self_cuda_time_total'):8.3f} "
              f"ms/frame x{e.count / n:5.1f}  {e.key[:90]}")
    # the hand-written kernels' own device time: the [kernel] lines time
    # back-to-back wrapper calls, which for the sub-0.1 ms kernels is the
    # host's enqueue rate
    for e in kernels_:
        if any(k in e.key for k in ("block_gather_kernel", "raster_kernel",
                                    "trirast_kernel", "trirast_fold_kernel",
                                    "bilinear_kernel",
                                    "mip_trilinear_kernel")):
            print(f"{tag} own kernel "
                  f"{per_frame(e, 'self_cuda_time_total'):8.4f} ms/frame "
                  f"x{e.count / n:4.1f}  {e.key[:70]}")
    print(f"{tag} kernels launched: "
          f"{sum(e.count for e in kernels_) / n:.0f} per frame")


def main():
    import dataclasses

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gswt_renderer_tpu_torch.benchmarks import (
        headline, mergesorted, micro_blockgather, micro_merge, micro_raster)
    from gswt_renderer_tpu_torch.engine import Engine, FlyPathControl, FlyPathFrame
    from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec
    from gswt_renderer_tpu_torch.ops import (
        kernels, project, proxy, raster, skybox, texsample, trirast)
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
    built = kernels.build_all()
    print(f"[build] {len(built)} kernels in {time.time() - t0:.1f} s")
    # every kernel's ptxas report, kept beside its library (this run's
    # build, or the one that built it)
    reports = {name: kernels.ptxas_report(name) for name in kernels.KERNELS}
    for name, rep in reports.items():
        entry = ""
        for line in rep.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line:
                print(f"[build] {name} {entry}: {line.strip()}")

    # 3. reference on a small input
    phase_reference(torch)

    # the bench scene at 1080p through Engine
    width, height = 1920, 1080
    image_wh = (width, height)
    n_px = width * height
    sv = synthetic_scene_vec(n_lod=3, splats_per_tile=512, lod_decay=2, seed=0)
    sky, checker = headline.bench_textures()
    fp = FlyPathControl()
    for t, p, tgt in headline.KEYFRAMES:
        fp.keyframes.append(FlyPathFrame(
            t, np.array(p, np.float32), np.array(tgt, np.float32)))

    def first_camera(eng):
        fp.reset_path()
        fp.start_path()
        fp.handle_events(eng.camera, now_ms=0.0)

    def bench_engine(config, label):
        """An Engine on the bench scene (bench.py:180-191), configured and
        ready at the fly path's first camera."""
        t_setup = time.time()
        eng = Engine(sv, viewport=image_wh, renderer_config=config,
                     synchronous=False, device="cuda")
        first_camera(eng)
        eng.configure(headline.bench_user_data())
        if not eng.wait_ready(timeout_s=300):
            raise RuntimeError("engine produced no frame")
        torch.cuda.synchronize()
        setup_s = time.time() - t_setup
        print(f"[setup] bench scene ready in {setup_s:.1f} s ({label})")
        return eng, setup_s

    def drive(eng, n_frames, label, alpha_share=0.0, moving=True):
        """n_frames 1080p frames through Engine, along the bench fly path
        or at the camera as it stands; per-frame wall times, bbox pair
        counts and pairs kept after the culls. Over an opaque sky alpha is
        1 but for `alpha_share` of the pixels (the half-res proxy's
        silhouette: its colour, alpha included, is upsampled bilinearly and
        its hit mask nearest, as in the JAX package)."""
        if moving:
            fp.reset_path()
            fp.start_path()
        frame_ms, pairs, kept, off = [], [], [], 0.0
        for i in range(n_frames):
            if moving:
                fp.handle_events(eng.camera, now_ms=15000.0 * i / n_frames)
            t0 = time.perf_counter()
            img = eng.frame(readback=False)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            if img is None or tuple(img.shape) != (height, width, 4):
                raise RuntimeError(f"{label} frame {i} missing or misshapen")
            if not bool(torch.isfinite(img).all()):
                raise RuntimeError(f"{label} frame {i} has non-finite pixels")
            if float(img[..., 3].mean()) <= 0.0:
                raise RuntimeError(f"{label} frame {i} has no coverage")
            if eng.use_skybox:
                share = float(((img[..., 3] - 1.0).abs() > 1e-5)
                              .float().mean())
                off = max(off, share)
                if share > alpha_share:
                    raise RuntimeError(
                        f"{label} frame {i}: alpha is not 1 over an opaque "
                        f"sky on {share:.2e} of the pixels")
            pairs.append(eng.renderer.last_aux["n_pairs"])
            kept.append(int(eng.renderer.last_aux["n_pairs_kept"]))
        return dict(ms=frame_ms, pairs=pairs, kept=kept, alpha_off=off,
                    img=img)

    def report(label, run, launches):
        q1, q2, q3 = np.percentile(run["ms"], [25, 50, 75])
        print(f"[main] {len(run['ms'])} {label} 1080p frames: median "
              f"{q2:.2f} ms (quartiles {q1:.2f}, {q3:.2f}; first "
              f"{run['ms'][0]:.2f}), pairs/frame median "
              f"{int(np.median(run['pairs']))}, kept after the culls "
              f"{int(np.median(run['kept']))}, alpha off 1 on at most "
              f"{run['alpha_off']:.2e} of the pixels, launches {launches}")

    def need(launches, names, n, label):
        for name in names:
            if launches.get(name, 0) < n:
                raise RuntimeError(f"{name} launched {launches.get(name, 0)} "
                                   f"times in {n} {label} frames")

    eng, setup_s = bench_engine(
        RendererConfig(width=width, height=height, exact=True), "exact")

    # 4. kernels against their plain versions on the first frame's inputs
    r = eng.renderer
    plan = r.upload_plan(eng._staged)
    binned = r.front(plan, eng.camera, eng.scene_params, eng.render_config)[0]
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

    tile_wh = (r.cfg.tile_w, r.cfg.tile_h)
    n_tiles = -(-width // tile_wh[0]) * -(-height // tile_wh[1])
    p_n = tile_wh[0] * tile_wh[1]
    ones = torch.ones((n_tiles, p_n), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    kept = binned["table"][6, :int(binned["n_pairs_kept"])]
    lo, hi = (float(x) for x in torch.quantile(
        kept[:1 << 20], torch.tensor([0.05, 0.95], device="cuda")))
    rand_depth = lo + (hi - lo) * torch.rand(
        (n_tiles, p_n), generator=gen, device="cuda")
    main_kw = dict(image_wh=image_wh, tile_wh=tile_wh, chunk=r.cfg.chunk,
                   use_depth=False)
    depth_kw = dict(main_kw, use_depth=True)

    # max abs diff per variant (exact, emit_zcut) over every table checked
    variant_err = {}

    def raster_check(label, table, depth, show_load=True, **kw):
        """The compositor kernel against its plain version on one table, and
        the load it carries (rasterize_plain's stats): (kernel output, max
        abs diff, stats). Fails if the kernel's warp-block mask would leave
        out a pair-pixel that passes the cutoff and the depth test."""
        st = {}
        k_out = raster.rasterize(table, depth, **kw)
        p_out = raster.rasterize_plain(table, depth, stats=st, **kw)
        zcut_equal = ""
        if kw.get("emit_zcut"):
            (k_out, k_z), (p_out, p_z) = k_out, p_out
            differ = int((k_z != p_z).sum())
            cut = int((k_z < raster.SAT_NOCUT).sum())
            zcut_equal = (f", zcut {tuple(k_z.shape)} differs in {differ} "
                          f"entries, {cut} bands cut")
            if differ:
                raise RuntimeError(f"raster {label}: the saturation-slot "
                                   f"record is not the plain version's")
        e = float((k_out - p_out).abs().amax())
        print(f"[kernel] raster {label}: max abs diff {e:.3e} alpha "
              f"{float(k_out[:, 3].mean()):.4f}, {st['pairs']} pairs "
              f"composited{zcut_equal}")
        if not (e <= RASTER_TOL and torch.isfinite(k_out).all()):
            raise RuntimeError(f"raster {label}: the kernel disagrees with "
                               f"its plain version")
        if st["missed"]:
            raise RuntimeError(f"raster {label}: the warp-block mask leaves "
                               f"out pair-pixels that are kept")
        key = (kw.get("exact", True), kw.get("emit_zcut", False))
        variant_err[key] = max(variant_err.get(key, 0.0), e)
        if not show_load:
            return k_out, e, st
        runs = st["runs"][st["runs"] > 0].double()
        done = st["tile_pairs"][st["runs"] > 0].double()
        q = torch.tensor([0.5, 0.99], dtype=torch.float64, device=runs.device)
        rq, dq = torch.quantile(runs, q), torch.quantile(done, q)
        print(f"[load] raster {label}: {st['kept']} of {st['pair_pixels']} "
              f"composited pair-pixels kept ({st['kept'] / st['pair_pixels']:.5f}); "
              f"the warp-block mask leaves {st['visits']} of {st['blocks']} "
              f"(pair, block) visits ({st['visits'] / st['blocks']:.4f}), "
              f"misses {st['missed']} kept pair-pixels; run length per tile "
              f"median {rq[0]:.0f}, p99 {rq[1]:.0f}, max {runs.max():.0f} "
              f"({runs.numel()} tiles with pairs); composited before the "
              f"early exit median {dq[0]:.0f}, p99 {dq[1]:.0f}, max "
              f"{done.max():.0f}")
        return k_out, e, st

    def other_variants(label, table, depth, done, **kw):
        """The variants (exact, emit_zcut) not in `done` on the same table:
        all four compositor variants are held on every table."""
        for exact in (True, False):
            for zcut in (False, True):
                if (exact, zcut) not in done:
                    raster_check(
                        f"{'exact' if exact else 'fast'}"
                        f"{' + zcut' if zcut else ''}, {label}", table,
                        depth, show_load=False,
                        **dict(kw, exact=exact, emit_zcut=zcut))

    def raster_bound_ms(pairs, ops=RASTER_FP32_OPS):
        """The older convention: every composited pair-pixel in full."""
        pp = pairs * p_n  # pair-pixels the frame composites
        return max(pp * ops / FP32_OPS_PER_S, pp / SFU_OPS_PER_S) * 1e3

    def raster_kept_bound(st, ops, use_depth, zcut=False):
        """(bound ms, bound_by, terms): the work on the kept pair-pixels,
        the composited pairs' table rows read once, the depth read once and
        the output (and the record) written once."""
        n_tiles_ = st["runs"].shape[0]
        n_bytes = 4 * (st["pairs"] * (RASTER_ROWS + int(zcut))
                       + 2 * n_tiles_ + n_tiles_ * 4 * p_n
                       + (n_tiles_ * p_n if use_depth else 0)
                       + (n_tiles_ * raster.SAT_BANDS if zcut else 0))
        terms = dict(operations=st["kept"] * ops / FP32_OPS_PER_S * 1e3,
                     sfu=st["kept"] / SFU_OPS_PER_S * 1e3,
                     bytes=n_bytes / HBM_BYTES_PER_S * 1e3)
        by = max(terms, key=terms.get)
        return terms[by], "bytes" if by == "bytes" else "operations", terms

    gs_st = raster_check("exact, gs-only frame, no depth test", binned,
                         ones, **main_kw)[2]
    raster_check("exact, gs-only frame, random depth", binned, rand_depth,
                 **depth_kw)
    done_exact = {(True, False)}
    other_variants("gs-only frame, no depth test", binned, ones, done_exact,
                   **main_kw)
    other_variants("gs-only frame, random depth", binned, rand_depth,
                   done_exact, **depth_kw)
    gs_pairs = gs_st["pairs"]
    gs_raster_ms = _time_ms(
        torch, lambda: raster.rasterize(binned, ones, **main_kw), 10)
    print(f"[kernel] raster exact on the gs-only frame, {gs_pairs} pairs x "
          f"{p_n} px, no depth test: {gs_raster_ms:.3f} ms (bound "
          f"{raster_kept_bound(gs_st, RASTER_FP32_OPS, False)[0]:.3f} from "
          f"the kept pair-pixels; every pair-pixel in full "
          f"{raster_bound_ms(gs_pairs):.3f})")

    # 5a. slice 1's main path: exact gs-only frames, at a cut depth
    kernels.LAUNCHES.clear()
    gs_run = drive(eng, N_FRAMES_GS, "exact gs-only")
    launches_gs = dict(kernels.LAUNCHES)
    need(launches_gs, ("block_gather", "raster"), N_FRAMES_GS, "gs-only")
    report("exact gs-only", gs_run, launches_gs)

    # the full config of bench.py: equirect skybox + checker proxy ground
    t0 = time.time()
    eng.set_skybox(sky, equirect=True)
    eng.set_proxy(checker)
    torch.cuda.synchronize()
    print(f"[setup] skybox {sky.shape} + proxy {checker.shape} (mip chain, "
          f"atlas, pyramid {tuple(r.proxy_pyr.shape)}) in "
          f"{time.time() - t0:.1f} s; proxy grid "
          f"{r.proxy_tris.shape[1]} triangles")

    # 4b. the three kernels of the skybox and proxy passes, on a frame's own
    # inputs (the first fly-path camera), at the exact profile's full
    # resolution and at the fast profile's half resolution
    first_camera(eng)
    scene_d, cam_d = r.frame_uniforms(eng.camera, eng.scene_params,
                                      eng.render_config)[:2]
    rcfg = eng.render_config
    surface = int(eng.scene_params.surface_type)
    ptile = (r.cfg.proxy_tile_w, r.cfg.proxy_tile_h)
    p_n_proxy = ptile[0] * ptile[1]

    def tri_load(label, rows, t_rs, t_re, tri_kw, sorted_key=None,
                 sorted_tri=None, bbox=None):
        """The plain raster with the kernel's block mask against the plain
        spec (bit-equal, on the card), and the load it carries. Fails if
        the mask would leave out a pair-pixel that hits."""
        st = {}
        spec = trirast.rasterize_triangles_plain(rows, t_rs, t_re, **tri_kw)
        masked = trirast.rasterize_triangles_plain(
            rows, t_rs, t_re, block_mask=True, stats=st, **tri_kw)
        split = trirast.rasterize_split_plain(rows, t_rs, t_re, **tri_kw)
        if not (torch.equal(masked, spec) and torch.equal(split, spec)):
            raise RuntimeError(f"trirast {label}: the masked or the split "
                               f"plain raster is not the plain spec")
        if st["missed"]:
            raise RuntimeError(f"trirast {label}: the block mask leaves out "
                               f"{st['missed']} pair-pixels that hit")
        runs = st["runs"][st["runs"] > 0].double()
        chunks = st["chunks"]
        rq = torch.quantile(runs, torch.tensor([0.5, 0.99], device="cuda",
                                               dtype=torch.float64))
        pp = st["pair_pixels"]
        in_bbox = ""
        if bbox is not None:
            # pixel centres of each pair's tile inside its triangle's bbox
            tw_, th_ = tri_kw["tile_wh"]
            ntx_ = -(-tri_kw["image_wh"][0] // tw_)
            ox = ((sorted_key % ntx_) * tw_).double()
            oy = (torch.div(sorted_key, ntx_, rounding_mode="floor")
                  * th_).double()
            bx0, bx1, by0, by1 = (t[sorted_tri].double() for t in bbox)
            nx = (torch.minimum(torch.floor(bx1 - 0.5), ox + (tw_ - 1))
                  - torch.maximum(torch.ceil(bx0 - 0.5), ox) + 1)
            ny = (torch.minimum(torch.floor(by1 - 0.5), oy + (th_ - 1))
                  - torch.maximum(torch.ceil(by0 - 0.5), oy) + 1)
            n_bb = int((nx.clamp(min=0) * ny.clamp(min=0)).sum())
            in_bbox = f"in the bbox {n_bb / pp:.4f}, "
        print(f"[load] trirast {label}: {st['pairs']} pairs on "
              f"{int((st['runs'] > 0).sum())} of {st['runs'].numel()} tiles, "
              f"run length median {rq[0]:.0f}, p99 {rq[1]:.0f}, max "
              f"{runs.max():.0f}; chunks per tile max {int(chunks.max())}, "
              f"{int((chunks > 1).sum())} tiles of several, "
              f"{int(chunks.sum())} entries; of {pp} pair-pixels "
              f"{in_bbox}inside the triangle {st['inside'] / pp:.4f}, hits "
              f"{st['hits'] / pp:.4f}, in the warp blocks the mask keeps "
              f"{st['covered'] / pp:.4f}; (pair, block) visits "
              f"{st['visits']} of {st['blocks']} "
              f"({st['visits'] / max(st['blocks'], 1):.4f}), missed hits "
              f"{st['missed']}; masked and split plain rasters bit-equal to "
              f"the spec")
        return st

    def trirast_equal(label, rows, t_rs, t_re, tri_kw):
        """The kernels against the plain spec: (kernel output, max abs
        diff)."""
        k_out = trirast.rasterize_pair_rows(rows, t_rs, t_re, **tri_kw)
        p_out = trirast.rasterize_triangles_plain(rows, t_rs, t_re, **tri_kw)
        torch.cuda.synchronize()
        both = (k_out[:, 0] < 1.0) & (p_out[:, 0] < 1.0)
        hit_differs = int(((k_out[:, 0] < 1.0) != (p_out[:, 0] < 1.0)).sum())
        z_equal = bool(torch.equal(k_out[:, 0], p_out[:, 0]))
        a_err = (k_out[:, 1:] - p_out[:, 1:]).abs()
        a_ok = bool((a_err <= TRIRAST_ATTR_RTOL * p_out[:, 1:].abs()
                     + 1e-7).all())
        tri_err = float((k_out - p_out).abs().amax())
        print(f"[kernel] trirast {label}: {rows.shape[1]} pairs on "
              f"{k_out.shape[0]} tiles: hit differs on {hit_differs} px, z "
              f"bit-equal {z_equal} ({int(both.sum())} px hit), attributes "
              f"within {TRIRAST_ATTR_RTOL:g} relative {a_ok}, max abs diff "
              f"{tri_err:.3e}")
        if not (hit_differs == 0 and z_equal and a_ok
                and torch.isfinite(k_out).all()):
            raise RuntimeError(
                f"trirast {label}: the kernels disagree with the plain spec")
        return k_out, tri_err

    def trirast_check(wh):
        """The triangle raster on the bench proxy grid as the frame's camera
        projects it onto a wh image: the load, the kernels against the
        plain spec, their times and bounds, the longest run alone."""
        label = f"{wh[0]}x{wh[1]}"
        planes, ok, bbox = proxy.map_grid_planes(
            cam_d, scene_d, wh, r.hm4, r.height_map_wh, r.proxy_verts,
            r.proxy_tris, surface_type=surface,
            height_offset=float(rcfg.proxy_height))
        rows, t_rs, t_re, n_tri_pairs, skey, stri = trirast.bin_triangles(
            planes, bbox, ok, image_wh=wh, tile_wh=ptile, return_index=True)
        tri_kw = dict(image_wh=wh, tile_wh=ptile, chunk=128)
        st = tri_load(f"{label} ({int(ok.sum())} triangles)", rows, t_rs,
                      t_re, tri_kw, skey, stri, bbox)
        k_out, tri_err = trirast_equal(label, rows, t_rs, t_re, tri_kw)
        ntx_, n_t = -(-wh[0] // ptile[0]), t_rs.shape[0]
        # the two kernels apart: entries into the fold's scratch, then the
        # fold, against the fold's plain version on the same scratch
        scratch = trirast.fold_scratch(rows.shape[1], ptile, 128, "cuda")
        entry_out = torch.full_like(k_out, float("nan"))

        def launch(mode, out_):
            trirast._launch(rows, t_rs, t_re, out_, scratch, ntx=ntx_,
                            tile_wh=ptile, chunk=128, mode=mode)

        launch(1, entry_out)
        fold_out = entry_out.clone()
        launch(2, fold_out)
        fold_want = trirast.trirast_fold_plain(scratch, entry_out, t_rs,
                                               t_re, chunk=128)
        if not torch.equal(fold_out, fold_want):
            raise RuntimeError(f"trirast_fold {label}: the kernel is not "
                               f"its plain version")
        multi = int((st["chunks"] > 1).sum())
        tri_bytes = 4 * (rows.numel() + t_rs.numel() + t_re.numel()
                         + k_out.numel())
        tri_bounds = (tri_bytes / HBM_BYTES_PER_S,
                      st["covered"] * TRIRAST_FP32_OPS / FP32_OPS_PER_S)
        every_ms = (n_tri_pairs * p_n_proxy * TRIRAST_FP32_OPS
                    / FP32_OPS_PER_S * 1e3)
        tr = dict(
            name="trirast", route="cuda",
            source="gswt_renderer_tpu_torch/csrc/trirast.cu",
            replaces="gswt_renderer_tpu/ops/trirast.py:221",
            max_abs_err=tri_err,
            ms=_time_ms(torch, lambda: trirast.rasterize_pair_rows(
                rows, t_rs, t_re, **tri_kw), 50),
            plain_ms=_time_ms(
                torch, lambda: trirast.rasterize_triangles_plain(
                    rows, t_rs, t_re, **tri_kw), 2),
            library_ms=None,  # no single PyTorch call rasterizes triangles
            bound_ms=max(tri_bounds) * 1e3,
            bound_by=("bytes" if tri_bounds[0] >= tri_bounds[1]
                      else "operations"),
        )
        # the fold: per pixel of a multi-chunk tile the z of each of its
        # slots, the winner's 4 means where a chunk hit, the 5 output rows;
        # the ranges of every tile
        is_multi = st["chunks"] > 1
        n_multi_entries = int(st["chunks"][is_multi].sum())
        multi_hits = int((k_out[is_multi, 0] < 1.0).sum())
        fold_bytes = 4 * (p_n_proxy * (n_multi_entries + 5 * multi)
                          + 4 * multi_hits + 2 * n_t)
        fd = dict(
            name="trirast_fold", route="cuda",
            source="gswt_renderer_tpu_torch/csrc/trirast.cu",
            replaces="gswt_renderer_tpu/ops/trirast.py:221",
            max_abs_err=0.0,
            ms=_time_ms(torch, lambda: launch(2, fold_out), 50),
            plain_ms=_time_ms(torch, lambda: trirast.trirast_fold_plain(
                scratch, entry_out, t_rs, t_re, chunk=128), 5),
            library_ms=None,  # no single PyTorch call folds the partials
            bound_ms=fold_bytes / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes",
        )
        entries_ms = _time_ms(torch, lambda: launch(1, entry_out), 50)
        # own device time of each kernel in one profiler window
        from torch.profiler import ProfilerActivity, profile
        n_own = 20
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n_own):
                trirast.rasterize_pair_rows(rows, t_rs, t_re, **tri_kw)
            torch.cuda.synchronize()
        own = {"trirast_kernel": 0.0, "trirast_fold_kernel": 0.0}
        for ev in prof.key_averages():
            t = getattr(ev, "self_device_time_total", None)
            if t is None:
                t = getattr(ev, "self_cuda_time_total", 0.0)
            for key in own:
                if key in ev.key:
                    own[key] += t / 1e3 / n_own
        # the longest run alone: one tile's entries and its fold
        runs = t_re - t_rs
        top = int(torch.argmax(runs))
        keep = torch.arange(n_t, device="cuda") == top
        a_rs = torch.where(keep, t_rs, 0).int().contiguous()
        a_re = torch.where(keep, t_re, 0).int().contiguous()
        alone_ms = _time_ms(torch, lambda: trirast.rasterize_pair_rows(
            rows, a_rs, a_re, **tri_kw), 50)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n_own):
                trirast.rasterize_pair_rows(rows, a_rs, a_re, **tri_kw)
            torch.cuda.synchronize()
        alone_own = sum(
            getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
            for ev in prof.key_averages() if "trirast" in ev.key) / 1e3 / n_own
        # the wrapper's host time per call: 200 calls enqueued without a
        # synchronize (the queue does not fill), host clock
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            trirast.rasterize_pair_rows(rows, t_rs, t_re, **tri_kw)
        host_ms = (time.perf_counter() - t0) * 1e3 / 200
        torch.cuda.synchronize()
        # the C entry alone, its arguments built once: the launches' own
        # host cost, the rest of host_ms being the Python wrapper's
        c_args = (rows.data_ptr(), rows.shape[1], t_rs.data_ptr(),
                  t_re.data_ptr(), fold_out.data_ptr(), scratch.data_ptr(),
                  n_t, ntx_, ptile[0], ptile[1], 128, 3,
                  kernels.stream_ptr(fold_out))
        t0 = time.perf_counter()
        for _ in range(200):
            trirast._entry(*c_args)
        launch_ms = (time.perf_counter() - t0) * 1e3 / 200
        torch.cuda.synchronize()
        print(f"[kernel] trirast {label}: {tr['ms']:.4f} ms by events "
              f"(entries {entries_ms:.4f} + fold {fd['ms']:.4f} apart), "
              f"wrapper host time {host_ms:.4f} ms per call (the C entry "
              f"alone {launch_ms:.4f}); own "
              f"device time entries {own['trirast_kernel']:.4f}, fold "
              f"{own['trirast_fold_kernel']:.4f} ms; plain "
              f"{tr['plain_ms']:.3f}; bound {tr['bound_ms']:.4f} by "
              f"{tr['bound_by']}: bytes {tri_bounds[0] * 1e3:.4f}, "
              f"covered-only operations (the pair-pixels of the warp blocks "
              f"the mask keeps) {tri_bounds[1] * 1e3:.5f} (the older "
              f"convention, every pair-pixel's operations: {every_ms:.4f}); "
              f"fold bound {fd['bound_ms']:.4f} (bytes: the slots' z, the "
              f"winners' means on {multi_hits} hit px of {multi} multi-chunk "
              f"tiles, the output), plain fold "
              f"{fd['plain_ms']:.3f}")
        print(f"[kernel] trirast {label} on the longest run alone "
              f"({int(runs[top])} pairs, tile {top}, "
              f"{int(st['chunks'][top])} chunks): {alone_ms:.4f} ms by "
              f"events, own device time {alone_own:.4f} ms (entries and "
              f"fold), against the whole raster's {tr['ms']:.4f} by events "
              f"and {own['trirast_kernel'] + own['trirast_fold_kernel']:.4f} "
              f"own")
        return tr, fd

    def mip_check(wh):
        """The mip pyramid sampler at a wh proxy pass's own u, v, rho: the
        kernel on the Renderer's pyramid (the interleaved texels) against
        the plain spec on the planes; its time by events, its own device
        time, and the wrapper's host time per call."""
        n_s = wh[0] * wh[1]
        _, u_px, v_px, _, hit_px, _ = proxy.raster_map_grid(
            cam_d, scene_d, wh, r.hm4, r.height_map_wh, r.proxy_verts,
            r.proxy_tris, surface_type=surface,
            height_offset=float(rcfg.proxy_height), tile_wh=ptile, chunk=128)
        rho_px = proxy._uv_footprint(u_px, v_px, float(r.proxy_wh[0]),
                                     float(r.proxy_wh[1]))
        pyr_meta, l_min = r.proxy_pyr_meta
        texels = r.proxy_pyr
        planes = texels[..., :3].permute(2, 0, 1).contiguous()
        mip_args = (pyr_meta, l_min, u_px, v_px, rho_px)

        def kernel():
            return texsample.factored_mip_trilinear(texels, *mip_args, n_ch=3)

        k_out = kernel()
        p_out = texsample.factored_mip_trilinear_plain(planes, *mip_args)
        t_out = texsample.factored_mip_trilinear_texels_plain(
            texels, 3, *mip_args)
        mip_err = float((k_out - p_out).abs().amax())
        print(f"[kernel] mip_trilinear {wh[0]}x{wh[1]}: planes "
              f"{tuple(planes.shape)}, texels {tuple(texels.shape)}, "
              f"l_min {l_min}, {len(pyr_meta)} levels at {n_s} samples "
              f"({float(hit_px.float().mean()):.3f} on the ground): max abs "
              f"diff {mip_err:.3e}; the texel plain form bit-equal to the "
              f"spec {torch.equal(t_out, p_out)}")
        if not (mip_err <= SAMPLER_TOL and torch.isfinite(k_out).all()
                and torch.equal(t_out, p_out)):
            raise RuntimeError(
                "mip_trilinear kernel disagrees with its plain version")
        mp = dict(
            name="mip_trilinear", route="cuda",
            source="gswt_renderer_tpu_torch/csrc/miptrilinear.cu",
            replaces="gswt_renderer_tpu/ops/texsample.py:322",
            max_abs_err=mip_err,
            ms=_time_ms(torch, kernel, 200),
            plain_ms=_time_ms(
                torch,
                lambda: texsample.factored_mip_trilinear_plain(planes,
                                                               *mip_args), 3),
            library_ms=None,  # no single PyTorch call samples a packed mip chain
            # texels (8 B each), u, v and rho read once; [3, P] written once
            bound_ms=(texels.numel() * 2 + 4 * 3 * n_s + 4 * 3 * n_s)
            / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes",
        )
        # the wrapper's host time per call: 200 calls enqueued without a
        # synchronize (the queue does not fill), host clock
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            kernel()
        host_ms = (time.perf_counter() - t0) * 1e3 / 200
        torch.cuda.synchronize()
        out_ = torch.empty_like(k_out)
        uvr = [t.contiguous() for t in (u_px, v_px, rho_px)]
        c_args = (texels.data_ptr(), 3, texels.shape[0], texels.shape[1],
                  texsample._mip_level_table(pyr_meta), len(pyr_meta),
                  int(l_min), uvr[0].data_ptr(), uvr[1].data_ptr(),
                  uvr[2].data_ptr(), n_s, out_.data_ptr(),
                  kernels.stream_ptr(out_))
        entry = texsample._mip_launch_fn()
        t0 = time.perf_counter()
        for _ in range(200):
            entry(*c_args)
        launch_ms = (time.perf_counter() - t0) * 1e3 / 200
        torch.cuda.synchronize()
        from torch.profiler import ProfilerActivity, profile
        n_own = 50
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n_own):
                kernel()
            torch.cuda.synchronize()
        own = 0.0
        for ev in prof.key_averages():
            if "mip_trilinear_kernel" in ev.key:
                t = getattr(ev, "self_device_time_total", None)
                if t is None:
                    t = getattr(ev, "self_cuda_time_total", 0.0)
                own += t / 1e3 / n_own
        if not own > 0:
            raise RuntimeError("the profiler saw no mip_trilinear kernel")
        print(f"[kernel] mip_trilinear {wh[0]}x{wh[1]}: own device time "
              f"{own:.4f} ms; by events {mp['ms']:.4f} ms; wrapper host time "
              f"{host_ms:.4f} ms per call (the C entry alone "
              f"{launch_ms:.4f}); plain {mp['plain_ms']:.3f}; bound "
              f"{mp['bound_ms']:.4f}")
        return mp

    def trirast_adversarial(chunk):
        """The kernels against the plain spec on the adversarial triangles
        of tests/torch_tables.py (slivers, vertices 1e4 px off-screen,
        edges through pixel centres, near- and far-plane crossings, ties
        across chunk boundaries, empty tiles)."""
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tests"))
        from torch_tables import adversarial_triangles, binned_triangles
        for seed in (0, 1):
            rows, t_rs, t_re, _ = binned_triangles(
                adversarial_triangles(seed), device="cuda")
            kw = dict(image_wh=(384, 256), tile_wh=(64, 32), chunk=chunk)
            tri_load(f"adversarial seed {seed}, chunk {chunk}", rows, t_rs,
                     t_re, kw)
            trirast_equal(f"adversarial seed {seed}, chunk {chunk}", rows,
                          t_rs, t_re, kw)

    half_wh = (-(-width // 2), -(-height // 2))
    trirast_adversarial(128)
    trirast_adversarial(32)
    trirast_check(image_wh)
    tr, fd = trirast_check(half_wh)   # the main path's shape
    mip_check(image_wh)
    mp = mip_check(half_wh)       # the main path's shape

    # bilinear sampler: the equirect sky at every pixel's view direction
    sky_planes = torch.movedim(r.skybox_tex, -1, 0).contiguous()
    sx, sy = skybox.equirect_texel_coords(
        skybox.sky_directions(cam_d, image_wh, equirect=True),
        tuple(r.skybox_tex.shape[:2]))
    bl_kw = dict(wrap_x=False, wrap_y=False)
    k_out = texsample.factored_bilinear(sky_planes, sx, sy, **bl_kw)
    p_out = texsample.factored_bilinear_plain(sky_planes, sx, sy, **bl_kw)
    _, s_h, s_w = sky_planes.shape
    grid = torch.stack([(sx + 0.5) / s_w * 2.0 - 1.0,
                        (sy + 0.5) / s_h * 2.0 - 1.0], dim=-1).reshape(
                            1, 1, n_px, 2)

    def grid_sample():
        return torch.nn.functional.grid_sample(
            sky_planes[None], grid, mode="bilinear", padding_mode="border",
            align_corners=False)

    bl_err = float((k_out - p_out).abs().amax())
    lib_err = float((grid_sample()[0, :, 0] - k_out.reshape(3, -1)).abs().amax())
    print(f"[kernel] bilinear {tuple(sky_planes.shape)} at {n_px} samples: "
          f"max abs diff {bl_err:.3e} (grid_sample differs by {lib_err:.3e})")
    if not (torch.equal(k_out, p_out) and torch.isfinite(k_out).all()):
        raise RuntimeError("bilinear kernel disagrees with its plain version")
    bl = dict(
        name="bilinear", route="cuda",
        source="gswt_renderer_tpu_torch/csrc/bilinear.cu",
        replaces="gswt_renderer_tpu/ops/texsample.py:119",
        max_abs_err=bl_err,
        ms=_time_ms(torch, lambda: texsample.factored_bilinear(
            sky_planes, sx, sy, **bl_kw), 50),
        plain_ms=_time_ms(torch, lambda: texsample.factored_bilinear_plain(
            sky_planes, sx, sy, **bl_kw), 10),
        library_ms=_time_ms(torch, grid_sample, 50),
        # texture, x and y read once; [C, P] written once
        bound_ms=4 * (sky_planes.numel() + 2 * n_px + 3 * n_px)
        / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
    )
    # like for like: each call's own device time, kernel and grid_sample in
    # one profiler window (CUDA events time a sub-0.1 ms call's enqueue)
    from torch.profiler import ProfilerActivity, profile
    n_own = 20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_own):
            texsample.factored_bilinear(sky_planes, sx, sy, **bl_kw)
            grid_sample()
        torch.cuda.synchronize()
    own = {"bilinear": 0.0, "grid_sample": 0.0}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        key = ("bilinear" if "bilinear_kernel" in ev.key else
               "grid_sample" if "grid_sampler" in ev.key else None)
        if key:
            own[key] += t / 1e3 / n_own
    print(f"[kernel] bilinear: {bl['ms']:.4f} ms (plain {bl['plain_ms']:.4f}, "
          f"grid_sample {bl['library_ms']:.4f}, bound {bl['bound_ms']:.4f}); "
          f"own device time in one profiler window: kernel "
          f"{own['bilinear']:.4f} ms, grid_sample {own['grid_sample']:.4f} ms")
    if not (own["bilinear"] > 0 and own["grid_sample"] > 0):
        raise RuntimeError("the profiler saw no bilinear or grid_sample "
                           "kernel on the device")

    # the exact compositor and the block gather on the exact full-config
    # frame's own inputs: pairs depth-tested against the proxy's depth.
    # Splats behind the ground no longer raise a pixel's opacity, so fewer
    # tiles saturate and leave their run early than in the gs-only frame.
    def frame_inputs(e):
        """One full-config frame's plan checked through the block gather,
        and its binned pair table and proxy depth."""
        rr = e.renderer
        plan_f = rr.upload_plan(e._staged)
        src_f = plan_f["blocks"][0].contiguous()
        scratch_f = project.merged_scratch(plan_f["merged"], rr.store_packed,
                                           rr.panels.shape[0])
        if not torch.equal(
                block_gather(rr.panels, src_f, scratch_f).view(torch.int32),
                block_gather_plain(rr.panels, src_f,
                                   scratch_f).view(torch.int32)):
            raise RuntimeError("block_gather kernel disagrees with its plain "
                               "version on the full-config plan")
        binned_f, _, depth_f, _ = rr.front(
            plan_f, e.camera, e.scene_params, e.render_config,
            use_skybox=True, use_proxy=True)
        return binned_f, depth_f

    def raster_entry(name, table, depth, e, st, ops, **kw):
        bound, by, terms = raster_kept_bound(
            st, ops, kw["use_depth"], kw.get("emit_zcut", False))
        d = dict(
            name=name, route="cuda",
            source="gswt_renderer_tpu_torch/csrc/raster.cu",
            replaces="gswt_renderer_tpu/ops/raster.py:735",
            max_abs_err=e,
            ms=_time_ms(torch, lambda: raster.rasterize(table, depth, **kw),
                        10),
            plain_ms=_time_ms(
                torch, lambda: raster.rasterize_plain(table, depth, **kw), 1),
            library_ms=None,  # no stock call composites a sorted pair table
            bound_ms=bound,
            bound_by=by,
        )
        print(f"[kernel] {name} {st['pairs']} pairs x {p_n} px, "
              f"{st['kept']} pair-pixels kept: {d['ms']:.3f} ms (plain "
              f"{d['plain_ms']:.3f}, bound {d['bound_ms']:.4f} by {by}: "
              f"FP32 {terms['operations']:.4f}, SFU {terms['sfu']:.4f}, "
              f"bytes {terms['bytes']:.4f}; every pair-pixel in full "
              f"{raster_bound_ms(st['pairs'], ops):.3f})")
        return d

    binned_f, depth_f = frame_inputs(eng)
    st_f = raster_check(
        "exact, full-config frame, against the proxy depth", binned_f,
        depth_f, **depth_kw)[2]
    other_variants("full-config frame, against the proxy depth", binned_f,
                   depth_f, done_exact, **depth_kw)
    rs = raster_entry("raster", binned_f, depth_f,
                      variant_err[(True, False)], st_f, RASTER_FP32_OPS,
                      **depth_kw)
    nodepth_ms = _time_ms(torch, lambda: raster.rasterize(
        binned_f, depth_f, **main_kw), 10)
    stats_nd = {}
    raster.rasterize_plain(binned_f, depth_f, stats=stats_nd, **main_kw)
    print(f"[kernel] raster exact: untested, the same table composites "
          f"{stats_nd['pairs']} pairs in {nodepth_ms:.3f} ms")

    # 5b. slice 2's main path: exact full-config frames, at a cut depth
    kernels.LAUNCHES.clear()
    exact_run = drive(eng, N_FRAMES_EXACT, "exact full-config")
    launches_exact = dict(kernels.LAUNCHES)
    need(launches_exact, ("block_gather", "raster", "trirast", "trirast_fold",
                          "bilinear"),
         N_FRAMES_EXACT, "exact full-config")
    if launches_exact.get("mip_trilinear", 0):
        raise RuntimeError("the exact-profile frame launched mip_trilinear: "
                           "it samples the proxy through the atlas")
    rs["launches"] = launches_exact["raster"]
    report("exact full-config", exact_run, launches_exact)
    print(f"[main] proxy pairs last frame "
          f"{eng.renderer.last_aux['proxy_pairs']}, setup {setup_s:.1f} s")

    # 6a. where the exact full-config frame's time goes
    phase_profile(torch, eng, fp, "exact")
    eng.shutdown()

    # ------------------------------------------------------------------ #
    # this slice: the fast profile, the frame bench.py times
    # ------------------------------------------------------------------ #
    eng, setup_fast_s = bench_engine(
        RendererConfig(width=width, height=height), "fast, bench.py:157")
    r = eng.renderer
    if r.cfg.exact or r.cfg.sat_cull or r.cfg.depth_cull:
        raise RuntimeError("the default RendererConfig is not the fast "
                           "profile with both culls off")
    eng.set_skybox(sky, equirect=True)
    eng.set_proxy(checker)
    first_camera(eng)

    # 4c. the compositor's fast variant, and fast + saturation-slot record,
    # on the fast frame's own pair table (quantized values) under its
    # half-res, nearest-upsampled proxy depth
    binned_q, depth_q = frame_inputs(eng)
    fast_kw = dict(depth_kw, exact=False)
    st_q = raster_check(
        "fast, full-config frame, against the half-res proxy depth",
        binned_q, depth_q, **fast_kw)[2]
    st_z = raster_check(
        "fast + zcut, the same table", binned_q, depth_q, emit_zcut=True,
        **fast_kw)[2]
    other_variants("fast frame's table", binned_q, depth_q,
                   {(False, False), (False, True)}, **depth_kw)
    # each entry's max_abs_err: its variant over every table it was held on
    rs["max_abs_err"] = variant_err[(True, False)]
    rf = raster_entry("raster_fast", binned_q, depth_q,
                      variant_err[(False, False)], st_q,
                      RASTER_FAST_FP32_OPS, **fast_kw)
    rz = raster_entry("raster_fast_zcut", binned_q, depth_q,
                      variant_err[(False, True)], st_z,
                      RASTER_FAST_FP32_OPS, emit_zcut=True, **fast_kw)
    print(f"[kernel] raster, all four variants on the gs-only (untested and "
          f"random depth), exact and fast full-config tables: max abs diff "
          f"per (exact, zcut) {variant_err}")
    # the longest run alone: a tile is one CTA walking its run in order, so
    # the kernel takes at least this tile's time on one SM
    runs_q = binned_q["range_end"] - binned_q["range_start"]
    top = int(torch.argmax(runs_q))
    alone = dict(binned_q, **{k: torch.where(
        torch.arange(n_tiles, device="cuda") == top, binned_q[k], 0).int()
        .contiguous() for k in ("range_start", "range_end")})
    alone_ms = _time_ms(torch, lambda: raster.rasterize(
        alone, depth_q, **fast_kw), 10)
    print(f"[kernel] raster_fast on the longest run alone ({int(runs_q[top])} "
          f"pairs, tile {top}): {alone_ms:.3f} ms of the frame's "
          f"{rf['ms']:.3f} ms")
    exact_on_q_ms = _time_ms(torch, lambda: raster.rasterize(
        binned_q, depth_q, **depth_kw), 10)
    print(f"[kernel] raster variants on the fast frame's table: exact "
          f"{exact_on_q_ms:.3f} ms, fast {rf['ms']:.3f} ms, fast + zcut "
          f"{rz['ms']:.3f} ms")

    # 5c. the main path: fast full-config frames through Engine
    kernels.LAUNCHES.clear()
    fast_run = drive(eng, N_FRAMES, "fast full-config", alpha_share=0.02)
    launches = dict(kernels.LAUNCHES)
    per_frame = ("block_gather", "raster", "trirast", "trirast_fold",
                 "bilinear", "mip_trilinear")
    need(launches, per_frame, N_FRAMES, "fast full-config")
    for k in (bg, tr, fd, bl, mp):
        k["launches"] = launches[k["name"]]
    rf["launches"] = launches["raster"]
    report("fast full-config", fast_run, launches)
    print(f"[main] proxy pairs last frame "
          f"{eng.renderer.last_aux['proxy_pairs']}, setup "
          f"{setup_fast_s:.1f} s")

    # 5d. the sat-cull path: the same Engine at a fixed camera (the last
    # fly-path pose), first without the cull, then with it. Frame 1 records,
    # the later frames cull by the record; the builder thread is idle, so
    # the frames differ by the cull alone.
    quiet, staged = 0, eng._staged
    while quiet < 10:  # until the builder's last sort has come in
        eng.frame(readback=False)
        time.sleep(0.05)
        quiet = quiet + 1 if eng._staged is staged else 0
        staged = eng._staged
    still = drive(eng, N_FRAMES_SAT, "fast, fixed camera", alpha_share=0.02,
                  moving=False)
    r.cfg = dataclasses.replace(r.cfg, sat_cull=True)
    kernels.LAUNCHES.clear()
    sat_run = drive(eng, N_FRAMES_SAT, "fast + sat_cull", alpha_share=0.02,
                    moving=False)
    launches_sat = dict(kernels.LAUNCHES)
    r.cfg = dataclasses.replace(r.cfg, sat_cull=False)
    need(launches_sat, per_frame, N_FRAMES_SAT, "sat-culled")
    rz["launches"] = launches_sat["raster"]
    if r.sat_zimg is None:
        raise RuntimeError("the sat-culled frames left no saturation-slot "
                           "image: the zcut variant did not run")
    cut_bands = int((r.sat_zimg < raster.SAT_NOCUT).sum())
    sat_diff = float((sat_run["img"] - still["img"]).abs().amax())
    print(f"[sat] {N_FRAMES_SAT} frames at a fixed camera: median "
          f"{np.median(sat_run['ms']):.2f} ms with sat_cull against "
          f"{np.median(still['ms']):.2f} ms without; pairs kept "
          f"{sat_run['kept']} against {still['kept'][-1]} (frame 1 records, "
          f"culled {still['kept'][-1] - sat_run['kept'][-1]} pairs at the "
          f"end); cut image {tuple(r.sat_zimg.shape)}, {cut_bands} of "
          f"{r.sat_zimg.numel()} band cells cut; last frame differs from "
          f"the un-culled one by max {sat_diff:.3e}; launches {launches_sat}")
    # the culled pairs composite behind a transmittance < MIN_T; the 1.5 is
    # tests/test_sat_cull.py's allowance for the early exit's moved phase
    if sat_diff > MIN_T * 1.5 or sat_run["kept"][-1] > still["kept"][-1]:
        raise RuntimeError("the sat-culled frame is not the un-culled one")

    # 6b. where the fast full-config frame's time goes
    phase_profile(torch, eng, fp, "fast")
    eng.shutdown()

    # ------------------------------------------------------------------ #
    # 7. the benchmarks sub-package: the parked merge and the micro-bench
    # kernels against their plain versions at the scripts' own shapes, then
    # the scripts themselves and the headline fly-through through main()
    # ------------------------------------------------------------------ #
    csrc = "gswt_renderer_tpu_torch/csrc/"

    def once_ms(fn):
        """(result, device ms) of one call, no warm-up: for the plain
        versions that take seconds."""
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)

    def same_words(x, y):
        return bool(torch.equal(x.view(torch.int32), y.view(torch.int32)))

    # 7a. sorted merge at micro_merge's shape: 5 tables of 1 << 22 lanes in
    # all, int32 key + 6 payload rows, block 2048
    mm_n, mm_k, mm_rows, mm_block = 1 << 22, 5, 7, 2048
    tabs_np, keys_np = micro_merge.make_tables(mm_n, mm_k, mm_rows)
    tabs = [torch.from_numpy(t).cuda() for t in tabs_np]
    want_keys = torch.from_numpy(np.sort(keys_np)).cuda()

    def merge_check(label, tables):
        """The merge of `tables` against its plain version and numpy."""
        n_in = sum(t.shape[1] for t in tables)
        got = mergesorted.merge_sorted(tables, block=mm_block)
        plain, plain_ms = once_ms(lambda: mergesorted.merge_sorted_plain(
            tables, block=mm_block))
        torch.cuda.synchronize()
        real = got[0].view(torch.int32) != mergesorted.SENTINEL
        ordered = torch.sort(torch.cat(
            [t[0].view(torch.int32) for t in tables]))[0]
        keys_ok = (int(real.sum()) == n_in and bool(real[:n_in].all())
                   and bool(torch.equal(got[0, :n_in].view(torch.int32),
                                        ordered)))
        tail = got[:, n_in:].view(torch.int32)
        tail_ok = (bool((tail[0] == mergesorted.SENTINEL).all())
                   and not bool(tail[1:].any()))
        rows_ok = same_words(got, plain)
        print(f"[kernel] {label}: {n_in} lanes -> {got.shape[1]} columns x "
              f"{got.shape[0]} rows, keys equal to the sorted keys {keys_ok}, "
              f"rows bit-equal to the plain version {rows_ok}, sentinel tail "
              f"of {got.shape[1] - n_in} columns {tail_ok}")
        if not (keys_ok and rows_ok and tail_ok):
            raise RuntimeError(f"{label}: the kernel disagrees with its "
                               f"plain version")
        return got, plain_ms

    def merge_bytes(widths):
        """Bytes the tournament must move: every pair merge reads both
        tables once and writes its block-rounded output once."""
        widths, total = sorted(widths), 0
        while len(widths) > 1:
            na, nb = widths.pop(0), widths.pop(0)
            no = -(-(na + nb) // mm_block) * mm_block
            total += 4 * mm_rows * (na + nb + no)
            widths = sorted(widths + [no])
        return total

    pair = tabs[:2]
    merge_check("merge_sorted_pair", pair)
    pair_flat = torch.cat(pair, dim=1)
    pair_ms = _time_ms(torch, lambda: mergesorted.merge_sorted_pair(
        *pair, block=mm_block), 20)
    pair_lib = _time_ms(
        torch, lambda: micro_merge.sort_and_gather(pair_flat), 20)
    pair_bound = merge_bytes([t.shape[1] for t in pair]) / HBM_BYTES_PER_S * 1e3
    print(f"[kernel] merge_sorted_pair {pair[0].shape[1]} + "
          f"{pair[1].shape[1]} lanes: {pair_ms:.4f} ms (torch.sort + gather "
          f"{pair_lib:.4f}, bound {pair_bound:.4f})")
    merged, mm_plain_ms = merge_check(f"merge_sorted k={mm_k}", tabs)
    if not torch.equal(merged[0, :mm_n].view(torch.int32), want_keys):
        raise RuntimeError("merge_sorted: keys are not numpy's merge")
    del merged, pair_flat

    # 7b. micro-raster variants at 1 << 22 pairs, 1080p, 64x32, chunk 256.
    # Tolerance 1e-4 per channel, absolute, in every variant: the plain
    # version walks a chunk's pairs in the kernel's order and rounds the
    # exponent's operations (and its bf16 hi/lo parts) as the kernel does, so
    # T, the cutoff and the bf16 rounding of the weights decide alike; what is
    # left is the f32 order of the colour sums. One exception, variant D only
    # (the script's accuracy reference, not a usable compositor): its
    # exponent, from operands rounded to bf16 once, comes out positive for
    # some pairs, g exceeds 1, T changes sign and a pixel's sums are signed
    # terms of up to 1e6 that partly cancel. A pixel whose sum of |w| passes
    # 1.01 is held to 1e-4 of that sum (the f32 rounding of its sums scales
    # with it) and is left out of the absolute figure; the share of such
    # pixels is printed, and must be 0 in A, B, C and C2.
    # Bound: the compositor's convention (RASTER_FP32_OPS above): the whole
    # per-pair-pixel work (the exponent, 10 FP32 operations or 31 when
    # split2, its compare, the other 13, 2 more for the bf16 rounding, and
    # the exp) on the pair-pixels that pass the cutoff and the depth test,
    # beside the 11 table rows of the composited pairs, the depth and the
    # output, each moved once; the plain version counts the pairs and the
    # kept pair-pixels. PR 4's convention (the exponent and compare on every
    # composited pair-pixel) is printed beside it.
    # The kernel skips, per warp, the pairs its f64 block mask leaves out,
    # with a margin for each precision: the plain version computes the same
    # mask on the card's tensors and counts the (pair, warp block) visits it
    # keeps and the kept pair-pixels it would leave out, which must be 0.
    # Each instantiation's registers and spill come from the build's ptxas
    # report.
    mr_regs = micro_raster.ptxas_by_variant(reports["micro_raster"])
    for (loc, prec_i, bf2_i), text in sorted(mr_regs.items()):
        names = [n for n, (lo, pr, b2, _) in micro_raster.VARIANTS.items()
                 if (int(lo), micro_raster.PRECISIONS.index(pr), int(b2))
                 == (loc, prec_i, bf2_i)]
        print(f"[build] micro_raster <kLocal={loc}, kPrec={prec_i}, "
              f"kBf2={bf2_i}> {'/'.join(names) or '(no variant)'}: {text}")
    if len(mr_regs) != 12:
        raise RuntimeError(f"micro_raster: {len(mr_regs)} of 12 "
                           f"instantiations in the ptxas report")
    mr_pairs, mr_chunk = 1 << 22, 256
    mr_binned = micro_raster.make_binned(mr_pairs, image_wh, tile_wh,
                                         device="cuda")
    mr_ops = {"highest": 10, "split2": 31, "default": 10}
    mr_out, mr_info = {}, {}
    for name, (local, prec, bf2, text) in micro_raster.VARIANTS.items():
        b_v, kw_v = micro_raster.variant_inputs(
            mr_binned, name, image_wh=image_wh, tile_wh=tile_wh)
        kw_v.update(image_wh=image_wh, tile_wh=tile_wh, chunk=mr_chunk)
        k_out = micro_raster.composite(b_v, ones, **kw_v)
        st = {}
        p_out, plain_ms = once_ms(lambda: micro_raster.composite_plain(
            b_v, ones, stats=st, **kw_v))
        mag = st["mag"][:, None, :]
        blown = (mag > 1.01).expand_as(p_out)
        blown_share = float(blown.float().mean())
        diff = (k_out - p_out).abs()
        e = float(diff[~blown].amax())
        e_blown = (float((diff / mag.clamp(min=1.0))[blown].amax())
                   if blown_share else 0.0)
        mr_out[name] = k_out
        err_a = float((k_out - mr_out["A"]).abs().amax())
        pp, kept = st["pairs"] * p_n, st["kept"]
        rest = 13 + (2 if bf2 else 0)
        n_bytes = 4 * (st["pairs"] * RASTER_ROWS + 2 * n_tiles
                       + 5 * n_tiles * p_n)
        mr_info[name] = dict(
            err=e, plain_ms=plain_ms, pairs=st["pairs"], kept_share=kept / pp,
            visit_share=st["visits"] / st["blocks"],
            bound_ms=max(kept * (mr_ops[prec] + 1 + rest) / FP32_OPS_PER_S,
                         kept / SFU_OPS_PER_S,
                         n_bytes / HBM_BYTES_PER_S) * 1e3,
            bound_pr4_ms=max((pp * (mr_ops[prec] + 1) + kept * rest)
                             / FP32_OPS_PER_S, kept / SFU_OPS_PER_S) * 1e3)
        print(f"[kernel] micro_raster {name} ({text}): max |diff| {e:.3e} "
              f"against its plain version; {blown_share:.3e} of the pixels "
              f"have a sum of |w| over 1.01 and differ by at most "
              f"{e_blown:.3e} of it; {err_a:.3e} against A, alpha "
              f"{float(k_out[:, 3].mean()):.4f}, {st['pairs']} of "
              f"{int((mr_binned['key'] < n_tiles).sum())} pairs composited, "
              f"{kept} of {pp} pair-pixels kept ({kept / pp:.4f})")
        print(f"[load] micro_raster {name}: the block mask (relative margin "
              f"{micro_raster.MASK_REL[prec]!r}) keeps {st['visits']} of "
              f"{st['blocks']} (pair, warp block) visits "
              f"({st['visits'] / st['blocks']:.4f}); kept pair-pixels in "
              f"blocks it leaves out: {st['missed']}")
        if st["missed"]:
            raise RuntimeError(f"micro_raster {name}: the block mask leaves "
                               f"out {st['missed']} kept pair-pixels")
        if not (e <= RASTER_TOL and e_blown <= RASTER_TOL
                and blown_share <= (0.5 if name == "D" else 0.0)
                and torch.isfinite(k_out).all()):
            raise RuntimeError(f"micro_raster {name}: the kernel disagrees "
                               f"with its plain version")
    del mr_out, mr_binned, b_v, k_out, p_out, st, mag, blown, diff

    # 7c. micro block gathers at the script's shape: [11, 4M] strided and
    # [16384, 16, 256] block-contiguous, 12288 blocks
    bg_np, bg_nb = 4 << 20, 12 << 10
    table_s, table_bc, src_g = micro_blockgather.make_inputs(
        bg_np, bg_nb, "cuda")
    g_checks = {
        "strided": (lambda: micro_blockgather.gather_strided(table_s, src_g),
                    lambda: micro_blockgather.gather_strided_plain(
                        table_s, src_g)),
        "contig g8": (lambda: micro_blockgather.gather_contig(
            table_bc, src_g, group=8),
            lambda: micro_blockgather.gather_contig_plain(table_bc, src_g)),
        "contig g1": (lambda: micro_blockgather.gather_contig(
            table_bc, src_g, group=1),
            lambda: micro_blockgather.gather_contig_plain(table_bc, src_g)),
    }
    g_plain_ms = {}
    for label, (k_fn, p_fn) in g_checks.items():
        if not same_words(k_fn(), p_fn()):
            raise RuntimeError(f"micro_blockgather {label}: the kernel "
                               f"disagrees with its plain version")
        g_plain_ms[label] = _time_ms(torch, p_fn, 10)
        print(f"[kernel] micro_blockgather {label}: bit-exact")
    del table_s, table_bc

    # 7d. the bench entry's path, through the entry points a user calls, one
    # launch window per script: the three micro-benchmarks at their default
    # (full) shapes, then the headline fly-through
    kernels.LAUNCHES.clear()
    mm_res = micro_merge.main([])
    launches_mm = dict(kernels.LAUNCHES)
    need(launches_mm, ("merge_sorted_pair", "merge_path_splits"), mm_k - 1,
         "micro_merge tournament")
    if mm_res["mismatched"]:
        raise RuntimeError("micro_merge: merged keys differ from numpy's")
    kernels.LAUNCHES.clear()
    mr_res = micro_raster.main([])
    launches_mr = dict(kernels.LAUNCHES)
    need(launches_mr, ("micro_raster",), len(micro_raster.VARIANTS),
         "micro_raster variant")
    kernels.LAUNCHES.clear()
    bg_res = micro_blockgather.main([])
    launches_bg = dict(kernels.LAUNCHES)
    need(launches_bg, ("micro_blockgather_strided",), 1, "micro_blockgather")
    need(launches_bg, ("micro_blockgather_contig",), 2, "micro_blockgather")
    print(f"[micro] launches: micro_merge {launches_mm}, micro_raster "
          f"{launches_mr}, micro_blockgather {launches_bg}")

    mm_bound = merge_bytes([t.shape[1] for t in tabs]) / HBM_BYTES_PER_S * 1e3
    print(f"[kernel] merge_sorted k={mm_k} tournament ({mm_k - 1} pair "
          f"merges): {mm_res['merge_ms']:.4f} ms (plain "
          f"{mm_plain_ms:.3f}, torch.sort + gather {mm_res['sort_ms']:.4f}, "
          f"bound {mm_bound:.4f})")
    # one entry for the merge kernel: a whole k=5 tournament (4 launches of
    # the merge kernel and 4 of the split kernel), what micro_merge times
    new_entries = [dict(
        name="merge_sorted_pair", route="cuda", source=csrc + "mergesorted.cu",
        replaces="benchmarks/mergesorted.py:227",
        launches=launches_mm["merge_sorted_pair"], max_abs_err=0.0,
        ms=mm_res["merge_ms"], plain_ms=mm_plain_ms, bound_ms=mm_bound,
        bound_by="bytes", library_ms=mm_res["sort_ms"])]
    # max_abs_err is absolute; D's leaves out its pixels with a sum of |w|
    # over 1.01, which 7b holds relative to that sum and prints apart
    for name, info in mr_info.items():
        new_entries.append(dict(
            name=f"micro_raster_{name}", route="cuda",
            source=csrc + "micro_raster.cu",
            replaces="benchmarks/micro_raster.py:189",
            launches=launches_mr["micro_raster"] // len(micro_raster.VARIANTS),
            max_abs_err=info["err"], ms=mr_res[name]["ms"],
            plain_ms=info["plain_ms"], bound_ms=info["bound_ms"],
            bound_by="operations",
            library_ms=None))  # no stock call composites a sorted pair table
        print(f"[kernel] micro_raster {name} {info['pairs']} pairs x {p_n} "
              f"px, {info['kept_share']:.4f} of them kept, "
              f"{info['visit_share']:.4f} of the (pair, block) visits: "
              f"{mr_res[name]['ms']:.3f} ms (plain {info['plain_ms']:.1f}, "
              f"bound {info['bound_ms']:.4f} from the kept pair-pixels; "
              f"PR 4's, the exponent on every one, "
              f"{info['bound_pr4_ms']:.3f}), max |err| against A "
              f"{mr_res[name]['err_vs_a']:.3e}")
    # label -> (table rows, the script's kernel line, its library line, the
    # entry's name and the TPU call site it replaces; group 1 is the same
    # kernel as group 8 and is listed once)
    gathers = {
        "strided": (micro_blockgather.K, "kernel strided",
                    "slice gather (index_select)",
                    "micro_blockgather_strided", "80"),
        "contig g8": (micro_blockgather.K16, "kernel blk-contig g8",
                      "row gather (16 KiB rows)",
                      "micro_blockgather_contig", "115"),
        "contig g1": (micro_blockgather.K16, "kernel blk-contig g1",
                      "row gather (16 KiB rows)", None, None),
    }
    for label, (rows, k_line, lib_line, entry, site) in gathers.items():
        # bytes: the gathered blocks read once and written once, and the ids
        n_bytes = 2 * 4 * rows * bg_nb * micro_blockgather.B + 4 * bg_nb
        bound = n_bytes / HBM_BYTES_PER_S * 1e3
        print(f"[kernel] micro_blockgather {label}: {bg_res[k_line]:.4f} ms "
              f"({n_bytes / bg_res[k_line] / 1e6:.1f} GB/s; plain "
              f"{g_plain_ms[label]:.4f}, library {bg_res[lib_line]:.4f}, "
              f"bound {bound:.4f})")
        if entry is not None:
            new_entries.append(dict(
                name=entry, route="cuda",
                source=csrc + "micro_blockgather.cu",
                replaces="benchmarks/micro_blockgather.py:" + site,
                launches=launches_bg[entry], max_abs_err=0.0,
                ms=bg_res[k_line], plain_ms=g_plain_ms[label],
                bound_ms=bound, bound_by="bytes",
                library_ms=bg_res[lib_line]))

    # the headline: 2 repeats of the first 15 s leg at full width
    kernels.LAUNCHES.clear()
    head = headline.main(["--seconds", "15", "--repeats", "2",
                          "--dense-splats", "0"])
    launches_head = dict(kernels.LAUNCHES)
    hm = head["meta"]
    bench_frames = sum(hm["frames"])
    if not (bench_frames > 0 and min(hm["frames"]) > 0 and head["value"] > 0):
        raise RuntimeError("[bench] the headline timed no frame")
    need(launches_head, per_frame, bench_frames, "headline")
    for name in per_frame:
        if hm["launches_per_frame"].get(name) != 1.0:
            raise RuntimeError(
                f"[bench] {name} launched "
                f"{hm['launches_per_frame'].get(name)} times per timed frame")
    if hm["alpha_off_share"] > 0.02:
        raise RuntimeError(f"[bench] alpha is not 1 over an opaque sky on "
                           f"{hm['alpha_off_share']:.2e} of the pixels")
    print(f"[bench] headline, first 15 s leg x 2 at {width}x{height}: medians "
          f"{[round(m, 2) for m in hm['median_frame_ms']]} ms, spread "
          f"{hm['spread']['min']:.2f}-{hm['spread']['max']:.2f}, "
          f"{head['value']:.2f} fps, frames {hm['frames']}, "
          f"{hm['n_pairs']} pairs, sort {hm['sort_ms']:.2f} ms, build "
          f"{hm['build_ms']:.2f} ms, builder load {hm['builder_load']:.3f}, "
          f"interactive latency {hm['interactive_latency_ms']:.2f} ms, "
          f"launches {launches_head}")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: d[k] for k in keys}
                                  for d in [bg, rs, rf, rz, tr, fd, bl, mp]
                                  + new_entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
