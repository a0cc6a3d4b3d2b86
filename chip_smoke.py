#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gswt_renderer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises (non-zero exit):
1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel of the main paths from csrc/ (five), one nvcc
   each, all at once;
3. reference: small frames rendered on the card against the port's CPU
   path (the plain PyTorch versions the CPU tests hold against the JAX
   package), within the JAX parity budget: gs-only, and with skybox + proxy;
4. kernels: on the first 1080p frame of the bench scene, each kernel against
   its plain version on the same inputs (block gather bit-exact; compositor
   <= 1e-4 per channel, without a depth test, with a random one, and on the
   full-config frame's pairs against the proxy's depth; triangle raster z
   bit-equal where both hit and attributes <= 1e-5 relative; bilinear
   sampler bit-equal, mip sampler <= 1e-6), timed with CUDA events beside
   its bound and, where one exists, a library call;
5. main paths, each with the launch counters zeroed just before and read
   just after: 8 gs-only 1080p frames along the bench fly path through
   Engine; 24 full-config frames (equirect skybox + proxy ground + splats,
   the frame bench.py times); the proxy pass with the mip pyramid sampler,
   which the Renderer wires in with the fast profile;
6. profile: where the full-config frame's time goes, per stage and kernel.

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

# per pair-pixel work of the triangle raster loop (csrc/trirast.cu): three
# plane evaluations (b0, b1, z) of two multiplies and two adds, and two
# subtractions for b2; the attribute planes are evaluated only for a pair
# that is its pixel's nearest so far and are not counted
TRIRAST_FP32_OPS = 14

RASTER_TOL = 1e-4  # per channel: FP32 summation order and expf vs torch.exp
# the mip sampler: same operations in the same order as the plain version,
# but the level's log2f against torch.log2. The bilinear sampler has no such
# call and is held bit-equal.
SAMPLER_TOL = 1e-6
# the triangle raster's attributes, relative: a tie's sum may be taken in
# another order
TRIRAST_ATTR_RTOL = 1e-5
BENCH_KEYFRAMES = [  # bench.py fly path
    (0.0, (0.0, 0.0, 5.0), (0.0, 30.0, 2.0)),
    (5.0, (6.0, 18.0, 5.0), (10.0, 48.0, 2.0)),
    (10.0, (2.0, 40.0, 6.0), (-20.0, 60.0, 1.0)),
    (15.0, (-10.0, 55.0, 5.0), (-30.0, 80.0, 2.0)),
]
N_FRAMES = 24      # full-config main path
N_FRAMES_GS = 8    # gs-only main path (the earlier slice's, at a cut depth)
N_PYR_PASSES = 3   # proxy passes through the mip pyramid sampler


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


def bench_textures(sky_hw=(64, 128), cells=64, cell=8):
    """bench.py's skybox (a vertical HDR ramp, equirect) and proxy texture
    (a checker of `cells` x `cells` cells of `cell` texels)."""
    sky = np.clip(
        np.linspace(0, 4, sky_hw[0])[:, None, None]
        * np.ones(sky_hw + (3,), np.float32), 0, 4)
    c = np.kron(np.indices((cells, cells)).sum(0) % 2,
                np.ones((cell, cell))).astype(np.float32)
    return sky, np.stack([c * 0.8 + 0.1, c * 0.5 + 0.2, c * 0.3 + 0.1],
                         axis=-1)


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
        rs = {}
        for device in ("cuda", "cpu"):
            r = Renderer(wang, RendererConfig(width=w, height=h, max_draws=128,
                                              max_stream=1 << 15, chunk=128),
                         device=device)
            r.configure(ud)
            r.set_skybox(sky)
            r.set_proxy(checker)
            rs[device] = r
        for full in (False, True):
            gpu, cpu = (rs[d].render(dt, camera, sp, rc, use_skybox=full,
                                     use_proxy=full) for d in ("cuda", "cpu"))
            diff = np.abs(gpu - cpu).max(axis=-1)
            print(f"[reference] surface {int(kw['surface_type'])} "
                  f"{'skybox+proxy' if full else 'gs-only'} 128x128: mean "
                  f"diff {diff.mean():.3e} max {diff.max():.3e} alpha "
                  f"{gpu[..., 3].mean():.3f}")
            if not (np.isfinite(gpu).all() and gpu[..., 3].mean() > 0.1
                    and _close(cpu, gpu)):
                raise RuntimeError(
                    "card frame disagrees with the CPU reference")


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
    for stage in ("gswt.skybox", "gswt.proxy", "gswt.project", "gswt.bin",
                  "gswt.raster"):
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

    def raster_bound_ms(pairs):
        pp = pairs * p_n  # pair-pixels the frame composites
        return max(pp * RASTER_FP32_OPS / FP32_OPS_PER_S,
                   pp / SFU_OPS_PER_S) * 1e3

    gs_raster_ms = _time_ms(
        torch, lambda: raster.rasterize(binned, ones, **main_kw), 10)
    print(f"[kernel] raster on the gs-only frame, {stats['pairs']} pairs x "
          f"{p_n} px, no depth test: {gs_raster_ms:.3f} ms (bound "
          f"{raster_bound_ms(stats['pairs']):.3f})")

    def drive(n_frames, label):
        """n_frames 1080p frames through Engine along the bench fly path;
        per-frame wall times and bbox pair counts."""
        fp.reset_path()
        fp.start_path()
        frame_ms, pairs_per_frame = [], []
        for i in range(n_frames):
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
            if eng.use_skybox and float(
                    (img[..., 3] - 1.0).abs().amax()) > 1e-5:
                raise RuntimeError(
                    f"{label} frame {i}: alpha is not 1 over an opaque sky")
            pairs_per_frame.append(eng.renderer.last_aux["n_pairs"])
        return frame_ms, pairs_per_frame

    def report(label, n_frames, frame_ms, pairs_per_frame, launches):
        q1, q2, q3 = np.percentile(frame_ms, [25, 50, 75])
        print(f"[main] {n_frames} {label} 1080p frames: median {q2:.2f} ms "
              f"(quartiles {q1:.2f}, {q3:.2f}; first {frame_ms[0]:.2f}), "
              f"pairs/frame median {int(np.median(pairs_per_frame))}, "
              f"launches {launches}")

    # 5a. the earlier slice's main path: gs-only frames, at a cut depth
    kernels.LAUNCHES.clear()
    gs_ms, gs_pairs = drive(N_FRAMES_GS, "gs-only")
    launches_gs = dict(kernels.LAUNCHES)
    for name in ("block_gather", "raster"):
        if launches_gs.get(name, 0) < N_FRAMES_GS:
            raise RuntimeError(f"{name} launched {launches_gs.get(name, 0)} "
                               f"times in {N_FRAMES_GS} gs-only frames")
    report("gs-only", N_FRAMES_GS, gs_ms, gs_pairs, launches_gs)

    # the full config of bench.py: equirect skybox + checker proxy ground
    t0 = time.time()
    sky, checker = bench_textures()
    eng.set_skybox(sky, equirect=True)
    eng.set_proxy(checker)
    torch.cuda.synchronize()
    print(f"[setup] skybox {sky.shape} + proxy {checker.shape} (mip chain, "
          f"atlas, pyramid {tuple(r.proxy_pyr.shape)}) in "
          f"{time.time() - t0:.1f} s; proxy grid "
          f"{r.proxy_tris.shape[1]} triangles")

    # 4b. the three kernels of the skybox and proxy passes, on the first
    # full-config frame's own inputs (the first fly-path camera)
    fp.reset_path()
    fp.start_path()
    fp.handle_events(eng.camera, now_ms=0.0)
    scene_d, cam_d = r.frame_uniforms(eng.camera, eng.scene_params,
                                      eng.render_config)[:2]
    rcfg = eng.render_config
    surface = int(eng.scene_params.surface_type)
    ptile = (r.cfg.proxy_tile_w, r.cfg.proxy_tile_h)
    p_n_proxy = ptile[0] * ptile[1]
    n_px = width * height

    # triangle raster: the bench proxy grid, projected by the frame's camera
    planes, ok, bbox = proxy.map_grid_planes(
        cam_d, scene_d, image_wh, r.hm4, r.height_map_wh, r.proxy_verts,
        r.proxy_tris, surface_type=surface,
        height_offset=float(rcfg.proxy_height))
    rows, t_rs, t_re, n_tri_pairs = trirast.bin_triangles(
        planes, bbox, ok, image_wh=image_wh, tile_wh=ptile)
    tri_kw = dict(image_wh=image_wh, tile_wh=ptile, chunk=128)
    k_out = trirast.rasterize_pair_rows(rows, t_rs, t_re, **tri_kw)
    p_out = trirast.rasterize_triangles_plain(rows, t_rs, t_re, **tri_kw)
    torch.cuda.synchronize()
    both = (k_out[:, 0] < 1.0) & (p_out[:, 0] < 1.0)
    hit_differs = int(((k_out[:, 0] < 1.0) != (p_out[:, 0] < 1.0)).sum())
    z_equal = bool(torch.equal(k_out[:, 0][both], p_out[:, 0][both]))
    a_err = (k_out[:, 1:] - p_out[:, 1:]).abs()
    a_ok = bool((a_err <= TRIRAST_ATTR_RTOL * p_out[:, 1:].abs() + 1e-7).all())
    tri_err = float((k_out - p_out).abs().amax())
    print(f"[kernel] trirast {int(ok.sum())} triangles, {n_tri_pairs} pairs on "
          f"{k_out.shape[0]} tiles: hit differs on {hit_differs} px, z "
          f"bit-equal {z_equal}, max abs diff {tri_err:.3e}, coverage "
          f"{float((k_out[:, 0] < 1.0).float().mean()):.3f}")
    if not (hit_differs == 0 and z_equal and a_ok
            and torch.isfinite(k_out).all()):
        raise RuntimeError("trirast kernel disagrees with its plain version")
    pair_px = n_tri_pairs * p_n_proxy
    tri_bytes = 4 * (rows.numel() + t_rs.numel() + t_re.numel()
                     + k_out.numel())
    tri_bounds = (tri_bytes / HBM_BYTES_PER_S,
                  pair_px * TRIRAST_FP32_OPS / FP32_OPS_PER_S)
    tr = dict(
        name="trirast", route="cuda",
        source="gswt_renderer_tpu_torch/csrc/trirast.cu",
        replaces="gswt_renderer_tpu/ops/trirast.py:221",
        max_abs_err=tri_err,
        ms=_time_ms(torch, lambda: trirast.rasterize_pair_rows(
            rows, t_rs, t_re, **tri_kw), 20),
        plain_ms=_time_ms(torch, lambda: trirast.rasterize_triangles_plain(
            rows, t_rs, t_re, **tri_kw), 2),
        library_ms=None,  # no single PyTorch call rasterizes triangles
        bound_ms=max(tri_bounds) * 1e3,
        bound_by="bytes" if tri_bounds[0] >= tri_bounds[1] else "operations",
    )
    print(f"[kernel] trirast: {tr['ms']:.4f} ms (plain {tr['plain_ms']:.3f}, "
          f"bound {tr['bound_ms']:.4f} by {tr['bound_by']}: bytes "
          f"{tri_bounds[0] * 1e3:.4f}, operations {tri_bounds[1] * 1e3:.4f})")

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
    print(f"[kernel] bilinear: {bl['ms']:.4f} ms (plain {bl['plain_ms']:.4f}, "
          f"grid_sample {bl['library_ms']:.4f}, bound {bl['bound_ms']:.4f})")

    # mip pyramid sampler: the frame's own u, v, rho from the proxy raster
    z_px, u_px, v_px, _, hit_px, _ = proxy.raster_map_grid(
        cam_d, scene_d, image_wh, r.hm4, r.height_map_wh, r.proxy_verts,
        r.proxy_tris, surface_type=surface,
        height_offset=float(rcfg.proxy_height), tile_wh=ptile, chunk=128)
    rho_px = proxy._uv_footprint(u_px, v_px, float(r.proxy_wh[0]),
                                 float(r.proxy_wh[1]))
    pyr_meta, l_min = r.proxy_pyr_meta
    mip_args = (r.proxy_pyr, pyr_meta, l_min, u_px, v_px, rho_px)
    k_out = texsample.factored_mip_trilinear(*mip_args)
    p_out = texsample.factored_mip_trilinear_plain(*mip_args)
    mip_err = float((k_out - p_out).abs().amax())
    print(f"[kernel] mip_trilinear planes {tuple(r.proxy_pyr.shape)} l_min "
          f"{l_min}, {len(pyr_meta)} levels at {n_px} samples "
          f"({float(hit_px.float().mean()):.3f} on the ground): max abs diff "
          f"{mip_err:.3e}")
    if not (mip_err <= SAMPLER_TOL and torch.isfinite(k_out).all()):
        raise RuntimeError(
            "mip_trilinear kernel disagrees with its plain version")
    mp = dict(
        name="mip_trilinear", route="cuda",
        source="gswt_renderer_tpu_torch/csrc/miptrilinear.cu",
        replaces="gswt_renderer_tpu/ops/texsample.py:322",
        max_abs_err=mip_err,
        ms=_time_ms(torch, lambda: texsample.factored_mip_trilinear(
            *mip_args), 50),
        plain_ms=_time_ms(
            torch, lambda: texsample.factored_mip_trilinear_plain(*mip_args), 3),
        library_ms=None,  # no single PyTorch call samples a packed mip chain
        # planes (bf16), u, v and rho read once; [3, P] written once
        bound_ms=(2 * r.proxy_pyr.numel() + 4 * 3 * n_px + 4 * 3 * n_px)
        / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
    )
    print(f"[kernel] mip_trilinear: {mp['ms']:.4f} ms (plain "
          f"{mp['plain_ms']:.3f}, bound {mp['bound_ms']:.4f})")

    # the compositor and the block gather on the full-config frame's own
    # inputs: pairs depth-tested against the proxy's depth, the path whose
    # launches the kernels line counts. Splats behind the ground no longer
    # raise a pixel's opacity, so fewer tiles saturate and leave their run
    # early than in the gs-only frame.
    plan_f = r.upload_plan(eng._staged)
    src_f = plan_f["blocks"][0].contiguous()
    scratch_f = project.merged_scratch(plan_f["merged"], r.store_packed,
                                       r.panels.shape[0])
    if not torch.equal(
            block_gather(r.panels, src_f, scratch_f).view(torch.int32),
            block_gather_plain(r.panels, src_f, scratch_f).view(torch.int32)):
        raise RuntimeError("block_gather kernel disagrees with its plain "
                           "version on the full-config plan")
    binned_f, _, depth_f, _ = r.front(
        plan_f, eng.camera, eng.scene_params, rcfg, use_skybox=True,
        use_proxy=True)
    depth_kw = dict(main_kw, use_depth=True)
    stats_f = {}
    k_out = raster.rasterize(binned_f, depth_f, **depth_kw)
    p_out = raster.rasterize_plain(binned_f, depth_f, stats=stats_f,
                                   **depth_kw)
    e = float((k_out - p_out).abs().amax())
    print(f"[kernel] raster on the full-config frame, depth-tested against "
          f"the proxy: max abs diff {e:.3e} alpha "
          f"{float(k_out[:, 3].mean()):.4f}")
    if not (e <= RASTER_TOL and torch.isfinite(k_out).all()):
        raise RuntimeError("raster kernel disagrees with its plain version "
                           "under the proxy depth test")
    rs = dict(
        name="raster", route="cuda",
        source="gswt_renderer_tpu_torch/csrc/raster.cu",
        replaces="gswt_renderer_tpu/ops/raster.py:735",
        max_abs_err=max(err, e),
        ms=_time_ms(torch, lambda: raster.rasterize(
            binned_f, depth_f, **depth_kw), 10),
        plain_ms=_time_ms(torch, lambda: raster.rasterize_plain(
            binned_f, depth_f, **depth_kw), 2),
        library_ms=None,
        bound_ms=raster_bound_ms(stats_f["pairs"]),
        bound_by="operations",
    )
    nodepth_ms = _time_ms(torch, lambda: raster.rasterize(
        binned_f, depth_f, **main_kw), 10)
    stats_nd = {}
    raster.rasterize_plain(binned_f, depth_f, stats=stats_nd, **main_kw)
    print(f"[kernel] raster {stats_f['pairs']} pairs x {p_n} px: "
          f"{rs['ms']:.3f} ms depth-tested (plain {rs['plain_ms']:.3f}, "
          f"bound {rs['bound_ms']:.3f}); untested, the same table "
          f"composites {stats_nd['pairs']} pairs in {nodepth_ms:.3f} ms")

    # 5b. this slice's main path: full-config frames through Engine
    kernels.LAUNCHES.clear()
    frame_ms, pairs_per_frame = drive(N_FRAMES, "full-config")
    launches = dict(kernels.LAUNCHES)
    proxy_pairs = eng.renderer.last_aux["proxy_pairs"]

    # 5c. a path of its own, counted on its own: the proxy pass through the
    # mip pyramid sampler (the route the Renderer takes in the fast profile)
    kernels.LAUNCHES.clear()
    pyr_ms = []
    for _ in range(N_PYR_PASSES):
        t0 = time.perf_counter()
        pyr_col, pyr_depth, pyr_hit, _ = r.proxy_pass(
            cam_d, scene_d, eng.scene_params, rcfg, mip_pyr=r.proxy_pyr_meta)
        torch.cuda.synchronize()
        pyr_ms.append((time.perf_counter() - t0) * 1e3)
    launches_pyr = dict(kernels.LAUNCHES)
    atlas_col = r.proxy_pass(cam_d, scene_d, eng.scene_params, rcfg)[0]
    pyr_diff = (pyr_col - atlas_col).abs()
    # where the footprint reaches the finest level the pyramid keeps, only
    # the bf16 rounding of the weights separates the two samplers
    kept_px = pyr_diff[pyr_hit & (rho_px >= 2.0 ** l_min)]
    if kept_px.numel() == 0:
        raise RuntimeError("no ground pixel of the bench frame samples a "
                           "level the pyramid keeps")
    print(f"[proxy] pass with the mip pyramid sampler at 1080p: "
          f"{np.median(pyr_ms):.2f} ms (host clock, median of "
          f"{N_PYR_PASSES}), launches {launches_pyr}; colour differs from "
          f"the atlas sampler's by max "
          f"{float(pyr_diff.amax()):.4f} mean {float(pyr_diff.mean()):.5f} "
          f"(the pyramid clamps below level {l_min} and rounds weights to "
          f"bf16); on the {kept_px.shape[0]} ground pixels at level {l_min} "
          f"or coarser: max {float(kept_px.amax()):.4f} mean "
          f"{float(kept_px.mean()):.5f}")
    if not (torch.isfinite(pyr_col).all()
            and bool(((pyr_depth < 1.0) == pyr_hit).all())):
        raise RuntimeError("proxy pass with the mip pyramid is malformed")
    if launches.get("mip_trilinear", 0):
        raise RuntimeError("the exact-profile frame launched mip_trilinear: "
                           "it samples the proxy through the atlas")
    for k in (bg, rs, tr, bl):
        k["launches"] = launches.get(k["name"], 0)
        if k["launches"] < N_FRAMES:
            raise RuntimeError(f"{k['name']} launched {k['launches']} times "
                               f"in {N_FRAMES} full-config frames")
    for name in ("trirast", "mip_trilinear"):
        if launches_pyr.get(name, 0) < N_PYR_PASSES:
            raise RuntimeError(
                f"{name} launched {launches_pyr.get(name, 0)} times in "
                f"{N_PYR_PASSES} proxy passes through the mip pyramid")
    mp["launches"] = launches_pyr["mip_trilinear"]
    report("full-config", N_FRAMES, frame_ms, pairs_per_frame, launches)
    print(f"[main] proxy pairs last frame {proxy_pairs}, setup {setup_s:.1f} s")

    # 6. where the full-config frame's time goes
    phase_profile(torch, eng, fp)
    eng.shutdown()

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: d[k] for k in keys}
                                  for d in (bg, rs, tr, bl, mp)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
