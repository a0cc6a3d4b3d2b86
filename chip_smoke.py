#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gswt_renderer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises (non-zero exit):
1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel of the main paths from csrc/ (eight sources, the
   compositor in eight compile-time variants, the micro-raster in twelve),
   one nvcc each, all at once, with each kernel's registers and spills, and
   each compositor variant's thread blocks an SM and clusters at once;
3. ground: the port's grid ground at 1080p against the benchmark's plain
   ground (gswt_bench/reference/background.py) at seven poses of its fly
   path ([ground] lines: the share of the reference's ground pixels the
   port misses, failing above 0.1%);
   reference: small frames rendered on the card against the port's CPU
   path (the plain PyTorch versions the CPU tests hold against the JAX
   package): gs-only and with skybox + proxy, in the exact profile within
   the JAX parity budget and in the fast profile (the default) within the
   stated one, plus three sat-culled frames whose carried cut image must be
   the CPU path's; and each gs-only frame against the port's oracle
   (refrender/oracle.py, the literal transcription of the reference's WGSL
   math) rendered on the card from the same inputs ([oracle] lines, with
   the oracle's own time and splat count): exact within
   tests/test_pipeline.py's budget, fast + sat cull within
   tests/test_fastmode.py's;
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
   kept pair-pixel; and on the pair tables of the dense and sky still cells
   (gswt_bench's cells at CELL_SEED, [cells] lines): run lengths, max_run,
   the whole table's time and its longest run's and longest walk's alone;
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
   main(), each in a launch-count window of its own; the sorted merge's
   tournament timed as the median of 7 event windows beside its byte bound;
8. parallel: on the exact frame, the stream cut into 4 segments rendered in
   turn and folded (parallel/batched.py render_stream_segments), up to 4
   calls of the cut's feedback, against Renderer.render of the same plan
   (max |err| <= 1e-3 + MIN_T, mean < 1e-4; pairs per segment within 1.5x
   of each other and within 5% of the frame's in sum), and dp = sp = 1
   through an NCCL group of one (a batch of 4 distinct cameras and the
   sharded stream, bit-equal); the same 4 segments on the fast frame within
   the limit derived at SEG_FAST_TOL;
9. viewer: the HTTP server over the fast 1080p Engine in a thread (3
   distinct 960x540 JPEGs while the camera moves, /hud, /bench over 2
   recorded keyframes, /quit, no render-loop error), the CLI's render (the
   demo fly path at 2 fps, 1080p PNGs) and bench; then batched_ab and a
   two-entry sweep_shapes through their main();
10. host sections: every call of a few exact and of a few fast frames that
   waits for the device (PyTorch's sync debug mode), each with the
   host-profiler section open at it, failing if one lies outside a sync.*
   section or render.drain; profile_hostloop's 24 fast 1080p frames along
   the first leg at depth 2 and at depth 0, with the builder running and
   frozen ([hostprof] lines, each beside the card's name and power
   limit);
11. in flight: on the bench scene at 1080p, in the exact and in the fast
   profile, 8 frames of the first leg rendered at pipeline_depth 2 from
   one plan under PyTorch's sync debug mode "error" (the only wait the
   drain of the frame two behind, which sync debug mode does not see: an
   event's synchronize), each image after the drain EQUAL to the depth-0
   frame of the same camera and plan once the pair budgets have grown
   ([inflight] lines, with overflow_frames over the fly-through);
   profile_hostloop at depth 2 and at depth 0, each with the builder
   running and frozen;
12. the fixed-camera and A/B scripts through their main() at their
   smallest honest setting, each in a launch-count window of its own
   ([bench] <script> lines): profile_frame, quick_full --ab,
   cull_ab (with and without the ellipse-tile cull), depth_cull_ab,
   proxydiv_ab, saturation (one 1080p frame), micro_background,
   inversion_ab (1080p and 4K) and configs --quick (its 4K and dense rows
   kept).

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
# the stream segments folded against the single frame. Exact profile: 1e-3
# of f32 association plus MIN_T, the weight of the tail pairs a later
# segment (its T restarting at 1) composites past the single frame's early
# exit (__graft_entry__.py's dry-run limit); mean < 1e-4. Fast profile: each
# weight w = g T is rounded to bf16 (relative 2^-9) on the segment's LOCAL T,
# the single frame's on the global T, so a weight differs by at most 2^-8 of
# itself, a pixel's colour by at most 2^-8 of its alpha (<= 1), on top of
# the exact limit
SEG_TOL = 1e-3 + MIN_T
SEG_FAST_TOL = 2.0 ** -8 + SEG_TOL
N_FRAMES = 24      # the main path: fast-profile full-config frames
N_FRAMES_EXACT = 8  # exact-profile full-config frames (slice 2's path, cut)
N_FRAMES_GS = 4    # exact-profile gs-only frames (slice 1's path, cut)
N_FRAMES_SAT = 6   # fixed-camera frames with and without the sat cull
# the splat-only still cells whose pair tables [cells] captures, at the pose
# and tile set that this --seed gives their benchmark runs
CELL_TABLES = ("dense_tiles_1080p.still", "paper_sky_1080p.still")
CELL_SEED = 4100000017


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


def _median_ms(torch, fn, windows: int = 7, reps: int = 10):
    """(median, all) of the mean device time of fn over `windows` CUDA-event
    windows of `reps` back-to-back calls each, after one warm-up call: a
    steadier figure than one window's mean."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return float(np.median(out)), out


# the projection kernel against its plain version, on valid lanes: pixels
# and extents within 1e-4 (plus 1e-4 relative for the extents), depth and
# colour within 1e-6, k within 1e-3 of its scale max(|qa|, |qc|)
# (tests/test_torch_project_cuda.py states why)
PROJECT_TOL = dict(px=1e-4, unit=1e-6, k_rel=1e-3)
# bytes a live lane reads (12 panel rows, or a merged lane's store index,
# map id and 10 store rows) and every lane writes (12 rows and the mask)
PROJECT_READ_B = 48
PROJECT_WRITE_B = 12 * 4 + 1


def phase_project(torch, eng, smi, dense_lanes: int = 1 << 22):
    """[kernel] project (csrc/project.cu) against its plain version on the
    fast frame's own inputs, at the 1080p frame's stream and at the dense
    cell's (the plan's blocks repeated to `dense_lanes` lanes): valid equal
    and the values within PROJECT_TOL; CUDA-event ms of the kernel and of
    the plain version, and the byte bound (the live lanes' reads, every
    lane's writes, the plan once). Returns the kernel's entry."""
    from gswt_renderer_tpu_torch.ops import project

    r = eng.renderer
    plan = r.upload_plan(eng._staged)
    uniforms = r.pack_uniforms(eng.camera, eng.scene_params,
                               eng.render_config)
    scene_d, cam_d, lod_en, cdist, gs_en = r.unpack_frame_uniforms(uniforms)
    keep = project.cull_draws(plan["draw"], cam_d, cdist, lod_en)
    kw = dict(surface_type=int(eng.scene_params.surface_type), draw_mode=0,
              image_wh=(r.cfg.width, r.cfg.height), exact=r.cfg.exact,
              hm_src=r.hm_src)
    if r.hm_src is None:
        raise RuntimeError("[kernel] project: the fast frame has no source map")
    entry, worst = None, 0.0
    nb0 = plan["blocks"].shape[1]
    for label, blocks in (
            ("1080p frame", plan["blocks"]),
            ("dense cell's stream", plan["blocks"].repeat(
                1, -(-dense_lanes // (256 * nb0)))[:, :dense_lanes // 256]
             .contiguous())):
        args = (blocks, plan["merged"], r.panels, keep, r.store_packed,
                uniforms, r.hm4, r.height_map_wh)
        plain_args = args[:5] + (scene_d, cam_d) + args[6:]
        plain_kw = dict(kw, gs_enable=gs_en)
        got = project.assemble_and_project(*args, **kw)
        want = project.assemble_and_project_plain(*plain_args, **plain_kw)
        if not torch.equal(got["valid"], want["valid"]):
            raise RuntimeError(f"[kernel] project {label}: the valid mask "
                               f"differs on {int((got['valid'] != want['valid']).sum())} lanes")
        v = want["valid"]
        err = {k: float((got[k][v] - want[k][v]).abs().max())
               for k in ("cx", "cy", "z")}
        err["color"] = max(float((a - b).abs().max())
                           for a, b in zip(got["color"], want["color"]))
        err["ext"] = max(float(((got[k][v] - want[k][v]).abs()
                                / (1.0 + want[k][v].abs())).max())
                         for k in ("ext_x", "ext_y"))
        scale = torch.maximum(want["q"][0][v].abs(), want["q"][2][v].abs())
        err["k_rel"] = max(float(((a[v] - b[v]).abs() / scale).max())
                           for a, b in zip(got["q"], want["q"]))
        if not (max(err["cx"], err["cy"], err["ext"]) <= PROJECT_TOL["px"]
                and max(err["z"], err["color"]) <= PROJECT_TOL["unit"]
                and err["k_rel"] <= PROJECT_TOL["k_rel"]):
            raise RuntimeError(f"[kernel] project {label}: {err}")
        worst = max(worst, err["cx"], err["cy"])
        s_n = blocks.shape[1] * 256
        lane = torch.arange(256, device=blocks.device).repeat(blocks.shape[1])
        live = int(((lane < blocks[3].repeat_interleave(256))
                    & keep[blocks[4].long()].repeat_interleave(256)).sum())
        bound_ms = (live * PROJECT_READ_B + s_n * PROJECT_WRITE_B
                    + blocks.numel() * 4) / HBM_BYTES_PER_S * 1e3
        ms, _ = _median_ms(torch, lambda: project.assemble_and_project(
            *args, **kw), windows=5, reps=10)
        plain_ms = _time_ms(torch, lambda: project.assemble_and_project_plain(
            *plain_args, **plain_kw), 3)
        print(f"[kernel] project {label}: {s_n} lanes ({live} live, "
              f"{int(v.sum())} valid), against the plain version {err}; "
              f"{ms:.4f} ms (plain {plain_ms:.4f}, bound {bound_ms:.4f} by "
              f"bytes, {100 * bound_ms / ms:.1f}%) ({smi})")
        if entry is None:
            entry = dict(
                name="project", route="cuda",
                source="gswt_renderer_tpu_torch/csrc/project.cu",
                replaces="none (XLA fusion in the JAX package)",
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None)
    entry["max_abs_err"] = worst
    return entry


# the binning kernel against its plain version on the kept pairs
# (tests/test_torch_binning_cuda.py states why): ranges, counts and rows 6-10
# and 12 equal; each k row (0-5) within 1e-5 of its largest |value|; ln a
# (row 11) within 3e-7 relative, -inf where the plain version has it
BIN_TOL = dict(k_rel=1e-5, ln_a_rel=3e-7)
# bytes the binning kernel must move at the least: a live lane's 12 projected
# rows and its mask, an off-screen valid lane's cx, cy, ext_x, ext_y and
# mask, an invalid lane's mask, each read once; each kept pair's 13 table
# rows written once, the dead code (rows 5 and 11) of every slot past the
# runs, the two ranges
BIN_LIVE_B = 12 * 4 + 1
BIN_OFF_B = 4 * 4 + 1
BIN_VOID_B = 1
BIN_KEPT_B = 13 * 4
BIN_DEAD_B = 2 * 4
BIN_TILE_B = 2 * 4


def phase_binning(torch, eng, smi, dense_lanes: int = 1 << 22):
    """[binning] the binning kernel (csrc/binning.cu) against its plain
    version on the fast 1080p frame's projected stream (the sky still's
    scene) and on the dense cell's (the plan's blocks repeated to
    `dense_lanes` lanes),
    at a capacity of 1.5x the demand as the pair budget keeps it. Raises
    unless ranges, counts, the runs (row 12) and rows 6-10 are equal, the k
    rows and ln a are within BIN_TOL and every slot past the runs has the
    dead code; prints the largest difference of each row group and the
    CUDA-event ms of the kernel and of the plain version beside the byte
    bound. Returns the kernel's entry."""
    from gswt_renderer_tpu_torch.ops import binning

    r = eng.renderer
    c = r.cfg
    plan = r.upload_plan(eng._staged)
    uniforms = r.pack_uniforms(eng.camera, eng.scene_params,
                               eng.render_config)
    unpacked = r.unpack_frame_uniforms(uniforms)
    kw = dict(image_wh=(c.width, c.height), tile_wh=(c.tile_w, c.tile_h),
              chunk=c.chunk, exact=c.exact, cull_exact=c.cull_exact)
    n_tiles = binning.grid_dims(kw["image_wh"], kw["tile_wh"])[2]
    entry = None
    nb0 = plan["blocks"].shape[1]
    for label, blocks in (
            ("1080p frame, the sky still's scene", plan["blocks"]),
            ("dense cell's stream", plan["blocks"].repeat(
                1, -(-dense_lanes // (256 * nb0)))[:, :dense_lanes // 256]
             .contiguous())):
        p = r._project(dict(plan, blocks=blocks), uniforms, unpacked,
                       eng.scene_params, eng.render_config)
        s_n = p["cx"].shape[0]
        demand = int(binning.bin_pairs_plain(p, capacity=c.chunk,
                                             **kw)["n_pairs"])
        cap = binning.fit_capacity(-(-3 * demand // 2), c.chunk)
        got = binning.bin_pairs(p, capacity=cap, **kw)
        want = binning.bin_pairs_plain(p, capacity=cap, **kw)
        for k in ("range_start", "range_end", "n_pairs", "n_pairs_kept",
                  "n_live", "overflow"):
            if not torch.equal(got[k], want[k]):
                raise RuntimeError(f"[binning] {label}: {k} differs")
        kept = int(want["n_pairs_kept"])
        gt, wt = got["table"][:13, :kept], want["table"][:13, :kept]
        if not torch.equal(gt[12], wt[12]):
            raise RuntimeError(f"[binning] {label}: the runs differ")

        def diff(rows):
            """|got - want| of the rows, 0 where they are equal (so -inf
            against -inf is 0); NaN where either is NaN and they differ"""
            d = (gt[rows] - wt[rows]).abs()
            return torch.where(gt[rows] == wt[rows], 0.0, d)

        err = dict(k=0.0, k_rel=0.0, z_rgb=0.0, ln_a_rel=0.0)
        if kept:
            dk, da = diff(slice(0, 6)), diff(slice(11, 12))
            scale = wt[:6].abs().amax(dim=1, keepdim=True)
            err = dict(
                k=float(dk.max()),
                k_rel=float(torch.where(dk == 0, 0.0, dk / scale).max()),
                z_rgb=float(diff(slice(6, 11)).max()),
                ln_a_rel=float(torch.where(
                    da == 0, 0.0, da / wt[11:12].abs()).max()))
        # `not x <= tol` also fails a NaN
        if not (err["z_rgb"] == 0.0 and err["k_rel"] <= BIN_TOL["k_rel"]
                and err["ln_a_rel"] <= BIN_TOL["ln_a_rel"]
                and (got["table"][5, kept:] == -1e30).all()
                and torch.isneginf(got["table"][11, kept:]).all()):
            raise RuntimeError(f"[binning] {label}: table rows against the "
                               f"plain version {err}, limits {BIN_TOL}")
        n_valid = int(p["valid"].sum())
        live = int(want["n_live"])
        bound_b = (live * BIN_LIVE_B + (n_valid - live) * BIN_OFF_B
                   + (s_n - n_valid) * BIN_VOID_B + kept * BIN_KEPT_B
                   + (cap - kept) * BIN_DEAD_B + n_tiles * BIN_TILE_B)
        bound_ms = bound_b / HBM_BYTES_PER_S * 1e3
        ms, _ = _median_ms(torch, lambda: binning.bin_pairs(
            p, capacity=cap, **kw), windows=5, reps=10)
        plain_ms = _time_ms(torch, lambda: binning.bin_pairs_plain(
            p, capacity=cap, **kw), 3)
        print(f"[binning] {label}: {s_n} lanes, {n_valid} valid, {live} "
              f"live, n_pairs {demand}, kept {kept}, capacity {cap}; table "
              f"rows against the plain version {err} (limits {BIN_TOL}); "
              f"{ms:.4f} ms (plain {plain_ms:.4f}); bound {bound_ms:.4f} ms "
              f"by bytes ({live} x {BIN_LIVE_B} + {n_valid - live} x "
              f"{BIN_OFF_B} + {s_n - n_valid} x {BIN_VOID_B} + {kept} x "
              f"{BIN_KEPT_B} + {cap - kept} x {BIN_DEAD_B} + {n_tiles} x "
              f"{BIN_TILE_B} = {bound_b} B), {100 * bound_ms / ms:.1f}% "
              f"({smi})")
        if entry is None:
            entry = dict(
                name="binning", route="cuda",
                source="gswt_renderer_tpu_torch/csrc/binning.cu",
                replaces="none (XLA ops in the JAX package)",
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None, max_abs_err=err["k"])
    return entry


def phase_oracle(torch, fi, img, exact, label, smi):
    """The card's gs-only frame `img` against the port's oracle rendered on
    the card from the same FrameInputs. Exact profile: tests/test_pipeline.py's
    budget (mean < 1e-4, at most 5e-4 of the pixels over 1e-3); fast profile:
    tests/test_fastmode.py's (max <= 8/255, at most 0.5% of the values over
    2/255, mean <= 0.5/255)."""
    from gswt_renderer_tpu_torch.refrender import (
        assemble_stream, project_draw, render_oracle)

    h, w = img.shape[:2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = render_oracle(fi, w, h, device="cuda")
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    ref = ref.cpu().numpy()
    stream = assemble_stream(fi, device="cuda")
    n_valid = int(project_draw(fi, **stream)["valid"].sum())
    d = np.abs(img - ref)
    px = d.max(axis=-1)
    if exact:
        ok = px.mean() < 1e-4 and np.mean(px > 1e-3) <= 5e-4
    else:
        ok = (d.max() <= 8.0 / 255.0 and np.mean(d > 2.0 / 255.0) <= 0.005
              and d.mean() <= 0.5 / 255.0)
    print(f"[oracle] {label} gs-only {w}x{h} card frame against the port's "
          f"oracle on the card: pixel mean {px.mean():.3e} max {px.max():.3e} "
          f"over 1e-3 {np.mean(px > 1e-3):.2e}, value max {d.max() * 255:.3f}"
          f"/255 over 2/255 {np.mean(d > 2.0 / 255.0):.2e} mean "
          f"{d.mean() * 255:.4f}/255; oracle {oracle_s:.3f} s for "
          f"{int(stream['gs_index'].shape[0])} splats in the stream "
          f"({n_valid} composited), alpha {ref[..., 3].mean():.3f} | {smi}")
    if not (np.isfinite(ref).all() and ref[..., 3].mean() > 0.1 and ok):
        raise RuntimeError(f"{label}: the card's frame is outside its budget "
                           "against the port's oracle")


def phase_reference(torch, smi):
    """Small frames on the card against the port's CPU path, in both
    profiles. Budget: tests/test_pipeline.py's (mean < 1e-4 and at most 5e-4
    of the pixels over 1e-3), four times that share with the half-res
    proxy. Each gs-only frame also against the port's oracle on the card
    (phase_oracle)."""
    from gswt_renderer_tpu_torch.core import Camera, UserData
    from gswt_renderer_tpu_torch.core.config import (
        RenderConfig, SelectiveMergeType, SurfaceType, TileSortType)
    from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec
    from gswt_renderer_tpu_torch.render.pipeline import Renderer, RendererConfig
    from gswt_renderer_tpu_torch.render.uniforms import (
        SceneParams, build_frame_inputs)
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
        fi = build_frame_inputs(wang, dt, camera, rc)
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
                if not full:
                    phase_oracle(torch, fi, gpu, exact,
                                 f"{profile} surface {int(kw['surface_type'])}",
                                 smi)
            if not exact and not torch.equal(rs["cuda"].sat_zimg.cpu(),
                                             rs["cpu"].sat_zimg):
                raise RuntimeError("the card's saturation-slot image is not "
                                   "the CPU path's")


# the ground witness: the share of the pixels the plain ground hits that the
# port's grid ground may miss at 1080p
GROUND_MISS_SHARE = 1e-3
GROUND_POSES_S = (0.0, 2.0, 4.5, 7.5, 10.0, 12.0, 14.5)


def phase_ground(torch, smi):
    """The port's grid ground (ops/proxy.py render_proxy, the fast profile's
    half resolution, the triangle raster and mip sampler kernels) against
    the benchmark's plain ground (gswt_bench/reference/background.py: each
    pixel's ray marched to the stated mesh) at 1920x1080 on the paper's map,
    at poses of the benchmark's fly path ([ground] lines): the pixels the
    reference hits and the port misses, as a share of those and of all,
    and the ones the port alone hits. Fails above GROUND_MISS_SHARE."""
    from gswt_bench.frozen.scene import bench_textures, mirrored_pose
    from gswt_bench.reference import background, camera as rcam, store
    from gswt_renderer_tpu_torch.core import Camera, UserData
    from gswt_renderer_tpu_torch.core.camera import CameraUniforms
    from gswt_renderer_tpu_torch.core.config import RenderConfig, SurfaceType
    from gswt_renderer_tpu_torch.io.textures import build_mip_chain
    from gswt_renderer_tpu_torch.ops import proxy
    from gswt_renderer_tpu_torch.ops.project import pack_tex4
    from gswt_renderer_tpu_torch.ops.texsample import (
        pack_pyramid, sampler_pyramid)
    from gswt_renderer_tpu_torch.render.pipeline import PROXY_CHUNK, Renderer
    from gswt_renderer_tpu_torch.render.uniforms import SceneParams

    w, h, half, tw = 1920, 1080, 48, 4.0
    dev = torch.device("cuda")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "gswt_bench", "traffic", "still.json")) as f:
        keys = json.load(f)["keyframes"]
    hm, hm_wh = store.height_map((10, 10), tw, 0.3)
    _, checker = bench_textures()
    mips = build_mip_chain(np.asarray(checker, np.float32))
    atlas, meta = proxy.pack_mip_atlas(mips)
    pyr, pyr_meta, l_min = pack_pyramid(mips)
    verts, tris = proxy.make_map_grid((2 * half + 1,) * 2, (half, half), tw)
    prox = dict(atlas=proxy.atlas_words(atlas).to(dev),
                mip_tab=proxy.mip_table(meta, dev),
                pyr=sampler_pyramid(torch.as_tensor(pyr).to(dev).to(torch.bfloat16)),
                verts=torch.as_tensor(verts).to(dev),
                tris=torch.as_tensor(tris).to(dev))
    hm4 = torch.as_tensor(pack_tex4(hm, *hm_wh)).to(dev)
    ud = UserData.from_ui(tile_map_half_wh=(half, half), tile_width=tw,
                          surface_type=SurfaceType.HEIGHT_MAP,
                          height_map_wh=(10, 10), height_map_scale=(1.0, 0.3))
    pyramid = background.mip_pyramid(checker)
    worst = 0.0
    for t in GROUND_POSES_S:
        pos, tgt = mirrored_pose(keys, t)
        cc = tuple(int(c) for c in np.floor(pos[:2] / tw))
        cam = Camera((w, h), pos, tgt, (0, 0, 1), np.deg2rad(rcam.FOVY_DEG),
                     rcam.Z_NEAR, rcam.Z_FAR)
        uni = Renderer.pack_frame_uniforms(
            SceneParams.from_data(ud, cc, RenderConfig()), CameraUniforms(cam),
            [True], 1.0)
        scene_d, cam_d, *_ = Renderer.unpack_frame_uniforms(
            torch.as_tensor(uni).to(dev))
        _, _, hit, aux = proxy.render_proxy(
            cam_d, scene_d, (w // 2, h // 2), hm4, hm_wh, prox,
            (meta[0][0], meta[0][1]), surface_type=1,
            height_offset=background.PROXY_HEIGHT, brightness=1.0,
            black_background=False, use_clip=False, clip_height=0.0,
            mip_meta=meta, mip_pyr=(pyr_meta, l_min), tile_wh=(64, 32),
            chunk=PROXY_CHUNK, proxy_pairs=1 << 20)
        scene = dict(map_half_wh=(half, half), tile_width=tw,
                     height_map_scale=np.array([1.0, 1.0, 0.3], np.float32),
                     center_coord=cc)
        ref = background.proxy(rcam.camera(pos, tgt, w, h), scene,
                               torch.as_tensor(hm).to(dev), hm_wh, pyramid,
                               w, h, dev)[2][::2, ::2]
        miss = int((ref & ~hit).sum())
        extra = int((hit & ~ref).sum())
        n_ref = int(ref.sum())
        share = miss / max(n_ref, 1)
        worst = max(worst, share)
        print(f"[ground] t {t:4.1f} s, 960x540 ground of the 1080p frame: "
              f"reference hits {n_ref}, port misses {miss} ({share:.4%} of "
              f"those, {miss / hit.numel():.4%} of all), port alone hits "
              f"{extra}, pairs {int(aux['proxy_pairs'])}, overflow "
              f"{bool(aux['proxy_overflow'])} | {smi}")
        if bool(aux["proxy_overflow"]):
            raise RuntimeError("the ground witness overflowed its pair slots")
    if worst > GROUND_MISS_SHARE:
        raise RuntimeError(f"the port's ground misses {worst:.4%} of the "
                           f"reference ground's pixels")


def capture_cell_table(torch, workload, seed):
    """One frame's pair table of a benchmark cell, at the pose and on the
    tile set that `--seed` gives the cell's run (gswt_bench/harness.py
    run_cell's draws), after the harness's warm-up: (binned, depth_tiles,
    rasterize's keywords as Renderer.back passes them)."""
    from gswt_bench import harness
    from gswt_bench.frozen import synth
    from gswt_bench.reference import camera as rcam

    cell = harness.cell_of(harness.benchmark(), workload)
    cfg = harness.config(cell["config"])
    trf = harness.traffic(cell["traffic"])
    if trf["moving"]:
        raise ValueError(f"{workload} is not a still cell")
    t0 = float(np.random.default_rng(seed).uniform(*trf["pose_s"]))
    raw = synth.tile_set(
        n_lod=cfg["n_lod"], n_center_options=cfg["n_center_options"],
        tile_width=cfg["tile_width"], splats_per_tile=cfg["splats_per_tile"],
        seed=seed, lod_decay=cfg["lod_decay"])
    eng = harness.build_engine(cfg, raw, torch.device("cuda"))
    try:
        harness.warm_up(eng, trf, t0, [
            (-np.inf, np.asarray(rcam.STARTUP_POSITION, np.float32))])
        r = eng.renderer
        binned, _, depth, _ = r.front(
            r.upload_plan(eng._staged), eng.camera, eng.scene_params,
            eng.render_config, use_skybox=bool(cfg["skybox"]),
            use_proxy=bool(cfg["proxy"]))
        torch.cuda.synchronize()
        c = r.cfg
        kw = dict(image_wh=(c.width, c.height), tile_wh=(c.tile_w, c.tile_h),
                  chunk=c.chunk, use_depth=bool(cfg["proxy"]), exact=c.exact)
    finally:
        eng.shutdown()
    return binned, depth, kw


def one_tile(torch, binned, tile):
    """The binned table with every run but `tile`'s emptied."""
    keep = torch.arange(binned["range_start"].shape[0],
                        device=binned["range_start"].device) == tile
    return dict(binned, **{k: torch.where(keep, binned[k], 0).int()
                           .contiguous()
                           for k in ("range_start", "range_end")})


def phase_cell_tables(torch, smi, seed=CELL_SEED):
    """[cells] The compositor on the splat-only still cells' own pair tables
    (capture_cell_table): held to its plain version (RASTER_TOL), each
    table's run lengths per tile, max_run, the pairs composited before the
    early exit, and CUDA-event medians of the whole table and of its
    longest run alone (and of its longest walk alone where that is another
    tile). Returns {workload: numbers}."""
    from gswt_renderer_tpu_torch.ops import raster

    out = {}
    for workload in CELL_TABLES:
        binned, depth, kw = capture_cell_table(torch, workload, seed)
        st = {}
        want = raster.rasterize_plain(binned, depth, stats=st, **kw)
        got = raster.rasterize(binned, depth, **kw)
        err = float((got - want).abs().amax())
        del got, want
        if not err <= RASTER_TOL:
            raise RuntimeError(f"[cells] {workload}: the kernel is {err} "
                               f"off its plain version")
        runs = (binned["range_end"] - binned["range_start"]).long()
        walk = st["tile_pairs"]
        q = torch.quantile(runs[runs > 0].double(), torch.tensor(
            [0.5, 0.99], dtype=torch.float64, device=runs.device))
        top, top_w = int(torch.argmax(runs)), int(torch.argmax(walk))
        max_run = int(binned["max_run"])
        if max_run != int(runs.max()):
            raise RuntimeError(f"[cells] {workload}: max_run {max_run} is "
                               f"not the longest run {int(runs.max())}")
        whole = _median_ms(torch, lambda: raster.rasterize(
            binned, depth, **kw))[0]
        row = dict(pairs_kept=int(binned["n_pairs_kept"]), max_run=max_run,
                   run_median=float(q[0]), run_p99=float(q[1]),
                   walk_max=int(walk.max()), whole_ms=whole)
        for name, t in (("alone", top), ("walk_alone", top_w)):
            if name == "alone" or top_w != top:
                alone = one_tile(torch, binned, t)
                row[f"{name}_ms"] = _median_ms(torch, lambda: raster.rasterize(
                    alone, depth, **kw))[0]
        walk_note = ("" if top_w == top else
                     f"; the longest walk alone (tile {top_w}, "
                     f"{int(walk[top_w])} pairs) {row['walk_alone_ms']:.3f} "
                     f"ms")
        print(f"[cells] {workload} (seed {seed}): {row['pairs_kept']} pairs "
              f"kept; run length per tile median {row['run_median']:.0f}, "
              f"p99 {row['run_p99']:.0f}, max_run {max_run} (tile {top}, "
              f"{int(walk[top])} composited before the early exit; the "
              f"longest walk {row['walk_max']}); max |err| {err:.3e}; the "
              f"whole table {whole:.3f} ms, the longest run alone "
              f"{row['alone_ms']:.3f} ms ({row['alone_ms'] / whole:.1%})"
              f"{walk_note} | {smi}")
        out[workload] = row
        del binned, depth
        torch.cuda.empty_cache()
    return out


def phase_profile(torch, eng, fp, label, n: int = 4):
    """Where a frame's time goes: device time per pipeline stage (the
    host-section profiler's gswt.<section> ranges, on for the profiled
    frames) and per kernel, over n frames along the fly path, beside the
    frame's wall time. Lines start with `[profile] <label>`."""
    from torch.profiler import ProfilerActivity, profile

    from gswt_renderer_tpu_torch.core import hostprof

    fp.reset_path()
    fp.start_path()
    eng.renderer.drain()
    hostprof.set_host_prof(True)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                fp.handle_events(eng.camera, now_ms=15000.0 * (i + 0.5) / n)
                eng.frame(readback=False)
            eng.renderer.drain()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
    finally:
        hostprof.set_host_prof(False)
        hostprof.HOST_PROF.clear()
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
    for stage in ("gswt.render.front.skybox", "gswt.render.front.proxy",
                  "gswt.render.front.project", "gswt.render.front.bin",
                  "gswt.render.back"):
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
        if any(k in e.key for k in ("project_kernel", "raster_kernel",
                                    "trirast_kernel", "trirast_fold_kernel",
                                    "bilinear_kernel",
                                    "mip_trilinear_kernel")):
            print(f"{tag} own kernel "
                  f"{per_frame(e, 'self_cuda_time_total'):8.4f} ms/frame "
                  f"x{e.count / n:4.1f}  {e.key[:70]}")
    print(f"{tag} kernels launched: "
          f"{sum(e.count for e in kernels_) / n:.0f} per frame")


def phase_syncs(torch, eng, fp, label, n: int = 3):
    """[sync] Every call of n frames along the fly path (the last one read
    back, as Engine.frame does by default) that waits for the device, found
    by PyTorch's sync debug mode, which the host-section profiler turns on
    and counts by the section open at each call (core/hostprof.py
    trace().sync_sites). Fails if one lies outside a sync.* section or
    render.drain, or if none is found (the debug mode caught nothing)."""
    from gswt_renderer_tpu_torch.core import hostprof

    root = os.path.dirname(os.path.abspath(__file__))
    fp.reset_path()
    fp.start_path()
    eng.renderer.drain()
    hostprof.set_host_prof(True)
    try:
        for i in range(n):
            fp.handle_events(eng.camera, now_ms=15000.0 * (i + 1) / (n + 1))
            eng.frame(readback=i == n - 1)
        eng.renderer.drain()
    finally:
        hostprof.set_host_prof(False)
        hostprof.HOST_PROF.clear()
    sites = {(os.path.relpath(path, root), line, sec or "no section"): k
             for (sec, path, line), k in hostprof.trace().sync_sites.items()}
    for (path, line, sec), k in sorted(sites.items()):
        print(f"[sync] {label}: {path}:{line} in {sec}, {k} in {n} frames")
    bad = [site for site in sites
           if not (site[2].startswith("sync.") or site[2] == "render.drain")]
    if bad or not sites:
        raise RuntimeError(f"[sync] {label}: waits outside a sync.* section "
                           f"{bad}, or none found")


def phase_hostprof(need, per_frame, smi, n: int = 24):
    """[hostprof] profile_hostloop's n fast 1080p frames at depth 2 (two
    frames in flight, the Engine's) and at depth 0 (each frame read at its
    end), with the builder running and with it frozen, each in a
    launch-count window of its own; every line carries the card's name and
    power limit (`smi`)."""
    from gswt_renderer_tpu_torch.benchmarks import profile_hostloop
    from gswt_renderer_tpu_torch.ops import kernels

    for depth in (2, 0):
        for frozen in (False, True):
            kernels.LAUNCHES.clear()
            res = profile_hostloop.main(
                ["-n", str(n), "--depth", str(depth)]
                + (["--frozen"] if frozen else []))
            launches = dict(kernels.LAUNCHES)
            label = (f"depth {depth}, "
                     f"{'builder frozen' if frozen else 'builder running'}")
            need(launches, per_frame, n, f"hostprof, {label}")
            sec = res["sections"]
            # each frame pumps once and launches once, and once more for
            # each depth-0 retry (a frame that overflowed a budget, rendered
            # again); depth 2 completes the frames beyond the depth in
            # render.drain and the rest in the script's drain, depth 0
            # reads each launch's counts at its end (sync.aux)
            tries = n + res["overflow_retries"]
            want = {"frame.update_pump": n}
            for name in ("render.uniforms", "render.front.project",
                         "render.front.skybox", "render.front.proxy",
                         "render.front.bin", "render.back", "render.aux"):
                want[name] = tries
            if depth:
                want["render.drain"] = n + 1
            else:
                want.update({"sync.aux": tries, "render.drain": 1})
            got = {k: sec.get(k, {}).get("n") for k in want}
            if got != want or (depth and res["overflow_retries"]):
                raise RuntimeError(f"[hostprof] {label}: sections entered "
                                   f"{got}, want {want}; retries "
                                   f"{res['overflow_retries']}")
            old = [k for k in ("sync.uniforms", "sync.upload_plan",
                               "sync.bin_pairs", "sync.expand_bboxes",
                               "sync.mip_levels") if k in sec]
            if old or (depth and "sync.aux" in sec):
                raise RuntimeError(f"[hostprof] {label}: a frame waited "
                                   f"inside itself: {old or 'sync.aux'}")
            per = {k: v["self_ms"] / n for k, v in sec.items()}
            top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
            waits = {k: round(v, 3) for k, v in per.items()
                     if k.startswith("sync.") or k == "render.drain"}
            print(f"[hostprof] {label}, {n} fast 1080p frames ({smi}): wall "
                  f"{res['wall_ms']:.3f} ms/frame; render thread sections "
                  f"{res['accounted_ms']:.3f} = waits {res['sync_ms']:.3f} "
                  f"{waits} + dispatch {res['rest_ms']:.3f}, unaccounted "
                  f"{res['unaccounted_ms']:.3f}; builder staging "
                  f"{res['builder_ms']:.3f} ms/frame, load "
                  f"{res['builder_load']:.3f}; overflow frames "
                  f"{res['overflow_frames']}, retries "
                  f"{res['overflow_retries']}; self ms/frame "
                  + ", ".join(f"{k} {v:.3f}" for k, v in top)
                  + f"; launches {launches}")


def phase_inflight(torch, eng, fp, label, smi, n: int = 8):
    """[inflight] n frames of the first leg from the Engine's current plan:
    first at depth 0 (each read at its end, the budgets growing from every
    frame), then at pipeline_depth 2 under PyTorch's sync debug mode
    "error", which raises at any wait a tensor operation makes; the only
    wait there is the drain of the frame two behind (an event's
    synchronize, in render.drain, which the debug mode does not see). After
    the drain every pipelined image must EQUAL the depth-0 image of its
    camera, and no pipelined frame may overflow a budget."""
    from gswt_renderer_tpu_torch.core import hostprof

    r = eng.renderer
    staged = eng._staged
    kw = dict(render_gs=eng.render_gs, use_skybox=eng.use_skybox,
              use_proxy=eng.use_proxy, staged=staged, as_numpy=False)
    times = [15000.0 * i / n for i in range(n)]

    def frames(depth):
        imgs, held = [], []
        fp.reset_path()
        fp.start_path()
        for t in times:
            fp.handle_events(eng.camera, now_ms=t)
            imgs.append(r.render(None, eng.camera, eng.scene_params,
                                 eng.render_config, pipeline_depth=depth,
                                 **kw))
            held.append(len(r._inflight))
        return imgs, held

    r.drain()
    ref, _ = frames(0)
    r.drain()
    demand, overflow0 = r.pair_budget.demand, r.overflow_frames
    hostprof.HOST_PROF.clear()
    hostprof.set_host_prof(True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        piped, held = frames(2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        hostprof.set_host_prof(False)
    sec = {k: v[0] for k, v in hostprof.HOST_PROF.items()}
    hostprof.HOST_PROF.clear()
    r.drain()
    waits = {k: v for k, v in sec.items()
             if k.startswith("sync.") or k == "render.drain"}
    if waits != {"render.drain": n} or held != [1] + [2] * (n - 1):
        raise RuntimeError(f"[inflight] {label}: the pipelined frames "
                           f"waited in {waits}, frames in flight {held}")
    differ = [i for i, (a, b) in enumerate(zip(ref, piped))
              if not torch.equal(a, b)]
    if differ or r.overflow_frames != overflow0:
        raise RuntimeError(f"[inflight] {label}: pipelined frames {differ} "
                           f"differ from their depth-0 frames, overflow "
                           f"frames {r.overflow_frames - overflow0}")
    print(f"[inflight] {label}: {n} frames at depth 2 under sync debug "
          f"mode \"error\": no wait but the drain of the frame two behind "
          f"(render.drain entered {sec['render.drain']} times, frames in "
          f"flight after each {held}), each image bit-equal to its depth-0 "
          f"frame; stream {staged['blocks'].shape[1] * 256} lanes, pair "
          f"demand seen {demand} (capacity "
          f"{r.pair_budget.capacity(staged['blocks'].shape[1] * 256, r.cfg.chunk)}"
          f"), proxy pair demand {r.proxy_budget.demand}; overflow_frames "
          f"{r.overflow_frames} over this Engine's frames so far ({smi})")


def phase_scripts(need, per_frame):
    """[bench] The fixed-camera and A/B scripts through their main() at
    their smallest honest setting, each in a launch-count window of its
    own that must hold `frames` launches of each kernel its frames run."""
    from gswt_renderer_tpu_torch.benchmarks import (
        configs, cull_ab, depth_cull_ab, inversion_ab, micro_background,
        profile_frame, proxydiv_ab, quick_full, saturation)
    from gswt_renderer_tpu_torch.ops import kernels

    splat = ("project", "binning", "raster")
    background = ("bilinear", "trirast", "trirast_fold", "mip_trilinear")

    def run(name, fn, argv, names, frames):
        kernels.LAUNCHES.clear()
        t0 = time.time()
        res = fn(argv)
        launches = dict(kernels.LAUNCHES)
        need(launches, names, frames, name)
        return res, f"({time.time() - t0:.1f} s; launches {launches})"

    def med(s):
        return f"{s['median']:.2f} ({s['min']:.2f}-{s['max']:.2f})"

    res, tail = run("profile_frame", profile_frame.main, ["-n", "3"],
                    per_frame, 6)
    print(f"[bench] profile_frame: 3 frames {med(res['frame_ms'])} ms; top "
          f"device ops "
          + ", ".join(f"{stage} {ms:.3f}" for ms, _, stage, _ in
                      res["device_ops"][:4]) + f" {tail}")
    res, tail = run("quick_full", quick_full.main, ["-n", "4", "--ab"],
                    per_frame, 12)
    print(f"[bench] quick_full --ab: " + "; ".join(
        f"sat_cull={r['sat_cull']} {med(r['frame_ms'])} ms, kept "
        f"{r['n_pairs_kept']}" for r in res) + f" {tail}")
    for flag in ([], ["--no-cull-exact"]):
        res, tail = run("cull_ab", cull_ab.main, ["-n", "3"] + flag,
                        per_frame, 24)
        print(f"[bench] cull_ab{' ' + flag[0] if flag else ''}: " + "; ".join(
            f"{r['variant']}/cam{r['cam']} {med(r['frame_ms'])} ms, kept "
            f"{r['n_pairs_kept']}" for r in res) + f" {tail}")
    res, tail = run("depth_cull_ab", depth_cull_ab.main, ["-n", "4"],
                    per_frame, 8)
    print(f"[bench] depth_cull_ab: off {med(res['off']['frame_ms'])} ms, "
          f"kept {res['off']['n_pairs_kept']}; on "
          f"{med(res['on']['frame_ms'])} ms, kept "
          f"{res['on']['n_pairs_kept']} {tail}")
    res, tail = run("proxydiv_ab", proxydiv_ab.main, ["-n", "4"], per_frame,
                    8)
    print(f"[bench] proxydiv_ab: " + "; ".join(
        f"div {r['div']} {med(r['frame_ms'])} ms, proxy pairs "
        f"{r['proxy_pairs']}" for r in res)
        + f"; max |diff| {res[-1]['max_diff']:.4f}, over 8/255 "
        f"{res[-1]['share_over_8']:.3%} {tail}")
    res, tail = run("saturation", saturation.main, [], per_frame, 1)
    if res["pairs_composited"] + res["pairs_in_skipped_entries"] != \
            res["pairs_total"]:
        raise RuntimeError(f"[bench] saturation does not add up: {res}")
    print(f"[bench] saturation: {json.dumps(res)} {tail}")
    res, tail = run("micro_background", micro_background.main,
                    ["-n", "4", "--reps", "5"], background, 20)
    print(f"[bench] micro_background: " + "; ".join(
        f"{r['name']} {med(r)} ms" for r in res) + f" {tail}")
    res, tail = run("inversion_ab", inversion_ab.main, ["-n", "3"], splat,
                    18)
    print(f"[bench] inversion_ab: " + "; ".join(
        f"{r['res']} gs {med(r['gs'])}, +sky {med(r['gs+sky'])}, full "
        f"{med(r['full'])} ms, kept {r['n_pairs_kept']}" for r in res["rows"])
        + f"; ratios {json.dumps(res['ratio'])} {tail}")
    res, tail = run("configs", configs.main, ["--quick"], splat, 35)
    vps = {r["config"]: r["viewport"] for r in res}
    if (vps["4b_full_skybox_proxy_4k"] != [3840, 2160]
            or vps["5_batched_cameras_1080p"] != [1920, 1080]):
        raise RuntimeError(f"[bench] configs rendered at {vps}")
    print(f"[bench] configs --quick: " + "; ".join(
        f"{r['config']} {r['frame_ms']:.2f} ms ({r['spread']['min']:.2f}-"
        f"{r['spread']['max']:.2f})" for r in res) + f" {tail}")


def phase_parallel(torch, eng, need, label, *, gate, layers):
    """[parallel] on one Engine's frame (its staged plan, camera and
    textures, skybox + proxy): render_stream_segments at n_seg = 4 against
    Renderer.render of the same plan, 2 to 4 calls with the cut's feedback
    (until the pairs per segment are within 1.5x), in a launch window of
    its own. gate: (max |err| limit, mean limit or
    None); layers: the background's kernels that must run in every call.
    Returns (max err, mean err, pairs of the last call)."""
    from gswt_renderer_tpu_torch.ops import kernels
    from gswt_renderer_tpu_torch.parallel import render_stream_segments

    r, staged, cam = eng.renderer, eng._staged, eng.camera
    sp, rc = eng.scene_params, eng.render_config
    full = dict(use_skybox=True, use_proxy=True)
    ref = r.render(None, cam, sp, rc, staged=staged, as_numpy=False, **full)
    kept = int(r.last_aux["n_pairs_kept"])
    r.__dict__.pop("_sp_feedback", None)
    kernels.LAUNCHES.clear()
    for call in range(1, 5):
        img = render_stream_segments(r, staged, sp, cam, 4, rc, **full)
        pairs = r.last_shard_pairs_kept
        print(f"[parallel] {label} n_seg=4 call {call}: cut "
              f"{r.last_sp_bounds}, pairs per segment {pairs} (sum "
              f"{sum(pairs)}, the single frame {kept}, max/min "
              f"{max(pairs) / max(min(pairs), 1):.3f})")
        # at least one call on the cut the feedback set
        if call > 1 and min(pairs) > 0 and max(pairs) <= 1.5 * min(pairs):
            break
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    need(launches, ("project", "binning", "raster"), 4 * call,
         f"{label} segments")
    need(launches, layers, call, f"{label} segmented frames")
    if "mip_trilinear" not in layers and launches.get("mip_trilinear", 0):
        raise RuntimeError(f"[parallel] {label}: mip_trilinear ran; this "
                           f"profile samples the proxy through the atlas")
    diff = (img - ref).abs()
    err, mean = float(diff.amax()), float(diff.mean())
    print(f"[parallel] {label} n_seg=4 against Renderer.render of the same "
          f"plan: max |err| {err:.3e} (limit {gate[0]:.3e}), mean {mean:.3e}"
          f"{'' if gate[1] is None else f' (limit {gate[1]:.0e})'}; "
          f"launches {launches} in {call} calls, per segment "
          f"{ {k: v / (4 * call) for k, v in launches.items()} }")
    if not (bool(torch.isfinite(img).all()) and err <= gate[0]
            and (gate[1] is None or mean < gate[1])):
        raise RuntimeError(f"[parallel] {label}: the folded segments are not "
                           f"the single frame")
    if not (min(pairs) > 0 and max(pairs) <= 1.5 * min(pairs)
            and abs(sum(pairs) - kept) <= 0.05 * kept):
        raise RuntimeError(f"[parallel] {label}: pairs per segment {pairs} "
                           f"unbalanced or off the frame's {kept}")
    return err, mean, pairs


def phase_nccl(torch, eng, need):
    """[parallel] dp = sp = 1 through a real NCCL group of one: a batch of 4
    distinct cameras and the stream path, each against Renderer.render of
    the same plan, bit-equal (same kernels, same inputs)."""
    from gswt_renderer_tpu_torch.core import Camera
    from gswt_renderer_tpu_torch.ops import kernels
    from gswt_renderer_tpu_torch.parallel import (
        render_cameras_sharded, render_stream_sharded)
    from gswt_renderer_tpu_torch.parallel.batched import (
        group_of_one, pack_camera_batch)

    r, staged, c0 = eng.renderer, eng._staged, eng.camera
    sp, rc = eng.scene_params, eng.render_config
    full = dict(use_skybox=True, use_proxy=True)
    cams = [Camera(c0.viewport, c0.position + np.float32([0.5 * i, 0, 0]),
                   c0.target + np.float32([0.5 * i, 0, 0]), c0.up, c0.fovy,
                   c0.z_near, c0.z_far) for i in range(4)]
    kernels.LAUNCHES.clear()
    with group_of_one("cuda") as mesh:
        backend = torch.distributed.get_backend()
        imgs = render_cameras_sharded(
            r, staged, sp, pack_camera_batch(r, sp, cams, rc), mesh, rc,
            **full)
        img = render_stream_sharded(r, staged, sp, cams[0], mesh, rc, **full)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    need(launches, ("project", "binning", "raster", "trirast", "bilinear"),
         5, "dp batch and sp frame")
    errs = []
    for i, c in enumerate(cams):
        ref = r.render(None, c, sp, rc, staged=staged, as_numpy=False, **full)
        errs.append(float((imgs[i] - ref).abs().amax()))
        if i == 0:
            sp_equal = bool(torch.equal(img, ref))
        if not torch.equal(imgs[i], ref):
            raise RuntimeError(f"[parallel] dp camera {i} is not bit-equal "
                               f"to Renderer.render")
    print(f"[parallel] {backend} group of one, mesh {tuple(mesh.shape)}: "
          f"dp batch {tuple(imgs.shape)} max |err| per camera {errs} "
          f"(bit-equal), sp frame bit-equal {sp_equal}; launches {launches}")
    if not sp_equal or backend != "nccl":
        raise RuntimeError("[parallel] the NCCL stream path is not the "
                           "plain frame")


def phase_viewer(torch, eng, need, per_frame):
    """[viewer] serve() in a thread over the fast-profile 1080p Engine:
    /frame.jpg until 3 distinct JPEGs (each 960x540) while the camera moves,
    /hud, a /bench over 2 recorded keyframes, /quit; fails on a render-loop
    error. Returns the /bench answer."""
    import io
    import threading
    import urllib.error
    import urllib.request

    from PIL import Image

    from gswt_renderer_tpu_torch.ops import kernels
    from gswt_renderer_tpu_torch.viewer.server import serve

    stop, ready, bound = threading.Event(), threading.Event(), {}

    def on_bound(port):
        bound["port"] = port
        ready.set()

    def call(path, body=None, timeout=120):
        req = urllib.request.Request(
            f"http://127.0.0.1:{bound['port']}{path}",
            data=None if body is None else json.dumps(body).encode(),
            method="GET" if body is None else "POST")
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read()

    kernels.LAUNCHES.clear()
    t0 = time.time()
    th = threading.Thread(target=serve, args=(eng, "127.0.0.1", 0),
                          kwargs=dict(stream_ms=50.0, stop_event=stop,
                                      on_bound=on_bound), daemon=True)
    th.start()
    try:
        if not ready.wait(30):
            raise RuntimeError("[viewer] the server did not bind")
        call("/key", {"key": "w", "pressed": True})
        jpgs = []
        while len(set(jpgs)) < 3 and time.time() - t0 < 90:
            try:
                jpgs.append(call("/frame.jpg"))
            except urllib.error.HTTPError:  # 503 before the first grab
                pass
            time.sleep(0.1)
        call("/key", {"key": "w", "pressed": False})
        sizes = {Image.open(io.BytesIO(j)).size for j in set(jpgs)}
        hud = json.loads(call("/hud"))
        call("/flypath", {"action": "clear"})
        call("/flypath", {"action": "record"})
        pos = eng.camera.position + np.float32([2.0, 6.0, 0.0])
        call("/camera", {"position": pos.tolist()})
        call("/flypath", {"action": "record", "interval": 2.0})
        bench = json.loads(call("/bench", {}, timeout=300))
        hud_end = json.loads(call("/hud"))
        call("/quit", {})
    finally:
        stop.set()
        th.join(30)
    launches = dict(kernels.LAUNCHES)
    print(f"[viewer] {len(set(jpgs))} distinct JPEGs of {len(jpgs)} fetched, "
          f"sizes {sorted(sizes)}; /hud fps {hud['fps']:.2f}, frame "
          f"{hud['frame_ms']:.2f} ms, display {hud['display_fps']:.2f} fps, "
          f"splats {hud['splats']}, render errors {hud_end['render_errors']}")
    print(f"[viewer] /bench over 2 keyframes: {bench['frames']} frames, "
          f"median {bench['median_frame_ms']:.2f} ms, {bench['fps']:.2f} fps; "
          f"launches {launches}; {time.time() - t0:.1f} s")
    if th.is_alive():
        raise RuntimeError("[viewer] the server did not stop on /quit")
    if hud_end["render_errors"]:
        raise RuntimeError(f"[viewer] the render loop raised "
                           f"{hud_end['render_errors']} times: "
                           f"{hud_end['last_render_error']}")
    if len(set(jpgs)) < 3 or sizes != {(960, 540)}:
        raise RuntimeError(f"[viewer] JPEGs: {len(set(jpgs))} distinct, "
                           f"sizes {sizes}")
    if not (bench["frames"] > 0 and bench["median_frame_ms"] > 0):
        raise RuntimeError("[viewer] /bench timed no frame")
    need(launches, per_frame, 3, "viewer")
    return bench


def phase_cli(torch, root, need, per_frame):
    """[viewer] the CLI on the card: render the demo fly path at 1080p,
    2 fps, into PNGs (checked, then removed), and bench's dump."""
    import contextlib
    import io
    import shutil
    import struct

    from gswt_renderer_tpu_torch.ops import kernels
    from gswt_renderer_tpu_torch.viewer import cli

    out_dir = os.path.join(root, "chiprun_out", "smoke_cli_frames")
    shutil.rmtree(out_dir, ignore_errors=True)
    kernels.LAUNCHES.clear()
    t0 = time.time()
    cli.main(["render", "--fly-path",
              os.path.join(root, "examples", "flypath_demo.json"),
              "--out", out_dir, "--size", "1920x1080", "--fps", "2"])
    launches = dict(kernels.LAUNCHES)
    names = sorted(os.listdir(out_dir))
    for name in names:
        with open(os.path.join(out_dir, name), "rb") as f:
            head = f.read(24)
        if head[:8] != b"\x89PNG\r\n\x1a\n" or struct.unpack(
                ">II", head[16:24]) != (1920, 1080):
            raise RuntimeError(f"[viewer] cli render wrote a bad PNG {name}")
    shutil.rmtree(out_dir)
    print(f"[viewer] cli render: {len(names)} 1920x1080 PNGs of the demo "
          f"path at 2 fps in {time.time() - t0:.1f} s; launches {launches}")
    if len(names) != 30:  # 15 s of path at 2 fps
        raise RuntimeError(f"[viewer] cli render wrote {len(names)} frames, "
                           f"not 30")
    need(launches, per_frame[:2], len(names), "cli render")
    kernels.LAUNCHES.clear()
    t0 = time.time()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["bench", "--size", "1920x1080"])
    dump = buf.getvalue()
    launches = dict(kernels.LAUNCHES)
    res = json.loads(dump[: dump.index("Render & Sort")])
    print(f"[viewer] cli bench ({time.time() - t0:.1f} s): {res['frames']} "
          f"frames, median {res['median_frame_ms']:.2f} ms; launches "
          f"{launches}; dump: {dump.splitlines()[-1]}")
    if "\\pm" not in dump or not res["frames"]:
        raise RuntimeError("[viewer] cli bench printed no benchmark")
    need(launches, per_frame[:2], res["frames"], "cli bench")


def main():
    import dataclasses

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gswt_renderer_tpu_torch.benchmarks import (
        batched_ab, headline, mergesorted, micro_blockgather, micro_merge,
        micro_raster, sweep_shapes)
    from gswt_renderer_tpu_torch.engine import Engine, FlyPathControl, FlyPathFrame
    from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec
    from gswt_renderer_tpu_torch.ops import (
        kernels, project, proxy, raster, skybox, texsample, trirast)
    from gswt_renderer_tpu_torch.ops.blockgather import (
        block_gather, block_gather_plain)
    from gswt_renderer_tpu_torch.render.pipeline import (
        PROXY_CHUNK, SEED_PAIRS_PER_TRIANGLE, PairBudget, RendererConfig)

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

    # the compositor's variants as the card holds them: registers, local
    # memory, thread blocks an SM and clusters at once
    for tile_wh in ((64, 32), (100, 20)):
        for exact in (True, False):
            for zcut in (False, True):
                occ = raster.kernel_occupancy(tile_wh, exact=exact,
                                              emit_zcut=zcut)
                print(f"[build] raster {tile_wh[0]}x{tile_wh[1]} "
                      f"{'exact' if exact else 'fast'}"
                      f"{' + zcut' if zcut else ''}: {occ['registers']} "
                      f"registers, {occ['local_bytes']} B local a thread, "
                      f"{occ['ctas_per_sm']} thread blocks an SM, "
                      f"{occ['clusters']} clusters of 4 at once")

    # 3. the ground against the benchmark's; the reference on a small input
    phase_ground(torch, smi)
    phase_reference(torch, smi)

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
        its hit mask nearest, as in the JAX package). Each frame is
        launched as Engine.frame launches it (pipeline_depth 2) and then
        completed with every frame in flight (renderer.drain), so its wall
        time is device-complete and last_aux holds its own counts."""
        if moving:
            fp.reset_path()
            fp.start_path()
        frame_ms, pairs, kept, off = [], [], [], 0.0
        overflow0 = eng.renderer.overflow_frames
        for i in range(n_frames):
            if moving:
                fp.handle_events(eng.camera, now_ms=15000.0 * i / n_frames)
            t0 = time.perf_counter()
            img = eng.frame(readback=False)
            eng.renderer.drain()
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
                    img=img,
                    overflow=eng.renderer.overflow_frames - overflow0)

    def report(label, run, launches):
        q1, q2, q3 = np.percentile(run["ms"], [25, 50, 75])
        print(f"[main] {len(run['ms'])} {label} 1080p frames: median "
              f"{q2:.2f} ms (quartiles {q1:.2f}, {q3:.2f}; first "
              f"{run['ms'][0]:.2f}), pairs/frame median "
              f"{int(np.median(run['pairs']))}, kept after the culls "
              f"{int(np.median(run['kept']))}, alpha off 1 on at most "
              f"{run['alpha_off']:.2e} of the pixels, overflow frames "
              f"{run['overflow']}, launches {launches}")

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
    need(launches_gs, ("project", "binning", "raster"), N_FRAMES_GS,
         "gs-only")
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
    # one exact full-config frame there grows the proxy pair budget from
    # its full-resolution grid raster
    eng.frame()
    first_camera(eng)
    scene_d, cam_d = r.frame_uniforms(eng.camera, eng.scene_params,
                                      eng.render_config)[:2]
    rcfg = eng.render_config
    surface = int(eng.scene_params.surface_type)
    ptile = (r.cfg.proxy_tile_w, r.cfg.proxy_tile_h)
    p_n_proxy = ptile[0] * ptile[1]

    def tri_capacity(planes, bbox, ok, wh):
        """The proxy pair slots a frame of this camera gives the triangle
        raster at wh: the budget once a frame's demand at wh has grown it
        (at the exact profile's full resolution, the Renderer's own)."""
        n = int(trirast.bin_triangles(planes, bbox, ok, image_wh=wh,
                                      tile_wh=ptile, capacity=PROXY_CHUNK)[3])
        budget = PairBudget(SEED_PAIRS_PER_TRIANGLE)
        budget.absorb(n)
        cap = budget.capacity(r.proxy_tris.shape[1], PROXY_CHUNK)
        own = r.proxy_budget.capacity(r.proxy_tris.shape[1], PROXY_CHUNK)
        if wh == image_wh and cap != own:
            raise RuntimeError(f"trirast: {cap} slots at {wh}, the exact "
                               f"frame's budget gives {own}")
        return cap

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
        tri_cap = tri_capacity(planes, bbox, ok, wh)
        rows, t_rs, t_re, n_tri_pairs, skey, stri = trirast.bin_triangles(
            planes, bbox, ok, image_wh=wh, tile_wh=ptile, capacity=tri_cap,
            return_index=True)
        n_tri_pairs = int(n_tri_pairs)
        if n_tri_pairs > tri_cap:
            raise RuntimeError(f"trirast {label}: {n_tri_pairs} pairs beyond "
                               f"the proxy budget's {tri_cap}")
        tri_kw = dict(image_wh=wh, tile_wh=ptile, chunk=128)
        st = tri_load(f"{label} ({int(ok.sum())} triangles, {n_tri_pairs} "
                      f"pairs in the proxy budget's {tri_cap} slots)", rows,
                      t_rs, t_re, tri_kw, skey, stri, bbox)
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
        # the rows of the pairs in runs: the slots past the demand are
        # never read
        tri_bytes = 4 * (rows.shape[0] * n_tri_pairs + t_rs.numel()
                         + t_re.numel() + k_out.numel())
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
        _, u_px, v_px, _, hit_px, _, _ = proxy.raster_map_grid(
            cam_d, scene_d, wh, r.hm4, r.height_map_wh, r.proxy_verts,
            r.proxy_tris, surface_type=surface,
            height_offset=float(rcfg.proxy_height), tile_wh=ptile, chunk=128,
            capacity=r.proxy_budget.capacity(r.proxy_tris.shape[1],
                                             PROXY_CHUNK))
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
    need(launches_exact, ("project", "binning", "raster", "trirast",
                          "trirast_fold", "bilinear"),
         N_FRAMES_EXACT, "exact full-config")
    if launches_exact.get("mip_trilinear", 0):
        raise RuntimeError("the exact-profile frame launched mip_trilinear: "
                           "it samples the proxy through the atlas")
    rs["launches"] = launches_exact["raster"]
    report("exact full-config", exact_run, launches_exact)
    print(f"[main] proxy pairs last frame "
          f"{eng.renderer.last_aux['proxy_pairs']}, setup {setup_s:.1f} s")

    # 6a. where the exact full-config frame's time goes, and where its
    # host waits for the device
    phase_profile(torch, eng, fp, "exact")
    phase_syncs(torch, eng, fp, "exact")
    phase_inflight(torch, eng, fp, "exact", smi)

    # 8a. [parallel] the stream cut into 4 segments, folded, and dp = sp = 1
    # through NCCL, on the exact frame
    seg_exact = phase_parallel(torch, eng, need, "exact",
                               gate=(SEG_TOL, 1e-4),
                               layers=("trirast", "bilinear"))
    phase_nccl(torch, eng, need)
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

    # 4d. the projection kernel on the fast frame's own inputs
    pj = phase_project(torch, eng, smi)
    bn = phase_binning(torch, eng, smi)

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
    # the longest run alone: a tile's four CTAs walk its run in order, so
    # the kernel takes at least this tile's time
    runs_q = binned_q["range_end"] - binned_q["range_start"]
    top = int(torch.argmax(runs_q))
    alone_ms = _time_ms(torch, lambda: raster.rasterize(
        one_tile(torch, binned_q, top), depth_q, **fast_kw), 10)
    print(f"[kernel] raster_fast on the longest run alone ({int(runs_q[top])} "
          f"pairs, tile {top}): {alone_ms:.3f} ms of the frame's "
          f"{rf['ms']:.3f} ms (max_run {int(binned_q['max_run'])})")
    # the splat-only still cells' own tables
    phase_cell_tables(torch, smi)
    exact_on_q_ms = _time_ms(torch, lambda: raster.rasterize(
        binned_q, depth_q, **depth_kw), 10)
    print(f"[kernel] raster variants on the fast frame's table: exact "
          f"{exact_on_q_ms:.3f} ms, fast {rf['ms']:.3f} ms, fast + zcut "
          f"{rz['ms']:.3f} ms")

    # 5c. the main path: fast full-config frames through Engine
    kernels.LAUNCHES.clear()
    fast_run = drive(eng, N_FRAMES, "fast full-config", alpha_share=0.02)
    launches = dict(kernels.LAUNCHES)
    per_frame = ("project", "binning", "raster", "trirast", "trirast_fold",
                 "bilinear", "mip_trilinear")
    need(launches, per_frame, N_FRAMES, "fast full-config")
    for k in (pj, bn, tr, fd, bl, mp):
        k["launches"] = launches[k["name"]]
    # the main path no longer copies the stream: block_gather has its own
    # callers (the micro-benchmark, the plain projection)
    bg["launches"] = launches.get("block_gather", 0)
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

    # 6b. where the fast full-config frame's time goes, and where its host
    # waits for the device
    phase_profile(torch, eng, fp, "fast")
    phase_syncs(torch, eng, fp, "fast")
    phase_inflight(torch, eng, fp, "fast", smi)

    # 8b. [parallel] the fast profile's 4 segments beside the exact ones, and
    # [viewer] the HTTP viewer over this Engine, then the CLI
    seg_fast = phase_parallel(torch, eng, need, "fast", gate=(SEG_FAST_TOL, None),
                              layers=("trirast", "bilinear", "mip_trilinear"))
    print(f"[parallel] n_seg=4 max |err|: exact {seg_exact[0]:.3e} (limit "
          f"{SEG_TOL:.3e}), fast {seg_fast[0]:.3e} (limit {SEG_FAST_TOL:.3e}); "
          f"mean exact {seg_exact[1]:.3e}, fast {seg_fast[1]:.3e}")
    phase_viewer(torch, eng, need, per_frame)
    eng.shutdown()
    phase_cli(torch, os.path.dirname(os.path.abspath(__file__)), need,
              per_frame)

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
    # the tournament's time as the median of 7 event windows of 10 calls
    mm_ms, mm_windows = _median_ms(
        torch, lambda: mergesorted.merge_sorted(tabs, block=mm_block))

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
          f"merges): median {mm_ms:.4f} ms of 7 event windows of 10 calls "
          f"({', '.join(f'{w:.4f}' for w in mm_windows)}; micro_merge's own "
          f"{mm_res['merge_ms']:.4f}), {mm_bound / mm_ms:.1%} of its byte "
          f"bound {mm_bound:.4f} (plain {mm_plain_ms:.3f}, torch.sort + "
          f"gather {mm_res['sort_ms']:.4f})")
    # one entry for the merge kernel: a whole k=5 tournament (4 launches of
    # the merge kernel and 4 of the split kernel), what micro_merge times
    new_entries = [dict(
        name="merge_sorted_pair", route="cuda", source=csrc + "mergesorted.cu",
        replaces="benchmarks/mergesorted.py:227",
        launches=launches_mm["merge_sorted_pair"], max_abs_err=0.0,
        ms=mm_ms, plain_ms=mm_plain_ms, bound_ms=mm_bound,
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

    # the camera batch and stream segments against the interactive frame,
    # and two entries of the tile-shape sweep, through their main()
    kernels.LAUNCHES.clear()
    ab = {row["variant"]: row for row in batched_ab.main(["-b", "4", "-n", "3"])}
    launches_ab = dict(kernels.LAUNCHES)
    need(launches_ab, ("project", "binning", "raster"), 4, "batched_ab")
    print(f"[bench] batched_ab, gs-only 1080p, fast profile: interactive "
          f"{ab['interactive']['ms_per_cam']:.2f} ms, batch of 4 identical "
          f"{ab['batch_same']['ms_per_cam']:.2f} ms/camera "
          f"({ab['batch_same']['vs_interactive']:.3f}x), distinct "
          f"{ab['batch_diff']['ms_per_cam']:.2f} "
          f"({ab['batch_diff']['vs_interactive']:.3f}x), 2 segments "
          f"{ab['segments2']['ms']:.2f} ms (pairs {ab['segments2']['pairs']}, "
          f"max |err| {ab['segments2']['max_err']:.3e}), 4 segments "
          f"{ab['segments4']['ms']:.2f} ms (pairs {ab['segments4']['pairs']}, "
          f"max |err| {ab['segments4']['max_err']:.3e}), interactive again "
          f"{ab['interactive2']['ms_per_cam']:.2f}; launches {launches_ab}")
    kept_ab = ab["interactive"]["n_pairs_kept"]
    for n_seg in (2, 4):
        row = ab[f"segments{n_seg}"]
        if (row["max_err"] > SEG_FAST_TOL
                or abs(sum(row["pairs"]) - kept_ab) > 0.05 * kept_ab):
            raise RuntimeError(f"[bench] batched_ab segments{n_seg}: {row}")
    kernels.LAUNCHES.clear()
    n_sweep = 24
    sweep = sweep_shapes.main(["--grid", "64x32x256,32x16x128", "--frames",
                               str(n_sweep), "--warm-stride", "3"])
    launches_sw = dict(kernels.LAUNCHES)
    need(launches_sw, per_frame, len(sweep) * n_sweep, "sweep_shapes")
    print(f"[bench] sweep_shapes, 2 entries x {n_sweep} frames: "
          + "; ".join(f"{k} median {v['frame_ms_median']:.2f} ms, "
                      f"{v['n_pairs_kept']} pairs kept"
                      for k, v in sweep.items())
          + f"; launches {launches_sw}")

    # 10. where the fly-through's host time goes; 11. the fixed-camera and
    # A/B scripts
    phase_hostprof(need, per_frame, smi)
    phase_scripts(need, per_frame)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: d[k] for k in keys}
                                  for d in [bg, pj, bn, rs, rf, rz, tr, fd, bl,
                                            mp]
                                  + new_entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
