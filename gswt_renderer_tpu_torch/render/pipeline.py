"""The per-frame pipeline on torch tensors.

One frame:

  cull draws -> assemble + project the splat stream (panel block-gather
  kernel + vs_main math, vectorized) -> skybox background (bilinear sampler
  kernel) and proxy ground colour + depth (triangle raster kernel) -> tile
  binning (exact pair expansion + one stable sort by image tile, with the
  optional proxy-depth occlusion cull) -> compositor kernel, depth-tested
  against the proxy -> premultiplied over-composite onto the background.

Host/device split (mirrors the reference's preloaded vs streaming buffers,
renderer.rs:270-327): the splat store, the materialized presort panels and
the height map live on the device across frames; the *splat stream* is
described by a per-SORT block plan built on the host (a few hundred KB of
panel ids + per-draw bits, `stage_vp`) and assembled on the device. The plan
stays numpy until the render thread uploads it, so the builder thread never
touches a CUDA stream.

No frame waits for the device between its first and its last launch. The
pair expansions fill capacities fixed on the host before the frame starts
(PairBudget: the largest demand seen times PAIR_HEADROOM), the uniforms and
the plan go up from pinned host memory with non-blocking copies, and the
frame's counts come back through a pinned buffer behind an event.
render(pipeline_depth=0) reads them at the frame's end and renders the frame
again if it overflowed a budget, so every frame read back is exact and
equals what the JAX package renders once its buckets have converged;
pipeline_depth > 0 keeps that many frames in flight and completes the
oldest (drain), as the JAX package's Renderer.render does.

Two profiles, as in the JAX package. The default fast profile
(RendererConfig.exact=False, PARITY.md #8) quantizes what the compositor
consumes (bf16 Cholesky factors of the quadratic, u16 floored z, u8
colours), takes the height-map gradient analytically, renders the proxy at
half resolution through the mip-pyramid sampler kernel, and composites with
bf16-rounded weights; on top of it sat_cull feeds the compositor's
saturation-slot record of one frame into the next frame's binning. The exact
profile follows the WGSL/oracle math and is the parity reference.

The stages run under the host-section profiler's sections
(core/hostprof.py, re-exported here), which record nothing unless
set_host_prof(True). While it is on, each section is a span in the span log
and a profiler range ``gswt.<section>`` (gswt.render.front.project,
gswt.render.front.skybox, gswt.render.front.proxy, gswt.render.front.bin,
gswt.render.back, ...; chip_smoke.py's profile phase reads them); the
render thread's sections that launch device work (render.sat_cut,
render.uniforms, render.plan, render.front.project, .background, .skybox,
.proxy with its .proxy.raster and .proxy.shade, .bin, render.back,
render.aux) also take a device start and end; and each frame's pair demand,
the capacity its expansions were launched with and the proxy grid's
triangle counts are filed under its frame id once its counts are read back
(_drain_one, exactly). Every launch of a frame falls inside one of them.
"""

from __future__ import annotations

import contextlib
import math
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..core import hostprof
from ..core.camera import Camera, CameraUniforms
from ..core.config import RenderConfig
from ..core.hostprof import (  # noqa: F401  (the profiler's public names)
    HOST_PROF, _hprof, host_prof_report, set_host_prof)
from ..core.mathutil import OPENGL_TO_WGPU
from ..io.textures import build_mip_chain
from ..ops import binning, project, raster
from ..ops.raster import SAT_BANDS, SAT_NOCUT
from ..ops.kernels import resolve_device
from ..ops.project import GS_BITS, pack_tex4
from ..ops.proxy import (atlas_words, make_map_grid, mip_table,
                         pack_mip_atlas, render_proxy)
from ..ops.skybox import bake_hdri_to_cubemap, render_skybox
from ..ops.texsample import pack_pyramid, sampler_pyramid
from ..tiles.structures import DrawTable
from .uniforms import SceneParams

STREAM_BLOCK = 256  # stream panel width (ops/blockgather.py BLOCK)
PANEL_ROWS = 16     # pos xyz, cov 6, rgba u32, packed gs|lod, map id, 4 pad

# The two pair budgets (splat pairs, proxy-triangle pairs), PairBudget: a
# frame's capacity is the largest demand seen times PAIR_HEADROOM, so a
# camera that moves into half as many pairs again as any frame before it
# still fits (the JAX package grows its pair bucket with the same 1.5x; a
# pipelined frame sizes its capacity from the frames completed before it,
# pipeline_depth frames late); before any demand is seen, the stream's
# lanes times SEED_PAIRS_PER_LANE (a bbox pair per lane is about what the
# bench fly-through bins) or the proxy grid's triangles times
# SEED_PAIRS_PER_TRIANGLE (most triangles lie off screen).
PAIR_HEADROOM = 1.5
SEED_PAIRS_PER_LANE = 2.0
SEED_PAIRS_PER_TRIANGLE = 2.0
# the proxy raster's pair chunk (ops/trirast.py)
PROXY_CHUNK = 128
# the frame counts a frame reads back (its aux), in the order of the host
# vector; the proxy grid's triangle counts only while the host-section
# profiler is on (ops/proxy.py grid_counts)
AUX_KEYS = ("n_pairs", "n_pairs_kept", "n_live", "max_run", "overflow",
            "proxy_pairs", "proxy_overflow", "proxy_tris_live",
            "proxy_tris_thin")
# every array of an upload (upload_parts) starts at a multiple of this many
# bytes
_UPLOAD_ALIGN = 256


class PairBudget:
    """A grow-only pair budget: the capacity a pair expansion fills, fixed
    on the host before the frame is launched. Not keyed by shape and not
    rounded to powers of two: capacity = the largest demand absorbed times
    PAIR_HEADROOM, or `units * seed_per_unit` before any demand, rounded up
    to a whole chunk."""

    def __init__(self, seed_per_unit: float):
        self.seed_per_unit = seed_per_unit
        self.demand = 0  # the largest demand seen

    def capacity(self, units: int, chunk: int) -> int:
        want = (self.demand * PAIR_HEADROOM if self.demand
                else units * self.seed_per_unit)
        return binning.fit_capacity(math.ceil(want), chunk)

    def absorb(self, demand: int):
        self.demand = max(self.demand, int(demand))


@dataclass
class RendererConfig:
    width: int = 1920
    height: int = 1080
    # 64x32 raster tiles, chunk 256: the JAX package's defaults
    tile_w: int = 64
    tile_h: int = 32
    chunk: int = 256
    max_draws: int = 16384
    # stream budget in lanes: draws past it are truncated (front-most kept)
    max_stream: int = 1 << 22
    # exact ellipse-tile pair cull (ops/binning.py _cull_pair_tiles)
    cull_exact: bool = True
    # proxy-depth occlusion cull (ops/binning.py occ_zimg): drops pairs
    # that fail the compositor's depth test at every pixel of their tile.
    # Off by default, as in the JAX package.
    depth_cull: bool = False
    # temporal saturation cull: the compositor records, per band of a
    # tile, the STREAM SLOT beyond which nothing contributed this frame
    # because the band was already opaque (ops/raster.py emit_zcut), and
    # the NEXT frame's binning drops the splats behind that cut, dilated by
    # sat_dilate cells for camera-motion margin. Slot-keyed, so the
    # certificate renews itself: the cull never removes anything before the
    # recorded slot, and each frame's record is sound for its own content;
    # a stale cut under-composites for at most one frame. The culled pairs
    # composite behind a transmittance < MIN_T = 0.5/255. Fast profile only
    # (forced off in the exact profile). Off by default, as in the JAX
    # package: it pays only on scenes whose tiles really saturate.
    sat_cull: bool = False
    sat_dilate: int = 1
    # exact=True follows the WGSL/oracle math (parity-tested against the
    # per-pixel oracle at <= 1e-3); the default fast profile quantizes the
    # pair table and the compositor's weights, takes the analytic height-map
    # gradient and halves the proxy resolution: deviations of ~1-2/255,
    # under the reference's own 8-bit ROP quantization (PARITY.md #8)
    exact: bool = False
    # the proxy raster bins triangles on its OWN tile grid (it returns a
    # full-image depth buffer, re-tiled to the splat grid)
    proxy_tile_w: int = 64
    proxy_tile_h: int = 32
    # proxy pass resolution divisor: 0 = auto (1, the reference's
    # resolution, in the exact profile, 2 in the fast profile); div > 1
    # renders the proxy at 1/div resolution and upsamples (depth/hit
    # nearest, colour bilinear)
    proxy_res_div: int = 0


_STATE_KEYS = ("store_packed", "panels", "seg_block", "seg_count",
               "np_panel_blocks", "hm4", "height_map_wh", "hm_src",
               "sat_zimg",
               "skybox_tex", "skybox_equirect", "proxy_tex", "proxy_mip_meta",
               "proxy_wh", "proxy_pyr", "proxy_pyr_meta", "proxy_verts",
               "proxy_tris")


def build_resident_state(engine) -> dict:
    """The renderer's resident scene data as numpy: the packed splat store
    [10, n] and the materialized presort panels [16, Np] with their
    per-(kind, lod, tile, view) segment bookkeeping."""
    store = engine.tile_splats_merged
    if store.pos is None:
        store.generate_arrays()
    n = store.splat_count
    rgba_u32 = (
        store.rgba[:, 0].astype(np.uint32)
        | (store.rgba[:, 1].astype(np.uint32) << 8)
        | (store.rgba[:, 2].astype(np.uint32) << 16)
        | (store.rgba[:, 3].astype(np.uint32) << 24)
    )
    packed_store = np.empty((10, n), np.float32)
    packed_store[0:3] = store.pos.T
    packed_store[3:9] = store.cov.T
    packed_store[9] = rgba_u32.view(np.float32)

    if n >= 1 << GS_BITS:
        raise ValueError("splat store exceeds the 26-bit index budget")
    # Materialized presort panels: for every (lod, tile, view) the REVERSED
    # blended presort table (kind 0) and the reversed filtered own-lod
    # table (kind 1; a non-changing draw discards the blended lower-lod
    # entries in the shader anyway — valid_lod_id, gswt.wgsl:39-42), each
    # segment 256-aligned. A draw's stream segment is then a PREFIX of its
    # panel segment, so per-sort stream assembly is a pure panel gather.
    blk = STREAM_BLOCK
    n_lod, n_tile, n_view = engine.n_tiles
    seg_block = np.zeros((2, n_lod, n_tile, n_view), np.int64)
    seg_count = np.zeros((2, n_lod, n_tile, n_view), np.int64)
    segs = []  # (base, lod, idx_fwd, lod_fwd)
    base = 0
    for l in range(n_lod):
        for t in range(n_tile):
            for v in range(n_view):
                bd = engine.tile_base_data[l][t][v]
                own = bd.gs_lod_id == l
                for kind, (gi, gl) in enumerate(
                    (
                        (bd.gs_index, bd.gs_lod_id),
                        (bd.gs_index[own], None),
                    )
                ):
                    seg_block[kind, l, t, v] = base // blk
                    seg_count[kind, l, t, v] = len(gi)
                    segs.append((base, l, gi, gl))
                    base += -(-max(len(gi), 1) // blk) * blk
    panels = np.zeros((PANEL_ROWS, base), np.float32)
    for base_i, l, gi, gl in segs:
        m = len(gi)
        if m == 0:
            continue
        rev = gi[::-1].astype(np.int64)
        revlod = (
            gl[::-1].astype(np.int64)
            if gl is not None
            else np.full(m, l, np.int64)
        )
        panels[0:10, base_i : base_i + m] = packed_store[:, rev]
        panels[10, base_i : base_i + m] = (
            (rev | (revlod << GS_BITS)).astype(np.int32).view(np.float32)
        )
        # row 11 (map id) stays 0: only merged lanes carry map ids
    return dict(store_packed=packed_store, panels=panels,
                seg_block=seg_block, seg_count=seg_count,
                np_panel_blocks=base // blk)


def state_from_numpy(arrays: dict, device) -> dict:
    """The torch Renderer's resident state from numpy arrays (for example
    the JAX Renderer's store_packed, panels, seg_block, seg_count,
    np_panel_blocks, hm4, height_map_wh, hm_src, its skybox and proxy state,
    and its carried saturation-slot image _sat_zimg as sat_zimg):
    device arrays become tensors on `device`, host bookkeeping stays numpy
    or plain Python. The mip atlas (float32 holding bit-cast u32) is moved
    as raw int32 words; the pyramid planes (integers 0..255 in any float
    type) go through float32 to bfloat16, which is exact. Apply it with
    Renderer.set_state."""
    dev = resolve_device(device)
    unknown = set(arrays) - set(_STATE_KEYS)
    if unknown:
        raise KeyError(f"unknown renderer state {sorted(unknown)}")
    out = {}
    for k, a in arrays.items():
        if k in ("store_packed", "panels", "hm4", "hm_src", "sat_zimg",
                 "skybox_tex", "proxy_verts"):
            out[k] = torch.tensor(np.asarray(a, np.float32), device=dev)
        elif k in ("seg_block", "seg_count"):
            out[k] = np.asarray(a, np.int64)
        elif k == "np_panel_blocks":
            out[k] = int(a)
        elif k == "skybox_equirect":
            out[k] = bool(a)
        elif k == "proxy_tex":
            out[k] = atlas_words(np.asarray(a)).to(dev)
        elif k == "proxy_pyr":  # [3, Hp, Wp], laid out for dev's sampler
            out[k] = sampler_pyramid(torch.tensor(
                np.asarray(a).astype(np.float32), device=dev
            ).to(torch.bfloat16))
        elif k == "proxy_tris":
            out[k] = torch.tensor(np.asarray(a, np.int32), device=dev)
        elif k == "proxy_mip_meta":
            out[k] = tuple(tuple(int(x) for x in lv) for lv in a)
        elif k == "proxy_pyr_meta":
            meta, l_min = a
            out[k] = (tuple(tuple(int(x) for x in lv) for lv in meta),
                      int(l_min))
        else:  # height_map_wh, proxy_wh
            out[k] = (int(a[0]), int(a[1]))
    return out


def upload_parts(parts, device):
    """numpy arrays of one dtype as tensors on `device`. On the card they
    go up in one non-blocking copy from a pinned buffer allocated for it,
    carved into views (each 256-B aligned) on the device: the caching host
    allocator records the copy's event and hands the buffer out again only
    once the copy has completed, so nothing waits or keeps the buffer. On
    the CPU they are the arrays themselves (torch.from_numpy)."""
    if device.type != "cuda":
        return [torch.from_numpy(a) for a in parts]
    step = _UPLOAD_ALIGN // parts[0].itemsize
    offs, n = [], 0
    for a in parts:
        offs.append(n)
        n += -(-a.size // step) * step
    host = torch.empty(n, dtype=torch.from_numpy(parts[0]).dtype,
                       pin_memory=True)
    hn = host.numpy()
    for a, o in zip(parts, offs):
        hn[o:o + a.size] = a.reshape(-1)
    dev = host.to(device, non_blocking=True)
    return [dev[o:o + a.size].view(a.shape) for a, o in zip(parts, offs)]


class Renderer:
    """Holds the device-resident scene data and renders frames."""

    UNIFORMS_LEN = project.UNIFORMS_LEN

    def __init__(self, engine, config: RendererConfig | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.engine = engine
        self.cfg = config or RendererConfig()
        # full-f32 products: the projection math breaks the 1e-3 parity
        # budget under TF32 (the JAX package pins precision "highest")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.set_state(state_from_numpy(build_resident_state(engine),
                                        self.device))
        self.height_map_wh = (1, 1)
        self.hm4 = torch.zeros((4, 1), dtype=torch.float32, device=self.device)
        self.hm_src = None
        # the previous sat-eligible frame's dilated saturation-slot image
        # [nty * SAT_BANDS, ntx] and its view-projection (sat_cull)
        self.sat_zimg = None
        self.sat_vp = None
        self.skybox_tex = None
        self.skybox_equirect = True
        self.proxy_tex = None
        self.proxy_mip_meta = ((1, 1, 0),)
        # the exact profile's mip level table on the device (mip_table)
        self.proxy_mip_tab = mip_table(self.proxy_mip_meta, self.device)
        self.proxy_wh = (1, 1)
        # the packed pyramid in its device's sampler layout (sampler_pyramid)
        self.proxy_pyr = None
        self.proxy_pyr_meta = None
        self.proxy_verts = torch.zeros((2, 4), dtype=torch.float32,
                                       device=self.device)
        self.proxy_tris = torch.zeros((3, 2), dtype=torch.int32,
                                      device=self.device)
        # last_aux: the counts of the last frame completed (host ints and
        # bools, AUX_KEYS); overflow_frames: pipelined frames that overflowed
        # a budget (rendered short, the budget grown for later frames);
        # last_overflow_retries: depth-0 re-renders of the last frame
        self.last_aux = None
        self.overflow_frames = 0
        self.last_overflow_retries = 0
        self.pair_budget = PairBudget(SEED_PAIRS_PER_LANE)
        self.proxy_budget = PairBudget(SEED_PAIRS_PER_TRIANGLE)
        # the splat pairs of one stream segment (parallel/batched.py
        # render_segment): a segment holds a share of the frame's demand,
        # so it grows from the segments' demands, not the frame's
        self.segment_budget = PairBudget(SEED_PAIRS_PER_LANE)
        self.last_stream_truncated = 0
        self._plan_host = None
        self._plan_dev = None
        # frames in flight, oldest first: post_aux's pending records
        self._inflight = []

    def set_state(self, state: dict):
        """Install resident state (see state_from_numpy)."""
        for k, v in state.items():
            if k not in _STATE_KEYS:
                raise KeyError(f"unknown renderer state {k!r}")
            setattr(self, k, v)
        if "proxy_mip_meta" in state:
            self.proxy_mip_tab = mip_table(self.proxy_mip_meta, self.device)

    # ------------------------------------------------------------------ #
    def configure(self, user_data):
        """Bind the height map after engine.configure (renderer.rs:351-405)
        and build the proxy tile-map grid mesh (proxy.rs:215-258)."""
        if user_data.height_map is not None and len(user_data.height_map):
            w, h = user_data.height_map_wh
            self.height_map_wh = (int(w), int(h))
            self.hm4 = torch.as_tensor(
                pack_tex4(user_data.height_map, int(w), int(h))
            ).to(self.device)
            # small source map: the fast profile samples the bicubic
            # surface of the pre-resize source directly
            # (ops/project.py _smallmap_resized_bilinear)
            self.hm_src = None
            src = user_data.height_map_src
            if not self.cfg.exact and src is not None:
                sw, sh = user_data.height_map_src_wh
                if sw * sh <= 4096:
                    self.hm_src = torch.as_tensor(
                        np.asarray(src, np.float32).reshape(sh, sw)
                    ).to(self.device)
        else:
            self.height_map_wh = (1, 1)
            self.hm4 = torch.zeros((4, 1), dtype=torch.float32,
                                   device=self.device)
            self.hm_src = None
        gv, gt = make_map_grid(
            user_data.tile_map_wh, user_data.tile_map_half_wh,
            user_data.tile_width,
        )
        self.proxy_verts = torch.as_tensor(gv).to(self.device)
        self.proxy_tris = torch.as_tensor(gt).to(self.device)

    def set_skybox(self, tex, equirect=True, bake=False, bake_resolution=2048):
        """Upload a skybox: equirect HDRI [H,W,3] or cube faces [6,R,R,3].
        bake=True runs the reference's 6-pass HDRI->cubemap bake
        (skybox.rs:341-455) so runtime sampling goes through the cubemap
        path; the default samples the equirect directly (identical output
        up to the cubemap's own resample, PARITY.md #5)."""
        if tex is None:
            self.skybox_tex = None
            return
        tex = torch.as_tensor(np.asarray(tex, np.float32)).to(self.device)
        if equirect and bake:
            self.skybox_tex = bake_hdri_to_cubemap(tex, bake_resolution)
            self.skybox_equirect = False
            return
        self.skybox_tex = tex
        self.skybox_equirect = equirect

    def set_proxy(self, tex):
        """Upload the proxy ground texture. tex: [H,W,3] (the Lanczos mip
        chain is built here, proxy.rs:513-554) or a prebuilt list of mip
        levels. Keeps both the mip atlas (the exact profile's sampler) and
        the packed pyramid (the fast profile's, ops/texsample.py
        factored_mip_trilinear)."""
        if tex is None:
            self.proxy_tex = None
            return
        mips = tex if isinstance(tex, (list, tuple)) else build_mip_chain(
            np.asarray(tex, np.float32)
        )
        atlas, meta = pack_mip_atlas(mips)
        self.proxy_tex = atlas_words(atlas).to(self.device)
        self.proxy_mip_meta = meta
        self.proxy_mip_tab = mip_table(meta, self.device)
        self.proxy_wh = (meta[0][0], meta[0][1])
        pyr, pyr_meta, l_min = pack_pyramid(mips)
        self.proxy_pyr = sampler_pyramid(
            torch.as_tensor(pyr).to(self.device).to(torch.bfloat16))
        self.proxy_pyr_meta = (pyr_meta, l_min)

    # ------------------------------------------------------------------ #
    @staticmethod
    def host_cull(dt: DrawTable, n: int, view_proj: np.ndarray,
                  culling_dist: float) -> np.ndarray:
        """Per-draw viewport culling on the host (renderer.rs:471-494) with
        the stage-time camera. Used with a margin over the render-time
        culling distance so the exact per-frame device cull never disagrees.
        Returns keep mask [n]."""
        corners = dt.corner_pos[:n]  # [n,4,3]
        hom = np.concatenate(
            [corners, np.ones_like(corners[..., :1])], axis=-1
        )
        p = hom @ view_proj.T
        with np.errstate(divide="ignore", invalid="ignore"):
            pd = p[..., :3] / p[..., 3:4]
        px = np.min(np.abs(pd[..., 0]), axis=1)
        py = np.min(np.abs(pd[..., 1]), axis=1)
        pz = np.max(pd[..., 2], axis=1)
        culled = (pz < -culling_dist) | (px > culling_dist) | (py > culling_dist)
        culled &= (dt.single_draw[:n] == 0) & (dt.has_corners[:n] == 1)
        return ~culled

    def plan_blocks_host(self, dt: DrawTable, view_proj=None,
                         culling_dist: float = 1.0):
        """Build the per-sort block plan (renderer.rs:466-591's draw loop,
        recast as panel bookkeeping): walk draws front-to-back (reversed)
        and emit, per 256-lane block, the source panel id + per-draw uniform
        bits. Merged streams get a reversed copy into the aligned merged
        scratch. With view_proj given, host-culled draws are dropped (with a
        margin; the device cull stays exact).

        Returns (blocks [5, NB] i32, merged [2, M] i32, total, n,
        truncated_splats)."""
        c = self.cfg
        blk = STREAM_BLOCK
        n = min(dt.n_draws, c.max_draws)
        if n == 0:
            return (
                np.zeros((5, 0), np.int32),
                np.zeros((2, blk), np.int32), 0, 0, 0,
            )
        is_merged = dt.stream_start[:n] >= 0
        changing = dt.changing[:n] == 1
        bl = np.clip(dt.base_lod[:n], 0, self.seg_count.shape[1] - 1)
        bt = np.clip(dt.base_tile[:n], 0, self.seg_count.shape[2] - 1)
        bv = np.clip(dt.base_view[:n], 0, self.seg_count.shape[3] - 1)
        # non-merged, non-changing draws use the filtered (own-lod) panels
        kind = np.where(changing, 0, 1)
        seg_cnt = self.seg_count[kind, bl, bt, bv]
        seg_base = self.seg_block[kind, bl, bt, bv]
        counts = np.where(
            is_merged,
            dt.splat_count[:n].astype(np.int64),
            np.minimum(dt.splat_count[:n].astype(np.int64), seg_cnt),
        )
        if view_proj is not None:
            keep = self.host_cull(dt, n, view_proj, culling_dist * 1.25)
            counts = np.where(keep, counts, 0)

        # front-to-back walk = reversed draw order
        order = np.arange(n - 1, -1, -1)
        cnt_r = counts[order]
        nb_r = -(-cnt_r // blk)
        # truncate draws overflowing the stream block budget; a truncated
        # draw keeps its FRONT-most lanes. Surfaced via truncated_splats.
        max_blocks = c.max_stream // blk
        cum_b = np.cumsum(nb_r)
        requested = int(cnt_r.sum())
        over = int(np.searchsorted(cum_b, max_blocks, side="right"))
        if over < n:
            prev = int(cum_b[over - 1]) if over > 0 else 0
            cnt_r = cnt_r.copy()
            cnt_r[over] = min(cnt_r[over], (max_blocks - prev) * blk)
            cnt_r[over + 1 :] = 0
            nb_r = -(-cnt_r // blk)
        total = int(cnt_r.sum())
        truncated = requested - total
        counts_final = np.zeros(n, np.int64)
        counts_final[order] = cnt_r

        # merged scratch: reversed lane copies, segment-aligned
        m_rows = order[is_merged[order] & (cnt_r > 0)]
        m_nb = -(-counts_final[m_rows] // blk)
        m_base = np.zeros(len(m_rows), np.int64)
        if len(m_rows):
            m_base[1:] = np.cumsum(m_nb)[:-1]
        m_total_blocks = int(m_nb.sum()) if len(m_rows) else 0
        merged = np.zeros((2, max(m_total_blocks, 1) * blk), np.int32)
        merged_base_of = np.zeros(n, np.int64)
        for r, mb in zip(m_rows, m_base):
            cnt = int(counts_final[r])
            # on truncation keep the FRONT-most lanes (stream is reversed,
            # so the front of a segment is the END of the forward slice)
            s1 = int(dt.stream_start[r]) + int(dt.splat_count[r])
            sl = slice(s1 - cnt, s1)
            merged[0, mb * blk : mb * blk + cnt] = (
                dt.stream_gs_index[sl].astype(np.int64)
                | (dt.stream_lod_id[sl].astype(np.int64) << GS_BITS)
            ).astype(np.int32)[::-1]
            merged[1, mb * blk : mb * blk + cnt] = (
                dt.stream_map_id[sl].astype(np.int32)[::-1]
            )
            merged_base_of[r] = mb

        # per-draw uniform bits (device applies culling via keep_draw)
        b1, b2 = project.pack_draw_bits(
            dt.single_draw[:n].astype(np.int64),
            dt.changing[:n].astype(np.int64),
            dt.changing_to_lower[:n].astype(np.int64),
            dt.tile_lod[:n].astype(np.int64),
            dt.valid_lod_id[:n].astype(np.int64),
            dt.view_id[:n].astype(np.int64),
            dt.tile_id[:n].astype(np.int64),
            dt.map_index[:n].astype(np.int64),
            dt.single_lod_id[:n].astype(np.int64),
        )
        src_of = np.where(
            is_merged, self.np_panel_blocks + merged_base_of, seg_base
        )

        # expand per-draw -> per-block
        live = nb_r > 0
        d_live = order[live]
        nb_live = nb_r[live]
        cnt_live = cnt_r[live]
        nb_total = int(nb_live.sum())
        draw_of_block = np.repeat(d_live, nb_live)
        k_within = np.arange(nb_total, dtype=np.int64) - np.repeat(
            np.cumsum(nb_live) - nb_live, nb_live
        )
        blocks = np.empty((5, nb_total), np.int32)
        blocks[0] = src_of[draw_of_block] + k_within
        blocks[1] = b1[draw_of_block]
        blocks[2] = b2[draw_of_block]
        blocks[3] = np.minimum(
            np.repeat(cnt_live, nb_live) - k_within * blk, blk
        )
        blocks[4] = draw_of_block
        return blocks, merged, total, n, truncated

    @staticmethod
    def prepare_draws(dt: DrawTable, n: int):
        """The per-draw arrays the device still needs (render-time culling),
        n draws (at least one row, so an empty frame keeps its shapes)."""
        d = max(n, 1)

        def pad_i(a):
            out = np.zeros(d, np.int32)
            out[:n] = a[:n]
            return out

        corner = np.zeros((d, 4, 3), np.float32)
        corner[:n] = dt.corner_pos[:n]
        return dict(
            n_draws=n,
            single_draw=pad_i(dt.single_draw),
            tile_lod=pad_i(dt.tile_lod),
            has_corners=pad_i(dt.has_corners),
            corner_pos=corner,
        )

    # ------------------------------------------------------------------ #
    @staticmethod
    def pack_frame_uniforms(scene: SceneParams, cam: CameraUniforms,
                            lod_enable, culling_dist: float,
                            render_gs: bool = True) -> np.ndarray:
        """One frame's uniform block [UNIFORMS_LEN] f32 (host), laid out as
        ops/project.py UNIFORMS says."""
        le = [1.0 if b else 0.0 for b in lod_enable][:16]
        return project.pack_uniform_block(dict(
            view=cam.view, proj_wgpu=OPENGL_TO_WGPU @ cam.projection,
            view_proj=cam.projection @ cam.view, focal=cam.focal,
            htan_fov=cam.htan_fov, cam_pos=cam.cam_pos,
            **{f.name: getattr(scene, f.name) for f in project.UNIFORMS
               if f.group == "scene"},
            lod_enable=le + [0.0] * (16 - len(le)),
            culling_dist=culling_dist, gs_enable=1.0 if render_gs else 0.0))

    # (scene_dict, cam_dict, lod_enable, culling_dist, gs_enable) of a
    # uniforms tensor, on its device (ops/project.py unpack_uniform_block)
    unpack_frame_uniforms = staticmethod(project.unpack_uniform_block)

    # ------------------------------------------------------------------ #
    def stage(self, dt: DrawTable, camera: Camera | None = None,
              culling_dist: float = 1.0):
        """Per-SORT staging of the block plan and draw arrays (host numpy).
        The result is reused across frames until the next sort. With a
        camera, host-culls draws (coarse, margined)."""
        vp = camera.view_proj() if camera is not None else None
        return self.stage_vp(dt, vp, culling_dist)

    def stage_vp(self, dt: DrawTable, vp=None, culling_dist: float = 1.0):
        """stage() taking a raw view-projection matrix (builder-thread use).
        Returns numpy only: the render thread uploads it (upload_plan)."""
        with _hprof("stage.plan"):
            blocks, merged, _, n, truncated = self.plan_blocks_host(
                dt, vp, culling_dist
            )
        # splats the last staged plan dropped past max_stream (the viewer's
        # /hud shows it)
        self.last_stream_truncated = truncated
        if truncated:
            print(
                f"[gswt] warning: stream budget exceeded, dropped {truncated} "
                f"far splats (max_stream={self.cfg.max_stream})",
                file=sys.stderr,
            )
        with _hprof("stage.prep"):
            draw = self.prepare_draws(dt, n)
        return dict(blocks=blocks, merged=merged, draw=draw)

    def upload_plan(self, staged):
        """The staged plan on the device (upload_parts); uploaded once per
        staged plan."""
        if staged is self._plan_host:
            return self._plan_dev
        d = staged["draw"]
        parts = [np.ascontiguousarray(a, np.int32) for a in (
            staged["blocks"], staged["merged"], d["single_draw"],
            d["tile_lod"], d["has_corners"])]
        parts.append(np.ascontiguousarray(d["corner_pos"], np.float32)
                     .view(np.int32))
        with _hprof("render.plan", self.device):
            arrs = upload_parts(parts, self.device)
        blocks, merged, single_draw, tile_lod, has_corners, corner = arrs
        self._plan_dev = dict(
            blocks=blocks, merged=merged,
            draw=dict(n_draws=d["n_draws"], single_draw=single_draw,
                      tile_lod=tile_lod, has_corners=has_corners,
                      corner_pos=corner.view(torch.float32)),
        )
        self._plan_host = staged
        return self._plan_dev

    # ------------------------------------------------------------------ #
    def pack_uniforms(self, camera: Camera, scene: SceneParams,
                      rc: RenderConfig, render_gs: bool = True):
        """One frame's packed uniforms [UNIFORMS_LEN] f32 on the device
        (upload_parts)."""
        lod_enable = list(rc.lod_enable or [True] * 16)
        v = self.pack_frame_uniforms(
            scene, CameraUniforms(camera), lod_enable, rc.culling_dist,
            render_gs=render_gs)
        return upload_parts([v], self.device)[0]

    def frame_uniforms(self, camera: Camera, scene: SceneParams,
                       rc: RenderConfig, render_gs: bool = True):
        """One frame's uniforms on the device, unpacked (see
        unpack_frame_uniforms)."""
        return self.unpack_frame_uniforms(
            self.pack_uniforms(camera, scene, rc, render_gs))

    def project(self, plan, camera: Camera, scene: SceneParams,
                rc: RenderConfig, render_gs: bool = True):
        """Draw cull + stream assembly + projection of one frame from an
        uploaded plan (ops/project.py assemble_and_project outputs)."""
        uniforms = self.pack_uniforms(camera, scene, rc, render_gs)
        return self._project(plan, uniforms,
                             self.unpack_frame_uniforms(uniforms), scene, rc)

    def _project(self, plan, uniforms, unpacked, scene: SceneParams,
                 rc: RenderConfig):
        """project() from the frame's packed uniforms and their unpacked
        form: the draw cull reads the unpacked values, the kernel the
        block."""
        c = self.cfg
        _, cam_d, lod_en, culling_dist, _ = unpacked
        keep = project.cull_draws(plan["draw"], cam_d, culling_dist, lod_en)
        return project.assemble_and_project(
            plan["blocks"], plan["merged"], self.panels, keep,
            self.store_packed, uniforms, self.hm4, self.height_map_wh,
            surface_type=int(scene.surface_type), draw_mode=int(rc.draw_mode),
            image_wh=(c.width, c.height),
            point_cloud=bool(rc.draw_point_cloud), exact=c.exact,
            hm_src=self.hm_src,
        )

    def proxy_pass(self, cam_d, scene_d, scene: SceneParams, rc: RenderConfig):
        """The proxy ground pass at the configured resolution divisor.
        Returns (color [H,W,4], depth [H,W], hit [H,W], aux). The exact
        profile samples the texture through the mip atlas; the fast profile
        through the packed pyramid (the mip-pyramid sampler kernel)."""
        c = self.cfg
        div = int(c.proxy_res_div)
        if div <= 0:  # auto: the reference's resolution in the exact profile
            div = 1 if c.exact else 2
        p_wh = (-(-c.width // div), -(-c.height // div))
        prox = dict(atlas=self.proxy_tex, verts=self.proxy_verts,
                    tris=self.proxy_tris, mip_tab=self.proxy_mip_tab)
        mip_pyr = None
        if not c.exact and self.proxy_pyr is not None:
            prox["pyr"] = self.proxy_pyr
            mip_pyr = self.proxy_pyr_meta
        capacity = self.proxy_budget.capacity(self.proxy_tris.shape[1],
                                              PROXY_CHUNK)
        pcol, depth, hit, paux = render_proxy(
            cam_d, scene_d, p_wh, self.hm4, self.height_map_wh, prox,
            self.proxy_wh, surface_type=int(scene.surface_type),
            height_offset=float(rc.proxy_height),
            brightness=float(rc.proxy_brightness),
            black_background=bool(rc.proxy_black_background),
            use_clip=bool(rc.use_clip), clip_height=float(rc.clip_height),
            mip_meta=self.proxy_mip_meta, mip_pyr=mip_pyr,
            tile_wh=(c.proxy_tile_w, c.proxy_tile_h), chunk=PROXY_CHUNK,
            proxy_pairs=capacity,
        )
        paux["proxy_capacity"] = capacity
        if div > 1:
            # depth/hit upsample NEAREST (bilinear would blend across
            # silhouettes and fabricate halo depths); colour bilinear for
            # smooth shading
            def up_near(x):
                x = x.repeat_interleave(div, 0).repeat_interleave(div, 1)
                return x[: c.height, : c.width]

            depth = up_near(depth)
            hit = up_near(hit)
            pcol = torch.nn.functional.interpolate(
                pcol.permute(2, 0, 1)[None], scale_factor=div,
                mode="bilinear", align_corners=False,
            )[0].permute(1, 2, 0)[: c.height, : c.width]
        return pcol, depth, hit, paux

    def front(self, plan, camera: Camera, scene: SceneParams,
              rc: RenderConfig, render_gs: bool = True,
              use_skybox: bool = False, use_proxy: bool = False,
              sat_zimg=None, emit_block_demand: bool = False):
        """Projection, background + proxy depth, binning of one frame from
        an uploaded plan. Returns (binned, bg [H,W,4], depth_tiles [T,P],
        aux): the binned pair table (ops/binning.py bin_pairs), what the
        compositor's output lies over and is depth-tested against. The
        background and depth come BEFORE binning: the proxy depth feeds the
        occlusion cull. sat_zimg ([nty * SAT_BANDS, ntx] or None): the
        previous frame's dilated saturation-slot image (binning's sat_simg).
        emit_block_demand moves binning's per-block pair demand into
        aux["block_demand"]."""
        with _hprof("render.uniforms", self.device):
            uniforms = self.pack_uniforms(camera, scene, rc, render_gs)
        return self.front_packed(
            plan, uniforms, scene, rc, use_skybox=use_skybox,
            use_proxy=use_proxy, sat_zimg=sat_zimg,
            emit_block_demand=emit_block_demand)

    def front_packed(self, plan, uniforms, scene: SceneParams,
                     rc: RenderConfig, *, use_skybox: bool = False,
                     use_proxy: bool = False, sat_zimg=None,
                     emit_block_demand: bool = False):
        """front() from packed uniforms ([UNIFORMS_LEN] f32 on the device,
        pack_uniforms or a row of parallel/batched.py pack_camera_batch)."""
        with _hprof("render.front.project", self.device):
            unpacked = self.unpack_frame_uniforms(uniforms)
            p = self._project(plan, uniforms, unpacked, scene, rc)
        bg, depth_tiles, aux = self.background(
            unpacked, scene, rc, use_skybox=use_skybox, use_proxy=use_proxy)
        with _hprof("render.front.bin", self.device):
            binned, bin_aux = self.bin_pairs(
                p, depth_tiles, use_proxy=use_proxy, sat_zimg=sat_zimg,
                emit_block_demand=emit_block_demand)
        aux.update(bin_aux)
        return binned, bg, depth_tiles, aux

    def background(self, unpacked, scene: SceneParams, rc: RenderConfig, *,
                   use_skybox: bool, use_proxy: bool):
        """The skybox and the proxy ground of one frame from its unpacked
        uniforms. Returns (bg [H,W,4], depth_tiles [T,P], aux): the
        background the compositor's output lies over and the depth it is
        tested against (1.0 without the proxy); aux holds proxy_pairs (the
        grid raster's pair demand) and proxy_overflow (beyond the proxy
        budget), 0-d tensors, and proxy_capacity (the host int the raster
        was launched with), when the proxy was drawn."""
        c = self.cfg
        image_wh = (c.width, c.height)
        scene_d, cam_d = unpacked[0], unpacked[1]
        aux = {}
        with _hprof("render.front.background", self.device):
            if use_skybox:
                with _hprof("render.front.skybox", self.device):
                    bg = render_skybox(cam_d, image_wh, self.skybox_tex,
                                       equirect=self.skybox_equirect)
            else:
                bg = torch.zeros((c.height, c.width, 4), dtype=torch.float32,
                                 device=self.device)
            if use_proxy:
                with _hprof("render.front.proxy", self.device):
                    pcol, depth, hit, paux = self.proxy_pass(
                        cam_d, scene_d, scene, rc)
                    bg = torch.where(hit[..., None], pcol, bg)
                aux.update(paux)
            else:
                depth = torch.ones((c.height, c.width), dtype=torch.float32,
                                   device=self.device)
            depth_tiles = raster.image_to_depth_tiles(
                depth, image_wh=image_wh, tile_wh=(c.tile_w, c.tile_h))
        return bg, depth_tiles, aux

    def bin_pairs(self, p, depth_tiles, *, use_proxy: bool, sat_zimg=None,
                  emit_block_demand: bool = False, budget=None):
        """Binning of a projected stream (ops/binning.py bin_pairs) with the
        configured culls, into the capacity of `budget` (the splat pair
        budget when None) for the stream's lanes. Returns (binned, aux): aux
        holds n_pairs, overflow, n_pairs_kept, n_live and max_run (0-d
        tensors), pair_capacity (the host int the expansion was launched
        with), and block_demand with emit_block_demand."""
        c = self.cfg
        image_wh = (c.width, c.height)
        tile_wh = (c.tile_w, c.tile_h)
        occ_zimg = None
        if use_proxy and c.depth_cull:
            ntx, nty, _ = binning.grid_dims(image_wh, tile_wh)
            occ_zimg = depth_tiles.amax(dim=1).reshape(nty, ntx)
        capacity = (budget or self.pair_budget).capacity(p["cx"].shape[0],
                                                         c.chunk)
        binned = binning.bin_pairs(
            p, image_wh=image_wh, tile_wh=tile_wh, chunk=c.chunk,
            exact=c.exact, cull_exact=c.cull_exact, occ_zimg=occ_zimg,
            sat_simg=sat_zimg, emit_block_demand=emit_block_demand,
            capacity=capacity,
        )
        aux = {k: binned[k] for k in ("n_pairs", "overflow", "n_pairs_kept",
                                      "n_live", "max_run")}
        aux["pair_capacity"] = capacity
        if emit_block_demand:
            aux["block_demand"] = binned.pop("block_demand")
        return binned, aux

    def back(self, binned, bg, depth_tiles, *, use_proxy: bool,
             emit_zcut: bool = False):
        """Compositor (depth-tested against the proxy when there is one) +
        premultiplied over-composite onto the background. [H, W, 4]; with
        emit_zcut also the next frame's dilated saturation-slot image
        [nty * SAT_BANDS, ntx], band-row-major."""
        c = self.cfg
        image_wh = (c.width, c.height)
        tile_wh = (c.tile_w, c.tile_h)
        tiles = raster.rasterize(
            binned, depth_tiles, image_wh=image_wh, tile_wh=tile_wh,
            chunk=c.chunk, use_depth=bool(use_proxy), exact=c.exact,
            emit_zcut=emit_zcut,
        )
        if emit_zcut:
            tiles, zcut = tiles
        img = raster.tiles_to_image(tiles, image_wh=image_wh, tile_wh=tile_wh)
        # premultiplied-over: final = gs + T * background
        out = img + (1.0 - img[..., 3:4]) * bg
        if not emit_zcut:
            return out
        ntx, nty, _ = binning.grid_dims(image_wh, tile_wh)
        # [T, B] -> band-major rows [nty * B, ntx]: row = tile_row * B + band
        # (ops/binning.py's global band-row indexing)
        zimg = zcut.reshape(nty, ntx, SAT_BANDS).permute(0, 2, 1)
        zimg = zimg.reshape(nty * SAT_BANDS, ntx)
        # camera-motion margin: a deeper neighbouring cut wins (keeps more)
        # within sat_dilate band rows and tile columns, off-grid cells
        # counting 0.0. Small on purpose: the max takes SAT_NOCUT from any
        # unsaturated neighbour, so a large radius poisons whole saturated
        # regions; a stale cut mispredicts for at most one frame.
        for _ in range(max(int(c.sat_dilate), 0)):
            for dim in (1, 0):
                pad = (1, 1, 0, 0) if dim == 1 else (0, 0, 1, 1)
                z = torch.nn.functional.pad(zimg, pad, value=0.0)
                n = zimg.shape[dim]
                zimg = torch.maximum(zimg, torch.maximum(
                    z.narrow(dim, 2, n), z.narrow(dim, 0, n)))
        return out, zimg

    def _sat_motion_exceeds(self, camera, prev_vp, vp_now) -> bool:
        """True when the camera moved or rotated enough since the previous
        sat-eligible frame that screen positions can shift past the
        saturation cut's dilation margin (sat_dilate tile columns
        horizontally, sat_dilate band rows vertically: the only slack the
        cut image's dilation provides, see back()).

        Probe: a 3x3 NDC ray grid through the CURRENT camera sampled at
        three scene depths, projected with both view-projection matrices;
        max pixel delta against the margin. Host-side NumPy, ~30 points a
        frame. Conservative failure modes count as exceeded (a probe behind
        either camera, a singular matrix)."""
        if np.array_equal(prev_vp, vp_now):
            return False
        c = self.cfg
        dil = max(int(c.sat_dilate), 0)
        margin_x = dil * c.tile_w
        margin_y = dil * max(c.tile_h // SAT_BANDS, 1)
        try:
            inv = np.linalg.inv(vp_now.astype(np.float64))
        except np.linalg.LinAlgError:
            return True
        g = np.array([-0.85, 0.0, 0.85], np.float64)
        xs, ys = np.meshgrid(g, g)
        ndc = np.stack([xs.ravel(), ys.ravel()], axis=1)  # [9, 2]

        def unproj(zc):
            h = np.concatenate(
                [ndc, np.full((9, 1), zc), np.ones((9, 1))], axis=1)
            w = h @ inv.T
            return w[:, :3] / w[:, 3:4]

        # two GL-clip depths span the frustum; sample world points at fixed
        # distances along the rays so near content (which moves fastest in
        # screen space) is represented
        near = unproj(-0.8)
        d = unproj(0.8) - near
        d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
        pos = np.asarray(camera.position, np.float64)
        pts = np.concatenate([pos + d * s for s in (2.0, 10.0, 50.0)], axis=0)
        pts_h = np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=1)

        def to_px(m):
            h = pts_h @ m.astype(np.float64).T
            w = h[:, 3]
            ok = w > 1e-6
            x = (h[:, 0] / np.where(ok, w, 1.0) * 0.5 + 0.5) * c.width
            y = (h[:, 1] / np.where(ok, w, 1.0) * 0.5 + 0.5) * c.height
            return x, y, ok

        x0, y0, ok0 = to_px(prev_vp)
        x1, y1, ok1 = to_px(vp_now)
        if not np.all(ok0 & ok1):  # a probe crossed a camera plane
            return True
        return bool(np.max(np.abs(x1 - x0)) > margin_x
                    or np.max(np.abs(y1 - y0)) > margin_y)

    def _sat_cut_in(self, camera: Camera, rc: RenderConfig, render_gs: bool):
        """The saturation cull's part in this frame: None when the frame
        does not take part, else the cut image binning tests against (all
        SAT_NOCUT until a record exists).

        Fast-profile colour frames only: debug draw modes and point clouds
        change what "contributes" means, and the exact profile is the
        parity reference. The banded record and binning's band lookup
        assume uniform band rows (tile_h % SAT_BANDS == 0); other tile
        heights disable the cull. Motion gate: the recorded cut is sound
        only within the dilation margin, and beyond it a stale cut would
        mispredict EVERY frame under sustained motion, so a moving frame
        drops the cut and renders without any of the cull; the first
        static-enough frame re-certifies from its own run."""
        c = self.cfg
        if not (c.sat_cull and not c.exact and render_gs
                and not rc.draw_point_cloud and int(rc.draw_mode) == 0
                and c.tile_h % SAT_BANDS == 0):
            return None
        vp_now = np.asarray(camera.view_proj(), np.float32).reshape(4, 4)
        prev_vp, self.sat_vp = self.sat_vp, vp_now
        if prev_vp is not None and self._sat_motion_exceeds(
                camera, prev_vp, vp_now):
            self.sat_zimg = None
            return None
        ntx, nty, _ = binning.grid_dims((c.width, c.height),
                                        (c.tile_w, c.tile_h))
        shape = (nty * SAT_BANDS, ntx)
        if self.sat_zimg is not None and tuple(self.sat_zimg.shape) == shape:
            return self.sat_zimg
        with _hprof("render.sat_cut", self.device):
            return torch.full(shape, SAT_NOCUT, dtype=torch.float32,
                              device=self.device)

    # ------------------------------------------------------------------ #
    def post_aux(self, aux):
        """Start a frame's counts on their way to the host, after its last
        launch: the AUX_KEYS it has as one int64 vector, copied into a
        pinned buffer with a non-blocking copy, an event behind it (the
        frame's end). Returns the pending record for fetch_aux: (keys, the
        vector, the event or None, and while the host-section profiler is
        on (frame id, pair capacity, proxy capacity) as launched, else
        None)."""
        keys = [k for k in AUX_KEYS if k in aux]
        launched = ((hostprof.current_frame(), aux.get("pair_capacity"),
                     aux.get("proxy_capacity")) if hostprof._PROF_ON else None)
        if not keys:
            return keys, torch.zeros(0, dtype=torch.int64), None, launched
        with _hprof("render.aux", self.device):
            vec = torch.stack([aux[k].reshape(()).to(torch.int64)
                               for k in keys])
            if not vec.is_cuda:
                return keys, vec, None, launched
            host = torch.empty(len(keys), dtype=torch.int64, pin_memory=True)
            host.copy_(vec, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(vec.device))
        return keys, host, done, launched

    def fetch_aux(self, pending, section: str | None = "sync.aux") -> dict:
        """The counts of a pending record (post_aux) once its event has
        completed (a wait, timed as `section` when one is named): host
        ints, and bools for the overflow flags. A frame launched while the
        host-section profiler was on has them filed under its id with the
        capacities it was launched with (hostprof.count_frame)."""
        keys, host, done, launched = pending
        with _hprof(section) if section else contextlib.nullcontext():
            if done is not None:
                done.synchronize()
            vals = host.tolist()
        aux = {k: bool(v) if k.endswith("overflow") else int(v)
               for k, v in zip(keys, vals)}
        if launched is not None:
            frame, capacity, proxy_capacity = launched
            hostprof.count_frame(frame, capacity=capacity,
                                 proxy_capacity=proxy_capacity, **aux)
        return aux

    def absorb(self, aux: dict, budget=None) -> bool:
        """Grow the pair budgets from a frame's fetched counts (n_pairs into
        `budget`, the splat pair budget when None); True when the frame
        overflowed one of them (it was rendered short)."""
        if "n_pairs" in aux:
            (budget or self.pair_budget).absorb(aux["n_pairs"])
        if "proxy_pairs" in aux:
            self.proxy_budget.absorb(aux["proxy_pairs"])
        return bool(aux.get("overflow") or aux.get("proxy_overflow"))

    def exactly(self, attempt, budget=None):
        """attempt() -> (result, aux) launched until its counts show no
        overflow: the depth-0 policy, for render and for callers that drive
        front(), background() and bin_pairs() themselves
        (parallel/batched.py; `budget`: the splat pair budget their
        bin_pairs was given). Each try's counts are read at its end (after
        the frames in flight, complete by then); an overflow grows the
        budgets from the true demand and launches again
        (last_overflow_retries), which then fits."""
        for _ in range(3):
            out, aux = attempt()
            pending = self.post_aux(aux)
            if self._inflight:
                self.drain()
            self.last_aux = self.fetch_aux(pending)
            if not self.absorb(self.last_aux, budget):
                return out
            self.last_overflow_retries += 1
        raise RuntimeError(f"the pair budgets overflowed three times: "
                           f"{self.last_aux}")

    def _drain_one(self):
        """Complete the oldest frame in flight: its counts become last_aux,
        and an overflow grows the budgets for later frames (too late to
        render this one again) and counts in overflow_frames."""
        aux = self.fetch_aux(self._inflight.pop(0), None)
        self.last_aux = aux
        if self.absorb(aux):
            self.overflow_frames += 1

    def drain(self):
        """Complete every frame in flight, then wait for whatever else was
        launched on the device (a frame rendered without readback returns
        before it is done)."""
        with _hprof("render.drain"):
            while self._inflight:
                self._drain_one()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def render(self, dt: DrawTable, camera: Camera, scene: SceneParams,
               render_config: RenderConfig | None = None, *,
               render_gs: bool = True, use_skybox: bool = False,
               use_proxy: bool = False, as_numpy: bool = True,
               staged=None, pipeline_depth: int = 0):
        """Render one frame; returns [H, W, 4] float32 (numpy, or a device
        tensor with as_numpy=False). The skybox and the proxy are drawn only
        when asked for AND their texture is set. With sat_cull the frame
        also leaves its saturation-slot image in sat_zimg for the next.

        pipeline_depth > 0 (with as_numpy=False) keeps up to that many
        frames in flight and only blocks on the OLDEST one: the frame is
        queued with its counts' pending copy and returns, and the frames
        beyond the depth are completed (drain) — per-frame last_aux lands
        pipeline_depth frames late, and a pair-budget overflow grows the
        budget for later frames instead of rendering this one again
        (`overflow_frames` counts those). At depth 0 the frame reads its
        counts at its end (last_aux: n_pairs, n_pairs_kept, n_live,
        max_run, overflow, and proxy_pairs and proxy_overflow when the
        proxy was drawn) and an overflowed frame is rendered again with the grown
        budgets (`last_overflow_retries`), so every frame read back is
        exact. Either way no wait for the device falls between the frame's
        first and last launch."""
        use_skybox = bool(use_skybox and self.skybox_tex is not None)
        use_proxy = bool(use_proxy and self.proxy_tex is not None)
        rc = render_config or RenderConfig.new(self.engine.n_tiles[0])
        if staged is None:
            staged = self.stage(dt, camera, rc.culling_dist)
        self.last_overflow_retries = 0
        sat_zin = self._sat_cut_in(camera, rc, render_gs)
        plan = self.upload_plan(staged)

        def attempt():
            binned, bg, depth_tiles, aux = self.front(
                plan, camera, scene, rc, render_gs=render_gs,
                use_skybox=use_skybox, use_proxy=use_proxy, sat_zimg=sat_zin)
            with _hprof("render.back", self.device):
                img = self.back(binned, bg, depth_tiles, use_proxy=use_proxy,
                                emit_zcut=sat_zin is not None)
            if sat_zin is not None:
                img, self.sat_zimg = img
            return img, aux

        if pipeline_depth > 0 and not as_numpy:
            img, aux = attempt()
            self._inflight.append(self.post_aux(aux))
            with _hprof("render.drain"):
                while len(self._inflight) > pipeline_depth:
                    self._drain_one()
            return img
        img = self.exactly(attempt)
        if not as_numpy:
            return img
        with _hprof("sync.readback"):
            return img.cpu().numpy()
