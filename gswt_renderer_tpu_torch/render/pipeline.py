"""The per-frame pipeline on torch tensors.

One frame:

  cull draws -> assemble + project the splat stream (panel block-gather
  kernel + vs_main math, vectorized) -> tile binning (exact pair expansion
  + one stable sort by image tile) -> compositor kernel -> premultiplied
  over-composite onto the background.

Host/device split (mirrors the reference's preloaded vs streaming buffers,
renderer.rs:270-327): the splat store, the materialized presort panels and
the height map live on the device across frames; the *splat stream* is
described by a per-SORT block plan built on the host (a few hundred KB of
panel ids + per-draw bits, `stage_vp`) and assembled on the device. The plan
stays numpy until the render thread uploads it, so the builder thread never
touches a CUDA stream.

Every domain is sized exactly from the frame's own counts; the image equals
what the JAX package renders once its buckets have converged. The stages
run under profiler ranges gswt.project, gswt.bin and gswt.raster, which
chip_smoke.py's profile phase reads.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from ..core.camera import Camera, CameraUniforms
from ..core.config import RenderConfig
from ..core.mathutil import OPENGL_TO_WGPU
from ..ops import binning, project, raster
from ..ops.kernels import resolve_device
from ..ops.project import GS_BITS, pack_tex4
from ..tiles.structures import DrawTable
from .uniforms import SceneParams

STREAM_BLOCK = 256  # stream panel width (ops/blockgather.py BLOCK)
PANEL_ROWS = 16     # pos xyz, cov 6, rgba u32, packed gs|lod, map id, 4 pad

_NEXT_SLICE = "the skybox/proxy slice of the port"


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
    # the proxy-depth and saturation culls of the JAX package; both off
    # there by default and not ported yet
    depth_cull: bool = False
    sat_cull: bool = False
    # the exact profile; the fast profile (PARITY.md #8) is not ported yet
    exact: bool = True


_STATE_KEYS = ("store_packed", "panels", "seg_block", "seg_count",
               "np_panel_blocks", "hm4", "height_map_wh")


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
    np_panel_blocks, hm4 and height_map_wh): device arrays become float32
    tensors on `device`, host bookkeeping stays numpy. Apply it with
    Renderer.set_state."""
    dev = resolve_device(device)
    unknown = set(arrays) - set(_STATE_KEYS)
    if unknown:
        raise KeyError(f"unknown renderer state {sorted(unknown)}")
    out = {}
    for k, a in arrays.items():
        if k in ("store_packed", "panels", "hm4"):
            out[k] = torch.tensor(np.asarray(a, np.float32), device=dev)
        elif k in ("seg_block", "seg_count"):
            out[k] = np.asarray(a, np.int64)
        elif k == "np_panel_blocks":
            out[k] = int(a)
        else:
            out[k] = (int(a[0]), int(a[1]))
    return out


class Renderer:
    """Holds the device-resident scene data and renders frames."""

    UNIFORMS_LEN = 112

    def __init__(self, engine, config: RendererConfig | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.engine = engine
        self.cfg = config or RendererConfig()
        if not self.cfg.exact:
            raise NotImplementedError("the fast profile is not ported yet")
        if self.cfg.depth_cull:
            raise NotImplementedError(f"depth_cull comes with {_NEXT_SLICE}")
        if self.cfg.sat_cull:
            raise NotImplementedError(
                "sat_cull belongs to the fast profile, not ported yet")
        # full-f32 products: the projection math breaks the 1e-3 parity
        # budget under TF32 (the JAX package pins precision "highest")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.set_state(state_from_numpy(build_resident_state(engine),
                                        self.device))
        self.height_map_wh = (1, 1)
        self.hm4 = torch.zeros((4, 1), dtype=torch.float32, device=self.device)
        self.last_aux = None
        self._plan_host = None
        self._plan_dev = None

    def set_state(self, state: dict):
        """Install resident state (see state_from_numpy)."""
        for k, v in state.items():
            if k not in _STATE_KEYS:
                raise KeyError(f"unknown renderer state {k!r}")
            setattr(self, k, v)

    # ------------------------------------------------------------------ #
    def configure(self, user_data):
        """Bind the height map after engine.configure (renderer.rs:351-405).
        The proxy grid comes with the proxy slice."""
        if user_data.height_map is not None and len(user_data.height_map):
            w, h = user_data.height_map_wh
            self.height_map_wh = (int(w), int(h))
            self.hm4 = torch.as_tensor(
                pack_tex4(user_data.height_map, int(w), int(h))
            ).to(self.device)
        else:
            self.height_map_wh = (1, 1)
            self.hm4 = torch.zeros((4, 1), dtype=torch.float32,
                                   device=self.device)

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
        v = np.zeros(Renderer.UNIFORMS_LEN, np.float32)
        v[0:16] = cam.view.reshape(-1)
        v[16:32] = (OPENGL_TO_WGPU @ cam.projection).reshape(-1)
        v[32:48] = (cam.projection @ cam.view).reshape(-1)
        v[48:50] = cam.focal
        v[50:52] = cam.htan_fov
        v[52:55] = cam.cam_pos
        v[55] = scene.splat_scale
        v[56] = scene.tile_width
        v[57] = scene.use_clip
        v[58] = scene.clip_height
        v[59] = scene.sphere_radius
        v[60] = scene.point_cloud_radius
        v[61] = scene.transition_width_ratio
        v[62] = scene.num_lod
        v[63:65] = scene.map_half_wh
        v[65:67] = scene.center_coord
        v[67:83] = scene.transition_dist_vec
        v[83:86] = scene.height_map_scale
        v[86:89] = scene.scene_scale
        le = [1.0 if b else 0.0 for b in lod_enable][:16]
        v[89 : 89 + len(le)] = le
        v[105] = culling_dist
        v[106] = 1.0 if render_gs else 0.0
        return v

    @staticmethod
    def unpack_frame_uniforms(v):
        """Unpack a uniforms tensor into (scene_dict, cam_dict, lod_enable,
        culling_dist, gs_enable), 0-d and small tensors on v's device."""
        i32 = torch.int32
        cam = dict(
            view=v[0:16].reshape(4, 4),
            proj_wgpu=v[16:32].reshape(4, 4),
            view_proj=v[32:48].reshape(4, 4),
            focal=v[48:50],
            htan_fov=v[50:52],
            cam_pos=v[52:55],
        )
        scene = dict(
            splat_scale=v[55],
            tile_width=v[56],
            use_clip=v[57].to(i32),
            clip_height=v[58],
            sphere_radius=v[59],
            point_cloud_radius=v[60],
            transition_width_ratio=v[61],
            num_lod=v[62].to(i32),
            map_half_wh=v[63:65].to(i32),
            center_coord=v[65:67].to(i32),
            transition_dist_vec=v[67:83],
            height_map_scale=v[83:86],
            scene_scale=v[86:89],
        )
        lod_enable = v[89:105].to(i32)
        culling_dist = v[105]
        gs_enable = v[106].to(i32)
        return scene, cam, lod_enable, culling_dist, gs_enable

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
        blocks, merged, _, n, truncated = self.plan_blocks_host(
            dt, vp, culling_dist
        )
        if truncated:
            print(
                f"[gswt] warning: stream budget exceeded, dropped {truncated} "
                f"far splats (max_stream={self.cfg.max_stream})",
                file=sys.stderr,
            )
        return dict(blocks=blocks, merged=merged,
                    draw=self.prepare_draws(dt, n))

    def upload_plan(self, staged):
        """The staged plan on the device; uploaded once per staged plan."""
        if staged is not self._plan_host:
            dev = self.device

            def up(a):
                return torch.as_tensor(a).to(dev)

            d = staged["draw"]
            self._plan_dev = dict(
                blocks=up(staged["blocks"]),
                merged=up(staged["merged"]),
                draw=dict(
                    n_draws=d["n_draws"],
                    single_draw=up(d["single_draw"]),
                    tile_lod=up(d["tile_lod"]),
                    has_corners=up(d["has_corners"]),
                    corner_pos=up(d["corner_pos"]),
                ),
            )
            self._plan_host = staged
        return self._plan_dev

    # ------------------------------------------------------------------ #
    def project(self, plan, camera: Camera, scene: SceneParams,
                rc: RenderConfig, render_gs: bool = True):
        """Draw cull + stream assembly + projection of one frame from an
        uploaded plan (ops/project.py assemble_and_project outputs)."""
        c = self.cfg
        lod_enable = list(rc.lod_enable or [True] * 16)
        uniforms = torch.as_tensor(
            self.pack_frame_uniforms(
                scene, CameraUniforms(camera), lod_enable, rc.culling_dist,
                render_gs=render_gs,
            )
        ).to(self.device)
        scene_d, cam_d, lod_en, culling_dist, gs_enable = (
            self.unpack_frame_uniforms(uniforms)
        )
        keep = project.cull_draws(plan["draw"], cam_d, culling_dist, lod_en)
        return project.assemble_and_project(
            plan["blocks"], plan["merged"], self.panels, keep,
            self.store_packed, scene_d, cam_d, self.hm4, self.height_map_wh,
            surface_type=int(scene.surface_type), draw_mode=int(rc.draw_mode),
            image_wh=(c.width, c.height),
            point_cloud=bool(rc.draw_point_cloud), gs_enable=gs_enable,
        )

    def front(self, plan, camera: Camera, scene: SceneParams,
              rc: RenderConfig, render_gs: bool = True):
        """Projection + binning of one frame from an uploaded plan.
        Returns the binned pair table (ops/binning.py bin_pairs)."""
        c = self.cfg
        with record_function("gswt.project"):
            p = self.project(plan, camera, scene, rc, render_gs=render_gs)
        with record_function("gswt.bin"):
            return binning.bin_pairs(
                p, image_wh=(c.width, c.height), tile_wh=(c.tile_w, c.tile_h),
                chunk=c.chunk, cull_exact=c.cull_exact,
            )

    def back(self, binned):
        """Compositor + premultiplied over-composite onto the gs-only
        background (zeros; depth ones, so no depth test). [H, W, 4]."""
        c = self.cfg
        image_wh = (c.width, c.height)
        tile_wh = (c.tile_w, c.tile_h)
        bg = torch.zeros((c.height, c.width, 4), dtype=torch.float32,
                         device=self.device)
        depth = torch.ones((c.height, c.width), dtype=torch.float32,
                           device=self.device)
        depth_tiles = raster.image_to_depth_tiles(
            depth, image_wh=image_wh, tile_wh=tile_wh)
        with record_function("gswt.raster"):
            tiles = raster.rasterize(
                binned, depth_tiles, image_wh=image_wh, tile_wh=tile_wh,
                chunk=c.chunk, use_depth=False,
            )
        img = raster.tiles_to_image(tiles, image_wh=image_wh, tile_wh=tile_wh)
        # premultiplied-over: final = gs + T * background
        return img + (1.0 - img[..., 3:4]) * bg

    def render(self, dt: DrawTable, camera: Camera, scene: SceneParams,
               render_config: RenderConfig | None = None, *,
               render_gs: bool = True, use_skybox: bool = False,
               use_proxy: bool = False, as_numpy: bool = True,
               staged=None):
        """Render one gs-only frame; returns [H, W, 4] float32 (numpy, or
        a device tensor with as_numpy=False). last_aux holds the frame's
        counts: n_pairs (int) and n_pairs_kept, n_live (0-d tensors)."""
        if use_skybox or use_proxy:
            raise NotImplementedError(
                f"skybox and proxy passes come with {_NEXT_SLICE}")
        rc = render_config or RenderConfig.new(self.engine.n_tiles[0])
        if staged is None:
            staged = self.stage(dt, camera, rc.culling_dist)
        binned = self.front(self.upload_plan(staged), camera, scene, rc,
                            render_gs=render_gs)
        img = self.back(binned)
        self.last_aux = dict(n_pairs=binned["n_pairs"],
                             n_pairs_kept=binned["n_pairs_kept"],
                             n_live=binned["n_live"])
        return img.cpu().numpy() if as_numpy else img
