"""The Wang-tile engine: procedural tiling, presorting, LOD, merging, ordering.

A re-implementation of wangtile.rs with the scrolling tile map kept as
struct-of-arrays (NumPy) so per-rebuild work is vectorized; the per-splat
hot paths (depth keys, counting sorts, k-way merges) go through the C++ host
runtime (native/). This code runs on the builder thread (engine/worker.py)
exactly as the reference runs its worker thread, while all per-splat render
work happens on the TPU.

RNG contract: the reference spawns tiles with StdRng::seed_from_u64(0) and
draw-order-dependent sampling (wangtile.rs:1746-1752). Both modes are
supported via UserData.rng_mode (PARITY.md #1, closed in round 3):
"stdrng" selects the bit-level rand-0.9 StdRng emulation in core/stdrng.py
(SplitMix64 seed expansion + ChaCha12 + Canon's-method random_range),
golden-pinned in tests/test_stdrng.py; the default "numpy" uses numpy's
default_rng(0) with the same draw order (edge-color draws as needed +
1 center draw per spawned tile) — same spawn distribution, faster host path.

Sphere-seam note: the reference copies corner frames from already-spawned
neighbors (wangtile.rs:1623-1652) so tiles across the 5x2 sphere block seams
share exact corner values; the vectorized rebuild here computes each tile's
corners from its own block mapping, which matches exactly on flat/height-map
surfaces and differs only at sphere block seams.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..core.config import (
    HeightMapType,
    SelectiveMergeType,
    SurfaceType,
    TileSortType,
    UserData,
)
from ..core.mathutil import look_at_rh, normalize, perspective, vp_z_row
from .structures import (
    DrawTable,
    LruCache,
    MergeStatus,
    RenderDataKey,
    RenderDataValue,
    SceneData,
    TileBaseData,
    TransitionStatus,
    transition_hash,
)
from . import surface as surf

NUM_P = 2  # edge colors per edge -> 2^4 = 16 combos (wangtile.rs:1673)
MAP_RESO = 1024  # internal random height-map resolution (wangtile.rs:377)

# The 9 canonical presort directions (wangtile.rs:146-156)
PRESORT_DIRS = np.array(
    [
        [1.0, 0.0, 0.0],
        [-1.0, 0.0, 0.0],
        [0.0, 1.0, 0.0],
        [0.0, -1.0, 0.0],
        [1.0, 0.0, -1.0],
        [-1.0, 0.0, -1.0],
        [0.0, 1.0, -1.0],
        [0.0, -1.0, -1.0],
        [0.0, 0.0, -1.0],
    ],
    dtype=np.float32,
)
PRESORT_DIRS /= np.linalg.norm(PRESORT_DIRS, axis=1, keepdims=True)


class WangTileEngine:
    def __init__(self, scene_vec, log=None):
        self.log = log or (lambda *a: None)
        self.user_data = UserData()
        self.tile_splats_vec = scene_vec
        self.n_tiles = (len(scene_vec), len(scene_vec[0]), 0)
        self.initialized = False

        self.center_coord = np.zeros(2, np.int64)
        self.camera_pos = np.zeros(3, np.float32)

        self.presort_dirs = PRESORT_DIRS
        self.rng = np.random.default_rng(0)  # replaced on configure

        self.tile_splats_merged = None
        self.splats_merge_offset = None  # u32 [n_lod, n_tile]
        self.lod_avg_scale = []
        self.tile_base_data = []  # [lod][tile][view] TileBaseData
        self.base_counts = None  # i32 [n_lod, n_tile]: blended splat counts
        self.tile_centers0 = None  # f32 [n_tile, 3] (lod0 avg / n_lod)
        self.aabb_corners = None  # f32 [n_tile, 8, 3]
        self.sort_lru_cache = LruCache(1)

        # --- scrolling map state (struct-of-arrays) ---
        self.occupied = None          # bool [W,H]
        self.tile_id = None           # i32 [W,H]
        self.lod_id = None            # i32 [W,H]
        self.tile_center = None       # f32 [W,H,3] (surface-mapped)
        self.to_local = None          # f32 [W,H,3,3]
        self.merge_status = None      # i8 [W,H]
        self.merge_to = None          # i32 [W,H]
        self.merge_groups = {}        # host map_index -> list of member indices
        self.trans_status = None      # i8 [W,H]
        self.trans_to_lower = None    # bool [W,H]
        self.trans_blend = None       # f32 [W,H]
        self.corner_pos = None        # f32 [W,H,4,3]
        self.corner_to_world = None   # f32 [W,H,4,3,3]
        self.edge_pos = None          # f32 [W,H,4,3]
        self.edge_normal = None       # f32 [W,H,4,3]
        self.neighbor_coord = None    # i64 [W,H,4,2] (-1 = none)
        self.neighbor_edge = None     # i64 [W,H,4]

        self._preprocess()

    # ------------------------------------------------------------------ #
    # preprocess (wangtile.rs:71-254)
    # ------------------------------------------------------------------ #
    def _preprocess(self):
        n_lod, n_tile, _ = self.n_tiles

        aabb_vec = []
        center_vec = []
        for tile_id in range(n_tile):
            scene0 = self.tile_splats_vec[0][tile_id]
            (aabb_lo, aabb_hi), avg_center = scene0.compute_aabb_and_center()
            # Height normalization (wangtile.rs:84-90)
            for lod_id in range(n_lod):
                self.tile_splats_vec[lod_id][tile_id].translate(
                    [0.0, 0.0, -avg_center[2]]
                )
            aabb_lo = aabb_lo.copy()
            aabb_hi = aabb_hi.copy()
            aabb_lo[2] -= avg_center[2]
            aabb_hi[2] -= avg_center[2]
            avg_center = avg_center.copy()
            avg_center[2] = 0.0
            # NOTE: replicates the reference exactly (wangtile.rs:106-107):
            # the accumulator adds only the lod-0 center but divides by n_lod.
            center_vec.append((avg_center / np.float32(n_lod)).astype(np.float32))
            aabb_vec.append((aabb_lo, aabb_hi))

        self.tile_centers0 = np.stack(center_vec)
        lo = np.stack([a[0] for a in aabb_vec])
        hi = np.stack([a[1] for a in aabb_vec])
        sel = np.array(
            [  # 8 aabb corners (wangtile.rs:1519-1529 ordering)
                [0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
                [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1],
            ]
        )
        both = np.stack([lo, hi], axis=1)  # [T,2,3]
        self.aabb_corners = np.stack(
            [both[:, sel[c], [0, 1, 2]] for c in range(8)], axis=1
        ).astype(np.float32)  # [T,8,3]

        # Merge all (lod, tile) scenes into one store (wangtile.rs:113-125)
        from ..io.ply import Scene

        merged = Scene()
        offsets = np.zeros((n_lod, n_tile), np.uint32)
        for lod_id in range(n_lod):
            for tile_id in range(n_tile):
                offsets[lod_id, tile_id] = merged.splat_count
                merged.merge(self.tile_splats_vec[lod_id][tile_id])
        merged.generate_arrays()
        self.tile_splats_merged = merged
        self.splats_merge_offset = offsets

        # Per-lod average scale, strictly ascending (wangtile.rs:127-142)
        self.lod_avg_scale = []
        for lod_id in range(n_lod):
            ssum = sum(
                self.tile_splats_vec[lod_id][t].compute_scale_sum()
                for t in range(n_tile)
            )
            snum = sum(
                self.tile_splats_vec[lod_id][t].splat_count * 3 for t in range(n_tile)
            )
            avg = ssum / snum
            if lod_id > 0:
                assert avg > self.lod_avg_scale[-1], (
                    f"lod {lod_id} avg scale {avg} not > {self.lod_avg_scale[-1]}"
                )
            self.lod_avg_scale.append(avg)

        # Presort views (wangtile.rs:144-174)
        sort_projection = perspective(np.deg2rad(90.0), 1.0, 0.1, 10.0)
        vp_z_rows = []
        for d in self.presort_dirs:
            up = (
                np.array([0.0, 0.0, 1.0])
                if (d[0] != 0.0 or d[1] != 0.0)
                else np.array([0.0, 1.0, 0.0])
            )
            view = look_at_rh([0.0, 0.0, 0.0], d, up)
            vp_z_rows.append(vp_z_row(sort_projection @ view))
        n_view = len(vp_z_rows)
        self.n_tiles = (n_lod, n_tile, n_view)

        # Raw depths + blended presorted orders (wangtile.rs:177-254)
        self.tile_base_data = []
        for i in range(n_lod):
            tile_vec = []
            for j in range(n_tile):
                fbuf = self.tile_splats_vec[i][j]._f32_view()
                view_vec = [
                    TileBaseData(
                        splat_count=0,
                        tile_center=center_vec[j],
                        aabb=aabb_vec[j],
                        raw_depth=native.depth_keys(fbuf, vp_z_rows[k]),
                    )
                    for k in range(n_view)
                ]
                tile_vec.append(view_vec)
            self.tile_base_data.append(tile_vec)

        self.base_counts = np.zeros((n_lod, n_tile), np.int64)
        for i in range(n_lod):
            for j in range(n_tile):
                for k in range(n_view):
                    depths = [self.tile_base_data[i][j][k].raw_depth]
                    lod_ids = [np.uint32(i)]
                    merge_off = [offsets[i, j]]
                    if i < n_lod - 1:
                        depths.append(self.tile_base_data[i + 1][j][k].raw_depth)
                        lod_ids.append(np.uint32(i + 1))
                        merge_off.append(offsets[i + 1, j])
                    concat = np.concatenate(depths)
                    displ = np.zeros(len(depths) + 1, np.int64)
                    displ[1:] = np.cumsum([len(d) for d in depths])
                    seg_id, idx = native.counting_sort_merge(concat, displ)
                    off = np.asarray(merge_off, np.uint32)
                    lid = np.asarray(lod_ids, np.uint32)
                    bd = self.tile_base_data[i][j][k]
                    bd.gs_index = (idx + off[seg_id]).astype(np.uint32)
                    bd.gs_lod_id = lid[seg_id]
                    bd.splat_count = len(idx)
                self.base_counts[i, j] = self.tile_base_data[i][j][0].splat_count

    # ------------------------------------------------------------------ #
    # map topology (wangtile.rs:257-338)
    # ------------------------------------------------------------------ #
    def _compute_map_neighbors(self):
        w, h = self.user_data.tile_map_wh
        coord = np.full((w, h, 4, 2), -1, np.int64)
        edge = np.zeros((w, h, 4), np.int64)
        ii, jj = np.meshgrid(np.arange(w), np.arange(h), indexing="ij")
        if self.user_data.surface_type == SurfaceType.SPHERE:
            block_w = w // 5
            bidx = 5 * ii // w
            bidy = 2 * jj // h
            bx = ii - bidx * block_w
            by = jj - bidy * block_w
            # West (wangtile.rs:269-283)
            inner = bx > 0
            coord[..., 0, 0] = np.where(inner, ii - 1,
                np.where(bidy == 0, (w + ii - 1) % w, (w + ii - by - 1) % w))
            coord[..., 0, 1] = np.where(inner, jj,
                np.where(bidy == 0, jj + block_w, h - 1))
            edge[..., 0] = np.where(inner, 2, np.where(bidy == 0, 2, 1))
            # East (wangtile.rs:285-295)
            inner = bx < block_w - 1
            coord[..., 2, 0] = np.where(inner, ii + 1,
                np.where(bidy == 0, (ii + block_w - by) % w, (ii + 1) % w))
            coord[..., 2, 1] = np.where(inner, jj,
                np.where(bidy == 0, 0, jj - block_w))
            edge[..., 2] = np.where(inner, 0, np.where(bidy == 0, 3, 0))
            # South (wangtile.rs:297-307)
            inner = jj > 0
            coord[..., 3, 0] = np.where(inner, ii, (w + bidx * block_w - 1) % w)
            coord[..., 3, 1] = np.where(inner, jj - 1, block_w - 1 - bx)
            edge[..., 3] = np.where(inner, 1, 2)
            # North (wangtile.rs:309-319)
            inner = jj < h - 1
            coord[..., 1, 0] = np.where(inner, ii, (bidx * block_w + block_w) % w)
            coord[..., 1, 1] = np.where(inner, jj + 1, 2 * block_w - 1 - bx)
            edge[..., 1] = np.where(inner, 3, 0)
        else:
            m = ii > 0
            coord[..., 0, 0] = np.where(m, ii - 1, -1)
            coord[..., 0, 1] = np.where(m, jj, -1)
            edge[..., 0] = 2
            m = ii < w - 1
            coord[..., 2, 0] = np.where(m, ii + 1, -1)
            coord[..., 2, 1] = np.where(m, jj, -1)
            edge[..., 2] = 0
            m = jj > 0
            coord[..., 3, 0] = np.where(m, ii, -1)
            coord[..., 3, 1] = np.where(m, jj - 1, -1)
            edge[..., 3] = 1
            m = jj < h - 1
            coord[..., 1, 0] = np.where(m, ii, -1)
            coord[..., 1, 1] = np.where(m, jj + 1, -1)
            edge[..., 1] = 3
        self.neighbor_coord = coord
        self.neighbor_edge = edge

    def _neighbor(self, mc, idx):
        c = self.neighbor_coord[mc[0], mc[1], idx]
        if c[0] < 0:
            return None
        return c, int(self.neighbor_edge[mc[0], mc[1], idx])

    # ------------------------------------------------------------------ #
    # configure (wangtile.rs:349-432)
    # ------------------------------------------------------------------ #
    @staticmethod
    def _make_rng(ud):
        """Engine RNG (wangtile.rs:55,352-354): numpy by default;
        UserData.rng_mode == "stdrng" selects the bit-exact Rust
        StdRng/ChaCha12 emulation (core/stdrng.py, PARITY #1)."""
        if getattr(ud, "rng_mode", "numpy") == "stdrng":
            from ..core.stdrng import NumpyCompatRng, StdRng

            return NumpyCompatRng(StdRng(0))
        return np.random.default_rng(0)

    def configure(self, user_data: UserData) -> UserData:
        self.initialized = False
        self.user_data = user_data
        ud = self.user_data
        if ud.reset_rng:
            self.rng = self._make_rng(ud)

        if ud.surface_type == SurfaceType.SPHERE:
            ud.tile_map_wh = (ud.tile_map_half_wh[0] * 2, ud.tile_map_half_wh[1] * 2)
            assert ud.tile_map_wh[0] * 2 == ud.tile_map_wh[1] * 5, (
                "sphere map requires 2w == 5h (wangtile.rs:358)"
            )
        else:
            ud.tile_map_wh = (
                ud.tile_map_half_wh[0] * 2 + 1,
                ud.tile_map_half_wh[1] * 2 + 1,
            )

        w, h = ud.tile_map_wh
        assert self.n_tiles[1] // 16 >= ud.center_option, (
            "tile set too small for requested center options (wangtile.rs:366)"
        )
        self._compute_map_neighbors()

        self.occupied = np.zeros((w, h), bool)
        self.tile_id = np.zeros((w, h), np.int32)
        self.lod_id = np.zeros((w, h), np.int32)
        self.tile_center = np.zeros((w, h, 3), np.float32)
        self.to_local = np.zeros((w, h, 3, 3), np.float32)
        self.merge_status = np.zeros((w, h), np.int8)
        self.merge_to = np.full((w, h), -1, np.int32)
        self.merge_groups = {}
        self.trans_status = np.zeros((w, h), np.int8)
        self.trans_to_lower = np.zeros((w, h), bool)
        self.trans_blend = np.ones((w, h), np.float32)
        self.corner_pos = np.zeros((w, h, 4, 3), np.float32)
        self.corner_to_world = np.zeros((w, h, 4, 3, 3), np.float32)
        self.edge_pos = np.zeros((w, h, 4, 3), np.float32)
        self.edge_normal = np.zeros((w, h, 4, 3), np.float32)

        # Height map generation (wangtile.rs:377-413)
        hw, hh = ud.height_map_wh
        if ud.height_map_type == HeightMapType.TEXTURE and ud.height_tex is not None:
            hmap = np.asarray(ud.height_tex[0], np.float32).copy()
            ud.height_map_wh = tuple(ud.height_tex[1])
        elif ud.height_map_type == HeightMapType.RANDOM:
            hmap = self.rng.uniform(-1.0, 1.0, hh * hw).astype(np.float32)
        else:
            jj, ii = np.meshgrid(np.arange(hh), np.arange(hw), indexing="ij")
            if ud.height_map_type == HeightMapType.SLOPE_X:
                hmap = (ii / hh * 2.0 - 1.0).reshape(-1)
            elif ud.height_map_type == HeightMapType.SLOPE_Y:
                hmap = (jj / hh * 2.0 - 1.0).reshape(-1)
            elif ud.height_map_type == HeightMapType.DUAL_SLOPE:
                hmap = (jj / hw + ii / hh - 1.0).reshape(-1)
            else:
                hmap = np.zeros(hh * hw)
            hmap = hmap.astype(np.float32)
        # pre-scale by tile_width * scale_z (wangtile.rs:401-403)
        hmap = hmap * np.float32(ud.tile_width * ud.height_map_scale[2])
        if ud.height_map_type == HeightMapType.RANDOM:
            # keep the pre-resize source: the renderer can sample its
            # bicubic surface directly (ops/project._smallmap_bicubic)
            ud.height_map_src = hmap
            ud.height_map_src_wh = tuple(ud.height_map_wh)
            hmap = surf.map_resize(hmap, ud.height_map_wh, (MAP_RESO, MAP_RESO))
            ud.height_map_wh = (MAP_RESO, MAP_RESO)
        else:
            ud.height_map_src = None
            ud.height_map_src_wh = (0, 0)
        ud.height_map = hmap

        # LOD transition distances (wangtile.rs:416-423)
        s_n = self.lod_avg_scale[-1]
        ud.lod_transition_dist = tuple(
            ud.lod_max_dist * s / s_n for s in self.lod_avg_scale
        )

        self.sort_lru_cache = LruCache(ud.cache_size)
        ud.n_tiles = self.n_tiles
        return ud.clone()

    # ------------------------------------------------------------------ #
    # coordinate transforms (wangtile.rs:1783-1828)
    # ------------------------------------------------------------------ #
    def coord_to_pos(self, c):
        tw = self.user_data.tile_width
        return np.array([c[0] * tw, c[1] * tw, 0.0], np.float32)

    def pos_to_coord(self, p):
        tw = self.user_data.tile_width
        return np.array([np.floor(p[0] / tw), np.floor(p[1] / tw)], np.int64)

    def index_to_map(self, index):
        h = self.user_data.tile_map_wh[1]
        return np.array([index // h, index % h], np.int64)

    def map_to_index(self, mc):
        return int(mc[0]) * self.user_data.tile_map_wh[1] + int(mc[1])

    def map_to_coord(self, mc):
        half = self.user_data.tile_map_half_wh
        return np.array(
            [
                int(mc[0]) + self.center_coord[0] - half[0],
                int(mc[1]) + self.center_coord[1] - half[1],
            ],
            np.int64,
        )

    def coord_to_map(self, coord):
        half = self.user_data.tile_map_half_wh
        return np.array(
            [
                int(coord[0]) - self.center_coord[0] + half[0],
                int(coord[1]) - self.center_coord[1] + half[1],
            ],
            np.int64,
        )

    def all_map_coords(self):
        """[W*H, 2] int array in index order (index = i*h + j)."""
        w, h = self.user_data.tile_map_wh
        ii, jj = np.meshgrid(np.arange(w), np.arange(h), indexing="ij")
        return np.stack([ii.reshape(-1), jj.reshape(-1)], axis=1)

    def all_tile_offsets(self):
        """[W*H, 3] world positions of all tile origins."""
        mcs = self.all_map_coords()
        half = self.user_data.tile_map_half_wh
        coords = mcs + (self.center_coord - np.asarray(half))[None, :]
        tw = self.user_data.tile_width
        out = np.zeros((mcs.shape[0], 3), np.float32)
        out[:, 0] = coords[:, 0] * tw
        out[:, 1] = coords[:, 1] * tw
        return out

    @staticmethod
    def tile_id_to_color(tile_id: int):
        """West, North, East, South edge colors (wangtile.rs:1830-1839)."""
        t = tile_id % 16
        return (t // 8 % 2, t // 4 % 2, t // 2 % 2, t % 2)

    @staticmethod
    def color_to_tile_id(color, center_idx: int) -> int:
        edge_id = color[0] * 8 + color[1] * 4 + color[2] * 2 + color[3]
        return edge_id + 16 * center_idx

    # ------------------------------------------------------------------ #
    # surface mapping dispatch (wangtile.rs:1352-1494)
    # ------------------------------------------------------------------ #
    def surface_mapping_batch(self, map_coords, pos, to_world: bool):
        """Batched; map_coords [N,2] int, pos [N,3] ->
        (new_pos [N,3], transform [N,3,3])."""
        ud = self.user_data
        pos = np.asarray(pos, np.float32).reshape(-1, 3)
        n = pos.shape[0]
        if ud.surface_type == SurfaceType.HEIGHT_MAP:
            return surf.heightmap_surface(ud, pos, to_world)
        if ud.surface_type == SurfaceType.SPHERE:
            origin = self.coord_to_pos(self.map_to_coord((0, 0)))
            mc = np.asarray(map_coords, np.int64).reshape(-1, 2)
            return surf.sphere_surface(ud, mc, pos, origin, to_world)
        eye = np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)).copy()
        return pos.copy(), eye

    def surface_mapping(self, map_coord, pos, to_world: bool):
        mc = np.asarray(map_coord, np.int64).reshape(1, 2)
        p, t = self.surface_mapping_batch(mc, np.asarray(pos, np.float32), to_world)
        return p[0], t[0]

    # ------------------------------------------------------------------ #
    # build_tiles (wangtile.rs:434-474)
    # ------------------------------------------------------------------ #
    def check_update(self, camera_pos) -> bool:
        if not self.initialized:
            return True
        d = np.asarray(camera_pos, np.float32) - self.camera_pos
        return float(d @ d) >= self.user_data.update_distance2

    def build_tiles(self, camera_pos) -> SceneData:
        if not self.initialized:
            self.initialized = True
        self._update_tile_map(np.asarray(camera_pos, np.float32))

        n_lod = self.n_tiles[0]
        sd = SceneData()
        sd.center_coord = (int(self.center_coord[0]), int(self.center_coord[1]))
        counts = self.base_counts[self.lod_id, self.tile_id]  # [W,H]
        sd.splat_count = int(counts.sum())
        sd.lod_splat_count = [
            int(counts[self.lod_id == l].sum()) for l in range(n_lod)
        ]
        sd.lod_instance_count = [int((self.lod_id == l).sum()) for l in range(n_lod)]
        # blending counts (wangtile.rs:453-469)
        blend = counts.astype(np.int64).copy()
        changing_up = (self.trans_status == TransitionStatus.CHANGING) & (
            ~self.trans_to_lower
        )
        higher = np.where(changing_up, self.base_counts[
            np.maximum(self.lod_id - 1, 0), self.tile_id], 0)
        blend += higher
        blend_lower = (self.lod_id < n_lod - 1) & ~changing_up
        lower = np.where(
            blend_lower,
            self.base_counts[np.minimum(self.lod_id + 1, n_lod - 1), self.tile_id],
            0,
        )
        blend += lower
        sd.blending_splat_count = int(blend.sum())
        return sd

    # ------------------------------------------------------------------ #
    # map update (wangtile.rs:1671-1781)
    # ------------------------------------------------------------------ #
    def _update_tile_map(self, camera_pos):
        ud = self.user_data
        w, h = ud.tile_map_wh
        self.camera_pos = camera_pos

        if ud.surface_type != SurfaceType.SPHERE:
            prev_center = self.center_coord.copy()
            self.center_coord = self.pos_to_coord(camera_pos)
            di = int(self.center_coord[0] - prev_center[0])
            dj = int(self.center_coord[1] - prev_center[1])
            if di != 0 or dj != 0 or not self.occupied.any():
                # shift surviving tiles: new[i,j] = old[i+di, j+dj]
                new_occ = np.zeros((w, h), bool)
                new_tid = np.zeros((w, h), np.int32)
                src_i = np.arange(w) + di
                src_j = np.arange(h) + dj
                vi = (src_i >= 0) & (src_i < w)
                vj = (src_j >= 0) & (src_j < h)
                if vi.any() and vj.any():
                    ii = np.ix_(np.where(vi)[0], np.where(vj)[0])
                    ss = np.ix_(src_i[vi], src_j[vj])
                    new_occ[ii] = self.occupied[ss]
                    new_tid[ii] = self.tile_id[ss]
                self.occupied = new_occ
                self.tile_id = np.where(new_occ, new_tid, 0)
        else:
            self.center_coord = np.zeros(2, np.int64)

        # Spawn new tiles (wangtile.rs:1727-1777): sequential because edge
        # colors propagate from already-placed neighbors.
        missing = np.argwhere(~self.occupied)
        for i, j in missing:
            mc = (int(i), int(j))
            color = [0, 0, 0, 0]
            for idx in range(4):
                nb = self._neighbor(mc, idx)
                done = False
                if nb is not None:
                    n_mc, n_idx = nb
                    if self.occupied[n_mc[0], n_mc[1]]:
                        color[idx] = self.tile_id_to_color(
                            int(self.tile_id[n_mc[0], n_mc[1]])
                        )[n_idx]
                        done = True
                if not done:
                    color[idx] = int(self.rng.integers(0, NUM_P))
            center_opt = int(self.rng.integers(0, ud.center_option))
            self.tile_id[i, j] = self.color_to_tile_id(color, center_opt)
            self.occupied[i, j] = True

        # Vectorized per-tile geometry: tile centers + local frames
        mcs = self.all_map_coords()
        offsets = self.all_tile_offsets()
        tids = self.tile_id.reshape(-1)
        centers_flat = self.tile_centers0[tids] + offsets
        mapped, to_local = self.surface_mapping_batch(mcs, centers_flat, False)
        self.tile_center = mapped.reshape(w, h, 3)
        self.to_local = to_local.reshape(w, h, 3, 3)

        # Corner & edge geometry (wangtile.rs:1609-1669), vectorized
        if (
            ud.tile_sort_type == TileSortType.GRAPH
            or ud.merge_type == SelectiveMergeType.EDGE
        ):
            d_coords = np.array([[0, 0], [0, 1], [1, 1], [1, 0]])
            half = np.asarray(ud.tile_map_half_wh)
            if ud.surface_type == SurfaceType.SPHERE:
                # Shared corner lattice (wangtile.rs:1623-1652): the
                # reference copies corner frames from already-spawned
                # neighbors so tiles across the 5x2 block seams hold
                # IDENTICAL corner values even though their own block
                # mappings disagree there. The spawn-order owner is
                # path-dependent; the vectorized rebuild uses a canonical
                # owner instead — the lattice point's lowest (i, j) tile —
                # which gives the same sharing guarantee deterministically
                # (PARITY.md #3).
                li = np.arange(w + 1)
                lj = np.arange(h + 1)
                gi, gj = np.meshgrid(li, lj, indexing="ij")
                own_i = np.minimum(gi, w - 1)
                own_j = np.minimum(gj, h - 1)
                own_mcs = np.stack([own_i, own_j], axis=-1).reshape(-1, 2)
                lat_coords = (
                    np.stack([gi, gj], axis=-1).reshape(-1, 2)
                    + (self.center_coord - half)[None, :]
                )
                lpos = np.zeros((lat_coords.shape[0], 3), np.float32)
                lpos[:, 0] = lat_coords[:, 0] * ud.tile_width
                lpos[:, 1] = lat_coords[:, 1] * ud.tile_width
                own_tid = self.tile_id[own_mcs[:, 0], own_mcs[:, 1]]
                lpos[:, 2] = self.tile_centers0[own_tid][:, 2]
                lp, lw = self.surface_mapping_batch(own_mcs, lpos, True)
                lp = lp.reshape(w + 1, h + 1, 3)
                lw = lw.reshape(w + 1, h + 1, 3, 3)
                ti = mcs[:, 0][:, None] + d_coords[None, :, 0]
                tj = mcs[:, 1][:, None] + d_coords[None, :, 1]
                self.corner_pos = lp[ti, tj].reshape(w, h, 4, 3)
                self.corner_to_world = lw[ti, tj].reshape(w, h, 4, 3, 3)
            else:
                # flat/height-map: the mapping is independent of the owner
                # tile, so per-tile computation is already seam-exact
                corner_mcs = (mcs[:, None, :] + d_coords[None, :, :]).reshape(-1, 2)
                corner_coords = corner_mcs + (self.center_coord - half)[None, :]
                cpos = np.zeros((corner_coords.shape[0], 3), np.float32)
                cpos[:, 0] = corner_coords[:, 0] * ud.tile_width
                cpos[:, 1] = corner_coords[:, 1] * ud.tile_width
                cpos[:, 2] = np.repeat(self.tile_centers0[tids][:, 2], 4)
                own_mcs = np.repeat(mcs, 4, axis=0)
                cp, cw = self.surface_mapping_batch(own_mcs, cpos, True)
                self.corner_pos = cp.reshape(w, h, 4, 3)
                self.corner_to_world = cw.reshape(w, h, 4, 3, 3)
            c1 = self.corner_pos
            c2 = np.roll(self.corner_pos, -1, axis=2)
            t1z = self.corner_to_world[..., :, 2]
            t2z = np.roll(t1z, -1, axis=2)
            self.edge_pos = (c1 + c2) / 2.0
            corner_dir = c2 - c1
            nrm = (t1z + t2z) / 2.0
            en = np.cross(nrm, corner_dir)
            norm = np.linalg.norm(en, axis=-1, keepdims=True)
            self.edge_normal = (en / np.where(norm == 0, 1.0, norm)).astype(np.float32)

        self._update_lod(camera_pos)

    # ------------------------------------------------------------------ #
    # LOD (wangtile.rs:1496-1607), vectorized
    # ------------------------------------------------------------------ #
    def _update_lod(self, cam_pos):
        ud = self.user_data
        w, h = ud.tile_map_wh
        dists = np.asarray(ud.lod_transition_dist, np.float32)
        n_lod = len(dists)

        center_dist = np.linalg.norm(
            self.tile_center.reshape(-1, 3) - cam_pos[None, :], axis=1
        )
        # first lod whose transition distance >= center_dist (wangtile.rs:1509)
        selected = np.searchsorted(dists, center_dist, side="left")
        selected = np.minimum(selected, n_lod - 1).astype(np.int32)

        status = np.zeros(w * h, np.int8)
        to_lower = np.zeros(w * h, bool)
        if ud.lod_blending:
            tids = self.tile_id.reshape(-1)
            offsets = self.all_tile_offsets()
            if ud.lod_bbox_check:
                check = self.aabb_corners[tids] + offsets[:, None, :]  # [N,8,3]
            else:
                check = (self.tile_centers0[tids] + offsets)[:, None, :]
            n_check = check.shape[1]
            mcs = np.repeat(self.all_map_coords(), n_check, axis=0)
            mapped, _ = self.surface_mapping_batch(mcs, check.reshape(-1, 3), True)
            d = np.linalg.norm(mapped - cam_pos[None, :], axis=1).reshape(-1, n_check)
            min_d = d.min(axis=1)
            max_d = d.max(axis=1)
            # blend with higher lod (wangtile.rs:1547-1555)
            prev_td = dists[np.maximum(selected - 1, 0)]
            cond_hi = (selected > 0) & (
                min_d < prev_td * (1.0 + ud.lod_transition_width_ratio)
                + ud.lod_dist_tolerance
            )
            status = np.where(cond_hi, TransitionStatus.CHANGING, status).astype(np.int8)
            # blend with lower lod wins if both (wangtile.rs:1557-1565)
            td = dists[np.minimum(selected, n_lod - 1)]
            cond_lo = (selected < n_lod - 1) & (
                max_d > td * (1.0 - ud.lod_transition_width_ratio)
                - ud.lod_dist_tolerance
            )
            status = np.where(cond_lo, TransitionStatus.CHANGING, status).astype(np.int8)
            to_lower = cond_lo

        self.lod_id = selected.reshape(w, h)
        self.trans_status = status.reshape(w, h)
        self.trans_to_lower = to_lower.reshape(w, h)
        self.trans_blend = np.ones((w, h), np.float32)

        # Border fade (wangtile.rs:1587-1604)
        if ud.lod_blending and ud.surface_type != SurfaceType.SPHERE:
            cp0 = self.coord_to_pos(self.center_coord)
            cam_u = (cam_pos[0] - cp0[0]) / ud.tile_width
            cam_v = (cam_pos[1] - cp0[1]) / ud.tile_width
            bf = np.ones((w, h), np.float32)
            bf[0, :] *= 1.0 - cam_u
            bf[w - 1, :] *= cam_u
            bf[:, 0] *= 1.0 - cam_v
            bf[:, h - 1] *= cam_v
            border = bf != 1.0
            self.trans_status[border] = TransitionStatus.SPAWNING
            self.trans_blend[border] = bf[border]

    # ------------------------------------------------------------------ #
    # presort view choice (wangtile.rs:701-718), batched
    # ------------------------------------------------------------------ #
    def choose_presort_view_batch(self, transforms, positions, cam_pos):
        """transforms [N,3,3], positions [N,3] -> view ids [N]."""
        d = positions - cam_pos[None, :]
        d = d / np.linalg.norm(d, axis=1, keepdims=True)
        dir_local = np.einsum("nij,nj->ni", transforms, d)
        err = np.sum(
            (dir_local[:, None, :] - self.presort_dirs[None, :, :]) ** 2, axis=2
        )
        return np.argmin(err, axis=1).astype(np.int32)

    def choose_presort_view(self, transform, pos, cam_pos) -> int:
        return int(
            self.choose_presort_view_batch(
                transform[None], np.asarray(pos, np.float32)[None],
                np.asarray(cam_pos, np.float32),
            )[0]
        )

    # ------------------------------------------------------------------ #
    # sort_tiles (wangtile.rs:476-690)
    # ------------------------------------------------------------------ #
    def sort_tiles(self, camera_pos, view_proj) -> DrawTable:
        from . import merge as merge_mod
        from . import order as order_mod

        camera_pos = np.asarray(camera_pos, np.float32)
        view_proj = np.asarray(view_proj, np.float32)
        ud = self.user_data
        w, h = ud.tile_map_wh

        if ud.merge_type == SelectiveMergeType.AXIS:
            merge_mod.selective_merge_axis(self, camera_pos, view_proj)
        elif ud.merge_type == SelectiveMergeType.EDGE:
            merge_mod.selective_merge_edge(self, camera_pos, view_proj)

        if ud.tile_sort_type == TileSortType.DISTANCE:
            tile_sorted = order_mod.sort_tiles_by_distance(self, camera_pos)
        elif ud.tile_sort_type == TileSortType.VIEWPORT:
            tile_sorted = order_mod.sort_tiles_by_viewport(self, view_proj)
        elif ud.tile_sort_type == TileSortType.OBJECT:
            tile_sorted = order_mod.sort_tiles_bfs(self, camera_pos)
        else:
            tile_sorted = order_mod.sort_tiles_graph(self, camera_pos)

        n = len(tile_sorted)
        dt = DrawTable(n_draws=n)
        idx = np.asarray(tile_sorted, np.int64)
        mi_i = idx // h
        mi_j = idx % h
        lods = self.lod_id[mi_i, mi_j]
        tids = self.tile_id[mi_i, mi_j]
        stat = self.trans_status[mi_i, mi_j]
        tlow = self.trans_to_lower[mi_i, mi_j]
        is_merged = self.merge_status[mi_i, mi_j] == MergeStatus.MERGED_FROM

        # view selection for non-merged draws (batched)
        view_ids = np.zeros(n, np.int32)
        nm = ~is_merged
        if nm.any():
            view_ids[nm] = self.choose_presort_view_batch(
                self.to_local[mi_i[nm], mi_j[nm]],
                self.tile_center[mi_i[nm], mi_j[nm]],
                camera_pos,
            )

        changing = (stat == TransitionStatus.CHANGING).astype(np.uint8)
        dt.single_draw = is_merged.astype(np.uint8)
        dt.map_index = idx.astype(np.int32)
        dt.single_lod_id = np.full(n, -1, np.int32)
        dt.valid_lod_id = np.where(
            (~is_merged) & (changing == 0), lods, -1
        ).astype(np.int32)
        dt.changing = np.where(is_merged, 0, changing).astype(np.uint8)
        dt.changing_to_lower = np.where(
            (~is_merged) & (changing == 1), tlow.astype(np.int8), -1
        ).astype(np.int8)
        dt.tile_lod = lods.astype(np.int32)
        dt.tile_id = tids.astype(np.int32)
        dt.offset = self.all_tile_offsets().reshape(w, h, 3)[mi_i, mi_j]
        dt.map_coord = np.stack([mi_i, mi_j], axis=1).astype(np.int32)
        if self.corner_pos is not None and (
            ud.tile_sort_type == TileSortType.GRAPH
            or ud.merge_type == SelectiveMergeType.EDGE
        ):
            dt.corner_pos = self.corner_pos[mi_i, mi_j]
            dt.has_corners = np.ones(n, np.uint8)
        else:
            dt.corner_pos = np.zeros((n, 4, 3), np.float32)
            dt.has_corners = np.zeros(n, np.uint8)

        # preloaded splat source, incl. the changing-to-higher buffer quirk
        # (renderer.rs:563-571): Changing(to_lower=false) uses (lod-1) buffers
        base_lod = np.where(
            (changing == 1) & (~tlow), np.maximum(lods - 1, 0), lods
        ).astype(np.int32)
        dt.base_lod = base_lod
        dt.base_tile = tids.astype(np.int32)
        dt.base_view = view_ids.copy()
        counts = self.base_counts[base_lod, tids].astype(np.int32)
        dt.stream_start = np.full(n, -1, np.int64)
        dt.splat_count = counts

        # merged draws: per-group exact k-way sort with LRU
        stream_chunks_idx = []
        stream_chunks_map = []
        stream_chunks_lod = []
        stream_pos = 0
        merged_rows = np.where(is_merged)[0]
        for row in merged_rows:
            mi = int(idx[row])
            mc = (int(mi_i[row]), int(mi_j[row]))
            from_vec = self.merge_groups[mi]
            value, view_id = self._merged_sort(from_vec, mc, camera_pos)
            view_ids[row] = view_id
            dt.single_lod_id[row] = value.single_lod_id
            dt.changing[row] = 1 if value.single_lod_id == -1 else 0
            dt.splat_count[row] = value.splat_count
            dt.stream_start[row] = stream_pos
            stream_pos += value.splat_count
            stream_chunks_idx.append(value.gs_index)
            stream_chunks_map.append(value.gs_map_id)
            if value.gs_lod_id is not None:
                stream_chunks_lod.append(value.gs_lod_id)
            else:
                stream_chunks_lod.append(
                    np.full(value.splat_count, max(value.single_lod_id, 0), np.uint32)
                )
        dt.view_id = view_ids
        if stream_chunks_idx:
            dt.stream_gs_index = np.concatenate(stream_chunks_idx)
            dt.stream_map_id = np.concatenate(stream_chunks_map)
            dt.stream_lod_id = np.concatenate(stream_chunks_lod)
        else:
            dt.stream_gs_index = np.zeros(0, np.uint32)
            dt.stream_map_id = np.zeros(0, np.uint32)
            dt.stream_lod_id = np.zeros(0, np.uint32)
        return dt

    def _merged_sort(self, from_vec, host_mc, camera_pos):
        """Build (or fetch from LRU) the exact sorted stream for one merged
        group (wangtile.rs:507-676). Returns (RenderDataValue, view_id)."""
        h = self.user_data.tile_map_wh[1]
        merge_x = merge_y = True
        tids = []
        statuses = []
        centers = np.zeros(3, np.float32)
        rots = np.zeros((3, 3), np.float32)
        for m_mi in from_vec:
            m_i, m_j = m_mi // h, m_mi % h
            if m_i != host_mc[0]:
                merge_x = False
            if m_j != host_mc[1]:
                merge_y = False
            tids.append((int(self.lod_id[m_i, m_j]), int(self.tile_id[m_i, m_j])))
            statuses.append(
                transition_hash(
                    int(self.trans_status[m_i, m_j]), bool(self.trans_to_lower[m_i, m_j])
                )
            )
            centers += self.tile_center[m_i, m_j]
            rots += self.to_local[m_i, m_j]
        if not merge_x and not merge_y:
            # force top-down view if not merging a line (wangtile.rs:533-536)
            view_id = len(self.presort_dirs) - 1
        else:
            k = float(len(from_vec))
            # The reference averages quaternions (wangtile.rs:531-541);
            # averaging rotation matrices picks the same nearest view for the
            # near-identity surface frames involved.
            view_id = self.choose_presort_view(rots / k, centers / k, camera_pos)

        cache_key = RenderDataKey(view_id, tuple(tids), tuple(statuses))
        if self.user_data.use_cache:
            hit = self.sort_lru_cache.get(cache_key)
            if hit is not None:
                # Remap cached map ids to this frame's indices
                # (wangtile.rs:578-590)
                old_ids = np.asarray(hit.merge_from_vec, np.int64)
                new_ids = np.asarray(from_vec, np.int64)
                perm = np.argsort(old_ids, kind="stable")
                old_sorted = old_ids[perm]
                pos = np.searchsorted(old_sorted, hit.gs_map_id.astype(np.int64))
                pos = np.clip(pos, 0, len(old_ids) - 1)
                matched = old_sorted[pos] == hit.gs_map_id
                gs_map_id = np.where(
                    matched, new_ids[perm[pos]], hit.gs_map_id
                ).astype(np.uint32)
                return (
                    RenderDataValue(
                        splat_count=hit.splat_count,
                        gs_index=hit.gs_index,
                        gs_map_id=gs_map_id,
                        merge_from_vec=list(from_vec),
                        single_lod_id=hit.single_lod_id,
                        gs_lod_id=hit.gs_lod_id,
                    ),
                    view_id,
                )

        do_transition = any(s[0] != TransitionStatus.NONE for s in statuses)
        depths = []
        lod_ids = []
        map_ids = []
        merge_offs = []
        for m_mi in from_vec:
            m_i, m_j = m_mi // h, m_mi % h
            m_lod = int(self.lod_id[m_i, m_j])
            m_tile = int(self.tile_id[m_i, m_j])
            base = self.tile_base_data[m_lod][m_tile][view_id]
            depths.append(base.raw_depth)
            lod_ids.append(m_lod)
            map_ids.append(m_mi)
            merge_offs.append(self.splats_merge_offset[m_lod, m_tile])
            if self.trans_status[m_i, m_j] == TransitionStatus.CHANGING:
                other_lod = m_lod + 1 if self.trans_to_lower[m_i, m_j] else m_lod - 1
                other = self.tile_base_data[other_lod][m_tile][view_id]
                depths.append(other.raw_depth)
                lod_ids.append(other_lod)
                map_ids.append(m_mi)
                merge_offs.append(self.splats_merge_offset[other_lod, m_tile])

        concat = np.concatenate(depths)
        displ = np.zeros(len(depths) + 1, np.int64)
        displ[1:] = np.cumsum([len(d) for d in depths])
        seg_id, idx = native.counting_sort_merge(concat, displ)
        offs = np.asarray(merge_offs, np.uint32)
        gs_index = (idx + offs[seg_id]).astype(np.uint32)
        gs_map_id = native.lookup_u32(np.asarray(map_ids, np.uint32), seg_id)
        gs_lod_id = (
            native.lookup_u32(np.asarray(lod_ids, np.uint32), seg_id)
            if do_transition
            else None
        )
        host_lod = int(self.lod_id[host_mc[0], host_mc[1]])
        value = RenderDataValue(
            splat_count=len(gs_index),
            gs_index=gs_index,
            gs_map_id=gs_map_id,
            merge_from_vec=list(from_vec),
            single_lod_id=-1 if do_transition else host_lod,
            gs_lod_id=gs_lod_id,
        )
        if self.user_data.use_cache:
            self.sort_lru_cache.put(cache_key, value)
        return value, view_id
