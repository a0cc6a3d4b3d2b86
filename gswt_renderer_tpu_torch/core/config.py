"""Configuration surface mirroring the reference's ``UserData``/``RenderConfig``.

``UserData`` (structure.rs:15-100) is the entire config surface; the GUI's
string form applies derived transforms on confirm (structure.rs:140-211):
update_distance2 = update_dist**2, lod_max_dist *= tile_width, and
height_map_scale = (s_xy, s_xy, s_z). Here ``UserData.from_ui`` plays that
role. Defaults below match the GUI defaults (structure.rs:123-137), which
define the paper's benchmark configuration (97x97 map, tile width 4, Graph
tile sort, Edge merge topk=100 dot=0.2, LRU 1024, lod_max_dist 96*width,
blend ratio 0.05).

JSON round-trip (to_json/from_json) provides the checkpoint/resume story the
reference only had for fly paths (control.rs:535-578): full UserData + camera
+ RNG state serialize to one file.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


class SurfaceType(enum.IntEnum):
    # structure.rs:436-440; integer values match the shader's surface_type
    NONE = 0
    HEIGHT_MAP = 1
    SPHERE = 2


class HeightMapType(enum.IntEnum):
    # structure.rs:443-449
    TEXTURE = 0
    RANDOM = 1
    SLOPE_X = 2
    SLOPE_Y = 3
    DUAL_SLOPE = 4


class TileSortType(enum.IntEnum):
    # structure.rs:452-457
    DISTANCE = 0
    VIEWPORT = 1
    OBJECT = 2
    GRAPH = 3


class SelectiveMergeType(enum.IntEnum):
    # structure.rs:460-464
    NONE = 0
    AXIS = 1
    EDGE = 2


class DrawMode(enum.IntEnum):
    # structure.rs:391-397; values match SceneUniforms.draw_mode switch
    NORMAL = 0
    TILE_ID = 1
    TILE_LOD = 2
    LOD = 3
    VIEW = 4


@dataclass
class UserData:
    """All scene/engine configuration (structure.rs:15-100)."""

    config_id: int = 0
    tile_map_half_wh: Tuple[int, int] = (48, 48)
    center_option: int = 1
    update_distance2: float = 1.0  # squared distance gating rebuilds
    tile_width: float = 4.0

    tile_sort_type: TileSortType = TileSortType.GRAPH

    # Surface
    surface_type: SurfaceType = SurfaceType.HEIGHT_MAP
    height_map_wh: Tuple[int, int] = (0, 0)
    height_map_type: HeightMapType = HeightMapType.RANDOM
    height_map_scale: Tuple[float, float, float] = (1.0, 1.0, 0.0)
    height_tex: Optional[Tuple[np.ndarray, Tuple[int, int]]] = None
    sphere_radius: float = 0.0

    # LOD
    lod_max_dist: float = 0.0
    lod_blending: bool = True
    lod_transition_width_ratio: float = 0.0
    lod_bbox_check: bool = True
    lod_dist_tolerance: float = 0.0

    # Selective merging
    merge_type: SelectiveMergeType = SelectiveMergeType.EDGE
    merge_tile_dist: Tuple[int, int] = (-1, -1)
    merge_dot_threshold: float = 3.0
    merge_topk: int = 100
    use_cache: bool = True
    cache_size: int = 1024

    reset_rng: bool = True
    always_sort: bool = False
    # "numpy": numpy default_rng(0) with the reference's draw order (fast);
    # "stdrng": bit-exact Rust rand-0.9 StdRng (ChaCha12) emulation so
    # seed-0 tile-id spawn sequences match the reference renderer
    # (core/stdrng.py; closes PARITY #1)
    rng_mode: str = "numpy"

    # Filled by the wang engine on configure (structure.rs:57-64)
    tile_map_wh: Tuple[int, int] = (0, 0)
    height_map: Optional[np.ndarray] = None
    # pre-resize source of a RANDOM height map (set by WangTileEngine
    # .configure): enables the direct-bicubic small-map sampling fast path
    height_map_src: Optional[np.ndarray] = None
    height_map_src_wh: Tuple[int, int] = (0, 0)
    lod_transition_dist: Tuple[float, ...] = ()
    n_tiles: Tuple[int, int, int] = (0, 0, 0)  # (n_lod, n_tile, n_view)

    @staticmethod
    def from_ui(
        tile_map_half_wh=(48, 48),
        center_option=1,
        update_dist=1.0,
        tile_width=4.0,
        height_map_wh=(10, 10),
        height_map_scale=(1.0, 1.0),  # (xy, z) as in the GUI
        sphere_radius=20.0,
        merge_tile_dist=(3, 10),
        merge_dot_threshold=0.2,
        merge_topk=100,
        lod_max_dist=96.0,  # in tile widths, scaled below
        lod_transition_width_ratio=0.05,
        lod_dist_tolerance=0.0,
        cache_size=1024,
        **kwargs,
    ) -> "UserData":
        """Build a UserData applying the GUI's derived transforms
        (structure.rs:140-211): square the update distance, scale lod_max_dist
        by tile_width, and expand (s_xy, s_z) to (s_xy, s_xy, s_z)."""
        ud = UserData(
            tile_map_half_wh=tuple(tile_map_half_wh),
            center_option=int(center_option),
            update_distance2=float(update_dist) ** 2,
            tile_width=float(tile_width),
            height_map_wh=tuple(height_map_wh),
            height_map_scale=(
                float(height_map_scale[0]),
                float(height_map_scale[0]),
                float(height_map_scale[-1]),
            ),
            sphere_radius=float(sphere_radius),
            merge_tile_dist=tuple(merge_tile_dist),
            merge_dot_threshold=float(merge_dot_threshold),
            merge_topk=int(merge_topk),
            lod_max_dist=float(lod_max_dist) * float(tile_width),
            lod_transition_width_ratio=float(lod_transition_width_ratio),
            lod_dist_tolerance=float(lod_dist_tolerance),
            cache_size=int(cache_size),
        )
        for k, v in kwargs.items():
            if not hasattr(ud, k):
                raise TypeError(f"unknown UserData field: {k}")
            setattr(ud, k, v)
        return ud

    def clone(self) -> "UserData":
        c = dataclasses.replace(self)
        if self.height_map is not None:
            c.height_map = self.height_map.copy()
        return c

    # --- checkpoint/resume -------------------------------------------------
    _JSON_SKIP = ("height_tex", "height_map", "height_map_src")

    def to_json(self) -> str:
        d = {}
        for f in dataclasses.fields(self):
            if f.name in self._JSON_SKIP:
                continue
            v = getattr(self, f.name)
            if isinstance(v, enum.IntEnum):
                v = int(v)
            if isinstance(v, tuple):
                v = list(v)
            d[f.name] = v
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "UserData":
        d = json.loads(s)
        ud = UserData()
        casts = {
            "tile_sort_type": TileSortType,
            "surface_type": SurfaceType,
            "height_map_type": HeightMapType,
            "merge_type": SelectiveMergeType,
        }
        for k, v in d.items():
            if isinstance(v, list):
                v = tuple(v)
            if k in casts:
                v = casts[k](v)
            setattr(ud, k, v)
        return ud


@dataclass
class RenderConfig:
    """Runtime-tunable render settings (structure.rs:347-388)."""

    draw_mode: DrawMode = DrawMode.NORMAL
    height_map_scale_v: float = 1.0
    scene_scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    use_clip: bool = False
    clip_height: float = 0.0
    draw_point_cloud: bool = False
    point_cloud_radius: float = 0.01
    culling_dist: float = 1.0
    proxy_full: bool = False
    proxy_map: bool = True
    proxy_height: float = -0.5
    proxy_width_scale: float = 4.0
    proxy_brightness: float = 1.0
    proxy_black_background: bool = False
    lod_enable: Tuple[bool, ...] = ()
    debug_log: bool = False
    splat_scale: float = 1.0

    @staticmethod
    def new(max_lod_count: int) -> "RenderConfig":
        return RenderConfig(lod_enable=tuple([True] * max_lod_count))
