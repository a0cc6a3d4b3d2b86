"""Data contracts of the Wang-tile engine (structure.rs:466-716).

The reference keeps per-tile ``TileInstance`` structs (structure.rs:496-509);
here the scrolling map is struct-of-arrays on the engine (NumPy, vectorized),
and ``sort_tiles`` emits a ``DrawTable`` — the array-of-draws equivalent of
SortData + TileUniforms (structure.rs:489-493, renderer.rs:675-726) that the
TPU frame function consumes directly.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


class MergeStatus(enum.IntEnum):
    # structure.rs:557-561
    NONE = 0
    MERGED_FROM = 1
    MERGED_TO = 2


class TransitionStatus(enum.IntEnum):
    # structure.rs:564-568
    NONE = 0
    SPAWNING = 1
    CHANGING = 2


def transition_hash(status: int, to_lower: bool) -> Tuple:
    """Hashable transition key: Spawning drops its blend factor
    (structure.rs:570-584)."""
    if status == TransitionStatus.CHANGING:
        return (int(status), bool(to_lower))
    return (int(status),)


@dataclass
class TileBaseData:
    """Per-(lod, tile, view) preprocessed data (structure.rs:546-554):
    the raw per-splat depth keys for this presort view and the LOD-blended
    presorted index/lod-id arrays (wangtile.rs:221-254)."""

    splat_count: int = 0
    tile_center: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    aabb: Tuple[np.ndarray, np.ndarray] = None
    raw_depth: np.ndarray = None   # i32 [n_splats(lod)]
    gs_index: np.ndarray = None    # u32 [splat_count] into merged store
    gs_lod_id: np.ndarray = None   # u32 [splat_count]


@dataclass
class SceneData:
    """Per-rebuild splat statistics (structure.rs:467-486)."""

    scene_id: int = 0
    splat_count: int = 0
    blending_splat_count: int = 0
    center_coord: Tuple[int, int] = (0, 0)
    lod_splat_count: List[int] = field(default_factory=list)
    lod_instance_count: List[int] = field(default_factory=list)


@dataclass(frozen=True)
class RenderDataKey:
    """LRU key for a merged-group sort (structure.rs:670-684)."""

    view_id: int
    tid: Tuple[Tuple[int, int], ...]
    transition_status: Tuple[Tuple, ...]


@dataclass
class RenderDataValue:
    """A merged-group exact sort result (structure.rs:686-694)."""

    splat_count: int
    gs_index: np.ndarray           # u32
    gs_map_id: np.ndarray          # u32 (map_index per splat)
    merge_from_vec: List[int]
    single_lod_id: int             # -1 when per-splat lod ids are needed
    gs_lod_id: Optional[np.ndarray]  # u32 or None


@dataclass
class DrawTable:
    """Array-of-draws output of sort_tiles: one row per rendered tile/group,
    in back-to-front painter order. Fields mirror TileUniforms
    (renderer.rs:675-726) plus splat sourcing for the device pipeline."""

    scene_id: int = 0
    n_draws: int = 0

    # TileUniforms fields
    single_draw: np.ndarray = None        # u8 [N]
    map_index: np.ndarray = None          # i32 [N]
    single_lod_id: np.ndarray = None      # i32 [N]
    valid_lod_id: np.ndarray = None       # i32 [N]
    changing: np.ndarray = None           # u8 [N]
    changing_to_lower: np.ndarray = None  # i8 [N]
    tile_lod: np.ndarray = None           # i32 [N]
    tile_id: np.ndarray = None            # i32 [N]
    view_id: np.ndarray = None            # i32 [N]
    offset: np.ndarray = None             # f32 [N,3]
    map_coord: np.ndarray = None          # i32 [N,2]

    # render-time viewport culling inputs (renderer.rs:471-494)
    corner_pos: np.ndarray = None         # f32 [N,4,3]
    has_corners: np.ndarray = None        # u8 [N]

    # splat sourcing: preloaded (lod,tile,view) table or merged stream
    splat_count: np.ndarray = None        # i32 [N]
    stream_start: np.ndarray = None       # i64 [N], -1 => preloaded
    base_lod: np.ndarray = None           # i32 [N] (incl. changing-up quirk,
    base_tile: np.ndarray = None          #          renderer.rs:563-571)
    base_view: np.ndarray = None

    # merged stream payloads, concatenated over merged draws
    stream_gs_index: np.ndarray = None    # u32 [S]
    stream_map_id: np.ndarray = None      # u32 [S]
    stream_lod_id: np.ndarray = None      # u32 [S]

    def total_splats(self) -> int:
        return int(self.splat_count.sum()) if self.n_draws else 0


class LruCache:
    """Minimal LRU with the semantics of the `lru` crate used at
    wangtile.rs:37,576-675 (get refreshes recency; put evicts oldest)."""

    def __init__(self, cap: int):
        from collections import OrderedDict

        self.cap = max(int(cap), 1)
        self._d = OrderedDict()

    def get(self, key):
        if key in self._d:
            self._d.move_to_end(key)
            return self._d[key]
        return None

    def put(self, key, value):
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.cap:
            self._d.popitem(last=False)

    def __len__(self):
        return len(self._d)
