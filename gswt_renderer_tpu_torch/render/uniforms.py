"""Per-frame uniform staging: the host-side bridge from the Wang-tile engine's
DrawTable to what the renderers (NumPy oracle and TPU pipeline) consume.

SceneParams mirrors SceneUniforms (renderer.rs:602-673); FrameInputs bundles
the splat store, per-draw tables, stream arrays, camera and height map.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from ..core.camera import Camera, CameraUniforms
from ..core.config import DrawMode, RenderConfig, UserData
from ..tiles.structures import DrawTable


@dataclass
class SceneParams:
    """SceneUniforms (renderer.rs:631-672). Note num_lod replicates the
    reference's quirk of passing n_tiles.1 (the tile count, renderer.rs:646);
    the shader's lod_id == num_lod-1 branch is correspondingly dead for
    ordinary tile sets, and transition_dist_vec is zero-padded to 16."""

    splat_scale: float = 1.0
    tile_width: float = 4.0
    use_clip: int = 0
    clip_height: float = 0.0
    surface_type: int = 0
    sphere_radius: float = 0.0
    point_cloud_radius: float = 0.0
    transition_width_ratio: float = 0.0
    num_lod: int = 16
    draw_mode: int = 0
    map_half_wh: Tuple[int, int] = (0, 0)
    center_coord: Tuple[int, int] = (0, 0)
    transition_dist_vec: np.ndarray = field(
        default_factory=lambda: np.zeros(16, np.float32)
    )
    height_map_scale: np.ndarray = field(
        default_factory=lambda: np.ones(3, np.float32)
    )
    scene_scale: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))

    @staticmethod
    def from_data(
        user_data: UserData, center_coord, render_config: RenderConfig
    ) -> "SceneParams":
        rc = render_config
        trans = np.zeros(16, np.float32)
        td = np.asarray(user_data.lod_transition_dist, np.float32)
        trans[: len(td)] = td[:16]
        return SceneParams(
            splat_scale=rc.splat_scale,
            tile_width=user_data.tile_width,
            use_clip=int(rc.use_clip),
            clip_height=rc.clip_height,
            surface_type=int(user_data.surface_type),
            sphere_radius=user_data.sphere_radius,
            point_cloud_radius=(
                rc.point_cloud_radius if rc.draw_point_cloud else 0.0
            ),
            transition_width_ratio=user_data.lod_transition_width_ratio,
            num_lod=int(user_data.n_tiles[1]),  # reference quirk (renderer.rs:646)
            draw_mode=int(rc.draw_mode),
            map_half_wh=tuple(user_data.tile_map_half_wh),
            center_coord=(int(center_coord[0]), int(center_coord[1])),
            transition_dist_vec=trans,
            height_map_scale=np.array(
                [
                    user_data.height_map_scale[0],
                    user_data.height_map_scale[1],
                    user_data.height_map_scale[2] * rc.height_map_scale_v,
                ],
                np.float32,
            ),
            scene_scale=np.asarray(rc.scene_scale, np.float32),
        )


@dataclass
class FrameInputs:
    """Everything one frame render needs, host-side."""

    # splat store (from WangTileEngine.tile_splats_merged.generate_arrays())
    pos: np.ndarray      # f32 [N,3]
    cov: np.ndarray      # f32 [N,6]
    rgba: np.ndarray     # u8 [N,4]

    draw: DrawTable
    scene: SceneParams
    cam: CameraUniforms
    height_map: Optional[np.ndarray]      # f32 flat [h*w] or None
    height_map_wh: Tuple[int, int]

    # preloaded per-(lod,tile,view) presorted indices, flattened
    preload_gs_index: np.ndarray   # u32 [P]
    preload_gs_lod: np.ndarray     # u32 [P]
    preload_offset: np.ndarray     # i64 [n_lod, n_tile, n_view]

    # render config bits applied at render time (renderer.rs:466-497)
    culling_dist: float = 1.0
    lod_enable: Tuple[bool, ...] = ()


def flatten_preload(engine):
    """Concatenate all (lod,tile,view) presorted index tables into flat
    arrays + an offset table (the preloaded GPU buffers of renderer.rs:289-327
    become one resident HBM array)."""
    n_lod, n_tile, n_view = engine.n_tiles
    offs = np.zeros((n_lod, n_tile, n_view), np.int64)
    chunks_idx = []
    chunks_lod = []
    pos = 0
    for l in range(n_lod):
        for t in range(n_tile):
            for v in range(n_view):
                bd = engine.tile_base_data[l][t][v]
                offs[l, t, v] = pos
                chunks_idx.append(bd.gs_index)
                chunks_lod.append(bd.gs_lod_id)
                pos += bd.splat_count
    return (
        np.concatenate(chunks_idx).astype(np.uint32),
        np.concatenate(chunks_lod).astype(np.uint32),
        offs,
    )


def build_frame_inputs(
    engine,
    draw: DrawTable,
    camera: Camera,
    render_config: Optional[RenderConfig] = None,
    center_coord=None,
    preload=None,
) -> FrameInputs:
    """Assemble FrameInputs from engine state + a DrawTable + camera."""
    ud = engine.user_data
    rc = render_config or RenderConfig.new(engine.n_tiles[0])
    store = engine.tile_splats_merged
    if store.pos is None:
        store.generate_arrays()
    if center_coord is None:
        center_coord = engine.center_coord
    if preload is None:
        preload = flatten_preload(engine)
    pgi, pgl, poff = preload
    lod_enable = rc.lod_enable or tuple([True] * engine.n_tiles[0])
    return FrameInputs(
        pos=store.pos,
        cov=store.cov,
        rgba=store.rgba,
        draw=draw,
        scene=SceneParams.from_data(ud, center_coord, rc),
        cam=CameraUniforms(camera),
        height_map=ud.height_map,
        height_map_wh=ud.height_map_wh,
        preload_gs_index=pgi,
        preload_gs_lod=pgl,
        preload_offset=poff,
        culling_dist=rc.culling_dist,
        lod_enable=lod_enable,
    )
