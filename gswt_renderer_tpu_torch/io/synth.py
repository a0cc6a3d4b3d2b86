"""Synthetic Wang-tile splat sets, plus PLY/zip writers.

The official GSWT tile sets are produced offline by the paper's constructor
and are not vendored in the reference repo, so tests and benchmarks here use
deterministic synthetic tile sets: ``n_center_options * 16`` terrain-like
tiles (one per Wang edge-color combination, wangtile.rs:1830-1846), each with
splats in the tile-local [0, tile_width]^2 footprint and edge bands whose
geometry depends only on the edge color, so adjacent procedurally-spawned
tiles line up seamlessly. LOD levels halve the splat count and grow the
average scale (the engine asserts avg scale strictly increases with lod,
wangtile.rs:139).
"""

from __future__ import annotations

import io
import zipfile

import numpy as np

from .ply import Scene, pack_splats

_PLY_PROPS = (
    ["x", "y", "z", "nx", "ny", "nz"]
    + [f"f_dc_{i}" for i in range(3)]
    + [f"f_rest_{i}" for i in range(45)]
    + ["opacity"]
    + [f"scale_{i}" for i in range(3)]
    + [f"rot_{i}" for i in range(4)]
)


def write_ply(position, log_scale, color_dc, alpha_logit, rotation) -> bytes:
    """Serialize splat fields into the INRIA 62-float PLY layout
    (scene.rs:19-26)."""
    n = position.shape[0]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {p}" for p in _PLY_PROPS]
    header += ["end_header", ""]
    rows = np.zeros((n, 62), dtype="<f4")
    rows[:, 0:3] = position
    rows[:, 6:9] = color_dc
    rows[:, 54] = alpha_logit
    rows[:, 55:58] = log_scale
    rows[:, 58:62] = rotation
    return "\n".join(header).encode() + rows.tobytes()


def _edge_band(rng, color, axis, at_zero, width, n, lod_scale):
    """Splats along one tile edge; geometry/color keyed only by edge color."""
    t = np.linspace(0.04, 0.96, n) * width
    # deterministic per-color wiggle so matching edges are continuous
    wig = 0.08 * width * np.sin(t / width * np.pi * (2 + color))
    m = 0.05 * width
    off = (m + np.abs(wig)) if color else np.full(n, m)
    perp = off if at_zero else width - off
    xy = np.stack([t, perp] if axis == 0 else [perp, t], axis=1)
    z = (0.3 + 0.25 * color) * np.ones(n)
    col = np.array([[1.2, -0.2, -0.2]] if color else [[-0.2, 1.2, -0.2]]) * np.ones((n, 1))
    return xy, z, col


def make_synthetic_tile_set(
    n_lod: int = 3,
    n_center_options: int = 1,
    tile_width: float = 4.0,
    splats_per_tile: int = 512,
    seed: int = 0,
    lod_decay: int = 2,
):
    """Return raw splat fields per (lod, tile): list[list[dict]] with keys
    position, log_scale, color_dc, alpha_logit, rotation. lod_decay: splat
    count divisor per lod (4 matches the scale-doubling rule of real GS LOD
    chains: splat area x4 => count /4 for constant coverage)."""
    n_tile = 16 * n_center_options
    out = []
    for lod in range(n_lod):
        lod_vec = []
        n_body = max(splats_per_tile // (lod_decay**lod), 32)
        n_edge = max(n_body // 8, 8)
        # average scale must strictly increase with lod (wangtile.rs:139)
        lod_scale = 0.06 * tile_width * (1.8**lod)
        for tile_id in range(n_tile):
            rng = np.random.default_rng(seed * 100003 + tile_id)
            colors = [
                tile_id % 16 // 8 % 2,  # west
                tile_id % 16 // 4 % 2,  # north
                tile_id % 16 // 2 % 2,  # east
                tile_id % 16 % 2,  # south  (wangtile.rs:1830-1839)
            ]
            center_idx = tile_id // 16

            # interior splats: a smooth deterministic height field + noise
            xy = rng.uniform(0.08 * tile_width, 0.92 * tile_width, (n_body, 2))
            z = (
                0.4
                + 0.2 * np.sin(xy[:, 0] / tile_width * 3 + center_idx)
                * np.cos(xy[:, 1] / tile_width * 2)
            )
            hue = rng.uniform(-0.4, 0.4, (n_body, 3))
            col = np.array([[0.1, 0.5, 0.1]]) + 0.3 * hue

            parts_xy, parts_z, parts_c = [xy], [z], [col]
            for e_i, (axis, at_zero) in enumerate(
                [(1, True), (0, False), (1, False), (0, True)]  # w, n, e, s
            ):
                exy, ez, ec = _edge_band(
                    rng, colors[e_i], axis, at_zero, tile_width, n_edge, lod_scale
                )
                parts_xy.append(exy)
                parts_z.append(ez)
                parts_c.append(ec)

            xy = np.concatenate(parts_xy)
            z = np.concatenate(parts_z)
            col = np.concatenate(parts_c)
            n = xy.shape[0]
            position = np.concatenate([xy, z[:, None]], axis=1).astype(np.float32)
            log_scale = np.log(
                lod_scale * rng.uniform(0.6, 1.6, (n, 3)).astype(np.float32)
            )
            alpha_logit = rng.uniform(0.5, 3.0, n).astype(np.float32)
            rotation = rng.normal(0, 1, (n, 4)).astype(np.float32)
            rotation /= np.linalg.norm(rotation, axis=1, keepdims=True)
            lod_vec.append(
                dict(
                    position=position,
                    log_scale=log_scale.astype(np.float32),
                    color_dc=col.astype(np.float32),
                    alpha_logit=alpha_logit,
                    rotation=rotation,
                )
            )
        out.append(lod_vec)
    return out


def synthetic_scene_vec(**kwargs):
    """Synthetic tiles packed directly into Scenes (skipping PLY bytes)."""
    raw = make_synthetic_tile_set(**kwargs)
    return [
        [
            Scene(
                splat_count=d["position"].shape[0],
                buffer=pack_splats(
                    d["position"], d["log_scale"], d["color_dc"],
                    d["alpha_logit"], d["rotation"],
                ),
            )
            for d in lod_vec
        ]
        for lod_vec in raw
    ]


def write_tile_zip(path, **kwargs):
    """Write a synthetic tile set as a zip of lod{L}_tile_{T}.ply files,
    matching the naming the loader expects (scene.rs:1057)."""
    raw = make_synthetic_tile_set(**kwargs)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for lod, lod_vec in enumerate(raw):
            for tile_id, d in enumerate(lod_vec):
                data = write_ply(
                    d["position"], d["log_scale"], d["color_dc"],
                    d["alpha_logit"], d["rotation"],
                )
                zf.writestr(f"lod{lod}_tile_{tile_id}.ply", data)
    return path
