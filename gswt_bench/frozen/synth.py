"""The seeded synthetic Wang tile set, as raw splat fields.

Frozen copy of ``make_synthetic_tile_set`` and ``_edge_band`` from
``gswt_renderer_tpu_torch/io/synth.py`` at commit 6240227d. The official
GSWT tile sets are not in the repository, so every configuration renders
these tiles: ``n_center_options * 16`` tiles, one per Wang edge-colour
combination, whose edge bands depend only on the edge colour.
"""

from __future__ import annotations

import numpy as np


def _edge_band(rng, color, axis, at_zero, width, n, lod_scale):
    t = np.linspace(0.04, 0.96, n) * width
    wig = 0.08 * width * np.sin(t / width * np.pi * (2 + color))
    m = 0.05 * width
    off = (m + np.abs(wig)) if color else np.full(n, m)
    perp = off if at_zero else width - off
    xy = np.stack([t, perp] if axis == 0 else [perp, t], axis=1)
    z = (0.3 + 0.25 * color) * np.ones(n)
    col = np.array([[1.2, -0.2, -0.2]] if color else [[-0.2, 1.2, -0.2]]) * np.ones((n, 1))
    return xy, z, col


def tile_set(n_lod=3, n_center_options=1, tile_width=4.0, splats_per_tile=512,
             seed=0, lod_decay=2):
    """Raw splat fields per (lod, tile): list[list[dict]] with position,
    log_scale, color_dc, alpha_logit, rotation (float32 arrays)."""
    n_tile = 16 * n_center_options
    out = []
    for lod in range(n_lod):
        lod_vec = []
        n_body = max(splats_per_tile // (lod_decay**lod), 32)
        n_edge = max(n_body // 8, 8)
        lod_scale = 0.06 * tile_width * (1.8**lod)
        for tile_id in range(n_tile):
            rng = np.random.default_rng(seed * 100003 + tile_id)
            colors = [tile_id % 16 // 8 % 2, tile_id % 16 // 4 % 2,
                      tile_id % 16 // 2 % 2, tile_id % 16 % 2]
            center_idx = tile_id // 16
            xy = rng.uniform(0.08 * tile_width, 0.92 * tile_width, (n_body, 2))
            z = (0.4 + 0.2 * np.sin(xy[:, 0] / tile_width * 3 + center_idx)
                 * np.cos(xy[:, 1] / tile_width * 2))
            hue = rng.uniform(-0.4, 0.4, (n_body, 3))
            col = np.array([[0.1, 0.5, 0.1]]) + 0.3 * hue
            parts_xy, parts_z, parts_c = [xy], [z], [col]
            for e_i, (axis, at_zero) in enumerate(
                    [(1, True), (0, False), (1, False), (0, True)]):
                exy, ez, ec = _edge_band(rng, colors[e_i], axis, at_zero,
                                         tile_width, n_edge, lod_scale)
                parts_xy.append(exy)
                parts_z.append(ez)
                parts_c.append(ec)
            xy = np.concatenate(parts_xy)
            z = np.concatenate(parts_z)
            col = np.concatenate(parts_c)
            n = xy.shape[0]
            position = np.concatenate([xy, z[:, None]], axis=1).astype(np.float32)
            log_scale = np.log(
                lod_scale * rng.uniform(0.6, 1.6, (n, 3)).astype(np.float32))
            alpha_logit = rng.uniform(0.5, 3.0, n).astype(np.float32)
            rotation = rng.normal(0, 1, (n, 4)).astype(np.float32)
            rotation /= np.linalg.norm(rotation, axis=1, keepdims=True)
            lod_vec.append(dict(position=position,
                                log_scale=log_scale.astype(np.float32),
                                color_dc=col.astype(np.float32),
                                alpha_logit=alpha_logit, rotation=rotation))
        out.append(lod_vec)
    return out
