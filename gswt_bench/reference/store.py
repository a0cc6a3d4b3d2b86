"""The splat store, LOD distances and height map, worked out from the
benchmark's raw inputs; and the check of the draw list's inputs.

Semantics of the reference renderer (scene.rs, wangtile.rs) as the port
documents them at commit 6240227d (``io/ply.py`` ``pack_splats`` and
``generate_arrays``, ``tiles/wangtile.py`` ``_preprocess`` and
``configure``, ``tiles/surface.py`` ``map_resize``): each tile's splats in
importance order, colour and opacity as u8, the quaternion as u8, the
covariance R S S^T R^T times 4 rounded through float16; every LOD of a tile
lowered by its LOD-0 mean height; the (lod, tile) stores concatenated; the
LOD transition distances from the per-LOD mean scale; the random height map
drawn from a generator seeded with 0 and resized bicubically to 1024^2.
"""

from __future__ import annotations

import numpy as np

SH_C0 = 0.28209479177387814
MAP_RESO = 1024
# the 9 presort view directions (wangtile.rs:146-156), back to front =
# descending along the direction
PRESORT_DIRS = np.array(
    [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [1, 0, -1], [-1, 0, -1],
     [0, 1, -1], [0, -1, -1], [0, 0, -1]], np.float32)
PRESORT_DIRS /= np.linalg.norm(PRESORT_DIRS, axis=1, keepdims=True)


def _u8(x):
    """Rust's float-to-u8 cast: truncate, saturate, NaN to 0."""
    x = np.nan_to_num(np.asarray(x, np.float64), nan=0.0)
    return np.clip(np.trunc(x), 0, 255).astype(np.uint8)


def _pack(d):
    scale = np.exp(np.asarray(d["log_scale"], np.float32))
    opacity = 1.0 / (1.0 + np.exp(-np.asarray(d["alpha_logit"], np.float32)))
    size = (scale[:, 0] * scale[:, 1] * scale[:, 2]) * opacity
    order = np.argsort(-size, kind="stable")
    col = np.asarray(d["color_dc"], np.float32)[order]
    rot = np.asarray(d["rotation"], np.float32)[order]
    rgba = np.empty((len(order), 4), np.uint8)
    for c in range(3):
        rgba[:, c] = _u8((0.5 + SH_C0 * col[:, c]) * 255.0)
    rgba[:, 3] = _u8(opacity[order] * 255.0)
    qlen = np.sqrt(np.sum(rot.astype(np.float64) ** 2, axis=1))
    qlen = np.where(qlen == 0, 1.0, qlen)
    quat = _u8(((rot / qlen[:, None]).astype(np.float32) + 1.0) * 0.5 * 255.0)
    pos = np.asarray(d["position"], np.float32)[order].copy()
    return pos, scale[order], rgba, quat


def _covariance(scale, quat):
    q = quat.astype(np.float32) / 255.0 * 2.0 - 1.0
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r = [[1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z), 2.0 * (x * z + w * y)],
         [2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - w * x)],
         [2.0 * (x * z - w * y), 2.0 * (y * z + w * x), 1.0 - 2.0 * (x * x + y * y)]]
    m = [[r[i][k] * scale[:, k] for k in range(3)] for i in range(3)]

    def s(i, j):
        return m[i][0] * m[j][0] + m[i][1] * m[j][1] + m[i][2] * m[j][2]

    cov = np.stack([s(0, 0), s(0, 1), s(0, 2), s(1, 1), s(1, 2), s(2, 2)],
                   axis=1) * 4.0
    return cov.astype(np.float16).astype(np.float32)


def build_store(raw, lod_max_dist: float, tile_width: float) -> dict:
    """The merged store of a raw tile set (frozen/synth.py tile_set): pos
    [N, 3], cov [N, 6], rgba u8 [N, 4], offsets [n_lod, n_tile], and the
    LOD transition distances."""
    n_lod, n_tile = len(raw), len(raw[0])
    packed = [[_pack(raw[l][t]) for t in range(n_tile)] for l in range(n_lod)]
    for t in range(n_tile):
        p0 = packed[0][t][0]
        avg_z = (p0.astype(np.float64).sum(axis=0) / p0.shape[0]).astype(np.float32)[2]
        for l in range(n_lod):
            packed[l][t][0][...] += np.array([0.0, 0.0, -avg_z], np.float32)
    offsets = np.zeros((n_lod, n_tile), np.int64)
    pos, cov, rgba = [], [], []
    n = 0
    for l in range(n_lod):
        for t in range(n_tile):
            p, s, c, q = packed[l][t]
            offsets[l, t] = n
            n += p.shape[0]
            pos.append(p)
            cov.append(_covariance(s, q))
            rgba.append(c)
    avg_scale = []
    for l in range(n_lod):
        ssum = sum(float(packed[l][t][1].astype(np.float64).sum())
                   for t in range(n_tile))
        snum = sum(packed[l][t][1].shape[0] * 3 for t in range(n_tile))
        avg_scale.append(ssum / snum)
    trans = tuple(lod_max_dist * tile_width * s / avg_scale[-1] for s in avg_scale)
    return dict(pos=np.concatenate(pos), cov=np.concatenate(cov),
                rgba=np.concatenate(rgba), offsets=offsets,
                counts=np.array([[packed[l][t][0].shape[0] for t in range(n_tile)]
                                 for l in range(n_lod)]),
                transition_dist=trans)


def _cubic_weight(t):
    return np.stack([((-0.5 * t + 1.0) * t - 0.5) * t,
                     ((1.5 * t - 2.5) * t) * t + 1.0,
                     ((-1.5 * t + 2.0) * t + 0.5) * t,
                     ((0.5 * t - 0.5) * t) * t], axis=-1)


def height_map(hw, tile_width: float, scale_z: float):
    """The random height map (wangtile.rs:377-413): flat float32 [1024^2]
    and its (w, h)."""
    w, h = int(hw[0]), int(hw[1])
    src = np.random.default_rng(0).uniform(-1.0, 1.0, h * w).astype(np.float32)
    src = src * np.float32(tile_width * scale_z)
    jj, ii = np.meshgrid(np.arange(MAP_RESO), np.arange(MAP_RESO), indexing="ij")
    uv = np.stack([ii.reshape(-1) / MAP_RESO, jj.reshape(-1) / MAP_RESO],
                  axis=1).astype(np.float32)
    x = uv[:, 0] * w - 0.5
    y = uv[:, 1] * h - 0.5
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    wx = _cubic_weight((x - x0).astype(np.float32))
    wy = _cubic_weight((y - y0).astype(np.float32))
    out = np.zeros(uv.shape[0], np.float32)
    for j in range(4):
        for i in range(4):
            out += src[((y0 + j - 1) % h) * w + ((x0 + i - 1) % w)] * wx[:, i] * wy[:, j]
    return out.astype(np.float32), (MAP_RESO, MAP_RESO)


def presort_view_rows() -> list:
    """The z row (first three columns) of each presort view's 90-degree
    view-projection (wangtile.rs:144-174): a splat's depth key is
    trunc(4096 x position . row)."""
    from .camera import look_at_rh, perspective

    proj = perspective(np.deg2rad(90.0), 1.0, 0.1, 10.0)
    rows = []
    for d in PRESORT_DIRS:
        up = np.array([0.0, 0.0, 1.0]) if (d[0] != 0.0 or d[1] != 0.0) else np.array([0.0, 1.0, 0.0])
        rows.append((proj @ look_at_rh([0.0, 0.0, 0.0], d, up)).astype(np.float32)[2, :3])
    return rows


def presort_inversions(store, preload_index, preload_lod, preload_offset,
                       preload_count) -> tuple:
    """The program's presorted (lod, tile, view) lists against the store:
    (lists that are not the tile's splats of its LOD and the next,
    neighbours out of back-to-front order). Each list's order is the
    counting sort of scene.rs:537-552 and 655-698: depth keys trunc(4096 x
    position . z row of the 90-degree presort view), spread over 65536
    buckets between the list's least and largest key, back to front. Two
    neighbours are out of order when the later one's bucket is two or more
    above the earlier one's: one bucket of slack absorbs a key rounded
    across a bucket's edge."""
    n_lod, n_tile = store["offsets"].shape
    rows = presort_view_rows()
    pos = store["pos"]
    bad = inversions = 0
    for l in range(n_lod):
        for t in range(n_tile):
            want = np.arange(store["offsets"][l, t], store["offsets"][l, t] + store["counts"][l, t])
            if l + 1 < n_lod:
                want = np.concatenate([want, np.arange(
                    store["offsets"][l + 1, t],
                    store["offsets"][l + 1, t] + store["counts"][l + 1, t])])
            for v, vz in enumerate(rows):
                o, c = preload_offset[l, t, v], preload_count[l, t, v]
                idx = preload_index[o:o + c].astype(np.int64)
                lid = preload_lod[o:o + c].astype(np.int64)
                upper = (idx >= store["offsets"][l + 1, t] if l + 1 < n_lod
                         else np.zeros(idx.shape, bool))
                if (c != want.shape[0] or not np.array_equal(np.sort(idx), want)
                        or not np.array_equal(lid, np.where(upper, l + 1, l))):
                    bad += 1
                    continue
                key = np.trunc((pos[idx] @ vz).astype(np.float64) * 4096.0)
                span = key.max() - key.min()
                if span <= 0:
                    continue
                b = np.floor((key - key.min()).astype(np.float32)
                             * (np.float32(65535) / np.float32(span)))
                inversions += int(np.sum(np.diff(b) >= 2))
    return bad, inversions
