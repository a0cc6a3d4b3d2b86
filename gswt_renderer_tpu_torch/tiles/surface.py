"""Surface mapping: flat / height-map terrain / sphere (wangtile.rs:1220-1494).

These are the CPU-side mappings used for tile placement, corner/edge geometry
and LOD distance checks. The per-splat GPU-side equivalents live in
``ops/project.py`` as jnp code with identical math (gswt.wgsl:565-623).
All functions are vectorized over a batch of positions.
"""

from __future__ import annotations

import numpy as np

DELTA = 0.001  # finite-difference step (wangtile.rs:1359)


def map_fetch_bilinear(tex: np.ndarray, wh, uv: np.ndarray) -> np.ndarray:
    """Wrapping bilinear fetch (wangtile.rs:1220-1263). tex flat [h*w],
    uv [N,2] in [0,1]; returns [N]."""
    w, h = int(wh[0]), int(wh[1])
    x = uv[:, 0] * w - 0.5
    y = uv[:, 1] * h - 0.5
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    tx = (x - x0).astype(np.float32)
    ty = (y - y0).astype(np.float32)

    def texel(xi, yi):
        return tex[(yi % h) * w + (xi % w)]

    i00 = texel(x0, y0)
    i10 = texel(x0 + 1, y0)
    i01 = texel(x0, y0 + 1)
    i11 = texel(x0 + 1, y0 + 1)
    i0 = i00 * (1 - tx) + i10 * tx
    i1 = i01 * (1 - tx) + i11 * tx
    return i0 * (1 - ty) + i1 * ty


def map_fetch_bilinear_with_auxiliary(tex, wh, uv, dt):
    """Center + 4 offset taps used for the finite-difference tangent frame
    (wangtile.rs:1220-1290). Note the reference extrapolates the *weights*
    beyond [0,1] using the same 4 texels rather than fetching neighbors —
    replicated exactly. Returns [N,5]: center, right, left, up, down."""
    w, h = int(wh[0]), int(wh[1])
    x = uv[:, 0] * w - 0.5
    y = uv[:, 1] * h - 0.5
    dx = dt * w
    dy = dt * h
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    tx = (x - x0).astype(np.float32)
    ty = (y - y0).astype(np.float32)

    def texel(xi, yi):
        return tex[(yi % h) * w + (xi % w)]

    i00 = texel(x0, y0)
    i10 = texel(x0 + 1, y0)
    i01 = texel(x0, y0 + 1)
    i11 = texel(x0 + 1, y0 + 1)

    def bil(txx, tyy):
        i0 = i00 * (1 - txx) + i10 * txx
        i1 = i01 * (1 - txx) + i11 * txx
        return i0 * (1 - tyy) + i1 * tyy

    return np.stack(
        [bil(tx, ty), bil(tx + dx, ty), bil(tx - dx, ty), bil(tx, ty + dy), bil(tx, ty - dy)],
        axis=1,
    )


def _cubic_weight(t):
    return np.stack(
        [
            ((-0.5 * t + 1.0) * t - 0.5) * t,
            ((1.5 * t - 2.5) * t) * t + 1.0,
            ((-1.5 * t + 2.0) * t + 0.5) * t,
            ((0.5 * t - 0.5) * t) * t,
        ],
        axis=-1,
    )


def map_fetch_bicubic(tex, wh, uv):
    """Wrapping bicubic fetch (wangtile.rs:1292-1331)."""
    w, h = int(wh[0]), int(wh[1])
    x = uv[:, 0] * w - 0.5
    y = uv[:, 1] * h - 0.5
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    wx = _cubic_weight((x - x0).astype(np.float32))
    wy = _cubic_weight((y - y0).astype(np.float32))
    out = np.zeros(uv.shape[0], np.float32)
    for j in range(4):
        for i in range(4):
            v = tex[((y0 + j - 1) % h) * w + ((x0 + i - 1) % w)]
            out += v * wx[:, i] * wy[:, j]
    return out


def map_resize(tex, from_wh, to_wh):
    """Bicubic resize used to blow Random height maps up to 1024^2
    (wangtile.rs:1333-1349)."""
    tw, th = int(to_wh[0]), int(to_wh[1])
    jj, ii = np.meshgrid(np.arange(th), np.arange(tw), indexing="ij")
    uv = np.stack([ii.reshape(-1) / tw, jj.reshape(-1) / th], axis=1).astype(np.float32)
    return map_fetch_bicubic(np.asarray(tex, np.float32), from_wh, uv).astype(np.float32)


def heightmap_surface(ud, pos: np.ndarray, to_world: bool = True):
    """Height-map surface mapping (wangtile.rs:1364-1405). pos [N,3]; returns
    (new_pos [N,3], transform [N,3,3])."""
    n = pos.shape[0]
    hmap_xrange = ud.tile_map_wh[0] * ud.tile_width * ud.height_map_scale[0]
    hmap_yrange = ud.tile_map_wh[1] * ud.tile_width * ud.height_map_scale[1]
    u = (pos[:, 0] + ud.tile_map_half_wh[0] * ud.tile_width) / hmap_xrange
    v = (pos[:, 1] + ud.tile_map_half_wh[1] * ud.tile_width) / hmap_yrange
    uv = np.stack([u, v], axis=1).astype(np.float32)
    taps = map_fetch_bilinear_with_auxiliary(
        np.asarray(ud.height_map, np.float32), ud.height_map_wh, uv, DELTA
    ) * np.float32(ud.height_map_scale[2])
    height, h_r, h_l, h_u, h_d = (taps[:, i] for i in range(5))

    local_x = np.zeros((n, 3), np.float32)
    local_x[:, 0] = 1.0
    local_x[:, 2] = (h_r - h_l) / (2.0 * DELTA * hmap_xrange)
    local_y = np.zeros((n, 3), np.float32)
    local_y[:, 1] = 1.0
    local_y[:, 2] = (h_u - h_d) / (2.0 * DELTA * hmap_yrange)
    local_z = np.cross(local_x, local_y)
    local_z /= np.linalg.norm(local_z, axis=1, keepdims=True)

    l2w = np.stack([local_x, local_y, local_z], axis=2)  # columns
    new_pos = pos.copy().astype(np.float32)
    new_pos[:, 2] = height
    new_pos += l2w[:, :, 2] * pos[:, 2:3]  # local_offset = l2w @ (0,0,z)
    transform = l2w if to_world else np.linalg.inv(l2w)
    return new_pos, transform.astype(np.float32)


def sphere_get_uv(ud, block_id_x, block_id_y, block_x, block_y):
    """5x2-block icosphere-like UV unwrap (wangtile.rs:1411-1451). All args
    [N] arrays; returns uv [N,2] with u in [0,2pi], v in [-pi/2,pi/2]."""
    xmax = ud.tile_map_wh[0] * ud.tile_width
    block_w = xmax / 5.0
    bx, by = block_x, block_y
    u = np.zeros_like(bx)
    v = np.zeros_like(bx)

    top = block_id_y == 0.0
    lower_tri = by < bx

    # top block, lower triangle
    m = top & lower_tri
    den = block_w - (bx - by)
    safe = np.where(np.abs(den) < 1e-20, 1.0, den)
    u = np.where(m, np.where(bx - by == block_w, 0.0, (by / safe + block_id_x) / 5.0), u)
    v = np.where(m, (block_w - (bx - by)) / block_w / 3.0, v)
    # top block, upper triangle
    m = top & ~lower_tri
    u = np.where(m, (bx / block_w + block_id_x) / 5.0 + (by - bx) / block_w * 0.1, u)
    v = np.where(m, (by - bx) / block_w / 3.0 + 1.0 / 3.0, v)
    # bottom block, lower triangle
    m = ~top & lower_tri
    u = np.where(m, (bx / block_w + block_id_x) / 5.0 + (block_w - (bx - by)) / block_w * 0.1, u)
    v = np.where(m, (block_w - (bx - by)) / block_w / 3.0 + 1.0 / 3.0, v)
    # bottom block, upper triangle
    m = ~top & ~lower_tri
    den = block_w - (by - bx)
    safe = np.where(np.abs(den) < 1e-20, 1.0, den)
    u = np.where(m, np.where(by - bx == block_w, 0.0, (bx / safe + block_id_x) / 5.0 + 0.1), u)
    v = np.where(m, (by - bx) / block_w / 3.0 + 2.0 / 3.0, v)

    u = u + 0.5 * np.floor(v)
    u = u * 2.0 * np.pi
    v = (v - 0.5) * np.pi
    return np.stack([u, v], axis=1)


def sphere_uv_to_pos(uv):
    return np.stack(
        [
            np.cos(uv[:, 1]) * np.cos(uv[:, 0]),
            np.cos(uv[:, 1]) * np.sin(uv[:, 0]),
            np.sin(uv[:, 1]),
        ],
        axis=1,
    ).astype(np.float32)


def sphere_surface(ud, map_coord, pos, origin_pos, to_world: bool = True):
    """Sphere surface mapping (wangtile.rs:1406-1489). map_coord [N,2] int,
    pos [N,3], origin_pos = coord_to_pos(map_to_coord((0,0))) [3]."""
    ymax = ud.tile_map_wh[1] * ud.tile_width
    block_w = ud.tile_map_wh[0] * ud.tile_width / 5.0
    p = pos.astype(np.float32) - np.asarray(origin_pos, np.float32)
    block_id_x = (5 * map_coord[:, 0] // ud.tile_map_wh[0]).astype(np.float32)
    block_id_y = (2 * map_coord[:, 1] // ud.tile_map_wh[1]).astype(np.float32)
    bx = p[:, 0] - block_id_x * block_w
    by = p[:, 1] - block_id_y * block_w

    r = np.float32(ud.sphere_radius)
    uv = sphere_get_uv(ud, block_id_x, block_id_y, bx, by)
    local_z = sphere_uv_to_pos(uv)
    new_pos = local_z * r

    dt = DELTA * ymax
    pr = sphere_uv_to_pos(sphere_get_uv(ud, block_id_x, block_id_y, bx + dt, by)) * r
    pl = sphere_uv_to_pos(sphere_get_uv(ud, block_id_x, block_id_y, bx - dt, by)) * r
    pu = sphere_uv_to_pos(sphere_get_uv(ud, block_id_x, block_id_y, bx, by + dt)) * r
    pd = sphere_uv_to_pos(sphere_get_uv(ud, block_id_x, block_id_y, bx, by - dt)) * r
    local_x = (pr - pl) / (2.0 * dt)
    local_y = (pu - pd) / (2.0 * dt)

    l2w = np.stack([local_x, local_y, local_z], axis=2)
    new_pos = new_pos + l2w[:, :, 2] * pos[:, 2:3]
    transform = l2w if to_world else np.linalg.inv(l2w)
    return new_pos.astype(np.float32), transform.astype(np.float32)
