"""The check of a judged frame's draw list: which tile instances, which LODs,
which splats and in which order the builder drew.

The draw list is the builder's; the reference renders from it only once
these numbers have held it to the semantics of the reference renderer's
tile engine (wangtile.rs), as the port documents them at commit 6240227d
(``tiles/wangtile.py`` ``_update_tile_map``, ``_update_lod``,
``sort_tiles``, ``_merged_sort``; ``tiles/surface.py``; ``tiles/order.py``):

- the map holds (2 half + 1)^2 cells around the centre coordinate
  floor(build camera / tile width), every cell drawn exactly once, alone
  (a presorted list) or as a member of a merged group (a stream), at its
  own position;
- the tiles form a Wang tiling: two neighbours' shared edge has one colour
  (tile id mod 16 holds the W, N, E, S colour bits), and the centre option
  (tile id // 16) is one the configuration offers. Which of the fitting
  tiles a cell holds is drawn from a generator along the camera's path, so
  the tiling is checked and not replayed;
- LOD: the first LOD whose transition distance reaches the cell's centre
  (its tile's LOD-0 centre / n_lod on the height surface), blended with the
  next lower LOD when the farthest AABB corner passes (1 - ratio) x its
  distance, else with the higher one when the nearest corner is within
  (1 + ratio) x the previous distance; the map's outer ring fades in and is
  not blended. A cell draws its LOD's splats, and the blended LOD's too;
- a merged member's splats are exactly its tile's splats of those LODs,
  each once, with their LOD ids; the stream is back to front along the
  group's presort view (the top-down one unless the group is a line), by
  the counting sort of the members' local depth keys; a lone cell's
  presort view is the one nearest to the camera's direction in the cell's
  frame;
- draw order: across an edge between two draws, the draw on the far side
  of the edge from the camera comes first (the Graph order), except where
  the orientations close a cycle.

The builder works from a camera pose the viewer had shortly before the
frame: its build from the last pose that moved `update_dist` away from the
one before, its sort from the pose of a recent frame. Each check reads the
pose among those candidates that suits the whole draw list best.
"""

from __future__ import annotations

import numpy as np

from .store import PRESORT_DIRS, presort_view_rows

DELTA = 0.001  # finite-difference step of the surface frame (wangtile.rs:1359)
# a distance this close to a threshold may round either way on the builder
EPS_DIST = 1e-3
# a presort view this close to the nearest in squared error is a tie
EPS_VIEW = 1e-4
BUCKETS = 65536
# the numbers `check` returns, each compared with its limit
NUMBERS = ("draw_cells_off", "merged_streams_off", "wang_edges_off", "draw_lod_off",
           "presort_views_off", "merged_stream_inversions", "draw_order_wrong_share")


# ------------------------------------------------------------------ #
# the height surface on the host (wangtile.rs:1220-1290, 1364-1405)
# ------------------------------------------------------------------ #
def _surface(hm, hm_wh, scene, pos, to_world):
    """(mapped position [N, 3], frame [N, 3, 3]: local-to-world columns, or
    its inverse) of points `pos` [N, 3] on the height surface. The tangent
    taps reuse the centre's four texels with extrapolated weights, as the
    reference does."""
    pos = np.asarray(pos, np.float32).reshape(-1, 3)
    n = pos.shape[0]
    half, tw, hms = scene["map_half_wh"], scene["tile_width"], scene["height_map_scale"]
    xr = np.float32((2 * half[0] + 1) * tw * hms[0])
    yr = np.float32((2 * half[1] + 1) * tw * hms[1])
    u = (pos[:, 0] + np.float32(half[0] * tw)) / xr
    v = (pos[:, 1] + np.float32(half[1] * tw)) / yr
    w, h = int(hm_wh[0]), int(hm_wh[1])
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    tx = (x - x0).astype(np.float32)
    ty = (y - y0).astype(np.float32)

    def texel(xi, yi):
        return hm[(yi % h) * w + (xi % w)]

    i00, i10, i01, i11 = texel(x0, y0), texel(x0 + 1, y0), texel(x0, y0 + 1), texel(x0 + 1, y0 + 1)

    def bil(a, b):
        return (i00 * (1 - a) + i10 * a) * (1 - b) + (i01 * (1 - a) + i11 * a) * b

    z = np.float32(hms[2])
    dx, dy = DELTA * w, DELTA * h
    height = bil(tx, ty) * z
    h_r, h_l = bil(tx + dx, ty) * z, bil(tx - dx, ty) * z
    h_u, h_d = bil(tx, ty + dy) * z, bil(tx, ty - dy) * z
    lx = np.zeros((n, 3), np.float32)
    lx[:, 0] = 1.0
    lx[:, 2] = (h_r - h_l) / (2.0 * DELTA * xr)
    ly = np.zeros((n, 3), np.float32)
    ly[:, 1] = 1.0
    ly[:, 2] = (h_u - h_d) / (2.0 * DELTA * yr)
    lz = np.cross(lx, ly)
    lz /= np.linalg.norm(lz, axis=1, keepdims=True)
    l2w = np.stack([lx, ly, lz], axis=2)
    out = pos.copy()
    out[:, 2] = height
    out += l2w[:, :, 2] * pos[:, 2:3]
    return out.astype(np.float32), (l2w if to_world else np.linalg.inv(l2w)).astype(np.float32)


def tile_shapes(store, n_lod):
    """Per tile: its LOD-0 centre as the map places it (x, y of the mean
    over n_lod, z 0) and its 8 AABB corners (wangtile.rs:71-111)."""
    n_tile = store["offsets"].shape[1]
    centers, corners = [], []
    sel = np.array([[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
                    [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]])
    for t in range(n_tile):
        o, c = store["offsets"][0, t], store["counts"][0, t]
        p = store["pos"][o:o + c]
        mean = (p.astype(np.float64).sum(axis=0) / c).astype(np.float32)
        mean[2] = 0.0
        centers.append((mean / np.float32(n_lod)).astype(np.float32))
        both = np.stack([p.min(axis=0), p.max(axis=0)])
        corners.append(both[sel, [0, 1, 2]])
    return np.stack(centers), np.stack(corners).astype(np.float32)


# ------------------------------------------------------------------ #
# the draw list taken apart
# ------------------------------------------------------------------ #
def _blocks(store, gs):
    """(lod, tile) of store rows `gs`."""
    n_lod, n_tile = store["offsets"].shape
    starts = store["offsets"].reshape(-1)
    b = np.searchsorted(starts, gs, side="right") - 1
    return b // n_tile, b % n_tile


def _decompose(draw, store, n_cells, height):
    """Per cell: its draw, its tile (-1 if none) and the LODs it draws (a
    bit mask); and the off counts of the cells and the merged streams."""
    n_lod = store["offsets"].shape[0]
    n = int(draw["n_draws"])
    cell_draw = np.full(n_cells, -1, np.int64)
    times = np.zeros(n_cells, np.int64)
    tile = np.full(n_cells, -1, np.int64)
    lods = np.zeros(n_cells, np.int64)
    cells_off = streams_off = 0
    members = {}
    ss = np.asarray(draw["stream_start"][:n], np.int64)
    single = np.asarray(draw["single_draw"][:n])
    cells_off += int(np.sum((ss >= 0) != (single != 0)))
    lone = np.where(ss < 0)[0]
    mc = np.asarray(draw["map_coord"][:n], np.int64)
    ci = mc[lone, 0] * height + mc[lone, 1]
    ok = (mc[lone, 0] >= 0) & (mc[lone, 1] >= 0) & (mc[lone, 1] < height) & (ci < n_cells)
    cells_off += int(np.sum(~ok))
    lone, ci = lone[ok], ci[ok]
    np.add.at(times, ci, 1)
    cell_draw[ci] = lone
    bl = np.asarray(draw["base_lod"][:n], np.int64)[lone]
    tile[ci] = np.asarray(draw["base_tile"][:n], np.int64)[lone]
    vl = np.asarray(draw["valid_lod_id"][:n], np.int64)[lone]
    in_list = (1 << bl) | np.where(bl + 1 < n_lod, 1 << (bl + 1), 0)
    lods[ci] = np.where(vl < 0, in_list, in_list & np.where(vl >= 0, 1 << np.maximum(vl, 0), 0))
    gs_all = draw["stream_gs_index"]
    gs_all = np.asarray(gs_all, np.int64) if gs_all is not None else None
    for r in np.where(ss >= 0)[0]:
        seg = slice(int(ss[r]), int(ss[r]) + int(draw["splat_count"][r]))
        gs = gs_all[seg]
        mid = np.asarray(draw["stream_map_id"][seg], np.int64)
        lid = np.asarray(draw["stream_lod_id"][seg], np.int64)
        bl_, bt_ = _blocks(store, gs)
        mem = np.unique(mid)
        members[int(r)] = mem
        bad_cell = (mem < 0) | (mem >= n_cells)
        cells_off += int(bad_cell.sum())
        mem = mem[~bad_cell]
        np.add.at(times, mem, 1)
        cell_draw[mem] = r
        for m in mem:
            sel = mid == m
            g, l_, t_ = gs[sel], bl_[sel], bt_[sel]
            ts = np.unique(t_)
            ls = np.unique(l_)
            want = int(sum(store["counts"][l, ts[0]] for l in ls)) if ts.shape[0] == 1 else -1
            if (ts.shape[0] != 1 or g.shape[0] != want or np.unique(g).shape[0] != g.shape[0]
                    or not np.array_equal(lid[sel], l_)):
                streams_off += 1
                continue
            tile[m] = ts[0]
            lods[m] = int(sum(1 << int(l) for l in ls))
    cells_off += int(np.sum(times != 1))
    return dict(cell_draw=cell_draw, tile=tile, lods=lods, members=members,
                cells_off=cells_off, streams_off=streams_off)


def _wang_off(tile, width, height, n_tile, n_center):
    t = tile.reshape(width, height)
    bad = int(np.sum((t < 0) | (t >= n_tile) | (t // 16 >= n_center)))
    tt = t % 16
    west, north, east, south = tt // 8 % 2, tt // 4 % 2, tt // 2 % 2, tt % 2
    bad += int(np.sum(east[:-1, :] != west[1:, :]))
    bad += int(np.sum(north[:, :-1] != south[:, 1:]))
    return bad


# ------------------------------------------------------------------ #
# LOD: the build pose
# ------------------------------------------------------------------ #
def _lod_expect(geo, trans, ratio, cam, center_coord, tw, width, height):
    """(drawn LOD mask, selected LOD, changing, to_lower, status != none,
    near a threshold) per cell at build pose `cam`."""
    dists = np.asarray(trans, np.float32)
    n_lod = dists.shape[0]
    cd = np.linalg.norm(geo["center"] - cam[None, :], axis=1)
    sel = np.minimum(np.searchsorted(dists, cd, side="left"), n_lod - 1)
    d = np.linalg.norm(geo["corners"] - cam[None, None, :], axis=2)
    min_d, max_d = d.min(axis=1), d.max(axis=1)
    thr_hi = dists[np.maximum(sel - 1, 0)] * np.float32(1.0 + ratio)
    thr_lo = dists[np.minimum(sel, n_lod - 1)] * np.float32(1.0 - ratio)
    hi = (sel > 0) & (min_d < thr_hi)
    lo = (sel < n_lod - 1) & (max_d > thr_lo)
    near = (np.abs(cd[:, None] - dists[None, :]).min(axis=1) < EPS_DIST) \
        | ((sel > 0) & (np.abs(min_d - thr_hi) < EPS_DIST)) \
        | ((sel < n_lod - 1) & (np.abs(max_d - thr_lo) < EPS_DIST))
    changing = hi | lo
    cam_u = (cam[0] - np.float32(center_coord[0] * tw)) / np.float32(tw)
    cam_v = (cam[1] - np.float32(center_coord[1] * tw)) / np.float32(tw)
    bf = np.ones((width, height), np.float32)
    bf[0, :] *= 1.0 - cam_u
    bf[width - 1, :] *= cam_u
    bf[:, 0] *= 1.0 - cam_v
    bf[:, height - 1] *= cam_v
    border = (bf != 1.0).reshape(-1)
    status = changing | border
    changing &= ~border
    mask = np.where(changing & lo, (1 << sel) | (1 << np.minimum(sel + 1, n_lod - 1)),
                    np.where(changing, (1 << sel) | (1 << np.maximum(sel - 1, 0)), 1 << sel))
    return mask, sel, changing, lo, status, near


def _lod_off(dec, draw, geo, trans, ratio, cam, center_coord, tw, width, height):
    mask, sel, changing, lo, status, near = _lod_expect(
        geo, trans, ratio, cam, center_coord, tw, width, height)
    off = dec["lods"] != mask
    n = int(draw["n_draws"])
    cd = dec["cell_draw"]
    lone_cell = (cd >= 0) & (np.asarray(draw["stream_start"][:n])[np.maximum(cd, 0)] < 0)
    r = cd[lone_cell]
    tl = np.asarray(draw["tile_lod"][:n], np.int64)[r]
    ch = np.asarray(draw["changing"][:n], np.int64)[r]
    ctl = np.asarray(draw["changing_to_lower"][:n], np.int64)[r]
    off[lone_cell] |= (tl != sel[lone_cell]) | (ch != changing[lone_cell]) \
        | (changing[lone_cell] & (ctl != lo[lone_cell].astype(np.int64)))
    count = int(np.sum(off & ~near))
    for r, mem in dec["members"].items():
        want = int(bool(status[mem].any()))
        if int(draw["changing"][r]) != want and not near[mem].any():
            count += 1
    return count


# ------------------------------------------------------------------ #
# order: the sort pose
# ------------------------------------------------------------------ #
def _view_err(frames, centers, cam):
    d = centers - cam[None, :]
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    local = np.einsum("nij,nj->ni", frames, d)
    return np.sum((local[:, None, :] - PRESORT_DIRS[None, :, :]) ** 2, axis=2)


def _bucket_inversions(keys):
    """Neighbours out of back-to-front order among the counting sort's
    buckets of `keys` (one bucket of slack)."""
    if keys.shape[0] < 2:
        return 0
    span = keys.max() - keys.min()
    if span <= 0:
        return 0
    b = np.floor((keys - keys.min()).astype(np.float32)
                 * (np.float32(BUCKETS - 1) / np.float32(span)))
    return int(np.sum(np.diff(b) >= 2))


def _sort_off(dec, draw, geo, edges, stream_inv, cam):
    """(presort views off, merged-stream inversions, draw-order violations,
    oriented edges) at sort pose `cam`."""
    n = int(draw["n_draws"])
    ss = np.asarray(draw["stream_start"][:n], np.int64)
    cd = dec["cell_draw"]
    lone = np.where(ss < 0)[0]
    mc = np.asarray(draw["map_coord"][:n], np.int64)[lone]
    cells = mc[:, 0] * geo["height"] + mc[:, 1]
    views_off = 0
    if lone.shape[0]:
        err = _view_err(geo["to_local"][cells], geo["center"][cells], cam)
        v = np.asarray(draw["base_view"][:n], np.int64)[lone]
        views_off += int(np.sum(err[np.arange(lone.shape[0]), v] > err.min(axis=1) + EPS_VIEW))
    inv = 0
    h = geo["height"]
    for r, mem in dec["members"].items():
        host = int(draw["map_coord"][r][0]) * h + int(draw["map_coord"][r][1])
        line = bool(np.all(mem // h == host // h) or np.all(mem % h == host % h))
        if line:
            err = _view_err(geo["to_local"][mem].mean(axis=0, keepdims=True),
                            geo["center"][mem].mean(axis=0, keepdims=True), cam)[0]
            ok = np.where(err <= err.min() + EPS_VIEW)[0]
        else:
            ok = np.array([PRESORT_DIRS.shape[0] - 1])
        inv += min(stream_inv[r][v] for v in ok)
    # draw order across the edges between two draws
    a, b, en, ep = edges
    dot = np.einsum("nj,nj->n", en, ep - cam[None, :])
    da, db = cd[a], cd[b]
    use = (da >= 0) & (db >= 0) & (da != db) & (dot != 0.0)
    # the far draw first: across a's edge b is farther when dot > 0
    wrong = np.where(dot > 0, da < db, db < da) & use
    return views_off, inv, int(wrong.sum()), int(use.sum())


def _edges(geo, width, height):
    """Each edge between two map cells once: (cell a, cell b, a's edge
    normal, a's edge midpoint)."""
    cp, cz = geo["corner_pos"], geo["corner_z"]
    c2 = np.roll(cp, -1, axis=1)
    nrm = (cz + np.roll(cz, -1, axis=1)) / 2.0
    en = np.cross(nrm, c2 - cp)
    norm = np.linalg.norm(en, axis=-1, keepdims=True)
    en = (en / np.where(norm == 0, 1.0, norm)).astype(np.float32)
    ep = (cp + c2) / 2.0
    ii, jj = np.meshgrid(np.arange(width), np.arange(height), indexing="ij")
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    a_l, b_l, e_l = [], [], []
    # edge 1 is the north edge (j + 1), edge 2 the east one (i + 1)
    m = jj < height - 1
    a_l.append(ii[m] * height + jj[m])
    b_l.append(ii[m] * height + jj[m] + 1)
    e_l.append(np.full(int(m.sum()), 1))
    m = ii < width - 1
    a_l.append(ii[m] * height + jj[m])
    b_l.append((ii[m] + 1) * height + jj[m])
    e_l.append(np.full(int(m.sum()), 2))
    a, b, e = np.concatenate(a_l), np.concatenate(b_l), np.concatenate(e_l)
    return a, b, en[a, e], ep[a, e]


def map_geometry(store, scene, hm, hm_wh, tile, center_coord, n_lod):
    """Cell centres and frames, AABB corners and the corner lattice of the
    map placed around `center_coord` with tiles `tile` [cells]."""
    half, tw = scene["map_half_wh"], float(scene["tile_width"])
    width, height = 2 * half[0] + 1, 2 * half[1] + 1
    centers0, aabb = tile_shapes(store, n_lod)
    t = np.maximum(tile, 0)
    ii, jj = np.meshgrid(np.arange(width), np.arange(height), indexing="ij")
    ci = (ii.reshape(-1) + center_coord[0] - half[0]).astype(np.int64)
    cj = (jj.reshape(-1) + center_coord[1] - half[1]).astype(np.int64)
    offs = np.zeros((width * height, 3), np.float32)
    offs[:, 0] = ci * tw
    offs[:, 1] = cj * tw
    center, to_local = _surface(hm, hm_wh, scene, centers0[t] + offs, False)
    corners, _ = _surface(hm, hm_wh, scene, (aabb[t] + offs[:, None, :]).reshape(-1, 3), True)
    d = np.array([[0, 0], [0, 1], [1, 1], [1, 0]])
    cpos = np.zeros((width * height, 4, 3), np.float32)
    cpos[:, :, 0] = (ci[:, None] + d[None, :, 0]) * tw
    cpos[:, :, 1] = (cj[:, None] + d[None, :, 1]) * tw
    cpos[:, :, 2] = centers0[t][:, 2:3]
    cp, cw = _surface(hm, hm_wh, scene, cpos.reshape(-1, 3), True)
    return dict(center=center, to_local=to_local, corners=corners.reshape(-1, 8, 3),
                corner_pos=cp.reshape(-1, 4, 3), corner_z=cw[:, :, 2].reshape(-1, 4, 3),
                offset=offs, height=height, width=width)


def check(draw, store, scene, hm, hm_wh, n_center, build_poses, sort_poses) -> tuple:
    """The draw list's numbers, and the reference's own corner positions of
    each draw (for the render-time culling). `build_poses` and
    `sort_poses` [K, 3] are the candidate camera positions."""
    half, tw = scene["map_half_wh"], float(scene["tile_width"])
    width, height = 2 * half[0] + 1, 2 * half[1] + 1
    n_lod, n_tile = store["offsets"].shape
    cc = tuple(int(v) for v in scene["center_coord"])
    dec = _decompose(draw, store, width * height, height)
    nums = dict(draw_cells_off=dec["cells_off"], merged_streams_off=dec["streams_off"],
                wang_edges_off=_wang_off(dec["tile"], width, height, n_tile, n_center))
    geo = map_geometry(store, scene, hm, hm_wh, dec["tile"], cc, n_lod)
    n = int(draw["n_draws"])
    ss = np.asarray(draw["stream_start"][:n], np.int64)
    lone = np.where(ss < 0)[0]
    mc = np.asarray(draw["map_coord"][:n], np.int64)
    cells = np.clip(mc[:, 0] * height + mc[:, 1], 0, width * height - 1)
    nums["draw_cells_off"] += int(np.sum(np.any(
        np.asarray(draw["offset"][:n], np.float32)[lone] != geo["offset"][cells[lone]], axis=1)))
    # build: the candidate poses whose centre coordinate is the map's
    bp = np.asarray(build_poses, np.float32).reshape(-1, 3)
    at_cc = np.all(np.floor(bp[:, :2] / np.float32(tw)).astype(np.int64) == np.array(cc), axis=1)
    lod = [_lod_off(dec, draw, geo, scene["transition_dist"],
                    scene["transition_width_ratio"], p, cc, tw, width, height) for p in bp[at_cc]]
    nums["draw_lod_off"] = min(lod) if lod else width * height
    # sort: each merged stream's inversions along every presort view
    rows = presort_view_rows()
    pos = store["pos"]
    stream_inv = {}
    for r in dec["members"]:
        seg = slice(int(ss[r]), int(ss[r]) + int(draw["splat_count"][r]))
        p = pos[np.asarray(draw["stream_gs_index"][seg], np.int64)]
        stream_inv[r] = [_bucket_inversions(np.trunc((p @ vz).astype(np.float64) * 4096.0))
                         for vz in rows]
    edges = _edges(geo, width, height)
    best = None
    for p in np.asarray(sort_poses, np.float32).reshape(-1, 3):
        views, inv, wrong, used = _sort_off(dec, draw, geo, edges, stream_inv, p)
        key = (views + inv, wrong)
        if best is None or key < best[0]:
            best = (key, views, inv, wrong, used)
    _, views, inv, wrong, used = best
    nums["presort_views_off"] = views
    nums["merged_stream_inversions"] = inv
    nums["draw_order_wrong_share"] = wrong / max(used, 1)
    corners = geo["corner_pos"][cells]
    return {k: float(v) for k, v in nums.items()}, corners
