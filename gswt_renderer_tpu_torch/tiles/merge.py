"""Selective merging of tile groups (wangtile.rs:722-1027).

Axis merge: pick the camera-forward neighbor direction and merge 3-wide rows
outward from merge_tile_dist.0 to .1. Edge merge (the paper default): score
every visible tile edge by |edge_normal . view_dir| ascending (most edge-on
first), greedily union the top-k edges under a threshold into groups,
convexify the groups, then mark the member nearest the camera MergedFrom and
the rest MergedTo. Edge scoring/visibility is fully vectorized; the greedy
union loop runs over at most top-k entries.
"""

from __future__ import annotations

import numpy as np

from ..core.config import SurfaceType
from .structures import MergeStatus


def _reset_merge(eng):
    eng.merge_status[:] = MergeStatus.NONE
    eng.merge_to[:] = -1
    eng.merge_groups = {}


def _apply_group(eng, group, camera_pos):
    """Assign MergedFrom/MergedTo for one sorted group (wangtile.rs:992-1026)."""
    h = eng.user_data.tile_map_wh[1]
    gi = np.asarray(group, np.int64)
    ci, cj = gi // h, gi % h
    d2 = np.sum((eng.tile_center[ci, cj] - camera_pos[None, :]) ** 2, axis=1)
    min_k = int(np.argmin(d2))
    host = int(group[min_k])
    for k, mi in enumerate(group):
        i, j = mi // h, mi % h
        if k == min_k:
            eng.merge_status[i, j] = MergeStatus.MERGED_FROM
        else:
            eng.merge_status[i, j] = MergeStatus.MERGED_TO
            eng.merge_to[i, j] = host
    eng.merge_groups[host] = list(group)


def selective_merge_axis(eng, camera_pos, view_proj):
    """wangtile.rs:722-825 (plane / height map only, as in the reference)."""
    ud = eng.user_data
    _reset_merge(eng)
    if ud.surface_type == SurfaceType.SPHERE:
        d2 = np.sum(
            (eng.tile_center.reshape(-1, 3) - camera_pos[None, :]) ** 2, axis=1
        )
        h = ud.tile_map_wh[1]
        flat = (
            np.arange(d2.shape[0]).reshape(ud.tile_map_wh[0], h).transpose().reshape(-1)
        )
        # index order is i*h+j already; just argmin over index order
        mi = int(np.argmin(d2.reshape(ud.tile_map_wh[0], h).reshape(-1)))
        sort_center_mc = eng.index_to_map(mi)
    else:
        sort_center_mc = eng.coord_to_map(eng.center_coord)

    cam_dir = view_proj[2, :3] / np.linalg.norm(view_proj[2, :3])
    best_proj = 0.0
    merge_dir = -1
    for check_i in range(4):
        nb = eng._neighbor(sort_center_mc, check_i)
        if nb is None:
            continue
        n_mc, _ = nb
        tile_pos = eng.tile_center[n_mc[0], n_mc[1]]
        v = tile_pos - camera_pos
        proj = float(v @ cam_dir / np.linalg.norm(v))
        if best_proj < proj:
            best_proj = proj
            merge_dir = check_i
    if merge_dir < 0:
        return

    merge_neighbors = [(3, 1), (0, 2), (1, 3), (2, 0)]
    mc = sort_center_mc
    ok = True
    for _ in range(ud.merge_tile_dist[0]):
        nb = eng._neighbor(mc, merge_dir)
        if nb is None:
            return
        mc = nb[0]
    for i in range(ud.merge_tile_dist[0], ud.merge_tile_dist[1]):
        center_index = eng.map_to_index(mc)
        nb1 = eng._neighbor(mc, merge_neighbors[merge_dir][0])
        nb2 = eng._neighbor(mc, merge_neighbors[merge_dir][1])
        nxt = eng._neighbor(mc, merge_dir)
        if nb1 is None or nb2 is None or nxt is None:
            break
        n1, n2 = nb1[0], nb2[0]
        if (
            eng.merge_status[mc[0], mc[1]] != MergeStatus.NONE
            or eng.merge_status[n1[0], n1[1]] != MergeStatus.NONE
            or eng.merge_status[n2[0], n2[1]] != MergeStatus.NONE
        ):
            eng.log(f"axis merge hit already-merged tiles at distance {i}")
            break
        group = [eng.map_to_index(n1), center_index, eng.map_to_index(n2)]
        # reference marks the row center MergedFrom regardless of distance
        # (wangtile.rs:810-821)
        eng.merge_status[mc[0], mc[1]] = MergeStatus.MERGED_FROM
        eng.merge_status[n1[0], n1[1]] = MergeStatus.MERGED_TO
        eng.merge_to[n1[0], n1[1]] = center_index
        eng.merge_status[n2[0], n2[1]] = MergeStatus.MERGED_TO
        eng.merge_to[n2[0], n2[1]] = center_index
        eng.merge_groups[center_index] = group
        mc = nxt[0]


def _score_edges(eng, camera_pos, view_proj):
    """Vectorized edge visibility + scoring (wangtile.rs:832-906). Returns
    (map_index[], edge_index[], dot_abs[], normalized_dot[])."""
    ud = eng.user_data
    w, h = ud.tile_map_wh
    flat_index = np.arange(w * h).reshape(w, h)

    n_coord = eng.neighbor_coord  # [W,H,4,2]
    valid = n_coord[..., 0] >= 0
    n_index = np.where(valid, n_coord[..., 0] * h + n_coord[..., 1], -1)
    # dedup: reference scans tiles in index order and skips edges to
    # already-visited neighbors -> keep edges with neighbor_index > this index
    keep = valid & (n_index > flat_index[..., None])

    edge_pos = eng.edge_pos  # [W,H,4,3]
    edge_normal = eng.edge_normal
    c1 = eng.corner_pos
    c2 = np.roll(eng.corner_pos, -1, axis=2)
    w1z = eng.corner_to_world[..., :, 2]  # [W,H,4,3] (z column per corner)
    w2z = np.roll(w1z, -1, axis=2)

    view_dir = edge_pos - camera_pos[None, None, None, :]
    view_len = np.linalg.norm(view_dir, axis=-1)
    keep &= view_len > 0.0
    # back-facing corner check (wangtile.rs:876-879)
    keep &= ~(
        (np.einsum("whej,whej->whe", view_dir, w1z) > 0.0)
        | (np.einsum("whej,whej->whe", view_dir, w2z) > 0.0)
    )
    # off-screen check (wangtile.rs:881-897)
    with np.errstate(divide="ignore", invalid="ignore"):
        def project(c):
            hom = np.concatenate([c, np.ones_like(c[..., :1])], axis=-1)
            p = np.einsum("rc,whec->wher", view_proj, hom)
            return p[..., :3] / p[..., 3:4]

        p1 = project(c1)
        p2 = project(c2)

    clip = 1.0

    def out(p):
        return (
            (p[..., 2] < -clip)
            | (p[..., 0] < -clip)
            | (p[..., 0] > clip)
            | (p[..., 1] < -clip)
            | (p[..., 1] > clip)
        )

    keep &= ~(out(p1) & out(p2))

    dot_abs = np.abs(np.einsum("whej,whej->whe", edge_normal, view_dir))
    with np.errstate(divide="ignore", invalid="ignore"):
        norm_dot = np.where(view_len > 0, dot_abs / view_len, 0.0)

    sel = np.where(keep.reshape(-1))[0]
    map_idx = np.repeat(flat_index.reshape(-1), 4)[sel]
    edge_idx = np.tile(np.arange(4), w * h)[sel]
    return map_idx, edge_idx, dot_abs.reshape(-1)[sel], norm_dot.reshape(-1)[sel]


def selective_merge_edge(eng, camera_pos, view_proj):
    """wangtile.rs:827-1027."""
    ud = eng.user_data
    w, h = ud.tile_map_wh
    _reset_merge(eng)

    map_idx, edge_idx, dot_abs, norm_dot = _score_edges(eng, camera_pos, view_proj)
    order = np.argsort(dot_abs, kind="stable")

    # Greedy group building over accepted top-k edges (wangtile.rs:910-956)
    topk = 0
    merge_map = np.full(w * h, -1, np.int64)
    merge_groups: list[list[int]] = []
    for e in order:
        if topk >= ud.merge_topk:
            break
        if norm_dot[e] > ud.merge_dot_threshold:
            continue
        mi = int(map_idx[e])
        mc = (mi // h, mi % h)
        n_mc, _ = eng._neighbor(mc, int(edge_idx[e]))
        ni = eng.map_to_index(n_mc)
        gi_a = merge_map[mi]
        gi_b = merge_map[ni]
        if gi_a < 0 and gi_b < 0:
            gi = len(merge_groups)
            merge_groups.append([mi, ni])
            merge_map[mi] = gi
            merge_map[ni] = gi
        elif gi_a >= 0 and gi_b < 0:
            merge_groups[gi_a].append(ni)
            merge_map[ni] = gi_a
        elif gi_a < 0 and gi_b >= 0:
            merge_groups[gi_b].append(mi)
            merge_map[mi] = gi_b
        elif gi_a != gi_b:
            for g_mi in merge_groups[gi_b]:
                merge_map[g_mi] = gi_a
            merge_groups[gi_a].extend(merge_groups[gi_b])
            merge_groups[gi_b] = []
        topk += 1

    # Convexify: absorb tiles adjacent to a group on 2+ sides
    # (wangtile.rs:959-990)
    for gi in range(len(merge_groups)):
        members = set(merge_groups[gi])
        neighbors_seen = set()
        j = 0
        while j < len(merge_groups[gi]):
            t_mi = merge_groups[gi][j]
            t_mc = (t_mi // h, t_mi % h)
            for n_i in range(4):
                nb = eng._neighbor(t_mc, n_i)
                if nb is None:
                    continue
                n_mc, _ = nb
                ni = eng.map_to_index(n_mc)
                if ni in members:
                    continue
                if ni in neighbors_seen:
                    other = merge_map[ni]
                    if other >= 0 and other != gi:
                        for g_mi in merge_groups[other]:
                            merge_map[g_mi] = gi
                            members.add(g_mi)
                        merge_groups[gi].extend(merge_groups[other])
                        merge_groups[other] = []
                    elif other < 0:
                        merge_groups[gi].append(ni)
                        members.add(ni)
                        merge_map[ni] = gi
                else:
                    neighbors_seen.add(ni)
            j += 1

    for group in merge_groups:
        if group:
            group.sort()
            _apply_group(eng, group, camera_pos)
