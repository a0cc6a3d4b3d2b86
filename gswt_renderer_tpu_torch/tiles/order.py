"""Painter's order across tiles (wangtile.rs:1029-1218): four strategies.

- Distance: far-to-near by squared distance.
- Viewport: by view-space depth (z row of the view-projection).
- Object: BFS from the nearest tile, reversed.
- Graph (paper default): a DAG with one edge per shared tile edge, oriented by
  the sign of edge_normal . view_dir, topologically sorted; nodes on cycles
  are removed and appended (rendered first after the global reverse).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from .structures import MergeStatus


def _active_mask(eng):
    return (eng.merge_status != MergeStatus.MERGED_TO).reshape(-1)


def sort_tiles_by_distance(eng, camera_pos):
    """wangtile.rs:1029-1047: ascending dist^2, then reversed (far first)."""
    act = _active_mask(eng)
    idx = np.where(act)[0]
    c = eng.tile_center.reshape(-1, 3)[idx]
    d2 = np.sum((camera_pos[None, :] - c) ** 2, axis=1)
    order = np.argsort(d2, kind="stable")[::-1]
    return idx[order].tolist()


def sort_tiles_by_viewport(eng, view_proj):
    """wangtile.rs:1049-1070: by z-row dot of tile center, reversed."""
    act = _active_mask(eng)
    idx = np.where(act)[0]
    c = eng.tile_center.reshape(-1, 3)[idx]
    keys = c @ view_proj[2, :3]
    order = np.argsort(keys, kind="stable")[::-1]
    return idx[order].tolist()


def sort_tiles_bfs(eng, camera_pos):
    """wangtile.rs:1072-1113: BFS from the nearest active tile, reversed."""
    w, h = eng.user_data.tile_map_wh
    act = _active_mask(eng)
    c = eng.tile_center.reshape(-1, 3)
    d2 = np.sum((camera_pos[None, :] - c) ** 2, axis=1)
    d2 = np.where(act, d2, np.inf)
    start_idx = int(np.argmin(d2))
    start = (start_idx // h, start_idx % h)

    out = []
    seen = np.zeros((w, h), bool)
    q = deque([start])
    seen[start[0], start[1]] = True
    while q:
        mc = q.popleft()
        out.append(mc[0] * h + mc[1])
        for n_i in range(4):
            nb = eng._neighbor(mc, n_i)
            if nb is None:
                continue
            n_mc, _ = nb
            if not seen[n_mc[0], n_mc[1]]:
                q.append((int(n_mc[0]), int(n_mc[1])))
                seen[n_mc[0], n_mc[1]] = True
    out.reverse()
    return out


def sort_tiles_graph(eng, camera_pos):
    """wangtile.rs:1115-1218. Nodes = active (non-MergedTo) tiles (merged
    members collapse to their host); one edge per shared tile edge oriented
    toward the far side; Kahn toposort with deterministic cycle-node removal
    (lowest map index among remaining nodes — the reference removes whichever
    node petgraph's DFS reports; any node inside the cycle gives an equally
    valid painter order)."""
    ud = eng.user_data
    w, h = ud.tile_map_wh
    flat_index = np.arange(w * h).reshape(w, h)

    # host (group representative) per tile
    host = np.where(
        eng.merge_status.reshape(-1) == MergeStatus.MERGED_TO,
        eng.merge_to.reshape(-1),
        flat_index.reshape(-1),
    )

    # vectorized edge orientation
    n_coord = eng.neighbor_coord
    valid = n_coord[..., 0] >= 0
    n_index = np.where(valid, n_coord[..., 0] * h + n_coord[..., 1], -1)
    keep = valid & (n_index > flat_index[..., None])  # dedup, scan order

    view_dir = eng.edge_pos - camera_pos[None, None, None, :]
    nonzero = np.any(view_dir != 0.0, axis=-1)
    dot = np.einsum("whej,whej->whe", eng.edge_normal, view_dir)
    keep &= nonzero & (dot != 0.0)

    e_sel = np.where(keep.reshape(-1))[0]
    this_idx = np.repeat(flat_index.reshape(-1), 4)[e_sel]
    neigh_idx = n_index.reshape(-1)[e_sel]
    d = dot.reshape(-1)[e_sel]
    a = np.where(d > 0, host[this_idx], host[neigh_idx])
    b = np.where(d > 0, host[neigh_idx], host[this_idx])
    mask = a != b
    a, b = a[mask], b[mask]

    active = np.where(_active_mask(eng))[0]
    from .. import native

    result = native.toposort(a, b, active, int(w * h))
    if result is not None:
        return result.tolist()

    nodes = set(active.tolist())
    succ = {n: set() for n in nodes}
    pred = {n: set() for n in nodes}
    has_edge = set()
    for x, y in zip(a.tolist(), b.tolist()):
        if y not in succ[x]:
            succ[x].add(y)
            pred[y].add(x)
            has_edge.add(x)
            has_edge.add(y)

    indeg = {n: len(pred[n]) for n in nodes}
    alive = set(nodes)
    removed = []
    order = []
    ready = deque(sorted(n for n in alive if indeg[n] == 0))
    while alive:
        progressed = False
        while ready:
            n = ready.popleft()
            if n not in alive:
                continue
            alive.discard(n)
            order.append(n)
            progressed = True
            for m in succ[n]:
                if m in alive:
                    indeg[m] -= 1
                    if indeg[m] == 0:
                        ready.append(m)
        if alive:
            victim = min(alive)
            removed.append(victim)
            alive.discard(victim)
            for m in succ[victim]:
                if m in alive:
                    indeg[m] -= 1
                    if indeg[m] == 0:
                        ready.append(m)

    # only nodes with at least one edge are emitted; cycle-removed nodes are
    # appended, then the whole list reversed (wangtile.rs:1193-1217)
    out = [n for n in order if n in has_edge]
    out.extend(removed)
    out.reverse()
    return out
