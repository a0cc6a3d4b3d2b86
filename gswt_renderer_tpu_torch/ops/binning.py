"""Tile binning: expand projected splats into (image-tile, splat) pairs,
order them, and build the pair table the compositor reads.

The wgpu reference rasterizes via instanced quads; here, as in the JAX
package, each splat lands in every (tile_h x tile_w) pixel block its bbox
overlaps, and within a tile splats keep front-to-back stream order so
ordered alpha blending is exact.

Every domain is sized exactly from the frame's own counts: one host sync
reads the pair total, the pairs are enumerated splat-major (so within a
tile they ascend in stream slot), the exact ellipse-tile cull moves pairs
that cannot reach the cutoff to the dead key `n_tiles`, and one stable sort
by tile yields each tile's run in the joint (tile, slot) order.
"""

from __future__ import annotations

import torch


def grid_dims(image_wh, tile_wh):
    """(ntx, nty, n_tiles) with packing-budget validation."""
    w_img, h_img = image_wh
    tw, th = tile_wh
    ntx = -(-w_img // tw)
    nty = -(-h_img // th)
    n_tiles = ntx * nty
    # kept from the JAX package so both accept the same configurations
    if ntx > 256 or nty > 256:
        raise ValueError(
            f"tile grid {ntx}x{nty} exceeds the 256x256 bbox packing budget; "
            "increase tile_w/tile_h for this resolution"
        )
    if n_tiles >= 1 << 24:
        raise ValueError(f"n_tiles {n_tiles} exceeds the 24-bit worklist packing")
    return ntx, nty, n_tiles


def _expand(x0, y0, nx, count, *, ntx):
    """Enumerate the pairs of inclusive tile bboxes, primitive-major:
    pair k of primitive i covers tile (x0 + k % nx, y0 + k // nx).
    Returns (prim [total] i64, tile [total] i64). One host sync."""
    total = int(count.sum())
    prim = torch.repeat_interleave(
        torch.arange(count.shape[0], device=count.device), count,
        output_size=total)
    offs = torch.cumsum(count, 0) - count
    k = torch.arange(total, device=count.device) - offs[prim]
    nxp = nx[prim]
    tx = x0[prim] + k % nxp
    ty = y0[prim] + torch.div(k, nxp, rounding_mode="floor")
    return prim, ty * ntx + tx


def expand_bboxes(x0, x1, y0, y1, ok, *, ntx):
    """Expand per-primitive tile bboxes (inclusive, pre-clipped to the grid)
    into (tile, primitive) pairs, sorted by tile with original order kept
    inside each tile. Returns (sorted_key, sorted_prim, total)."""
    nx = torch.where(ok, x1 - x0 + 1, 0)
    ny = torch.where(ok, y1 - y0 + 1, 0)
    prim, tile = _expand(x0, y0, nx, nx * ny, ntx=ntx)
    sorted_key, order = torch.sort(tile, stable=True)
    return sorted_key, prim[order], prim.shape[0]


def tile_ranges(sorted_key, n_tiles):
    """Per-tile runs [range_start, range_end) of the tile-sorted pairs;
    empty tiles get the empty range (0, 0), as in the JAX worklist."""
    tile_idx = torch.arange(n_tiles, device=sorted_key.device,
                            dtype=sorted_key.dtype)
    rs = torch.searchsorted(sorted_key, tile_idx, side="left")
    re_ = torch.searchsorted(sorted_key, tile_idx, side="right")
    live = re_ > rs
    return (torch.where(live, rs, 0).to(torch.int32),
            torch.where(live, re_, 0).to(torch.int32))


def build_worklist(range_start, range_end, *, chunk: int):
    """The (tile, chunk) worklist of the tiles with pairs: for tile t, the
    global chunks floor(rs/C) .. floor((re-1)/C), tile-major. A worklist
    entry is where the compositor tests its early exit."""
    rs = range_start.long()
    re_ = range_end.long()
    live = re_ > rs
    c0 = torch.div(rs, chunk, rounding_mode="floor")
    c1 = torch.div(re_ - 1, chunk, rounding_mode="floor")
    n_e = torch.where(live, c1 - c0 + 1, 0)
    tiles = torch.arange(rs.shape[0], device=rs.device)
    n = int(n_e.sum())
    entry_tile = torch.repeat_interleave(tiles, n_e, output_size=n)
    first = torch.cumsum(n_e, 0) - n_e
    rank = torch.arange(n, device=rs.device) - first[entry_tile]
    return dict(entry_tile=entry_tile.to(torch.int32),
                entry_chunk=(c0[entry_tile] + rank).to(torch.int32))


def build_pair_table(sorted_key, dead, cx, cy, qa, qb, qc, z, r, g, b, a, *,
                     ntx, n_tiles, tile_wh, src=None):
    """Assemble the [16, P] raster table with the exponent quadratic
    RECENTERED to each pair's raster-tile origin:

      e(u, v) = k0 u^2 + k1 uv + k2 v^2 + k3 u + k4 v + k5,   (u, v) local

    algebraically identical to the global monomial form but with operand
    magnitudes bounded by the tile size instead of the image size.

    Row 11 carries ln(alpha) (-inf for dead/transparent pairs); row 12 the
    pair's STREAM SLOT as f32 (exact to 2^24)."""
    tw, th = tile_wh
    tile_c = torch.clamp(sorted_key, max=n_tiles - 1)
    ox = (tile_c % ntx * tw).to(torch.float32)
    oy = (torch.div(tile_c, ntx, rounding_mode="floor") * th).to(torch.float32)
    dx = cx - ox
    dy = cy - oy
    av = qa * dx + qb * dy
    bv = qb * dx + qc * dy
    k5 = torch.where(dead, -1e30, -(dx * av + dy * bv))
    zero = torch.zeros_like(z)
    src_row = zero if src is None else src.to(torch.float32)
    return torch.stack(
        [-qa, -2.0 * qb, -qc, 2.0 * av, 2.0 * bv, k5,
         z, zero, r, g, b, torch.log(a), src_row] + [zero] * 3,
        dim=0,
    )


def _rect_min_q(qa, qb, qc, lx0, lx1, ly0, ly1):
    """Min of the PSD quadratic Q(x,y) = qa x^2 + 2 qb xy + qc y^2 over
    the rectangle [lx0,lx1] x [ly0,ly1] (coordinates relative to the splat
    center). Zero when the center is inside; else the min lies on one of
    the four edges, each a 1D quadratic minimized at its clamped vertex."""
    inside = (lx0 <= 0.0) & (0.0 <= lx1) & (ly0 <= 0.0) & (0.0 <= ly1)
    tiny = 1e-20

    def edge_x(dx):  # x fixed at dx, y in [ly0, ly1]
        t = torch.clamp(-qb * dx / torch.clamp(qc, min=tiny), ly0, ly1)
        return qa * dx * dx + 2.0 * qb * dx * t + qc * t * t

    def edge_y(dy):  # y fixed at dy, x in [lx0, lx1]
        t = torch.clamp(-qb * dy / torch.clamp(qa, min=tiny), lx0, lx1)
        return qc * dy * dy + 2.0 * qb * dy * t + qa * t * t

    m = torch.minimum(
        torch.minimum(edge_x(lx0), edge_x(lx1)),
        torch.minimum(edge_y(ly0), edge_y(ly1)),
    )
    return torch.where(inside, 0.0, m)


# conservative margin over the exp(-4) cutoff, as in the JAX package (which
# sized it for its fast profile's reduced-precision exponent)
_CULL_MARGIN = 0.05


def _cull_pair_tiles(tiles, cx, cy, qa, qb, qc, *, ntx, n_tiles, tile_wh):
    """Exact ellipse-tile cull: remap pairs whose quadratic cannot reach
    the exp(-4) discard threshold at ANY pixel center of their tile to the
    dead sentinel (n_tiles). The compositor masks those fragments to zero
    anyway, so only dead work is removed. Pixel centers sit at +0.5
    offsets, so the test rect is inset by 0.5 on every side."""
    tw, th = tile_wh
    t_c = torch.clamp(tiles, max=n_tiles - 1)
    ox = (t_c % ntx * tw).to(torch.float32)
    oy = (torch.div(t_c, ntx, rounding_mode="floor") * th).to(torch.float32)
    minq = _rect_min_q(
        qa, qb, qc,
        ox + 0.5 - cx, ox + (tw - 0.5) - cx,
        oy + 0.5 - cy, oy + (th - 0.5) - cy,
    )
    return torch.where(minq > 4.0 + _CULL_MARGIN, n_tiles, tiles)


def _dilate_max2(zimg):
    """2x2 max-window image: out[y, x] = max of zimg over
    {y, y+1} x {x, x+1} (clipped at the grid edge). A splat whose CLIPPED
    tile bbox is <= 2x2 starting at (x0, y0) has its whole bbox inside
    that window, so one lookup conservatively bounds the bbox max."""
    zx = torch.cat([torch.maximum(zimg[:, :-1], zimg[:, 1:]), zimg[:, -1:]], 1)
    return torch.cat([torch.maximum(zx[:-1, :], zx[1:, :]), zx[-1:, :]], 0)


def _zmax_lookup(tx, ty, zimg):
    """Per-lane zimg[ty, tx] ([nty, ntx] f32); 0.0 for lanes off the grid."""
    nty, ntx = zimg.shape
    inb = (ty >= 0) & (ty < nty) & (tx >= 0) & (tx < ntx)
    t = torch.clamp(ty, 0, nty - 1) * ntx + torch.clamp(tx, 0, ntx - 1)
    return torch.where(inb, zimg.reshape(-1)[t], 0.0)


def bin_pairs(p, *, image_wh, tile_wh, chunk: int, cull_exact: bool = True,
              occ_zimg=None):
    """p: projection outputs (front-to-back order, S lanes; the lane index
    is the stream slot). Exact profile.

    occ_zimg (optional [nty, ntx] f32): per-raster-tile MAX of the proxy
    depth the compositor tests against. When given, enables the proxy-depth
    occlusion cull -- the equivalent of the early-z the reference gets from
    its depth pre-pass (renderer.rs:179-185, proxy.rs:119-125): a pair whose
    z is >= the max proxy depth anywhere in its tile fails `z < depth` at
    EVERY pixel (ops/raster.py), so dropping it changes no pixel. Two
    levels, on the same z the compositor tests: splats whose clipped bbox
    is <= 2x2 tiles test against the 2x2-dilated max image and leave the
    stream before the pair expansion; every enumerated pair of the rest
    tests its own tile.

    Returns dict:
      table — [16, dom] f32 rows k0..k5 (recentered to each pair's tile
        origin, build_pair_table), z, 0, r, g, b, ln a, slot, 0 x3; dom is
        the pair count rounded up to a multiple of `chunk` (at least one
        chunk), the tail and the culled pairs dead (k5 = -1e30, ln a = -inf)
      range_start/range_end [n_tiles] i32 — each tile's run of the table
      n_pairs — bbox pair demand (int), n_pairs_kept — pairs in tile runs
        after the culls (0-d tensor), n_live — visible splats (0-d tensor)
    """
    w_img, h_img = image_wh
    tw, th = tile_wh
    ntx, nty, n_tiles = grid_dims(image_wh, tile_wh)

    cx, cy = p["cx"], p["cy"]
    ex, ey = p["ext_x"], p["ext_y"]
    # clamping before the integer conversion matches XLA's saturating
    # float->int convert for off-grid values
    x0 = torch.clamp(torch.floor((cx - ex) / tw), 0, ntx - 1).long()
    x1 = torch.clamp(torch.floor((cx + ex) / tw), 0, ntx - 1).long()
    y0 = torch.clamp(torch.floor((cy - ey) / th), 0, nty - 1).long()
    y1 = torch.clamp(torch.floor((cy + ey) / th), 0, nty - 1).long()
    onscreen = ((cx + ex >= 0) & (cx - ex < w_img)
                & (cy + ey >= 0) & (cy - ey < h_img))
    ok = p["valid"] & onscreen
    if occ_zimg is not None:
        small = (x1 - x0 <= 1) & (y1 - y0 <= 1)
        ok = ok & ~(small & (p["z"] >= _zmax_lookup(
            x0, y0, _dilate_max2(occ_zimg))))
    nx = torch.where(ok, x1 - x0 + 1, 0)
    ny = torch.where(ok, y1 - y0 + 1, 0)
    prim, tiles = _expand(x0, y0, nx, nx * ny, ntx=ntx)
    n_pairs = prim.shape[0]

    qa, qb, qc = p["q"]
    cr, cg, cb, ca = p["color"]
    if occ_zimg is not None:
        occluded = p["z"][prim] >= occ_zimg.reshape(-1)[tiles]
        tiles = torch.where(occluded, n_tiles, tiles)
    if cull_exact:
        tiles = _cull_pair_tiles(
            tiles, cx[prim], cy[prim], qa[prim], qb[prim], qc[prim],
            ntx=ntx, n_tiles=n_tiles, tile_wh=tile_wh)
    # primitive-major enumeration + stable sort = joint (tile, slot) order
    tile_of, order = torch.sort(tiles, stable=True)
    src = prim[order]

    dom = max(-(-n_pairs // chunk), 1) * chunk
    pad = dom - n_pairs
    if pad:
        tile_of = torch.cat([tile_of, tile_of.new_full((pad,), n_tiles)])
        src = torch.cat([src, src.new_zeros(pad)])
    rows = torch.stack([cx, cy, qa, qb, qc, p["z"], cr, cg, cb, ca])
    rows = torch.cat([rows[:, src[:n_pairs]], rows.new_zeros((10, pad))], 1)
    dead = tile_of >= n_tiles
    cxg, cyg, qag, qbg, qcg, zg, rg, gg, bg, ag = rows
    table = build_pair_table(
        tile_of, dead, cxg, cyg, qag, qbg, qcg, zg, rg, gg, bg,
        torch.where(dead, 0.0, ag),
        ntx=ntx, n_tiles=n_tiles, tile_wh=tile_wh, src=src,
    )
    range_start, range_end = tile_ranges(tile_of, n_tiles)
    return dict(
        table=table,
        range_start=range_start,
        range_end=range_end,
        n_pairs=n_pairs,
        n_pairs_kept=(range_end - range_start).sum(),
        n_live=ok.sum(),
    )
