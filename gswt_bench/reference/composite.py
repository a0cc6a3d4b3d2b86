"""The reference composite: every splat of the stream over every pixel of
its box, blended in stream order (back to front), vectorized.

The per-pixel arithmetic is the oracle's ``render_oracle`` (the frozen copy
of gswt.wgsl's fragment shader and the ONE / ONE_MINUS_SRC_ALPHA blend,
``gswt_renderer_tpu_torch/refrender/oracle.py`` at commit 6240227d): the
pixel box from the float32 centre and extents, the quad coordinates
solved from the major and minor axes, the A < -4 discard and the depth test
against the proxy depth. The blend is regrouped: for each pixel the weight
of splat i is its alpha times the product of (1 - alpha) over the splats in
front of it, taken as the exponential of a sum of logarithms in float64
over 16x16 pixel tiles, and the background is added under the remaining
transmittance. No splat is left out: the early exit of the program's
compositor is not copied.

`composite_sequential` is the control's compositor: a compositor kernel's
loop, front to back over each pixel's splats with the transmittance and
the colour carried from splat to splat, every operation rounded to the
given type.
"""

from __future__ import annotations

import torch

TILE = 16
BLOCK_PAIRS = 1 << 18
# a transmittance floor: log(1 - a) is clamped here so that an alpha of
# exactly 1 leaves finite sums (its weight below it is exp(-60) ~ 1e-26)
LOG_FLOOR = -60.0


def _pairs(table, width, height, bg, depth):
    """The frame's (splat, 16x16 tile) pairs, sorted by tile and within a
    tile in stream order, with the splat columns the blend reads."""
    dev = bg.device
    c = table["center_ndc"]
    z = table["z_ndc"]
    maj = table["major_px"]
    mnr = table["minor_px"]
    col = table["color"]
    cx = (c[:, 0] * 0.5 + 0.5) * width
    cy = (0.5 - c[:, 1] * 0.5) * height
    ext = maj.abs() + mnr.abs()
    x0 = torch.clamp(torch.floor(cx - ext[:, 0]), min=0).to(torch.int64)
    x1 = torch.clamp(torch.ceil(cx + ext[:, 0]) + 1, max=width).to(torch.int64)
    y0 = torch.clamp(torch.floor(cy - ext[:, 1]), min=0).to(torch.int64)
    y1 = torch.clamp(torch.ceil(cy + ext[:, 1]) + 1, max=height).to(torch.int64)
    m2 = maj[:, 0] * maj[:, 0] + maj[:, 1] * maj[:, 1]
    n2 = mnr[:, 0] * mnr[:, 0] + mnr[:, 1] * mnr[:, 1]
    live = (table["valid"] & (z >= 0.0) & (z <= 1.0) & (x0 < x1) & (y0 < y1)
            & (m2 > 0) & (n2 > 0) & torch.isfinite(cx) & torch.isfinite(cy))
    sid = torch.nonzero(live).squeeze(1)
    ntx = (width + TILE - 1) // TILE
    nty = (height + TILE - 1) // TILE
    tx0, tx1 = x0[sid] // TILE, (x1[sid] - 1) // TILE
    ty0, ty1 = y0[sid] // TILE, (y1[sid] - 1) // TILE
    nx = tx1 - tx0 + 1
    npair = nx * (ty1 - ty0 + 1)
    owner = torch.repeat_interleave(torch.arange(sid.shape[0], device=dev), npair)
    k = torch.arange(owner.shape[0], device=dev) - (torch.cumsum(npair, 0) - npair)[owner]
    tile = (ty0[owner] + k // nx[owner]) * ntx + tx0[owner] + k % nx[owner]
    tile, order = torch.sort(tile, stable=True)
    pair_splat = sid[owner[order]]
    del owner, k, order
    counts = torch.bincount(tile, minlength=ntx * nty)
    ends = torch.cumsum(counts, 0)

    return dict(width=width, height=height, ntx=ntx, nty=nty, tile=tile, pair_splat=pair_splat,
                c=c, z=z, maj=maj, mnr=mnr, col=col, x0=x0, x1=x1, y0=y0, y1=y1, m2=m2, n2=n2,
                lx=torch.arange(TILE * TILE, device=dev) % TILE,
                ly=torch.arange(TILE * TILE, device=dev) // TILE,
                zbuf=depth if depth is not None else torch.ones((height, width),
                                                               dtype=torch.float32, device=dev),
                out_rgb=torch.zeros((nty * TILE, ntx * TILE, 4), dtype=torch.float32, device=dev),
                out_t=torch.ones((nty * TILE, ntx * TILE), dtype=torch.float32, device=dev),
                row_used=torch.zeros(c.shape[0], dtype=torch.bool, device=dev),
                ends_h=ends.tolist())


def composite(table, width, height, bg, depth=None, *, min_t=None):
    """table: the projected stream (project.project). bg [H, W, 4] the
    background, depth [H, W] the proxy depth or None. Returns (image [H, W,
    4] float32, kept, rows): with min_t, kept counts the pixel-pairs that
    pass the discard and the depth test behind a transmittance >= min_t,
    and rows the splats that have one."""
    v = _pairs(table, width, height, bg, depth)
    ntx, nty = v["ntx"], v["nty"]
    kept, t_lo, ends_h = 0, 0, v["ends_h"]
    while t_lo < ntx * nty:
        p0 = ends_h[t_lo - 1] if t_lo else 0
        t_hi = t_lo + 1
        while t_hi < ntx * nty and ends_h[t_hi] - p0 <= BLOCK_PAIRS:
            t_hi += 1
        if ends_h[t_hi - 1] > p0:
            kept += _block(v, p0, ends_h[t_hi - 1], t_lo, t_hi, min_t)
        t_lo = t_hi
    img = v["out_rgb"][:height, :width] + v["out_t"][:height, :width, None] * bg
    return img, kept, int(v["row_used"].sum())


def _cumsum_pairs(x):
    """Running sum over the pairs (dim 0) of [pairs, pixels], scanned along
    contiguous rows: a scan across the outer dimension is far slower."""
    return torch.cumsum(x.T.contiguous(), 1).T


def _alpha(v, tile, s, dtype):
    """(alpha [pairs, 256] in `dtype`, zero where discarded or depth-tested
    away; the discard-and-depth mask; colour [pairs, 4] in `dtype`) of the
    pairs (tile, splat)."""
    width, height, ntx = v["width"], v["height"], v["ntx"]
    tyy, txx = tile // ntx, tile % ntx
    px = txx[:, None] * TILE + v["lx"][None, :]
    py = tyy[:, None] * TILE + v["ly"][None, :]
    inbox = ((px >= v["x0"][s][:, None]) & (px < v["x1"][s][:, None])
             & (py >= v["y0"][s][:, None]) & (py < v["y1"][s][:, None]))
    pxc = torch.clamp(px, max=width - 1)
    pyc = torch.clamp(py, max=height - 1)
    # pixel and centre positions stay float32; the Gaussian and the blend
    # run in `dtype` (the control lowers them)
    c = v["c"][s]
    maj = v["maj"][s].to(dtype)
    mnr = v["mnr"][s].to(dtype)
    gx = (pxc.to(torch.float32) + 0.5) / width * 2.0 - 1.0
    gy = 1.0 - (pyc.to(torch.float32) + 0.5) / height * 2.0
    dx = ((gx - c[:, 0:1]) * width).to(dtype)
    dy = ((gy - c[:, 1:2]) * height).to(dtype)
    qx = (dx * maj[:, 0:1] + dy * maj[:, 1:2]) / v["m2"][s].to(dtype)[:, None]
    qy = (dx * mnr[:, 0:1] + dy * mnr[:, 1:2]) / v["n2"][s].to(dtype)[:, None]
    a_exp = -(qx * qx + qy * qy)
    mask = inbox & (a_exp >= -4.0) & (v["z"][s][:, None] < v["zbuf"][pyc, pxc])
    col = v["col"][s].to(dtype)
    alpha = torch.where(mask, torch.exp(a_exp) * col[:, 3:4], 0.0)
    return alpha, mask, col


def _block(v, p0, p1, t_lo, t_hi, min_t):
    """Composite the pairs [p0, p1), which are tiles [t_lo, t_hi), into the
    frame's output; `v` holds the frame's splat columns, pairs and output."""
    ntx = v["ntx"]
    tile = v["tile"][p0:p1]
    s = v["pair_splat"][p0:p1]
    acc_dtype = torch.float64
    alpha, mask, col = _alpha(v, tile, s, torch.float32)
    lg = torch.clamp(torch.log1p(-alpha.to(acc_dtype)), min=LOG_FLOOR)
    csum = _cumsum_pairs(lg)
    # per tile: the sum through its last pair and before its first
    local_end = torch.tensor(v["ends_h"][t_lo:t_hi], device=tile.device) - p0
    nt = t_hi - t_lo
    tl = tile - t_lo
    end_sum = torch.zeros((nt, TILE * TILE), dtype=acc_dtype, device=tile.device)
    start_sum = torch.zeros_like(end_sum)
    has = torch.cat([local_end[:1] > 0, local_end[1:] > local_end[:-1]])
    end_sum[has] = csum[local_end[has] - 1]
    first = torch.cat([torch.zeros(1, dtype=local_end.dtype, device=tile.device),
                       local_end[:-1]])
    nz = has & (first > 0)
    start_sum[nz] = csum[first[nz] - 1]
    front = torch.exp(end_sum[tl] - csum)  # transmittance of what is in front
    w = alpha.to(acc_dtype) * front
    rgb1 = torch.cat([col[:, :3], torch.ones_like(col[:, :1])], dim=1).to(acc_dtype)
    # each tile's sum over its run of pairs, as a difference of running sums
    # (the pairs are sorted by tile)
    acc = torch.zeros((nt, TILE * TILE, 4), dtype=acc_dtype, device=tile.device)
    for ch in range(4):
        run = _cumsum_pairs(w * rgb1[:, ch:ch + 1])
        acc[has, :, ch] = run[local_end[has] - 1]
        acc[nz, :, ch] -= run[first[nz] - 1]
    t_all = torch.exp(end_sum - start_sum)
    tys, txs = (torch.arange(t_lo, t_hi, device=tile.device) // ntx,
                torch.arange(t_lo, t_hi, device=tile.device) % ntx)
    out_rgb, out_t = v["out_rgb"], v["out_t"]
    gy0 = tys[:, None] * TILE + v["ly"][None, :]
    gx0 = txs[:, None] * TILE + v["lx"][None, :]
    out_rgb[gy0, gx0] = acc.to(torch.float32)
    out_t[gy0, gx0] = t_all.to(torch.float32)
    if min_t is None:
        return 0
    kept_mask = mask & (front >= min_t)
    used = kept_mask.any(dim=1)
    v["row_used"][s[used]] = True
    return int(kept_mask.sum())


def composite_sequential(table, width, height, bg, depth=None, *, dtype=torch.bfloat16):
    """The image [H, W, 4] float32 of a compositor that walks each pixel's
    splats front to back in `dtype`: alpha, the carried transmittance T, the
    colour sum C += T alpha c and T *= 1 - alpha, each rounded to `dtype`;
    the background is added under the final T. Tiles run side by side, one
    pair of each at a time."""
    v = _pairs(table, width, height, bg, depth)
    dev = bg.device
    ntx, nty = v["ntx"], v["nty"]
    tile = v["tile"]
    n_pairs = tile.shape[0]
    ends = torch.tensor(v["ends_h"], dtype=torch.int64, device=dev)
    # rank 0 is a tile's last pair in stream order: its front
    rank = ends[tile] - 1 - torch.arange(n_pairs, device=dev)
    rank, by_rank = torch.sort(rank, stable=True)
    starts = torch.searchsorted(rank, torch.arange(int(rank[-1]) + 2 if n_pairs else 1,
                                                   device=dev)).tolist()
    t_acc = torch.ones((ntx * nty, TILE * TILE), dtype=dtype, device=dev)
    c_acc = torch.zeros((ntx * nty, TILE * TILE, 3), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    for r in range(len(starts) - 1):
        p = by_rank[starts[r]:starts[r + 1]]
        tl, s = tile[p], v["pair_splat"][p]
        alpha, _, col = _alpha(v, tl, s, dtype)
        t_cur = t_acc[tl]
        c_acc[tl] = c_acc[tl] + (t_cur * alpha)[..., None] * col[:, None, :3]
        t_acc[tl] = t_cur * (one - alpha)
    tys = torch.arange(ntx * nty, device=dev) // ntx
    txs = torch.arange(ntx * nty, device=dev) % ntx
    gy = tys[:, None] * TILE + v["ly"][None, :]
    gx = txs[:, None] * TILE + v["lx"][None, :]
    out_rgb = torch.zeros((nty * TILE, ntx * TILE, 4), dtype=dtype, device=dev)
    out_t = torch.ones((nty * TILE, ntx * TILE), dtype=dtype, device=dev)
    out_rgb[gy, gx, :3] = c_acc
    out_rgb[gy, gx, 3] = one - t_acc
    out_t[gy, gx] = t_acc
    img = out_rgb[:height, :width] + out_t[:height, :width, None] * bg.to(dtype)
    return img.to(torch.float32)
