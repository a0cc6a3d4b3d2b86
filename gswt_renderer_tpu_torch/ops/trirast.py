"""Tile-binned triangle rasterizer with min-z (depth-write) semantics.

The reference's proxy pass draws a height-displaced grid mesh with depth
write + Less (proxy.rs:119-125); the splat pass then depth-tests against
it. This is the triangle raster used for that displaced grid (ops/proxy.py),
built from the same pieces as the splat compositor: bbox expansion + one
stable sort by image tile (ops/binning.py) and a kernel that walks each
tile's run.

Per triangle everything the raster needs is LINEAR in screen space: the
three barycentric coordinates, depth (GPUs interpolate the post-divide
clip z linearly in screen space), 1/w, and the perspective-corrected
attributes attr/w. So the per-pair table stores 8 plane equations x 3
coefficients = 24 rows.

Outputs per pixel: min depth + the winning triangle's (1/w, u/w, v/w,
extra/w); callers resolve perspective division and texture sampling.

On the card the raster is the CUDA kernel ``csrc/trirast.cu`` (one thread
block per tile); on the CPU it is ``rasterize_triangles_plain``, a vectorised
form of the same function over the (tile, chunk) worklist.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import kernels
from .binning import build_worklist, expand_bboxes, grid_dims, tile_ranges

N_PLANES = 8   # b0, b1, b2, z, 1/w, u/w, v/w, extra/w
N_ROWS = N_PLANES * 3
MAX_CHUNK = 256  # the CUDA kernel stages one chunk in shared memory
MAX_TILE_PIXELS = 2048  # 256 threads x 8 pixels
# worklist entries per step of the plain version: bounds its [B, C, P]
# temporaries (16 x 128 x 2048 f32 = 16 MiB each on the proxy grid)
_PLAIN_BATCH = 16


def triangle_planes(xs, ys, zs, ws, attrs, valid):
    """Per-triangle screen-space plane equations.

    xs, ys: [3, T] pixel coords; zs: [3, T] post-divide clip z; ws: [3, T]
    clip w; attrs: [A<=3, 3, T] per-vertex attributes (perspective-correct).
    Returns (planes [24, T] f32 rows grouped per plane (a, b, c), valid [T],
    bbox (x0f, x1f, y0f, y1f) float pixel bounds).
    Triangles with any vertex behind the near plane (w <= eps) are dropped
    (the GPU would clip them; ops/proxy.py's far-field fallback covers the
    resulting holes).
    """
    x0, x1t, x2 = xs[0], xs[1], xs[2]
    y0, y1t, y2 = ys[0], ys[1], ys[2]
    area2 = (x1t - x0) * (y2 - y0) - (x2 - x0) * (y1t - y0)
    eps_w = 1e-6
    ok = valid & (ws[0] > eps_w) & (ws[1] > eps_w) & (ws[2] > eps_w)
    ok = ok & (torch.abs(area2) > 1e-12)
    inv_a = torch.where(ok, 1.0 / torch.where(area2 == 0, 1.0, area2), 0.0)

    def plane(f0, f1, f2):
        # linear interpolant f(x, y) = a x + b y + c through the 3 vertices
        a = (f0 * (y1t - y2) + f1 * (y2 - y0) + f2 * (y0 - y1t)) * inv_a
        b = (f0 * (x2 - x1t) + f1 * (x0 - x2) + f2 * (x1t - x0)) * inv_a
        c = (
            f0 * (x1t * y2 - x2 * y1t)
            + f1 * (x2 * y0 - x0 * y2)
            + f2 * (x0 * y1t - x1t * y0)
        ) * inv_a
        return [a, b, c]

    one = torch.ones_like(x0)
    zero = torch.zeros_like(x0)
    invw = torch.where(ok, 1.0 / torch.where(ws <= eps_w, 1.0, ws), 0.0)
    planes = []
    planes += plane(one, zero, zero)   # b0
    planes += plane(zero, one, zero)   # b1
    planes += plane(zero, zero, one)   # b2
    planes += plane(zs[0], zs[1], zs[2])
    planes += plane(invw[0], invw[1], invw[2])
    for k in range(3):
        if attrs is not None and k < attrs.shape[0]:
            f = attrs[k] * invw
            planes += plane(f[0], f[1], f[2])
        else:
            planes += [zero, zero, zero]
    stacked = torch.stack(planes, dim=0)  # [24, T]
    bx0 = torch.minimum(torch.minimum(x0, x1t), x2)
    bx1 = torch.maximum(torch.maximum(x0, x1t), x2)
    by0 = torch.minimum(torch.minimum(y0, y1t), y2)
    by1 = torch.maximum(torch.maximum(y0, y1t), y2)
    return stacked, ok, (bx0, bx1, by0, by1)


def _far_tiles(n_tiles, p_n, device):
    tiles = torch.zeros((n_tiles, 5, p_n), dtype=torch.float32, device=device)
    tiles[:, 0] = 1.0  # far plane
    return tiles


def rasterize_triangles_plain(rows, range_start, range_end, *, image_wh,
                              tile_wh, chunk: int = 128):
    """Plain PyTorch rasterizer of tile-sorted pair rows, with the kernel's
    semantics (same arguments as rasterize_pair_rows).

    Worklist entries (tile, chunk) are processed rank by rank: rank r holds
    the r-th chunk of every tile that has one, so each tile's running z is
    known before its next chunk. Chunks begin at global multiples of
    `chunk` in the pair table. Within a chunk the nearest inside pair wins
    and the attributes of all pairs of the chunk at exactly that z are
    averaged; the chunk replaces a pixel only where its z is below 1 and
    strictly below the pixel's z so far."""
    tw, th = tile_wh
    ntx, _, n_tiles = grid_dims(image_wh, tile_wh)
    p_n = tw * th
    dev = rows.device
    tiles_out = _far_tiles(n_tiles, p_n, dev)
    n_pairs = rows.shape[1]
    rs = range_start.long()
    re_ = range_end.long()
    wl = build_worklist(rs, re_, chunk=chunk)
    et = wl["entry_tile"].long()
    ec = wl["entry_chunk"].long()
    if et.numel() == 0:
        return tiles_out
    rank = ec - torch.div(rs[et], chunk, rounding_mode="floor")
    i = torch.arange(p_n, device=dev)
    lx = (i % tw).to(torch.float32)
    ly = torch.div(i, tw, rounding_mode="floor").to(torch.float32)
    lane = torch.arange(chunk, device=dev)
    for r in range(int(rank.max()) + 1):
        idx = torch.nonzero(rank == r).flatten()
        for b0_ in range(0, idx.numel(), _PLAIN_BATCH):
            sel = idx[b0_:b0_ + _PLAIN_BATCH]
            tiles = et[sel]
            slot = ec[sel, None] * chunk + lane  # [B, C]
            in_run = (slot >= rs[tiles, None]) & (slot < re_[tiles, None])
            blk = rows[:, torch.clamp(slot, max=n_pairs - 1)]  # [24, B, C]
            px = ((tiles % ntx) * tw)[:, None].to(torch.float32) + lx + 0.5
            py = (torch.div(tiles, ntx, rounding_mode="floor")
                  * th)[:, None].to(torch.float32) + ly + 0.5
            px = px[:, None, :]  # [B, 1, P]
            py = py[:, None, :]

            def ev(k):
                # (a*px + b*py) + c, each operation rounded on its own:
                # the kernel evaluates the same sequence
                return (blk[3 * k][..., None] * px
                        + blk[3 * k + 1][..., None] * py
                        + blk[3 * k + 2][..., None])  # [B, C, P]

            b0, b1 = ev(0), ev(1)
            b2 = 1.0 - b0 - b1
            inside = ((b0 >= 0.0) & (b1 >= 0.0) & (b2 >= 0.0)
                      & in_run[..., None])
            z = ev(3)
            zk = torch.where(inside & (z >= 0.0), z, 2.0)  # near-plane clip
            zmin = zk.amin(dim=1, keepdim=True)  # [B, 1, P]
            hit = zmin < 1.0
            wmask = (zk == zmin) & inside
            cnt = torch.clamp(wmask.sum(dim=1, keepdim=True)
                              .to(torch.float32), min=1.0)
            cur = tiles_out[tiles]  # [B, 5, P]
            upd = ((zmin < cur[:, 0:1]) & hit)[:, 0]  # [B, P]
            new = [zmin[:, 0]]
            for k in range(4, 8):
                q = torch.where(wmask, ev(k), 0.0).sum(dim=1, keepdim=True)
                new.append((q / cnt)[:, 0])
            new = torch.stack(new, dim=1)  # [B, 5, P]
            tiles_out[tiles] = torch.where(upd[:, None, :], new, cur)
    return tiles_out


def rasterize_pair_rows(rows, range_start, range_end, *, image_wh, tile_wh,
                        chunk: int = 128):
    """Min-z raster of tile-sorted pair rows [24, n_pairs] with per-tile
    runs range_start/range_end [n_tiles] i32 -> [n_tiles, 5, P] (rows: z,
    1/w, u/w, v/w, extra/w); a tile with an empty run reads far plane
    (z = 1, attributes 0). CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if not rows.is_cuda:
        return rasterize_triangles_plain(
            rows, range_start, range_end, image_wh=image_wh, tile_wh=tile_wh,
            chunk=chunk)
    tw, th = tile_wh
    ntx, _, n_tiles = grid_dims(image_wh, tile_wh)
    p_n = tw * th
    if chunk > MAX_CHUNK or p_n > MAX_TILE_PIXELS:
        raise ValueError(f"the CUDA triangle raster takes chunk <= {MAX_CHUNK}"
                         f" and tiles of <= {MAX_TILE_PIXELS} pixels")
    dev = rows.device
    if (rows.dtype != torch.float32 or not rows.is_contiguous()
            or rows.dim() != 2 or rows.shape[0] != N_ROWS):
        raise ValueError("rows must be a contiguous float32 [24, n_pairs]")
    for name, t in (("range_start", range_start), ("range_end", range_end)):
        if (t.dtype != torch.int32 or not t.is_contiguous()
                or t.shape != (n_tiles,) or t.device != dev):
            raise ValueError(f"{name} must be contiguous int32 [{n_tiles}]")
    out = torch.empty((n_tiles, 5, p_n), dtype=torch.float32, device=dev)
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib = kernels.load("trirast", gswt_trirast=[
        vp, ll, vp, vp, vp, ci, ci, ci, ci, ci, vp])
    rc = lib.gswt_trirast(
        kernels.ptr(rows), rows.shape[1], kernels.ptr(range_start),
        kernels.ptr(range_end), kernels.ptr(out), n_tiles, ntx, tw, th,
        chunk, kernels.stream_ptr(out))
    kernels.LAUNCHES["trirast"] += 1
    kernels.check(rc, "trirast")
    return out


def bin_triangles(planes, bbox, ok, *, image_wh, tile_wh):
    """Expand triangles into (tile, triangle) pairs sorted by tile (triangle
    order kept inside a tile). Returns (rows [24, n_pairs], range_start,
    range_end [n_tiles] i32, n_pairs)."""
    w_img, h_img = image_wh
    tw, th = tile_wh
    ntx, nty, n_tiles = grid_dims(image_wh, tile_wh)
    bx0, bx1, by0, by1 = bbox
    # clamping before the integer conversion matches XLA's saturating
    # float->int convert for off-grid values
    x0 = torch.clamp(torch.floor(bx0 / tw), 0, ntx - 1).long()
    x1 = torch.clamp(torch.floor(bx1 / tw), 0, ntx - 1).long()
    y0 = torch.clamp(torch.floor(by0 / th), 0, nty - 1).long()
    y1 = torch.clamp(torch.floor(by1 / th), 0, nty - 1).long()
    onscreen = (bx1 >= 0) & (bx0 < w_img) & (by1 >= 0) & (by0 < h_img)
    sorted_key, sorted_tri, total = expand_bboxes(
        x0, x1, y0, y1, ok & onscreen, ntx=ntx)
    rows = planes[:, sorted_tri].contiguous()  # [24, n_pairs]
    range_start, range_end = tile_ranges(sorted_key, n_tiles)
    return rows, range_start, range_end, total


def rasterize_triangles(planes, bbox, ok, *, image_wh, tile_wh,
                        chunk: int = 128):
    """Rasterize triangles with min-z. planes/bbox/ok from triangle_planes.

    Returns dict: tiles [n_tiles, 5, P] (rows: z, 1/w, u/w, v/w, extra/w),
    n_pairs (int). Reassemble per-pixel images with tiles_to_maps.
    """
    rows, range_start, range_end, total = bin_triangles(
        planes, bbox, ok, image_wh=image_wh, tile_wh=tile_wh)
    tiles = rasterize_pair_rows(rows, range_start, range_end,
                                image_wh=image_wh, tile_wh=tile_wh,
                                chunk=chunk)
    return dict(tiles=tiles, n_pairs=total)


def tiles_to_maps(tiles, *, image_wh, tile_wh):
    """[n_tiles, 5, P] -> (z [H,W], attrs [4, H, W]) cropping grid padding."""
    w_img, h_img = image_wh
    tw, th = tile_wh
    ntx = -(-w_img // tw)
    nty = -(-h_img // th)
    m = tiles.reshape(nty, ntx, 5, th, tw)
    m = m.permute(2, 0, 3, 1, 4).reshape(5, nty * th, ntx * tw)
    m = m[:, :h_img, :w_img]
    return m[0], m[1:5]


def rasterize_triangles_reference(planes_np, bbox_np, ok_np, *, image_wh):
    """NumPy per-pixel reference with identical semantics (for tests)."""
    w_img, h_img = image_wh
    planes = np.asarray(planes_np)
    ok = np.asarray(ok_np)
    z = np.ones((h_img, w_img), np.float32)
    at = np.zeros((4, h_img, w_img), np.float32)
    ys, xs = np.mgrid[0:h_img, 0:w_img]
    px = xs.astype(np.float32) + 0.5
    py = ys.astype(np.float32) + 0.5
    for t in range(planes.shape[1]):
        if not ok[t]:
            continue

        def ev(k):
            return planes[3 * k, t] * px + planes[3 * k + 1, t] * py + planes[3 * k + 2, t]

        # b2 derived as 1 - b0 - b1, matching the kernel
        inside = (ev(0) >= 0) & (ev(1) >= 0) & (1.0 - ev(0) - ev(1) >= 0)
        zt = ev(3)
        upd = inside & (zt < z) & (zt < 1.0) & (zt >= 0.0)
        z = np.where(upd, zt, z)
        for k in range(4):
            at[k] = np.where(upd, ev(4 + k), at[k])
    return z, at
