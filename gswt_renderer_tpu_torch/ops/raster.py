"""Ordered alpha-compositing rasterizer.

The wgpu reference blends premultiplied quads back-to-front through the ROP
(renderer.rs:118-129, gswt.wgsl:424-435). Here each image tile walks its run
of the tile-sorted pair table FRONT-to-back carrying per-pixel transmittance
T = prod(1 - g_j): the final colour sum_i c_i g_i T_i is algebraically
identical to back-to-front ONE/ONE_MINUS_SRC_ALPHA blending.

On the card the compositor is the CUDA kernel ``csrc/raster.cu`` (one thread
block per tile, T and the colour sums in registers); on the CPU it is
``rasterize_plain``, a vectorised form of the same function over the
(tile, chunk) worklist. Both stop compositing a tile once max T < MIN_T,
tested where each chunk of the table begins.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels
from .binning import build_worklist

CUTOFF = -4.0  # fragment discard threshold (gswt.wgsl:427-430)
MIN_T = 0.5 / 255.0  # early-exit transmittance (below ROP quantization)
MAX_CHUNK = 256  # the CUDA kernel stages one chunk in shared memory
MAX_TILE_PIXELS = 2048  # 256 threads x 8 pixels
# worklist entries per step of the plain version: bounds its [B, C, P]
# temporaries (64 x 256 x 2048 f32 = 128 MiB each at 1080p)
_PLAIN_BATCH = 64


def _grid(image_wh, tile_wh):
    w_img, h_img = image_wh
    tw, th = tile_wh
    ntx = -(-w_img // tw)
    nty = -(-h_img // th)
    return ntx, nty, ntx * nty


def _pixel_monomials(tw, th, device):
    """(u^2, uv, v^2, u, v) at the tile-local pixel centres, flat p = y*tw + x
    (the table's k rows are recentred per pair to its tile origin)."""
    i = torch.arange(tw * th, device=device)
    u = (i % tw).to(torch.float32) + 0.5
    v = torch.div(i, tw, rounding_mode="floor").to(torch.float32) + 0.5
    return u * u, u * v, v * v, u, v


def rasterize_plain(binned, depth_tiles, *, image_wh, tile_wh, chunk: int,
                    use_depth: bool = True, stats=None):
    """Plain PyTorch compositor with the kernel's semantics.

    Worklist entries (tile, chunk) (ops.binning.build_worklist) are
    processed rank by rank: rank r holds the r-th chunk of every tile that
    has one, so the carried T of each tile is known before its next chunk
    starts. An entry is skipped when its
    tile's max T is below MIN_T (as the TPU kernel tests at each entry
    start). Within an entry T is an inclusive cumprod over the chunk.
    With `stats` (a dict) records the composited pair count under "pairs"."""
    tw, th = tile_wh
    _, _, n_tiles = _grid(image_wh, tile_wh)
    p_n = tw * th
    table = binned["table"]
    dev = table.device
    rs = binned["range_start"].long()
    re_ = binned["range_end"].long()
    wl = build_worklist(rs, re_, chunk=chunk)
    et = wl["entry_tile"].long()
    ec = wl["entry_chunk"].long()
    rank = ec - torch.div(rs[et], chunk, rounding_mode="floor")
    uu, uv, vv, u, v = _pixel_monomials(tw, th, dev)
    acc = torch.zeros((n_tiles, 4, p_n), dtype=torch.float32, device=dev)
    trans = torch.ones((n_tiles, p_n), dtype=torch.float32, device=dev)
    lane = torch.arange(chunk, device=dev)
    composited = torch.zeros((), dtype=torch.int64, device=dev)
    n_rank = int(rank.max()) + 1 if rank.numel() else 0
    for r in range(n_rank):
        idx = torch.nonzero(rank == r).flatten()
        if r > 0:
            idx = idx[trans[et[idx]].amax(dim=1) >= MIN_T]
        for b0 in range(0, idx.numel(), _PLAIN_BATCH):
            sel = idx[b0:b0 + _PLAIN_BATCH]
            tiles = et[sel]
            cols = ec[sel, None] * chunk + lane  # [B, C]
            blk = table[:, cols]  # [16, B, C]
            in_run = (cols >= rs[tiles, None]) & (cols < re_[tiles, None])
            k = [blk[i][..., None] for i in range(6)]  # [B, C, 1]
            # same operation order as the kernel (csrc/raster.cu), so the
            # cutoff mask decides identically
            e = k[0] * uu + k[1] * uv + k[2] * vv + k[3] * u + k[4] * v + k[5]
            mask = (e >= CUTOFF) & in_run[..., None]
            if use_depth:
                mask &= blk[6][..., None] < depth_tiles[tiles][:, None, :]
            g = torch.where(mask, torch.exp(e + blk[11][..., None]), 0.0)
            t_incl = torch.cumprod(1.0 - g, dim=1)
            t_excl = torch.cat(
                [torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], dim=1)
            weight = g * t_excl * trans[tiles][:, None, :]
            rgb1 = torch.stack(
                [blk[8], blk[9], blk[10], torch.ones_like(blk[8])], dim=1)
            acc[tiles] += torch.bmm(rgb1, weight)
            trans[tiles] = trans[tiles] * t_incl[:, -1]
            composited += in_run.sum()
    if stats is not None:
        stats["pairs"] = int(composited)
    return acc


def rasterize(binned, depth_tiles, *, image_wh, tile_wh, chunk: int,
              use_depth: bool = True, emit_zcut: bool = False):
    """Composite the binned pair table into [T, 4, P] premultiplied
    colour + alpha tile blocks (reassemble with `tiles_to_image`).

    binned: output of ops.binning.bin_pairs. depth_tiles: [T, th*tw]
    per-pixel depth, tested as `z < depth` when use_depth (1.0 when there is
    no proxy). Every tile is written; a tile with no pairs is zeros. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if emit_zcut:
        raise NotImplementedError(
            "emit_zcut (the saturation-slot record) belongs to the fast "
            "profile, which is not ported yet")
    table = binned["table"]
    if not table.is_cuda:
        return rasterize_plain(binned, depth_tiles, image_wh=image_wh,
                               tile_wh=tile_wh, chunk=chunk,
                               use_depth=use_depth)
    tw, th = tile_wh
    _, _, n_tiles = _grid(image_wh, tile_wh)
    p_n = tw * th
    if chunk > MAX_CHUNK or p_n > MAX_TILE_PIXELS:
        raise ValueError(f"the CUDA compositor takes chunk <= {MAX_CHUNK} "
                         f"and tiles of <= {MAX_TILE_PIXELS} pixels")
    rs = binned["range_start"]
    re_ = binned["range_end"]
    dev = table.device
    if (table.dtype != torch.float32 or not table.is_contiguous()
            or table.shape[0] != 16):
        raise ValueError("table must be a contiguous float32 [16, dom]")
    for name, t in (("range_start", rs), ("range_end", re_)):
        if (t.dtype != torch.int32 or not t.is_contiguous()
                or t.shape != (n_tiles,) or t.device != dev):
            raise ValueError(f"{name} must be contiguous int32 [{n_tiles}]")
    if (depth_tiles.dtype != torch.float32 or not depth_tiles.is_contiguous()
            or depth_tiles.shape != (n_tiles, p_n) or depth_tiles.device != dev):
        raise ValueError(f"depth_tiles must be contiguous float32 "
                         f"[{n_tiles}, {p_n}]")
    out = torch.empty((n_tiles, 4, p_n), dtype=torch.float32, device=dev)
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib = kernels.load("raster", gswt_raster=[
        vp, ll, vp, vp, vp, ci, vp, ci, ci, ci, ci, vp])
    rc = lib.gswt_raster(
        kernels.ptr(table), table.shape[1], kernels.ptr(rs), kernels.ptr(re_),
        kernels.ptr(depth_tiles), int(bool(use_depth)), kernels.ptr(out),
        n_tiles, tw, th, chunk, kernels.stream_ptr(table),
    )
    kernels.LAUNCHES["raster"] += 1
    kernels.check(rc, "raster")
    return out


def tiles_to_image(tile_acc, *, image_wh, tile_wh):
    """[T, 4, P] tile blocks -> [H, W, 4] image (cropping padding)."""
    w_img, h_img = image_wh
    tw, th = tile_wh
    ntx, nty, _ = _grid(image_wh, tile_wh)
    img = tile_acc.reshape(nty, ntx, 4, th, tw)
    img = img.permute(0, 3, 1, 4, 2).reshape(nty * th, ntx * tw, 4)
    return img[:h_img, :w_img, :]


def image_to_depth_tiles(depth, *, image_wh, tile_wh):
    """[H, W] depth -> [T, P] tile blocks (padding with 1.0)."""
    w_img, h_img = image_wh
    tw, th = tile_wh
    ntx, nty, _ = _grid(image_wh, tile_wh)
    d = torch.nn.functional.pad(
        depth, (0, ntx * tw - w_img, 0, nty * th - h_img), value=1.0)
    d = d.reshape(nty, th, ntx, tw).permute(0, 2, 1, 3)
    return d.reshape(ntx * nty, th * tw)
