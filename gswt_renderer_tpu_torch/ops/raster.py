"""Ordered alpha-compositing rasterizer.

The wgpu reference blends premultiplied quads back-to-front through the ROP
(renderer.rs:118-129, gswt.wgsl:424-435). Here each image tile walks its run
of the tile-sorted pair table FRONT-to-back carrying per-pixel transmittance
T = prod(1 - g_j): the final colour sum_i c_i g_i T_i is algebraically
identical to back-to-front ONE/ONE_MINUS_SRC_ALPHA blending.

On the card the compositor is the CUDA kernel ``csrc/raster.cu`` (one thread
block per tile, T and the colour sums in registers); on the CPU it is
``rasterize_plain``, the same function over the (tile, chunk) worklist.
Both stop compositing a tile once max T < MIN_T, tested where each chunk of
the table begins. Both come in the exact and the fast profile's variant
(bf16-rounded weights and colours), each with or without the saturation-slot
record the temporal saturation cull feeds back into binning.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels
from .binning import build_worklist, round_bf16

CUTOFF = -4.0  # fragment discard threshold (gswt.wgsl:427-430)
MIN_T = 0.5 / 255.0  # early-exit transmittance (below ROP quantization)
# saturation-SLOT record (emit_zcut): SAT_NOCUT (> any stream slot; slots are
# exact in f32 to 2^24) marks "no cut"; the +0.5 makes `slot >= cut` strictly
# `slot > last composited slot` (slots are integral)
SAT_NOCUT = float(1 << 25)
_SCUT_BUMP = 0.5
SAT_BANDS = 4  # horizontal bands per tile in the saturation record
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
                    use_depth: bool = True, exact: bool = True,
                    emit_zcut: bool = False, stats=None):
    """Plain PyTorch compositor with the kernel's semantics and the kernel's
    order of operations.

    Worklist entries (tile, chunk) (ops.binning.build_worklist) are
    processed rank by rank: rank r holds the r-th chunk of every tile that
    has one, so the carried T of each tile is known before its next chunk
    starts. An entry is skipped when its tile's max T is below MIN_T (as
    the TPU kernel tests at each entry start). Within an entry the pairs
    are walked one by one, w = g * T then T *= 1 - g, as the kernel's
    threads do, so T, the early exit and the saturation record decide
    identically in both.

    exact=False is the fast profile's value semantics: each weight and each
    colour is rounded to bf16 before the f32 accumulate (alpha is the sum
    of the rounded weights); T stays f32 from the un-rounded weights.
    emit_zcut also returns the saturation-slot record [n_tiles, SAT_BANDS]
    (see rasterize). With `stats` (a dict) records the composited pair
    count under "pairs"."""
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
    rec = torch.zeros_like(trans) if emit_zcut else None
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
            omg = 1.0 - g
            t = trans[tiles]  # [B, P], T where the entry starts
            if emit_zcut:
                smax = torch.where(in_run, blk[12], -1.0).amax(dim=1)
                rec[tiles] = torch.where(
                    t >= MIN_T, torch.maximum(rec[tiles], smax[:, None]),
                    rec[tiles])
            weight = g  # overwritten lane by lane: g[:, j] is read first
            for j in range(chunk):
                torch.mul(g[:, j], t, out=weight[:, j])
                t = t * omg[:, j]
            rgb1 = torch.stack(
                [blk[8], blk[9], blk[10], torch.ones_like(blk[8])], dim=1)
            if not exact:
                weight = round_bf16(weight)
                rgb1 = round_bf16(rgb1)
            acc[tiles] += torch.bmm(rgb1, weight)
            trans[tiles] = t
            composited += in_run.sum()
    if stats is not None:
        stats["pairs"] = int(composited)
    if not emit_zcut:
        return acc
    # per band b = min(row // (th // SAT_BANDS), SAT_BANDS - 1): the max
    # over its pixels of (saturated ? record + 0.5 : SAT_NOCUT); rows of a
    # tile height not divisible by SAT_BANDS fold into the last band
    pix = torch.arange(p_n, device=dev)
    band = torch.clamp(torch.div(
        pix, max(th // SAT_BANDS, 1) * tw, rounding_mode="floor"),
        max=SAT_BANDS - 1)
    cut_p = torch.where(trans < MIN_T, rec + _SCUT_BUMP, SAT_NOCUT)
    zcut = torch.stack(
        [torch.where(band == b, cut_p, -1.0).amax(dim=1)
         for b in range(SAT_BANDS)], dim=1)
    return acc, zcut


def rasterize(binned, depth_tiles, *, image_wh, tile_wh, chunk: int,
              use_depth: bool = True, exact: bool = True,
              emit_zcut: bool = False):
    """Composite the binned pair table into [T, 4, P] premultiplied
    colour + alpha tile blocks (reassemble with `tiles_to_image`).

    binned: output of ops.binning.bin_pairs. depth_tiles: [T, th*tw]
    per-pixel depth, tested as `z < depth` when use_depth (1.0 when there is
    no proxy). Every tile is written; a tile with no pairs is zeros.
    exact=False composites with the fast profile's bf16-rounded weights and
    colours (rasterize_plain).

    emit_zcut: also return the per-band saturation-SLOT record
    [T, SAT_BANDS] f32: per horizontal band of a tile, the stream slot
    (table row 12) beyond which no pair can contribute because every pixel
    of the band was already opaque, SAT_NOCUT for a band with any
    unsaturated pixel (an empty tile is all SAT_NOCUT). Per composited
    chunk, a pixel whose T where the chunk starts is >= MIN_T raises its
    record to the chunk's max slot; chunks the early exit skips update
    nothing. The return becomes (tiles, zcut).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    table = binned["table"]
    if not table.is_cuda:
        return rasterize_plain(binned, depth_tiles, image_wh=image_wh,
                               tile_wh=tile_wh, chunk=chunk,
                               use_depth=use_depth, exact=exact,
                               emit_zcut=emit_zcut)
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
    zcut = (torch.empty((n_tiles, SAT_BANDS), dtype=torch.float32, device=dev)
            if emit_zcut else None)
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib = kernels.load("raster", gswt_raster=[
        vp, ll, vp, vp, vp, ci, ci, vp, vp, ci, ci, ci, ci, vp])
    rc = lib.gswt_raster(
        kernels.ptr(table), table.shape[1], kernels.ptr(rs), kernels.ptr(re_),
        kernels.ptr(depth_tiles), int(bool(use_depth)), int(not exact),
        kernels.ptr(out), kernels.ptr(zcut) if emit_zcut else None,
        n_tiles, tw, th, chunk, kernels.stream_ptr(table),
    )
    kernels.LAUNCHES["raster"] += 1
    kernels.check(rc, "raster")
    return (out, zcut) if emit_zcut else out


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
