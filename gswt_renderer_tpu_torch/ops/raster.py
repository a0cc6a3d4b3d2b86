"""Ordered alpha-compositing rasterizer.

The wgpu reference blends premultiplied quads back-to-front through the ROP
(renderer.rs:118-129, gswt.wgsl:424-435). Here each image tile walks its run
of the tile-sorted pair table FRONT-to-back carrying per-pixel transmittance
T = prod(1 - g_j): the final colour sum_i c_i g_i T_i is algebraically
identical to back-to-front ONE/ONE_MINUS_SRC_ALPHA blending.

On the card the compositor is the CUDA kernel ``csrc/raster.cu`` (one thread
block per tile, T and the colour sums in registers, each of its 32 warps
owning one compact block of the tile: ``warp_layout``); on the CPU it is
``rasterize_plain``, the same function over the (tile, chunk) worklist.
Both stop compositing a tile once max T < MIN_T, tested where each chunk of
the table begins. Both come in the exact and the fast profile's variant
(bf16-rounded weights and colours), each with or without the saturation-slot
record the temporal saturation cull feeds back into binning.

The kernel skips, warp by warp, every pair that cannot reach the cutoff (or
pass the depth test) anywhere in the warp's block: ``pair_block_mask`` is
its conservative per-pair mask, computed here with the same operations, so
the CPU tests can show that it covers every kept pair-pixel and that
``rasterize_plain(block_mask=True)``, which skips as the kernel does, gives
the same bits.
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
MAX_TILE_PIXELS = 2048  # 1024 threads x 2 pixels
N_WARPS = 32  # warps per thread block: one block of the tile each
_BLOCK_W, _BLOCK_H = 16, 4  # warp blocks where 32 of them cover the tile
_FLAT = MAX_TILE_PIXELS // N_WARPS  # pixels per warp in the flat layout
# the mask's limit: CUTOFF - _MASK_MARGIN - _MASK_REL * (the magnitude of the
# terms the kernel's f32 exponent sums; its rounding is below 6 * 2^-24 of it)
_MASK_MARGIN = 1.0
_MASK_REL = 2.0 ** -20
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


def warp_layout(tile_wh, device=None):
    """Which pixels each of the kernel's 32 warps owns: the units of its
    pair mask.

    16x4 blocks when ceil(tw/16) * ceil(th/4) <= 32 (a 64x32 tile: 4 x 8),
    warp w the block (w % nbx, w // nbx); else the flat layout, warp w the
    pixels 64w .. 64w + 63 of the row-major tile. Returns (rects, warp):
    rects [32, 4] f32, each warp's rectangle of pixel centres (u0, u1, v0,
    v1), with u0 > u1 for a warp without pixels (the rows it spans, and the
    columns when they lie in one row); warp [tw * th] i64, the owner of
    pixel p = y * tw + x."""
    tw, th = tile_wh
    nbx, nby = -(-tw // _BLOCK_W), -(-th // _BLOCK_H)
    p = torch.arange(tw * th, device=device)
    x, y = p % tw, torch.div(p, tw, rounding_mode="floor")
    rects = []
    if nbx * nby <= N_WARPS:
        warp = (torch.div(y, _BLOCK_H, rounding_mode="floor") * nbx
                + torch.div(x, _BLOCK_W, rounding_mode="floor"))
        for w in range(N_WARPS):
            x0, y0 = w % nbx * _BLOCK_W, w // nbx * _BLOCK_H
            rects.append((x0, min(x0 + _BLOCK_W - 1, tw - 1), y0,
                          min(y0 + _BLOCK_H - 1, th - 1), y0 >= th))
    else:
        warp = torch.div(p, _FLAT, rounding_mode="floor")
        for w in range(N_WARPS):
            p0, p1 = _FLAT * w, min(_FLAT * (w + 1) - 1, tw * th - 1)
            y0, y1 = p0 // tw, p1 // tw
            one_row = y0 == y1
            rects.append((p0 % tw if one_row else 0,
                          p1 % tw if one_row else tw - 1, y0, y1, y0 >= th))
    r = torch.tensor([[1.0, 0.0, y0 + 0.5, y1 + 0.5] if none else
                      [x0 + 0.5, x1 + 0.5, y0 + 0.5, y1 + 0.5]
                      for x0, x1, y0, y1, none in rects],
                     dtype=torch.float32, device=device)
    return r, warp


def warp_depth_max(depth_tiles, warp):
    """[T, 32]: the largest depth of each warp's pixels per tile (NaN depths
    ignored, -inf for none), what the kernel's mask tests z against."""
    d = torch.nan_to_num(depth_tiles, nan=-torch.inf)
    out = torch.full((d.shape[0], N_WARPS), -torch.inf, dtype=d.dtype,
                     device=d.device)
    return out.scatter_reduce(1, warp.expand(d.shape[0], -1), d, "amax")


def _rect_min_q(a, b, c, rba, rbc, lx0, lx1, ly0, ly1):
    """ops/binning.py _rect_min_q over a positive definite quadratic, with
    the kernel's operation order (b / a and b / c given)."""
    inside = (lx0 <= 0.0) & (0.0 <= lx1) & (ly0 <= 0.0) & (0.0 <= ly1)

    def edge_x(dx):  # x fixed at dx, y in [ly0, ly1]
        t = torch.minimum(torch.maximum(-(rbc * dx), ly0), ly1)
        return (a * dx) * dx + ((2.0 * b) * dx) * t + (c * t) * t

    def edge_y(dy):  # y fixed at dy, x in [lx0, lx1]
        t = torch.minimum(torch.maximum(-(rba * dy), lx0), lx1)
        return (c * dy) * dy + ((2.0 * b) * dy) * t + (a * t) * t

    m = torch.minimum(torch.minimum(edge_x(lx0), edge_x(lx1)),
                      torch.minimum(edge_y(ly0), edge_y(ly1)))
    return torch.where(inside, 0.0, m)


def pair_peak(k):
    """The per-pair set-up of the kernel's mask (csrc/raster.cu
    pair_block_mask), in f64 with the same operations in the same order.
    k: 6 tensors (the table rows k0..k5) of one shape [...]. Returns a dict
    of [..., 1] tensors: "k" the six coefficients, (a, b, c) the form of
    -e's quadratic part (Q = a x^2 + 2 b xy + c y^2), "det" = ac - b^2,
    "half_inv" = 0.5 / det, "definite" (a > 0 and det > 0), and where
    definite (0 elsewhere) the centre (uc, vc), the peak "ec", the
    magnitude "mc" of the terms ec sums, and b / a, b / c."""
    k0, k1, k2, k3, k4, k5 = (t.double()[..., None] for t in k)
    a, b, c = -k0, -0.5 * k1, -k2
    det = a * c - b * b
    definite = (a > 0.0) & (det > 0.0)
    half_inv = 0.5 / torch.where(definite, det, 1.0)
    uc = (c * k3 - b * k4) * half_inv
    vc = (a * k4 - b * k3) * half_inv
    tu, tv = k3 * uc, k4 * vc
    ec = k5 + 0.5 * (tu + tv)
    mc = tu.abs() + tv.abs()
    rba = b / torch.where(definite, a, 1.0)
    rbc = b / torch.where(definite, c, 1.0)
    zero = torch.zeros((), dtype=torch.float64, device=det.device)
    uc, vc, ec, mc = (torch.where(definite, t, zero) for t in (uc, vc, ec, mc))
    return dict(k=(k0, k1, k2, k3, k4, k5), a=a, b=b, c=c, det=det,
                half_inv=half_inv, definite=definite, uc=uc, vc=vc, ec=ec,
                mc=mc, rba=rba, rbc=rbc)


def mask_limit(pk, u1, v1, rel=_MASK_REL):
    """(s5, lim) of the mask at a rectangle whose far corner is (u1, v1)
    (f64): s5 the sum of |k_i| times the largest monomials there (every
    monomial grows with u and v), lim = CUTOFF - 1 - rel S with S = s5 +
    |k5| + mc, for pair_peak's pk."""
    k0, k1, k2, k3, k4, k5 = pk["k"]
    s5 = ((((k0.abs() * (u1 * u1) + k1.abs() * (u1 * v1))
            + k2.abs() * (v1 * v1)) + k3.abs() * u1) + k4.abs() * v1)
    lim = CUTOFF - (_MASK_MARGIN + rel * ((s5 + k5.abs()) + pk["mc"]))
    return s5, lim


def pair_block_mask(k, z, rects, dmax=None, rel=_MASK_REL):
    """The kernel's per-pair warp-block mask (csrc/raster.cu
    pair_block_mask), with the same f64 operations in the same order.

    k: 6 tensors (the table rows k0..k5) of one shape [...]; z the same
    shape; rects [..., 32, 4] from warp_layout (broadcast against k[...,
    None], so a batch may carry rectangles of its own); dmax (optional,
    broadcastable to [..., 32]): each block's largest depth, for use_depth;
    rel: the limit's relative margin (the compositor's 2^-20 by default;
    the micro-benchmark's variants pass the one of their own precision).
    Returns [..., 32] bool:
    False only where no pixel centre of the block can give e >= CUTOFF in
    the kernel's f32 evaluation of the exponent (or, with dmax, z < depth).

    The bound: the max of e over the block's rectangle is the peak e_c less
    the min of the positive definite -e + e_c over the rectangle shifted to
    the centre; the centre and e_c come from the f32 coefficients by exact
    f64 products, one rounded subtraction and one division. It is tested
    against CUTOFF - 1 - rel S, S the magnitude of the terms (those the
    kernel sums at the block's far corner, and those e_c sums). A quadratic
    that is not negative definite gets the block unless the trivial bound
    k5 + sum |k_i| m_i (m_i the block's largest monomials) is below the
    limit; so a dead pair (k5 = -1e30) gets none."""
    pk = pair_peak(k)
    k5 = pk["k"][5]
    uc, vc = pk["uc"], pk["vc"]
    u0, u1, v0, v1 = rects.double().unbind(-1)
    s5, lim = mask_limit(pk, u1, v1, rel)
    rmin = _rect_min_q(pk["a"], pk["b"], pk["c"], pk["rba"], pk["rbc"],
                       u0 - uc, u1 - uc, v0 - vc, v1 - vc)
    reach = ~(k5 + s5 < lim) & (~pk["definite"] | ~(pk["ec"] - rmin < lim))
    reach &= u0 <= u1
    if dmax is not None:
        reach &= z[..., None] < dmax
    return reach


def _exponent(k, mono):
    """e at every pixel, in the kernel's order of operations (csrc/raster.cu
    rounds each multiply and add on its own), so that the cutoff mask
    decides identically. k: 6 tensors [...,]; mono: (uu, uv, vv, u, v)."""
    uu, uv, vv, u, v = mono
    k = [t[..., None] for t in k]
    return k[0] * uu + k[1] * uv + k[2] * vv + k[3] * u + k[4] * v + k[5]


def rasterize_plain(binned, depth_tiles, *, image_wh, tile_wh, chunk: int,
                    use_depth: bool = True, exact: bool = True,
                    emit_zcut: bool = False, block_mask: bool = False,
                    stats=None):
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
    (see rasterize). block_mask=True skips, as the kernel does, the
    pair-pixels of the warp blocks that pair_block_mask leaves out: the
    result is the same to the bit.

    With `stats` (a dict) records the load the compositor carries, over the
    pairs composited before the early exit: "pairs" (their count),
    "pair_pixels" (times the tile's pixels), "kept" (pair-pixels that pass
    the cutoff and the depth test), "visits" (pair x warp-block visits the
    mask leaves), "blocks" (pairs x warp blocks with pixels), "missed"
    (kept pair-pixels whose block the mask leaves out: 0 when the mask is
    conservative), "tile_pairs" ([n_tiles] composited pairs per tile) and
    "runs" ([n_tiles] run lengths in the table)."""
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
    mono = _pixel_monomials(tw, th, dev)
    masked = block_mask or stats is not None
    if masked:
        rects, warp = warp_layout(tile_wh, dev)
        dmax = warp_depth_max(depth_tiles, warp) if use_depth else None
        n_blocks = int((rects[:, 0] <= rects[:, 1]).sum())
        load = torch.zeros(4, dtype=torch.int64, device=dev)
        tile_pairs = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
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
            e = _exponent(blk[:6], mono)  # [B, C, P]
            mask = (e >= CUTOFF) & in_run[..., None]
            if use_depth:
                mask &= blk[6][..., None] < depth_tiles[tiles][:, None, :]
            if masked:
                reach = pair_block_mask(
                    blk[:6], blk[6], rects,
                    None if dmax is None else dmax[tiles][:, None, :])
                reach &= in_run[..., None]  # [B, C, 32]
                px_reach = reach[..., warp]  # [B, C, P]
                load += torch.stack([
                    mask.sum(), reach.sum(), (mask & ~px_reach).sum(),
                    in_run.sum() * n_blocks])
                tile_pairs.index_add_(0, tiles, in_run.sum(1))
                if block_mask:
                    mask &= px_reach
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
        stats["pair_pixels"] = int(composited) * p_n
        stats["kept"], stats["visits"], stats["missed"], stats["blocks"] = (
            int(x) for x in load)
        stats["tile_pairs"] = tile_pairs
        stats["runs"] = re_ - rs
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
    if chunk > MAX_CHUNK or chunk % 4 or p_n > MAX_TILE_PIXELS:
        raise ValueError(f"the CUDA compositor takes chunk <= {MAX_CHUNK}, a "
                         f"multiple of 4, and tiles of <= {MAX_TILE_PIXELS} "
                         f"pixels")
    rs = binned["range_start"]
    re_ = binned["range_end"]
    dev = table.device
    # the kernel stages whole chunks with 16-B aligned bulk copies
    if (table.dtype != torch.float32 or not table.is_contiguous()
            or table.shape[0] != 16 or table.shape[1] % chunk
            or table.data_ptr() % 16):
        raise ValueError("table must be a contiguous, 16-B aligned float32 "
                         "[16, dom] with dom a multiple of chunk")
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
