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

A tile's run is taken in chunks that begin at global multiples of `chunk`,
and a chunk replaces a pixel only where its nearest z is strictly below the
pixel's so far: the result is the lexicographic minimum of (the chunk's z,
its index) over the chunks that hit, carrying that chunk's own mean. So a
run splits exactly at chunk boundaries. On the card (``csrc/trirast.cu``)
every (tile, chunk) entry is a thread block of its own, whose warps skip
the pairs that ``tri_block_mask`` shows cannot cover a pixel centre of
their block; a second kernel, ``trirast_fold``, folds the entries of the
tiles whose run crosses a chunk boundary. On the CPU the raster is
``rasterize_triangles_plain``, which walks the chunks of every tile in
order; ``rasterize_triangles_plain(block_mask=True)`` skips as the kernel
does and ``rasterize_split_plain`` splits and folds as it does, both to the
same bits.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import kernels
from .binning import build_worklist, expand_bboxes, grid_dims, tile_ranges
from .raster import warp_layout

N_PLANES = 8   # b0, b1, b2, z, 1/w, u/w, v/w, extra/w
N_ROWS = N_PLANES * 3
MAX_CHUNK = 256  # the CUDA kernel stages one chunk in shared memory
MAX_TILE_PIXELS = 2048  # 1024 threads x 2 pixels, in 32 warp blocks laid
# out as the compositor's (ops/raster.py warp_layout)
# the block mask's margin: 2^-20 of the magnitudes the kernel's f32 plane
# evaluations sum (their rounding, b2's included, stays below 8 * 2^-24 of
# them)
_MASK_REL = 2.0 ** -20
# worklist entries per step of the plain version: bounds its [B, C, P]
# temporaries (16 x 128 x 2048 f32 = 16 MiB each on the proxy grid)
_PLAIN_BATCH = 16


def triangle_planes(xs, ys, zs, ws, attrs, valid):
    """Per-triangle screen-space plane equations.

    xs, ys: [3, T] pixel coords; zs: [3, T] post-divide clip z; ws: [3, T]
    clip w; attrs: [A<=3, 3, T] per-vertex attributes (perspective-correct).
    Returns (planes [24, T] f32 rows grouped per plane (a, b, c), valid [T],
    bbox (x0f, x1f, y0f, y1f) float pixel bounds).

    Each plane is solved from the differences to vertex 0 (its gradient from
    f1 - f0 and f2 - f0 over the edge vectors, then c = f0 - a x0 - b y0),
    so a large or thin far triangle keeps its depth: from the vertices'
    absolute coordinates, c would sum products of pixel coordinates that
    cancel, and its float32 rounding over a sub-pixel area lifts a depth
    just below the far plane past 1.
    Triangles with any vertex behind the camera (w <= eps) or of no area
    are dropped whole, not clipped: the stated ground mesh (PARITY.md #4)
    covers no pixel with them.
    """
    x0, y0 = xs[0], ys[0]
    dx1, dy1 = xs[1] - x0, ys[1] - y0
    dx2, dy2 = xs[2] - x0, ys[2] - y0
    area2 = dx1 * dy2 - dx2 * dy1
    eps_w = 1e-6
    ok = valid & (ws[0] > eps_w) & (ws[1] > eps_w) & (ws[2] > eps_w)
    ok = ok & (torch.abs(area2) > 1e-12)
    inv_a = torch.where(ok, 1.0 / torch.where(area2 == 0, 1.0, area2), 0.0)
    invw = torch.where(ok, 1.0 / torch.where(ws <= eps_w, 1.0, ws), 0.0)
    # the vertex values of the planes, [P, 3, T]: b0, b1, b2, z, 1/w, and
    # each attribute over w
    eye = torch.eye(3, dtype=xs.dtype, device=xs.device)[:, :, None]
    fs = [eye.expand(3, 3, xs.shape[1]), zs[None], invw[None]]
    if attrs is not None:
        fs.append(attrs[:3] * invw)
    f = torch.cat(fs)
    df1, df2 = f[:, 1] - f[:, 0], f[:, 2] - f[:, 0]
    a = (df1 * dy2 - df2 * dy1) * inv_a
    b = (df2 * dx1 - df1 * dx2) * inv_a
    c = torch.where(ok, f[:, 0] - a * x0 - b * y0, 0.0)
    rows = torch.stack([a, b, c], dim=1).reshape(-1, xs.shape[1])
    planes = torch.zeros((N_ROWS, xs.shape[1]), dtype=rows.dtype,
                         device=rows.device)
    planes[:rows.shape[0]] = rows
    bx0 = torch.minimum(torch.minimum(xs[0], xs[1]), xs[2])
    bx1 = torch.maximum(torch.maximum(xs[0], xs[1]), xs[2])
    by0 = torch.minimum(torch.minimum(ys[0], ys[1]), ys[2])
    by1 = torch.maximum(torch.maximum(ys[0], ys[1]), ys[2])
    return planes, ok, (bx0, bx1, by0, by1)


def _far_tiles(n_tiles, p_n, device):
    tiles = torch.zeros((n_tiles, 5, p_n), dtype=torch.float32, device=device)
    tiles[:, 0] = 1.0  # far plane
    return tiles


def tri_block_mask(blk, rects):
    """The kernel's per-pair warp-block mask (csrc/trirast.cu
    pair_reaches_block), with the same f64 operations in the same order.

    blk: [24, ...] f32 pair rows; rects: [..., 32, 4] (broadcast
    against the pairs' shape) each warp block's rectangle of pixel centres
    in image coordinates (u0, u1, v0, v1), u0 > u1 for a block without
    pixels. Returns [..., 32] bool: False only where no pixel centre of
    the block can pass the kernel's f32 tests b0, b1, b2 >= 0 and
    0 <= z < 1.

    The planes are affine, so each one's extremes over the block lie at its
    corners: the max of a u + b v + c takes u1 where a > 0, else u0 (and
    likewise v). The products of f32 values are exact in f64. A plane whose
    max plus a margin is below 0 fails at every pixel centre, as does z
    whose min less the margin is >= 1. The margin is 2^-20 of the summed
    magnitudes |a| u1 + |b| v1 + |c| (those of b0 and b1, plus 1, for the
    barycentrics, b2 being 1 - b0 - b1 in f32; those of z, plus 1, for z),
    above the f32 evaluation's rounding. A NaN or infinite plane keeps the
    block."""
    k = [t.double()[..., None] for t in blk[:12]]
    a0, b0, c0, a1, b1, c1 = k[:6]
    az, bz, cz = k[9:12]
    u0, u1, v0, v1 = rects.double().unbind(-1)

    def pmax(a, b, c):
        return ((c + torch.where(a > 0.0, a * u1, a * u0))
                + torch.where(b > 0.0, b * v1, b * v0))

    def pmin(a, b, c):
        return ((c + torch.where(a > 0.0, a * u0, a * u1))
                + torch.where(b > 0.0, b * v0, b * v1))

    def mag(a, b, c):
        return (a.abs() * u1 + b.abs() * v1) + c.abs()

    a2, b2, c2 = -(a0 + a1), -(b0 + b1), 1.0 - (c0 + c1)
    mb = _MASK_REL * ((mag(a0, b0, c0) + mag(a1, b1, c1)) + 1.0)
    mz = _MASK_REL * (mag(az, bz, cz) + 1.0)
    out = ~((pmax(a0, b0, c0) + mb < 0.0) | (pmax(a1, b1, c1) + mb < 0.0)
            | (pmax(a2, b2, c2) + mb < 0.0) | (pmax(az, bz, cz) + mz < 0.0)
            | (pmin(az, bz, cz) - mz >= 1.0))
    return out & (u0 <= u1)


def tile_rects(tiles, tile_wh, ntx, rects):
    """[B, 32, 4]: the warp blocks' rectangles (warp_layout's,
    tile-local) moved to each tile's origin in image coordinates."""
    tw, th = tile_wh
    ox = ((tiles % ntx) * tw).to(torch.float32)
    oy = (torch.div(tiles, ntx, rounding_mode="floor") * th).to(torch.float32)
    return rects + torch.stack([ox, ox, oy, oy], dim=-1)[:, None, :]


class _Entries:
    """Evaluates (tile, chunk) entries of a pair table, each on its own, as
    a thread block of the kernel does."""

    def __init__(self, rows, rs, re_, *, image_wh, tile_wh, chunk,
                 block_mask, stats):
        self.rows, self.rs, self.re, self.chunk = rows, rs, re_, chunk
        self.tile_wh = tile_wh
        self.ntx = grid_dims(image_wh, tile_wh)[0]
        tw, _ = tile_wh
        dev = rows.device
        i = torch.arange(tw * tile_wh[1], device=dev)
        self.lx = (i % tw).to(torch.float32)
        self.ly = torch.div(i, tw, rounding_mode="floor").to(torch.float32)
        self.lane = torch.arange(chunk, device=dev)
        self.block_mask = block_mask
        self.stats = stats
        if block_mask or stats is not None:
            self.rects, self.warp = warp_layout(tile_wh, dev)
            self.n_blocks = int((self.rects[:, 0] <= self.rects[:, 1]).sum())
            # pairs, inside, hits, covered, visits, blocks, missed
            self.load = torch.zeros(7, dtype=torch.int64, device=dev)

    def __call__(self, tiles, chunks):
        """[B, 5, P]: per pixel the chunk's nearest hit z (1 where none) and
        the mean of the attributes of its pairs at exactly that z (0 where
        none)."""
        rows, chunk, tw = self.rows, self.chunk, self.tile_wh[0]
        n_pairs = rows.shape[1]
        slot = chunks[:, None] * chunk + self.lane  # [B, C]
        in_run = ((slot >= self.rs[tiles, None])
                  & (slot < self.re[tiles, None]))
        blk = rows[:, torch.clamp(slot, max=n_pairs - 1)]  # [24, B, C]
        px = (((tiles % self.ntx) * tw)[:, None].to(torch.float32)
              + self.lx + 0.5)
        py = (torch.div(tiles, self.ntx, rounding_mode="floor")
              * self.tile_wh[1])[:, None].to(torch.float32) + self.ly + 0.5
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
        if self.block_mask or self.stats is not None:
            reach = tri_block_mask(
                blk, tile_rects(tiles, self.tile_wh, self.ntx,
                                self.rects)[:, None])
            reach &= in_run[..., None]  # [B, C, 32]
            px_reach = reach[..., self.warp]  # [B, C, P]
            hits = inside & (z >= 0.0) & (z < 1.0)
            self.load += torch.stack([
                in_run.sum(), inside.sum(), hits.sum(), px_reach.sum(),
                reach.sum(), in_run.sum() * self.n_blocks,
                (hits & ~px_reach).sum()])
            if self.block_mask:
                inside &= px_reach
        zk = torch.where(inside & (z >= 0.0), z, 2.0)  # near-plane clip
        zmin = zk.amin(dim=1, keepdim=True)  # [B, 1, P]
        hit = zmin < 1.0
        wmask = (zk == zmin) & inside
        cnt = torch.clamp(wmask.sum(dim=1, keepdim=True)
                          .to(torch.float32), min=1.0)
        res = [torch.where(hit, zmin, 1.0)[:, 0]]
        for k in range(4, 8):
            q = torch.where(wmask, ev(k), 0.0).sum(dim=1, keepdim=True)
            res.append(torch.where(hit, q / cnt, 0.0)[:, 0])
        return torch.stack(res, dim=1)  # [B, 5, P]

    def finish(self):
        if self.stats is None:
            return
        keys = ("pairs", "inside", "hits", "covered", "visits", "blocks",
                "missed")
        self.stats.update(zip(keys, (int(x) for x in self.load)))
        p_n = self.tile_wh[0] * self.tile_wh[1]
        self.stats["pair_pixels"] = self.stats["pairs"] * p_n
        live = self.re > self.rs
        self.stats["runs"] = self.re - self.rs
        c0 = torch.div(self.rs, self.chunk, rounding_mode="floor")
        c1 = torch.div(self.re - 1, self.chunk, rounding_mode="floor")
        self.stats["chunks"] = torch.where(live, c1 - c0 + 1, 0)


def _worklist_ranks(rs, re_, chunk):
    """(entry tile, entry chunk, rank of the chunk in its tile's run)."""
    wl = build_worklist(rs, re_, chunk=chunk)
    et = wl["entry_tile"].long()
    ec = wl["entry_chunk"].long()
    return et, ec, ec - torch.div(rs[et], chunk, rounding_mode="floor")


def _fold(tiles_out, partial, et, rank):
    """Fold entry results into the tiles rank by rank (a tile's chunks in
    order): a chunk replaces a pixel only where its z is strictly below the
    pixel's so far (1 where nothing hit yet)."""
    for r in range(int(rank.max()) + 1 if rank.numel() else 0):
        idx = torch.nonzero(rank == r).flatten()
        for b0 in range(0, idx.numel(), _PLAIN_BATCH):
            sel = idx[b0:b0 + _PLAIN_BATCH]
            new = partial(sel)
            cur = tiles_out[et[sel]]
            upd = new[:, 0:1] < cur[:, 0:1]
            tiles_out[et[sel]] = torch.where(upd, new, cur)
    return tiles_out


def rasterize_triangles_plain(rows, range_start, range_end, *, image_wh,
                              tile_wh, chunk: int = 128,
                              block_mask: bool = False, stats=None):
    """Plain PyTorch rasterizer of tile-sorted pair rows, with the kernel's
    semantics (same arguments as rasterize_pair_rows).

    Worklist entries (tile, chunk) are processed rank by rank: rank r holds
    the r-th chunk of every tile that has one, so each tile's running z is
    known before its next chunk. Chunks begin at global multiples of
    `chunk` in the pair table. Within a chunk the nearest inside pair wins
    and the attributes of all pairs of the chunk at exactly that z are
    averaged; the chunk replaces a pixel only where its z is below 1 and
    strictly below the pixel's z so far.

    block_mask=True skips, as the kernel does, the pair-pixels of the warp
    blocks that tri_block_mask leaves out: the result is the same to the
    bit. With `stats` (a dict) records the load: "pairs" (in runs),
    "pair_pixels" (times the tile's pixels), "inside" (pair-pixels inside
    their triangle), "hits" (of those, 0 <= z < 1), "covered" (pair-pixels
    of the warp blocks the mask keeps), "visits" / "blocks" ((pair, warp
    block) visits the mask keeps / all), "missed" (hits in a block the
    mask leaves out: 0 when it is conservative), "runs" and "chunks"
    ([n_tiles] run lengths and chunks per tile)."""
    tw, th = tile_wh
    n_tiles = grid_dims(image_wh, tile_wh)[2]
    rs, re_ = range_start.long(), range_end.long()
    tiles_out = _far_tiles(n_tiles, tw * th, rows.device)
    entries = _Entries(rows, rs, re_, image_wh=image_wh, tile_wh=tile_wh,
                       chunk=chunk, block_mask=block_mask, stats=stats)
    et, ec, rank = _worklist_ranks(rs, re_, chunk)
    _fold(tiles_out, lambda sel: entries(et[sel], ec[sel]), et, rank)
    entries.finish()
    return tiles_out


def trirast_entries_plain(rows, range_start, range_end, *, image_wh,
                          tile_wh, chunk: int = 128):
    """Plain version of the entry kernel (csrc/trirast.cu trirast_kernel):
    every (tile, chunk) entry rasterized on its own, skipping what
    tri_block_mask leaves out, into (scratch, out). A tile with an empty run
    is far plane in `out`, a tile of one chunk has its result there; an
    entry of a longer run leaves its partial (its
    nearest hit z, 1 where none, and its ties' mean) in scratch slot 2c + 1
    for the tile's first chunk c, 2c for a later one (fold_scratch). What
    the kernel leaves unwritten is NaN here."""
    tw, th = tile_wh
    n_tiles = grid_dims(image_wh, tile_wh)[2]
    rs, re_ = range_start.long(), range_end.long()
    entries = _Entries(rows, rs, re_, image_wh=image_wh, tile_wh=tile_wh,
                       chunk=chunk, block_mask=True, stats=None)
    et, ec, _ = _worklist_ranks(rs, re_, chunk)
    scratch = fold_scratch(rows.shape[1], tile_wh, chunk, rows.device)
    scratch.fill_(torch.nan)
    out = torch.full((n_tiles, 5, tw * th), torch.nan, device=rows.device)
    out[re_ <= rs] = _far_tiles(1, tw * th, rows.device)
    c0 = torch.div(rs, chunk, rounding_mode="floor")
    c1 = torch.div(re_ - 1, chunk, rounding_mode="floor")
    for b in range(0, et.numel(), _PLAIN_BATCH):
        t, c = et[b:b + _PLAIN_BATCH], ec[b:b + _PLAIN_BATCH]
        res = entries(t, c)
        single = c0[t] == c1[t]
        out[t[single]] = res[single]
        scratch[(2 * c + (c == c0[t]))[~single]] = res[~single]
    return scratch, out


def rasterize_split_plain(rows, range_start, range_end, *, image_wh, tile_wh,
                          chunk: int = 128):
    """The kernels' split in plain PyTorch: trirast_entries_plain, then
    trirast_fold_plain. Equal to the bit to rasterize_triangles_plain."""
    scratch, out = trirast_entries_plain(
        rows, range_start, range_end, image_wh=image_wh, tile_wh=tile_wh,
        chunk=chunk)
    return trirast_fold_plain(scratch, out, range_start, range_end,
                              chunk=chunk)


_entry = None


def _launch(rows, range_start, range_end, out, scratch, *, ntx, tile_wh,
            chunk, mode):
    """One call of the C entry (resolved once): mode 1 the entry kernel, 2
    the fold (when a run can cross a chunk), 3 both."""
    global _entry
    if _entry is None:
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        _entry = kernels.load("trirast", gswt_trirast=[
            vp, ll, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]).gswt_trirast
    rc = _entry(
        rows.data_ptr(), rows.shape[1], range_start.data_ptr(),
        range_end.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        range_start.shape[0], ntx, tile_wh[0], tile_wh[1], chunk, mode,
        kernels.stream_ptr(out))
    if mode & 1:
        kernels.LAUNCHES["trirast"] += 1
    if mode & 2 and rows.shape[1] > chunk:  # a run can cross a chunk
        kernels.LAUNCHES["trirast_fold"] += 1
    kernels.check(rc, "trirast")


def fold_scratch(n_pairs, tile_wh, chunk, device):
    """The entries' partials for the fold: two slots per global chunk (the
    tile whose run crosses the chunk's start, and the one that starts in it
    and crosses its end), [2 * ceil(n_pairs / chunk), 5, P] f32."""
    n_chunks = -(-n_pairs // chunk)
    return torch.empty((2 * n_chunks, 5, tile_wh[0] * tile_wh[1]),
                       dtype=torch.float32, device=device)


def trirast_fold_plain(scratch, entry_out, range_start, range_end, *,
                       chunk: int):
    """Plain version of the fold kernel (csrc/trirast.cu
    trirast_fold_kernel): from the entries' partials in `scratch`
    (fold_scratch's slots) and the tiles the entries wrote (`entry_out`,
    kept for the empty tiles and those of one chunk), the raster: a run of
    several chunks folded in chunk order, the first chunk at the smallest z
    winning."""
    out = entry_out.clone()
    rs, re_ = range_start.long(), range_end.long()
    live = re_ > rs
    c0 = torch.div(rs, chunk, rounding_mode="floor")
    c1 = torch.div(re_ - 1, chunk, rounding_mode="floor")
    multi = torch.nonzero(live & (c1 > c0)).flatten()
    if multi.numel() == 0:
        return out
    cur = _far_tiles(multi.numel(), out.shape[2], out.device)
    for k in range(int((c1 - c0)[multi].max()) + 1):
        c = c0[multi] + k
        slot = torch.clamp(2 * c + (k == 0), max=scratch.shape[0] - 1)
        new = scratch[slot]
        upd = (c <= c1[multi])[:, None, None] & (new[:, 0:1] < cur[:, 0:1])
        cur = torch.where(upd, new, cur)
    out[multi] = cur
    return out


def rasterize_pair_rows(rows, range_start, range_end, *, image_wh, tile_wh,
                        chunk: int = 128):
    """Min-z raster of tile-sorted pair rows [24, n_pairs] with per-tile
    runs range_start/range_end [n_tiles] i32 -> [n_tiles, 5, P] (rows: z,
    1/w, u/w, v/w, extra/w); a tile with an empty run reads far plane
    (z = 1, attributes 0). CPU tensors take the plain version; CUDA tensors
    launch the kernels (the entries, then the fold)."""
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
    _launch(rows, range_start, range_end, out,
            fold_scratch(rows.shape[1], tile_wh, chunk, dev), ntx=ntx,
            tile_wh=tile_wh, chunk=chunk, mode=3)
    return out


def on_image(bbox, image_wh):
    """[T] bool: the triangles whose pixel box (triangle_planes' bbox)
    meets the image."""
    bx0, bx1, by0, by1 = bbox
    return (bx1 >= 0) & (bx0 < image_wh[0]) & (by1 >= 0) & (by0 < image_wh[1])


def bin_triangles(planes, bbox, ok, *, image_wh, tile_wh, capacity: int,
                  return_index: bool = False):
    """Expand triangles into (tile, triangle) pairs in `capacity` slots
    (ops/binning.py expand_bboxes: triangle-major, so an overflowing frame
    keeps its first triangles' pairs), sorted by tile (triangle order kept
    inside a tile, the dead slots last). Returns (rows [24, capacity], range_start,
    range_end [n_tiles] i32, n_pairs: the demand, a 0-d tensor), and with
    return_index also the slots' (tile, triangle) indices [capacity] i64."""
    tw, th = tile_wh
    ntx, nty, n_tiles = grid_dims(image_wh, tile_wh)
    bx0, bx1, by0, by1 = bbox
    # clamping before the integer conversion matches XLA's saturating
    # float->int convert for off-grid values
    x0 = torch.clamp(torch.floor(bx0 / tw), 0, ntx - 1).long()
    x1 = torch.clamp(torch.floor(bx1 / tw), 0, ntx - 1).long()
    y0 = torch.clamp(torch.floor(by0 / th), 0, nty - 1).long()
    y1 = torch.clamp(torch.floor(by1 / th), 0, nty - 1).long()
    sorted_key, sorted_tri, total, _ = expand_bboxes(
        x0, x1, y0, y1, ok & on_image(bbox, image_wh), ntx=ntx,
        n_tiles=n_tiles,
        capacity=capacity)
    rows = planes[:, sorted_tri].contiguous()  # [24, n_pairs]
    range_start, range_end = tile_ranges(sorted_key, n_tiles)
    if return_index:
        return rows, range_start, range_end, total, sorted_key, sorted_tri
    return rows, range_start, range_end, total


def rasterize_triangles(planes, bbox, ok, *, image_wh, tile_wh,
                        chunk: int = 128, capacity: int):
    """Rasterize triangles with min-z. planes/bbox/ok from triangle_planes;
    capacity: the pair slots (bin_triangles).

    Returns dict: tiles [n_tiles, 5, P] (rows: z, 1/w, u/w, v/w, extra/w),
    n_pairs (the demand) and overflow (n_pairs > capacity), 0-d tensors.
    Reassemble per-pixel images with tiles_to_maps.
    """
    rows, range_start, range_end, total = bin_triangles(
        planes, bbox, ok, image_wh=image_wh, tile_wh=tile_wh,
        capacity=capacity)
    tiles = rasterize_pair_rows(rows, range_start, range_end,
                                image_wh=image_wh, tile_wh=tile_wh,
                                chunk=chunk)
    return dict(tiles=tiles, n_pairs=total, overflow=total > rows.shape[1])


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
