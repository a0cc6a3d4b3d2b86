#!/usr/bin/env python
"""Microbenchmark of compositor precision variants at the 1080p headline scale.

    python -m gswt_renderer_tpu_torch.benchmarks.micro_raster \
        [--pairs 4194304] [--width 1920 --height 1080] [--device cuda]

Synthesizes a binned pair table with uniform tile occupancy and composites
it with five variants of the kernel ``csrc/micro_raster.cu``:
  A   global pixel monomials, exponent f32, colour sums f32
  B   global monomials, exponent f32, colours and weights rounded to bf16
  C   tile-local recentred monomials, exponent split2 (bf16 hi/lo), bf16 sums
  C2  tile-local monomials, exponent f32, colour sums f32
  D   C with the exponent's operands rounded to bf16 once (accuracy reference)
Prints each variant's ms and its max |err| against A.

Row 11 of the table is the raw alpha, which these variants multiply into
exp(e) (the production compositor adds ln(alpha) in the exponent instead).
On the card ``composite`` launches the kernel; on CPU tensors it runs
``composite_plain``. The kernel has the production compositor's design
(csrc/raster.cu): each of its 32 warps skips the pairs that cannot reach
the cutoff in its block of the tile, by a per-pair f64 mask whose margin
bounds the variant's own rounding of the exponent (``MASK_REL``);
``composite_plain(block_mask=True)`` skips alike, to the same bits.
"""

from __future__ import annotations

import argparse
import ctypes
import re

import numpy as np
import torch

from ..ops import kernels
from ..ops import raster as traster
from ..ops.binning import build_worklist, round_bf16, tile_ranges
from ..ops.kernels import resolve_device
from .timing import device_label, time_ms

CUTOFF = -4.0
MIN_T = 0.5 / 255.0
MAX_CHUNK = 256          # the CUDA kernel stages one chunk in shared memory
MAX_TILE_PIXELS = 2048   # 1024 threads x 2 pixels
PRECISIONS = ("highest", "split2", "default")
# the block mask's relative margin per precision, above how far the
# variant's own evaluation of the exponent can fall from the exact quadratic
# of its f32 table, over the magnitude of its terms (csrc/micro_raster.cu
# derives the bounds: f32 below 2^-21.4, split2 below 3.1 * 2^-16, default
# below 2^-7 + 2^-16 + 2^-21.3)
MASK_REL = {"highest": 2.0 ** -20, "split2": 2.0 ** -13, "default": 2.0 ** -6}
# name -> (local, prec, bf2, description)
VARIANTS = {
    "A": (False, "highest", False, "global feats, highest/highest"),
    "B": (False, "highest", True, "global feats, highest/bf16"),
    "C": (True, "split2", True, "local feats, split2/bf16"),
    "C2": (True, "highest", False, "local feats, highest/highest"),
    "D": (True, "default", True, "local feats, default/bf16"),
}
# worklist entries per step of the plain version: bounds its [B, C, P]
# temporaries (64 x 256 x 2048 f32 = 128 MiB each at 1080p)
_PLAIN_BATCH = 64


def _grid(image_wh, tile_wh):
    ntx = -(-image_wh[0] // tile_wh[0])
    nty = -(-image_wh[1] // tile_wh[1])
    return ntx, nty, ntx * nty


def recentre(table, pair_tile, *, ntx, tile_wh):
    """The table with k3, k4, k5 of every pair moved to its tile's origin:
    e(x, y) = k0 x^2 + k1 xy + k2 y^2 + k3 x + k4 y + k5 at global
    coordinates becomes the same quadratic in (u, v) = (x - ox, y - oy)."""
    tw, th = tile_wh
    k0, k1, k2, k3, k4, k5 = (table[i] for i in range(6))
    ox = (pair_tile % ntx).to(torch.float32) * tw
    oy = torch.div(pair_tile, ntx, rounding_mode="floor").to(torch.float32) * th
    k3l = 2.0 * k0 * ox + k1 * oy + k3
    k4l = k1 * ox + 2.0 * k2 * oy + k4
    k5l = k0 * ox * ox + k1 * ox * oy + k2 * oy * oy + k3 * ox + k4 * oy + k5
    return torch.cat([table[0:3], k3l[None], k4l[None], k5l[None], table[6:]],
                     dim=0)


def _dot5(k, f):
    """k0 f0 + ... + k4 f4, left to right, every operation rounded on its
    own (the kernel's order)."""
    e = k[0] * f[0]
    for i in range(1, 5):
        e = e + k[i] * f[i]
    return e


def _exponent(k, f, prec):
    """e = k . (f0..f4, 1) in the given precision. k: six [B, C, 1]
    coefficient columns; f: five [B, 1, P] monomials."""
    if prec == "highest":
        return _dot5(k, f) + k[5]
    kh = [round_bf16(x) for x in k]
    fh = [round_bf16(x) for x in f]
    e = _dot5(kh, fh) + kh[5]
    if prec == "default":
        return e
    # split2: (hi + lo) . (hi + lo) without lo . lo; the sixth monomial is
    # 1, whose hi is 1 and whose lo is 0
    kl = [round_bf16(x - h) for x, h in zip(k, kh)]
    fl = [round_bf16(x - h) for x, h in zip(f, fh)]
    return e + (_dot5(kh, fl) + (_dot5(kl, fh) + kl[5]))


def block_reach(blk, tiles, rects, dmax, *, ntx, tile_wh, local, rel):
    """[B, C, 32] bool: the kernel's pair-block mask for the pairs blk [16,
    B, C] of tiles [B], with the kernel's f64 operations in its order.
    Two tests, both conservative: the box, then ops/raster.py
    pair_block_mask with the relative margin `rel` (the exact max of the
    quadratic over the block). The box bounds the ellipse on which e
    reaches the tile's lowest limit (its far corner's), its radius widened
    by 2^-30 and 1 against f64 rounding; a block outside it is left out (a
    pair whose peak is below that limit has an empty box; a quadratic that
    is not negative definite has no box). The warp blocks' rectangles
    `rects` from warp_layout are moved to each tile's origin unless `local`,
    as the kernel moves them; dmax [B, 32] is each block's largest depth."""
    tw, th = tile_wh
    far = torch.tensor([tw - 0.5, th - 0.5], dtype=torch.float32,
                       device=blk.device)
    if not local:
        ox = (tiles % ntx * tw).to(torch.float32)
        oy = (torch.div(tiles, ntx, rounding_mode="floor")
              * th).to(torch.float32)
        org = torch.stack([ox, ox, oy, oy], dim=-1)[:, None, None]  # [B,1,1,4]
        rects = rects + org
        far = far + org[..., 1:3]
    reach = traster.pair_block_mask(blk[:6], blk[6], rects, dmax[:, None, :],
                                    rel=rel)
    pk = traster.pair_peak(blk[:6])
    u1_t, v1_t = far.double().unbind(-1)
    _, lim_t = traster.mask_limit(pk, u1_t, v1_t, rel)
    r = pk["ec"] - lim_t
    open_ = pk["definite"] & (r > 0.0)
    rp = torch.where(open_, r, 0.0) * (1.0 + 2.0 ** -30) + 1.0
    inv = 2.0 * pk["half_inv"]
    hx = torch.sqrt((rp * pk["c"]) * inv)
    hy = torch.sqrt((rp * pk["a"]) * inv)
    inf = torch.full_like(hx, torch.inf)

    def edge(x, empty):
        # x where the box is open, `empty` where the peak is below the
        # limit, unbounded (-empty) where the quadratic is not definite
        return torch.where(pk["definite"], torch.where(open_, x, empty),
                           -empty)

    xl, xr = edge(pk["uc"] - hx, inf), edge(pk["uc"] + hx, -inf)
    yl, yr = edge(pk["vc"] - hy, inf), edge(pk["vc"] + hy, -inf)
    u0, u1, v0, v1 = rects.double().unbind(-1)
    return reach & (u0 <= xr) & (u1 >= xl) & (v0 <= yr) & (v1 >= yl)


def composite_plain(binned, depth_tiles, *, image_wh, tile_wh, chunk: int,
                    local: bool, prec: str, bf2: bool, block_mask=False,
                    stats=None):
    """Plain PyTorch version of `composite`, in the kernel's order of
    operations. Worklist entries (tile, chunk) are processed rank by rank,
    so each tile's carried T is known before its next chunk starts; an entry
    is skipped when its tile's max carried T is below MIN_T. Within an entry
    the pairs are walked one by one, w = (g Tl) Tc then Tl *= 1 - g, as the
    kernel's threads do. block_mask=True skips, as the kernel does, the
    pair-pixels of the warp blocks that the variant's mask (`block_reach`,
    margin MASK_REL[prec]) leaves out: the result is the same to the bit.
    With `stats` (a dict) records under "pairs" the pairs composited before
    the early exit, under "kept" the pair-pixels of those that pass the
    cutoff and the depth test, under "mag" [T, P] each pixel's sum of |w|
    (the magnitude its four sums' rounding scales with: at most 1 while
    every g lies in [0, 1]), under "visits" the (pair, warp block) visits
    the mask keeps of "blocks" (pairs times the blocks with pixels), and
    under "missed" the kept pair-pixels whose block the mask leaves out (0
    when the mask is conservative)."""
    tw, th = tile_wh
    ntx, _, n_tiles = _grid(image_wh, tile_wh)
    p_n = tw * th
    table = binned["table"]
    dev = table.device
    rs = binned["range_start"].long()
    re_ = binned["range_end"].long()
    wl = build_worklist(rs, re_, chunk=chunk)
    et = wl["entry_tile"].long()
    ec = wl["entry_chunk"].long()
    rank = ec - torch.div(rs[et], chunk, rounding_mode="floor")
    pix = torch.arange(p_n, device=dev)
    px = (pix % tw).to(torch.float32)
    py = torch.div(pix, tw, rounding_mode="floor").to(torch.float32)
    acc = torch.zeros((n_tiles, 4, p_n), dtype=torch.float32, device=dev)
    trans = torch.ones((n_tiles, p_n), dtype=torch.float32, device=dev)
    lane = torch.arange(chunk, device=dev)
    composited = torch.zeros((), dtype=torch.int64, device=dev)
    masked = block_mask or stats is not None
    if masked:
        rects, warp = traster.warp_layout(tile_wh, dev)
        dmax = traster.warp_depth_max(depth_tiles, warp)
        n_blocks = int((rects[:, 0] <= rects[:, 1]).sum())
        # kept pair-pixels, (pair, block) visits kept, kept pair-pixels missed
        load = torch.zeros(3, dtype=torch.int64, device=dev)
    mag = torch.zeros_like(trans) if stats is not None else None
    n_rank = int(rank.max()) + 1 if rank.numel() else 0
    for r in range(n_rank):
        idx = torch.nonzero(rank == r).flatten()
        idx = idx[trans[et[idx]].amax(dim=1) >= MIN_T]
        for b0 in range(0, idx.numel(), _PLAIN_BATCH):
            sel = idx[b0:b0 + _PLAIN_BATCH]
            tiles = et[sel]
            cols = ec[sel, None] * chunk + lane  # [B, C]
            blk = table[:, cols]  # [16, B, C]
            in_run = (cols >= rs[tiles, None]) & (cols < re_[tiles, None])
            if local:
                x, y = (px + 0.5)[None, None], (py + 0.5)[None, None]
            else:
                ox = (tiles % ntx * tw).to(torch.float32)[:, None, None]
                oy = (torch.div(tiles, ntx, rounding_mode="floor")
                      * th).to(torch.float32)[:, None, None]
                x, y = (ox + px) + 0.5, (oy + py) + 0.5  # [B, 1, P]
            e = _exponent([blk[i][..., None] for i in range(6)],
                          [x * x, x * y, y * y, x, y], prec)
            mask = ((e >= CUTOFF) & in_run[..., None]
                    & (blk[6][..., None] < depth_tiles[tiles][:, None, :]))
            if masked:
                reach = block_reach(blk, tiles, rects, dmax[tiles], ntx=ntx,
                                    tile_wh=tile_wh, local=local,
                                    rel=MASK_REL[prec])
                reach &= in_run[..., None]  # [B, C, 32]
                px_reach = reach[..., warp]  # [B, C, P]
                load += torch.stack([mask.sum(), reach.sum(),
                                     (mask & ~px_reach).sum()])
                if block_mask:
                    mask &= px_reach
            g = torch.where(mask, torch.exp(e) * blk[11][..., None], 0.0)
            omg = 1.0 - g
            t_carry = trans[tiles]  # [B, P]
            t_loc = torch.ones_like(t_carry)
            weight = g  # overwritten lane by lane: g[:, j] is read first
            for j in range(chunk):
                torch.mul(g[:, j] * t_loc, t_carry, out=weight[:, j])
                t_loc = t_loc * omg[:, j]
            rgb1 = torch.stack(
                [blk[8], blk[9], blk[10], torch.ones_like(blk[8])], dim=1)
            if bf2:
                weight = round_bf16(weight)
                rgb1 = round_bf16(rgb1)
            acc[tiles] += torch.bmm(rgb1, weight)
            trans[tiles] = t_carry * t_loc
            composited += in_run.sum()
            if stats is not None:
                mag[tiles] += weight.abs().sum(dim=1)
    if stats is not None:
        kept, visits, missed = (int(x) for x in load)
        stats.update(pairs=int(composited), kept=kept, mag=mag, visits=visits,
                     blocks=int(composited) * n_blocks, missed=missed)
    return acc


def composite(binned, depth_tiles, *, image_wh, tile_wh, chunk: int,
              local: bool, prec: str, bf2: bool):
    """Composite the binned table into [T, 4, P] colour + alpha tile blocks
    with one precision variant.

    binned: table [16, dom] float32 (rows 0-5 the exponent quadratic at
    global pixel coordinates, or tile-local after `recentre` when `local`;
    6 z; 8-10 colour; 11 alpha), range_start / range_end [T] int32.
    depth_tiles [T, P]: pairs are tested `z < depth`. prec: "highest",
    "split2" or "default", the exponent's precision; bf2: colours and
    weights rounded to bf16 before the f32 sums.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which stages whole chunks with 16-B aligned bulk copies: it takes chunk
    a multiple of 4 and a 16-B aligned table whose dom is a multiple of
    chunk, and raises on any other."""
    if prec not in PRECISIONS:
        raise ValueError(f"prec must be one of {PRECISIONS}")
    kw = dict(image_wh=image_wh, tile_wh=tile_wh, chunk=chunk, local=local,
              prec=prec, bf2=bf2)
    table = binned["table"]
    if not table.is_cuda:
        return composite_plain(binned, depth_tiles, **kw)
    tw, th = tile_wh
    ntx, _, n_tiles = _grid(image_wh, tile_wh)
    p_n = tw * th
    if chunk > MAX_CHUNK or chunk % 4 or p_n > MAX_TILE_PIXELS:
        raise ValueError(f"the CUDA kernel takes chunk <= {MAX_CHUNK}, a "
                         f"multiple of 4, and tiles of <= {MAX_TILE_PIXELS} "
                         f"pixels")
    rs, re_ = binned["range_start"], binned["range_end"]
    dev = table.device
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
            or depth_tiles.shape != (n_tiles, p_n)
            or depth_tiles.device != dev):
        raise ValueError(f"depth_tiles must be contiguous float32 "
                         f"[{n_tiles}, {p_n}]")
    out = torch.empty((n_tiles, 4, p_n), dtype=torch.float32, device=dev)
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib = kernels.load("micro_raster", gswt_micro_raster=[
        vp, ll, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, vp])
    rc = lib.gswt_micro_raster(
        kernels.ptr(table), table.shape[1], kernels.ptr(rs), kernels.ptr(re_),
        kernels.ptr(depth_tiles), kernels.ptr(out), n_tiles, ntx, tw, th,
        chunk, int(bool(local)), PRECISIONS.index(prec), int(bool(bf2)),
        kernels.stream_ptr(table))
    kernels.LAUNCHES["micro_raster"] += 1
    kernels.check(rc, "micro_raster")
    return out


def ptxas_by_variant(report: str) -> dict:
    """{(local, prec index, bf2): "stack and spill; registers and shared
    memory"} for each micro_raster_kernel instantiation in a -Xptxas -v
    report of csrc/micro_raster.cu (kernels.ptxas_report)."""
    regs, inst = {}, None
    for line in report.splitlines():
        hit = re.search(r"micro_raster_kernelILb(\d)ELi(\d)ELb(\d)E", line)
        if "Compiling entry function" in line:
            inst = tuple(int(x) for x in hit.groups()) if hit else None
        elif inst is not None and ("registers" in line or "spill" in line):
            regs.setdefault(inst, []).append(line.split(":")[-1].strip())
    return {k: "; ".join(v) for k, v in regs.items()}


def make_binned(max_pairs, image_wh, tile_wh, seed=0, device="cpu"):
    """Synthetic binned inputs with uniform tile occupancy: max_pairs / 1.6
    live pairs sorted by tile, the rest dead (key n_tiles, k5 = -1e30).
    Per-pair gaussians: centre within a tile of the pair's own, extents
    1.5-12 px. Row 11 is the raw alpha in [0, 0.8], which the variants
    multiply into exp(e). Returns table, range_start, range_end, pair_tile
    and the sorted tile key."""
    rng = np.random.default_rng(seed)
    tw, th = tile_wh
    ntx, _, n_tiles = _grid(image_wh, tile_wh)
    n_pairs = int(max_pairs / 1.6)
    key = np.sort(rng.integers(0, n_tiles, n_pairs).astype(np.int32))
    key = np.concatenate([key, np.full(max_pairs - n_pairs, n_tiles, np.int32)])
    dead = key >= n_tiles
    tile = np.minimum(key, n_tiles - 1)
    cx = (tile % ntx).astype(np.float32) * tw + rng.uniform(-tw, 2 * tw, max_pairs)
    cy = (tile // ntx).astype(np.float32) * th + rng.uniform(-th, 2 * th, max_pairs)
    sx = rng.uniform(1.5, 12.0, max_pairs)
    sy = rng.uniform(1.5, 12.0, max_pairs)
    rho = rng.uniform(-0.7, 0.7, max_pairs)
    # conic of the covariance [[sx^2, rho sx sy], [rho sx sy, sy^2]];
    # exponent = -(a dx^2 + 2 b dx dy + c dy^2), expanded into the k form
    det = (sx * sy) ** 2 * (1 - rho ** 2)
    a = 0.5 * sy * sy / det
    b = -0.5 * rho * sx * sy / det
    c = 0.5 * sx * sx / det
    k5 = np.where(dead, -1e30, -(a * cx * cx + 2 * b * cx * cy + c * cy * cy))
    z = rng.uniform(0.01, 0.99, max_pairs)
    col = rng.uniform(0, 1, (4, max_pairs))
    alpha = np.where(dead, 0.0, col[3] * 0.8)
    table = np.zeros((16, max_pairs), np.float32)
    for i, v in enumerate([-a, -2 * b, -c, 2 * a * cx + 2 * b * cy,
                           2 * b * cx + 2 * c * cy, k5, z,
                           np.zeros(max_pairs), col[0], col[1], col[2], alpha]):
        table[i] = v
    key_t = torch.from_numpy(key).to(device)
    rs, re_ = tile_ranges(key_t, n_tiles)
    return dict(table=torch.from_numpy(table).to(device), range_start=rs,
                range_end=re_, pair_tile=torch.from_numpy(tile).to(device),
                key=key_t)


def variant_inputs(binned, name, *, image_wh, tile_wh):
    """(binned as the variant reads it, its keyword arguments)."""
    local, prec, bf2, _ = VARIANTS[name]
    if local:
        ntx = _grid(image_wh, tile_wh)[0]
        binned = dict(binned, table=recentre(
            binned["table"], binned["pair_tile"], ntx=ntx, tile_wh=tile_wh))
    return binned, dict(local=local, prec=prec, bf2=bf2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=1 << 22)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--tile", type=int, nargs=2, default=(64, 32),
                    metavar=("W", "H"))
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    image_wh = (args.width, args.height)
    tile_wh = tuple(args.tile)
    n_tiles = _grid(image_wh, tile_wh)[2]
    binned = make_binned(args.pairs, image_wh, tile_wh, device=dev)
    depth = torch.ones((n_tiles, tile_wh[0] * tile_wh[1]), device=dev)
    print(f"tile {tile_wh[0]}x{tile_wh[1]}, pairs {args.pairs}, on "
          f"{device_label(dev)}")
    ref, results = None, {}
    for name, (_, _, _, text) in VARIANTS.items():
        b, kw = variant_inputs(binned, name, image_wh=image_wh,
                               tile_wh=tile_wh)
        kw.update(image_wh=image_wh, tile_wh=tile_wh, chunk=args.chunk)
        out = composite(b, depth, **kw)
        t = time_ms(lambda: composite(b, depth, **kw), args.reps, dev)
        ref = out if ref is None else ref
        err = float((out - ref).abs().amax())
        results[name] = dict(ms=t, err_vs_a=err)
        print(f"  {name + ': ' + text:40s} {t:9.3f} ms  maxerr={err:.2e}",
              flush=True)
    return results


if __name__ == "__main__":
    main()
