"""Tile binning: expand projected splats into (image-tile, splat) pairs,
order them, and build the pair table the compositor reads.

The wgpu reference rasterizes via instanced quads; here, as in the JAX
package, each splat lands in every (tile_h x tile_w) pixel block its bbox
overlaps, and within a tile splats keep front-to-back stream order so
ordered alpha blending is exact.

The pairs are enumerated splat-major into a capacity the caller gives (so
within a tile they ascend in stream slot, and a frame whose demand exceeds
the capacity keeps its front-most pairs, as the JAX package's budget does),
with no read of the demand on the host: the true demand and an overflow
flag come back as 0-d device tensors. Pairs past the demand, and those the
exact ellipse-tile cull finds cannot reach the cutoff, are dead; each
tile's run holds its live pairs in the joint (tile, slot) order, the dead
slots after every run. The plain version (bin_pairs_plain, the CPU path)
gives the dead pairs the key `n_tiles` and sorts by tile stably; on the card
csrc/binning.cu counts the pairs per tile and scatters each into its place,
a stable counting sort that writes the table where it lies.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.hostprof import _hprof
from . import kernels


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


def fit_capacity(demand, chunk: int) -> int:
    """The capacity of `demand` pairs: rounded up to a whole chunk, at
    least one chunk (a host int; `demand` may be a 0-d tensor, whose read
    waits for the device)."""
    return max(-(-int(demand) // chunk), 1) * chunk


def _expand(x0, y0, nx, count, *, ntx, n_tiles, capacity):
    """Enumerate the pairs of inclusive tile bboxes, primitive-major, into
    `capacity` slots: pair k of primitive i covers tile (x0 + k % nx,
    y0 + k // nx). Pair slot j finds its primitive by a search of the
    inclusive cumsum of `count`; slots at or past the demand are dead and
    take tile `n_tiles`. Returns (prim [capacity] i64, tile [capacity] i64,
    total, overflow): the true demand and whether it exceeds the capacity,
    0-d tensors. Needs at least one primitive (bin_pairs pads an empty
    stream)."""
    incl = torch.cumsum(count, 0)
    total = incl[-1]
    j = torch.arange(capacity, device=count.device)
    prim = torch.clamp(torch.searchsorted(incl, j, right=True),
                       max=count.shape[0] - 1)
    k = j - (incl - count)[prim]
    nxp = torch.clamp(nx[prim], min=1)
    tx = x0[prim] + k % nxp
    ty = y0[prim] + torch.div(k, nxp, rounding_mode="floor")
    tile = torch.where(j < total, ty * ntx + tx, n_tiles)
    return prim, tile, total, total > j.shape[0]


def expand_bboxes(x0, x1, y0, y1, ok, *, ntx, n_tiles, capacity):
    """Expand per-primitive tile bboxes (inclusive, pre-clipped to the grid)
    into (tile, primitive) pairs in `capacity` slots (_expand), sorted by
    tile with original order kept inside each tile and the dead slots
    last. Returns (sorted_key, sorted_prim, total, overflow), as the JAX
    package's expand_bboxes."""
    nx = torch.where(ok, x1 - x0 + 1, 0)
    ny = torch.where(ok, y1 - y0 + 1, 0)
    prim, tile, total, overflow = _expand(
        x0, y0, nx, nx * ny, ntx=ntx, n_tiles=n_tiles, capacity=capacity)
    sorted_key, order = torch.sort(tile, stable=True)
    return sorted_key, prim[order], total, overflow


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
    with _hprof("sync.worklist"):
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


# splat-level saturation cull window: a splat is lookup-cullable when its
# bbox spans <= 2 tile columns and <= _SAT_K band rows (small splats, the
# overwhelming majority); wider splats are not sat-culled at all
_SAT_K = 4


def quantize_z(z):
    """The fast profile's depth key: NDC z as u16 fixed point over [0, 1],
    FLOORED, back in f32. Fixed point because NDC z only spans [0, 1] and
    the splat-vs-proxy gaps the depth test must resolve are ~1e-4..1e-5 at
    range; floored because a tie must resolve to 'in front' (nearest
    rounding replaces distant splats with the proxy texture). The pair
    table's z row and both levels of the occlusion cull take their key from
    here, so cull and compositor can never disagree."""
    return torch.floor(torch.clamp(z, 0.0, 1.0) * 65535.0) * (1.0 / 65535.0)


def round_bf16(x):
    """x rounded to bfloat16 (to nearest even), back in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def quantize_payload(qa, qb, qc, color):
    """The fast profile's per-splat payload values (PARITY.md #8), in f32.

    The quadratic is quantized as its CHOLESKY factors (Q = L L^T), each
    rounded to bf16, not as (qa, qb, qc): grazing-angle splats reach
    |qb|/sqrt(qa qc) within 1e-7 of 1, and bf16's 2^-9 relative rounding of
    the raw coefficients tips about half of them indefinite, so the exponent
    GROWS along the bbox. L L^T is PSD at any precision of L. Colours and
    alpha are rounded to 8 bits (NaN -> 0, +-inf clipped into [0, 1])."""
    l11 = torch.sqrt(torch.clamp(qa, min=1e-12))
    l21 = qb / l11
    l22 = torch.sqrt(torch.clamp(qc - l21 * l21, min=0.0))
    l11, l21, l22 = round_bf16(l11), round_bf16(l21), round_bf16(l22)
    q = (l11 * l11, l11 * l21, l21 * l21 + l22 * l22)

    def u8(x):
        return torch.round(
            torch.clamp(torch.nan_to_num(x), 0.0, 1.0) * 255.0) * (1.0 / 255.0)

    return q, tuple(u8(c) for c in color)


def _sat_cullable(sat_simg, cy, ey, x0, x1, *, nty, th):
    """Splat-level saturation cull at BAND grain: mask [S] of the splats
    whose stream slot (= lane index) lies at or behind the cut of every
    band cell their bbox can reach. A splat whose bbox spans <= 2 tile
    columns and <= _SAT_K band rows tests ONE lookup: the cut image is
    pre-dilated at every (row-span, col-span) combination and the splat
    indexes the variant matching ITS span (a fixed max-size window would
    take SAT_NOCUT from rows and columns the splat never touches and barely
    cull). sat_simg: [nty * SAT_BANDS, ntx] f32, band-row-major."""
    n_br = sat_simg.shape[0]
    bh_px = (nty * th) // n_br

    def coldil(a):  # max over columns {x, x+1}
        return torch.cat([torch.maximum(a[:, :-1], a[:, 1:]), a[:, -1:]], 1)

    rd = sat_simg
    variants = [rd, coldil(rd)]
    for s in range(1, _SAT_K):
        # max over rows {y .. y+s}; replicate-padded: off-grid rows have no
        # pixels, so they must not poison the window
        sh = torch.cat([sat_simg[s:], sat_simg[-1:].expand(s, -1)], 0)
        rd = torch.maximum(rd, sh)
        variants += [rd, coldil(rd)]
    sdil = torch.cat(variants, 0)  # [2 * _SAT_K * n_br, ntx]
    gb0 = torch.clamp(torch.floor((cy - ey) / bh_px), 0, n_br - 1).long()
    gb1 = torch.clamp(torch.floor((cy + ey) / bh_px), 0, n_br - 1).long()
    span_y = torch.clamp(gb1 - gb0, 0, _SAT_K - 1)
    span_x = torch.clamp(x1 - x0, 0, 1)
    row = (span_y * 2 + span_x) * n_br + gb0
    small = (x1 - x0 <= 1) & (gb1 - gb0 <= _SAT_K - 1)
    slot = torch.arange(cy.shape[0], device=cy.device, dtype=torch.float32)
    return small & (slot >= _zmax_lookup(x0, row, sdil))


def _pad_empty(p):
    """An empty stream as one invalid lane, so the pair gathers stay
    defined."""
    def pad(v):
        if isinstance(v, tuple):
            return tuple(pad(x) for x in v)
        return torch.cat([v, v.new_zeros((1,) + tuple(v.shape[1:]))])
    return {k: pad(v) for k, v in p.items()}


_IN_ROWS = ("cx", "cy", "ext_x", "ext_y", "qa", "qb", "qc", "z", "r", "g",
            "b", "a")


class _BinArgs(ctypes.Structure):
    """csrc/binning.cu BinArgs."""
    _fields_ = [("inputs", ctypes.c_void_p * len(_IN_ROWS))] + [
        (n, ctypes.c_void_p) for n in (
            "valid", "occ", "sat", "scratch", "table", "range_start",
            "range_end", "counts", "overflow", "block_demand")] + [
        ("s", ctypes.c_longlong), ("cap", ctypes.c_longlong)] + [
        (n, ctypes.c_int) for n in (
            "img_w", "img_h", "tw", "th", "ntx", "nty", "n_tiles", "n_br",
            "bh_px", "chunk", "cull_exact", "fast")]


@functools.cache
def _lib():
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib = kernels.load("binning", gswt_binning=[ctypes.POINTER(_BinArgs), vp],
                       gswt_binning_scratch_bytes=[ll, ctypes.c_int, ll],
                       gswt_binning_max_tiles=[ctypes.c_int])
    for fn in (lib.gswt_binning_scratch_bytes, lib.gswt_binning_max_tiles):
        fn.restype = ll
    return lib


def max_tiles(device) -> int:
    """The largest tile grid (n_tiles) the binning kernel takes on the CUDA
    `device`: a one-warp block's 8 bytes a tile and staged lanes must fit
    its opt-in shared memory (27,392 tiles on an H100), and a tile index 16
    bits."""
    index = torch.device(device).index
    return _max_tiles(torch.cuda.current_device() if index is None else index)


@functools.cache
def _max_tiles(index: int) -> int:
    return int(_lib().gswt_binning_max_tiles(index))


def _device_rows(p, dev):
    """The 12 input rows and the mask, each a contiguous [S] tensor on dev."""
    qa, qb, qc = p["q"]
    r, g, b, a = p["color"]
    rows = dict(cx=p["cx"], cy=p["cy"], ext_x=p["ext_x"], ext_y=p["ext_y"],
                qa=qa, qb=qb, qc=qc, z=p["z"], r=r, g=g, b=b, a=a)
    s_n = p["cx"].shape[0]
    out = []
    for name in _IN_ROWS:
        t = rows[name]
        if t.dtype != torch.float32 or t.device != dev or t.shape != (s_n,):
            raise ValueError(
                f"{name} must be a float32 [{s_n}] tensor on {dev}")
        out.append(t.contiguous())
    valid = p["valid"]
    if (valid.dtype != torch.bool or valid.device != dev
            or valid.shape != (s_n,)):
        raise ValueError(f"valid must be a bool [{s_n}] tensor on {dev}")
    return out, valid.contiguous()


def _bin_pairs_cuda(p, *, image_wh, tile_wh, chunk, exact, cull_exact,
                    occ_zimg, sat_simg, emit_block_demand, capacity):
    """bin_pairs on the card: the six launches of csrc/binning.cu on the
    current stream, with no read on the host."""
    ntx, nty, n_tiles = grid_dims(image_wh, tile_wh)
    rows, valid = _device_rows(p, p["cx"].device)
    dev = valid.device
    if n_tiles > max_tiles(dev):
        raise ValueError(f"a {ntx}x{nty} tile grid exceeds the binning "
                         f"kernel's {max_tiles(dev)} tiles")
    capacity = int(capacity)
    if not 0 <= capacity < 1 << 31:
        raise ValueError("capacity must lie in [0, 2^31)")
    for name, t, shape in (("occ_zimg", occ_zimg, (nty, ntx)),
                           ("sat_simg", sat_simg, None)):
        if t is not None and (t.dtype != torch.float32 or t.device != dev
                              or t.dim() != 2 or t.shape[1] != ntx
                              or (shape and t.shape != shape)):
            raise ValueError(f"{name} must be a float32 [{shape or 'rows'}, "
                             f"{ntx}] tensor on {dev}")
    n_br = bh_px = 0
    if sat_simg is not None:
        n_br = sat_simg.shape[0]
        bh_px = (nty * tile_wh[1]) // n_br
        sat_simg = sat_simg.contiguous()
    if occ_zimg is not None:
        occ_zimg = occ_zimg.contiguous()
    s_n = valid.shape[0]
    lib = _lib()
    scratch = torch.empty(
        int(lib.gswt_binning_scratch_bytes(s_n, n_tiles, capacity)),
        dtype=torch.uint8, device=dev)
    table = torch.empty((16, capacity), dtype=torch.float32, device=dev)
    ranges = torch.empty((2, n_tiles), dtype=torch.int32, device=dev)
    counts = torch.empty(4, dtype=torch.int64, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    demand = (torch.empty(-(-s_n // 256), dtype=torch.int64, device=dev)
              if emit_block_demand else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = _BinArgs(
        (ctypes.c_void_p * len(_IN_ROWS))(*[t.data_ptr() for t in rows]),
        valid.data_ptr(), ptr(occ_zimg), ptr(sat_simg), scratch.data_ptr(),
        table.data_ptr(), ranges[0].data_ptr(), ranges[1].data_ptr(),
        counts.data_ptr(), overflow.data_ptr(), ptr(demand), s_n, capacity,
        int(image_wh[0]), int(image_wh[1]), int(tile_wh[0]), int(tile_wh[1]),
        ntx, nty, n_tiles, n_br, bh_px, int(chunk), int(bool(cull_exact)),
        int(not exact))
    rc = lib.gswt_binning(ctypes.byref(args), kernels.stream_ptr(table))
    kernels.LAUNCHES["binning"] += 1
    kernels.check(rc, "binning")
    out = dict(table=table, range_start=ranges[0], range_end=ranges[1],
               n_pairs=counts[0], overflow=overflow, n_pairs_kept=counts[1],
               n_live=counts[2], max_run=counts[3])
    if emit_block_demand:
        out["block_demand"] = demand
    return out


def bin_pairs(p, *, image_wh, tile_wh, chunk: int, exact: bool = True,
              cull_exact: bool = True, occ_zimg=None, sat_simg=None,
              emit_block_demand: bool = False, capacity: int):
    """p: projection outputs (front-to-back order, S lanes; the lane index
    is the stream slot).

    capacity: the pair slots (a multiple of `chunk`). The bbox pairs are
    enumerated splat-major into them (_expand) with no wait for the device:
    a frame whose demand exceeds them keeps its front-most pairs and flags
    `overflow`. A caller that wants the table of the demand itself reads
    n_pairs of a first call and calls again with fit_capacity(n_pairs).

    exact=False is the fast profile (PARITY.md #8): the table carries the
    quantized values of quantize_payload and quantize_z, and every cull
    tests those same values (the quantized coefficients in the ellipse
    cull, the quantized z in the occlusion cull).

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

    sat_simg (optional [nty * SAT_BANDS, ntx] f32, band-row-major): the
    per-band SATURATION SLOT cut, the stream slot beyond which the previous
    frame's compositor proved nothing can contribute to that band (all its
    pixels were opaque: ops/raster.py emit_zcut). A splat whose slot is >=
    the cut of every band it reaches composites entirely behind a
    transmittance < MIN_T. Splat level only (_sat_cullable).

    emit_block_demand: also return block_demand [S / 256] i64, the bbox pair
    demand of each 256-lane block of the stream after the culls above (the
    stream split of parallel/batched.py cuts its segments at quantiles of
    it; live lanes alone cannot see how many tiles a splat covers).

    Returns dict:
      table — [16, dom] f32 rows k0..k5 (recentered to each pair's tile
        origin, build_pair_table), z, 0, r, g, b, ln a, slot, 0 x3; dom is
        the capacity, the slots past the demand and the culled pairs dead
        (k5 = -1e30, ln a = -inf)
      range_start/range_end [n_tiles] i32 — each tile's run of the table
      n_pairs — bbox pair demand, overflow — n_pairs > dom, n_pairs_kept —
        pairs in tile runs after the culls, n_live — visible splats,
        max_run — the longest tile run (0-d tensors)
      block_demand — with emit_block_demand only (see above)

    CPU tensors take bin_pairs_plain; CUDA tensors launch the kernels of
    csrc/binning.cu (_bin_pairs_cuda), which leave the table's rows 13-15
    unwritten and, past n_pairs_kept, write only the dead code (rows 5 and
    11) and zeros in rows 0-12 up to the end of the chunk that holds
    n_pairs_kept.
    """
    if not p["cx"].is_cuda:
        return bin_pairs_plain(
            p, image_wh=image_wh, tile_wh=tile_wh, chunk=chunk, exact=exact,
            cull_exact=cull_exact, occ_zimg=occ_zimg, sat_simg=sat_simg,
            emit_block_demand=emit_block_demand, capacity=capacity)
    return _bin_pairs_cuda(
        p, image_wh=image_wh, tile_wh=tile_wh, chunk=chunk, exact=exact,
        cull_exact=cull_exact, occ_zimg=occ_zimg, sat_simg=sat_simg,
        emit_block_demand=emit_block_demand, capacity=capacity)


def bin_pairs_plain(p, *, image_wh, tile_wh, chunk: int, exact: bool = True,
                    cull_exact: bool = True, occ_zimg=None, sat_simg=None,
                    emit_block_demand: bool = False, capacity: int):
    """bin_pairs in plain PyTorch: the CPU path and the kernel's oracle
    (arguments and outputs as bin_pairs, every slot of the table defined)."""
    w_img, h_img = image_wh
    tw, th = tile_wh
    ntx, nty, n_tiles = grid_dims(image_wh, tile_wh)
    s_n = p["cx"].shape[0]
    if s_n == 0:
        p = _pad_empty(p)

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
    qa, qb, qc = p["q"]
    cr, cg, cb, ca = p["color"]
    z = p["z"]
    if not exact:
        (qa, qb, qc), (cr, cg, cb, ca) = quantize_payload(
            qa, qb, qc, (cr, cg, cb, ca))
        z = quantize_z(z)
    if occ_zimg is not None:
        small = (x1 - x0 <= 1) & (y1 - y0 <= 1)
        ok = ok & ~(small & (z >= _zmax_lookup(
            x0, y0, _dilate_max2(occ_zimg))))
    if sat_simg is not None:
        ok = ok & ~_sat_cullable(sat_simg, cy, ey, x0, x1, nty=nty, th=th)
    nx = torch.where(ok, x1 - x0 + 1, 0)
    ny = torch.where(ok, y1 - y0 + 1, 0)
    count0 = nx * ny
    prim, tiles, n_pairs, overflow = _expand(
        x0, y0, nx, count0, ntx=ntx, n_tiles=n_tiles, capacity=capacity)

    if occ_zimg is not None:
        occluded = z[prim] >= occ_zimg.reshape(-1)[
            torch.clamp(tiles, max=n_tiles - 1)]
        tiles = torch.where(occluded, n_tiles, tiles)
    if cull_exact:
        tiles = _cull_pair_tiles(
            tiles, cx[prim], cy[prim], qa[prim], qb[prim], qc[prim],
            ntx=ntx, n_tiles=n_tiles, tile_wh=tile_wh)
    # primitive-major enumeration + stable sort = joint (tile, slot) order
    tile_of, order = torch.sort(tiles, stable=True)
    src = prim[order]
    rows = torch.stack([cx, cy, qa, qb, qc, z, cr, cg, cb, ca])[:, src]
    dead = tile_of >= n_tiles
    cxg, cyg, qag, qbg, qcg, zg, rg, gg, bg, ag = rows
    table = build_pair_table(
        tile_of, dead, cxg, cyg, qag, qbg, qcg, zg, rg, gg, bg,
        torch.where(dead, 0.0, ag),
        ntx=ntx, n_tiles=n_tiles, tile_wh=tile_wh, src=src,
    )
    range_start, range_end = tile_ranges(tile_of, n_tiles)
    out = dict(
        table=table,
        range_start=range_start,
        range_end=range_end,
        n_pairs=n_pairs,
        overflow=overflow,
        n_pairs_kept=(range_end - range_start).sum(),
        n_live=ok.sum(),
        max_run=(range_end - range_start).max().long(),
    )
    if emit_block_demand:
        pad = -s_n % 256
        out["block_demand"] = torch.cat(
            [count0[:s_n], count0.new_zeros(pad)]).reshape(-1, 256).sum(1)
    return out
