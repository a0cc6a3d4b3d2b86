"""Pair tables shared by the port's CPU and card compositor tests (imports
no jax, so the card tests can use them on a host without it)."""

import numpy as np
import torch

from gswt_renderer_tpu_torch.ops import binning as tbin
from gswt_renderer_tpu_torch.ops import raster as tr


def adversarial_pairs(seed, n_per_kind=64):
    """(cx, cy, qa, qb, qc) of pairs meant to break a block mask, relative
    to a tile whose origin is (0, 0): needle-thin and edge-on conics,
    sub-pixel and tile-sized splats, centres off the tile, quadratics that
    are not definite (indefinite, negative, zero) and pairs whose peak sits
    just above or below the cutoff within a block."""
    rng = np.random.default_rng(seed)
    n = n_per_kind
    kinds = []

    def centres(lo=-40.0, hi=104.0):
        return rng.uniform(lo, hi, n), rng.uniform(lo, hi - 40.0, n)

    def rot(l1, l2):  # Q = R diag(l1, l2) R^T at random angles
        th = rng.uniform(0, np.pi, n)
        c, s = np.cos(th), np.sin(th)
        return (l1 * c * c + l2 * s * s, (l1 - l2) * c * s,
                l1 * s * s + l2 * c * c)

    # needle-thin at random angles: eigenvalues 1e-6 .. 1e-4 and 0.5 .. 50
    kinds.append((*centres(), *rot(10 ** rng.uniform(-6, -4, n),
                                   10 ** rng.uniform(-0.3, 1.7, n))))
    # edge-on: |qb| within 1e-7 .. 1e-3 of sqrt(qa qc) (barely definite)
    qa, qc = 10 ** rng.uniform(-2, 1, n), 10 ** rng.uniform(-2, 1, n)
    qb = np.sign(rng.uniform(-1, 1, n)) * np.sqrt(qa * qc) * (
        1.0 - 10 ** rng.uniform(-7, -3, n))
    kinds.append((*centres(), qa, qb, qc))
    # sub-pixel: extents 0.02 .. 0.5 px
    kinds.append((*centres(-2.0, 66.0), *rot(10 ** rng.uniform(1, 4, n),
                                           10 ** rng.uniform(1, 4, n))))
    # tile-sized and larger, centres far off the tile
    kinds.append((*centres(-300.0, 364.0),
                  *rot(10 ** rng.uniform(-5, -3, n),
                       10 ** rng.uniform(-5, -3, n))))
    # not definite: indefinite, negative, zero, one zero eigenvalue
    q = [rot(rng.uniform(-1, 1, n), -10 ** rng.uniform(-3, 0, n)),
         (-10 ** rng.uniform(-3, 0, n), np.zeros(n), rng.uniform(-1, 1, n)),
         (np.zeros(n), np.zeros(n), np.zeros(n)),
         rot(np.zeros(n), 10 ** rng.uniform(-3, 0, n))]
    for qa, qb, qc in q:
        kinds.append((*centres(), qa, qb, qc))
    cx, cy, qa, qb, qc = (np.concatenate(x).astype(np.float32)
                          for x in zip(*kinds))
    return cx, cy, qa, qb, qc


def adversarial_table(seed, tile_wh, exact):
    """A one-tile pair table of _adversarial_pairs (the fast profile's
    Cholesky-quantized q when not exact), half of them with k5 moved so the
    peak over the tile lands near the cutoff, and a few dead pairs."""
    cx, cy, qa, qb, qc = (torch.from_numpy(x) for x in adversarial_pairs(
        seed))
    if not exact:
        ok = (qa > 0) & (qa * qc - qb * qb > 0)
        (fa, fb, fc), _ = tbin.quantize_payload(qa, qb, qc, (qa,) * 4)
        qa, qb, qc = (torch.where(ok, f, x) for f, x in ((fa, qa), (fb, qb),
                                                          (fc, qc)))
    n = cx.shape[0]
    rng = np.random.default_rng(seed + 1)
    one = torch.ones(n)
    key = torch.zeros(n, dtype=torch.int64)
    dead = torch.from_numpy(rng.random(n) < 0.05)
    table = tbin.build_pair_table(
        key, dead, cx, cy, qa, qb, qc, torch.from_numpy(
            rng.uniform(0, 1, n).astype(np.float32)),
        one * 0.5, one * 0.25, one * 0.75,
        torch.where(dead, 0.0, 0.6 * one), ntx=1, n_tiles=1, tile_wh=tile_wh)
    # the peak of e over the tile's pixel centres, moved to just around the
    # cutoff for every other pair (what a mask's margin has to survive)
    mono = tr._pixel_monomials(*tile_wh, "cpu")
    e = tr._exponent(table[:6], mono)
    shift = torch.from_numpy(rng.uniform(-0.05, 0.05, n).astype(np.float32))
    near = (torch.arange(n) % 2 == 0) & ~dead & torch.isfinite(e.amax(1))
    table[5] = torch.where(near, table[5] + (tr.CUTOFF - e.amax(1)) + shift,
                           table[5])
    return table


def adversarial_binned(seed, tile_wh, grid=(2, 2), *, exact=True, chunk=128):
    """A binned table (bin_pairs' layout) over grid[0] x grid[1] tiles,
    each tile's run an adversarial_table of its own (without the pairs
    whose exponent passes 0 somewhere: no splat has g > 1), its runs
    starting off chunk boundaries. Row 12 is the slot. Returns (binned,
    image_wh)."""
    tw, th = tile_wh
    rng = np.random.default_rng(seed)
    mono = tr._pixel_monomials(tw, th, "cpu")
    cols, rs, re_ = [], [], []
    n = 3  # a few dead columns before the first run
    cols.append(torch.zeros((16, n)))
    for t in range(grid[0] * grid[1]):
        tab = adversarial_table(seed * 10 + t, tile_wh, exact)
        tab = tab[:, tr._exponent(tab[:6], mono).amax(1) <= 0.0]
        tab[6] = torch.from_numpy(rng.uniform(0, 1, tab.shape[1])
                                  .astype(np.float32))
        cols.append(tab)
        rs.append(n)
        n += tab.shape[1]
        re_.append(n)
    table = torch.cat(cols, 1)
    dead = torch.zeros(table.shape[1], dtype=torch.bool)
    dead[:3] = True
    pad = -(-n // chunk) * chunk - n
    table = torch.cat([table, torch.zeros((16, pad))], 1)
    dead = torch.cat([dead, torch.ones(pad, dtype=torch.bool)])
    table[5] = torch.where(dead, -1e30, table[5])
    table[11] = torch.where(dead, -torch.inf, table[11])
    table[12] = torch.arange(table.shape[1], dtype=torch.float32)
    binned = dict(table=table.contiguous(),
                  range_start=torch.tensor(rs, dtype=torch.int32),
                  range_end=torch.tensor(re_, dtype=torch.int32))
    return binned, (grid[0] * tw, grid[1] * th)


TRI_KINDS = ("sliver", "offscreen", "edge_centres", "near_plane", "ties",
             "random")


def adversarial_triangles(seed, image_wh=(384, 256), kinds=TRI_KINDS,
                          n_per_kind=48):
    """Screen-space triangles (xs, ys, zs, ws [3, T], attrs [3, 3, T] f32
    numpy) meant to break the triangle raster's block mask and its split
    at chunk boundaries, on an image of 64x32 tiles: they lie in its top
    left (image width - 128) x (height - 128) pixels, give or take 80, so
    its bottom tile row stays empty. Slivers down to
    |area2| just above 1e-12 (tiny ones near the origin, needles with
    perpendicular offsets of 1e-9 .. 1e-5 px); vertices 1e4 px off-screen;
    fans and right triangles whose edges run through pixel centres (b = 0
    exactly there) and end on warp-block boundaries; vertices on both sides
    of the near (z = 0) and far (z = 1) planes; and 150 coincident copies
    of one triangle (z ties within a chunk and across chunk boundaries)."""
    rng = np.random.default_rng(seed)
    w = float(image_wh[0] - 128)
    h = float(image_wh[1] - 128)
    n = n_per_kind
    xs, ys, zs = [], [], []

    def add(x, y, z=None):
        x = np.asarray(x, np.float64).reshape(3, -1)
        y = np.asarray(y, np.float64).reshape(3, -1)
        xs.append(x)
        ys.append(y)
        zs.append(rng.uniform(0.05, 0.95, x.shape) if z is None else
                  np.broadcast_to(z, x.shape))

    for kind in kinds:
        if kind == "sliver":
            # tiny, near the origin where f32 resolves 1e-6
            p = rng.uniform(0.3, 2.0, (2, n))
            d1, d2 = 10 ** rng.uniform(-6, -5, (2, n))
            add([p[0], p[0] + d1, p[0]], [p[1], p[1], p[1] + d2])
            # needles: a long edge and a third vertex barely off it
            p = rng.uniform([[0.0], [0.0]], [[w], [h]], (2, n))
            ang = rng.uniform(0, 2 * np.pi, n)
            ln = rng.uniform(10, 80, n)
            ex, ey = np.cos(ang) * ln, np.sin(ang) * ln
            t = rng.uniform(0.2, 0.8, n)
            off = 10 ** rng.uniform(-9, -5, n)
            add([p[0], p[0] + ex, p[0] + t * ex - off * ey / ln],
                [p[1], p[1] + ey, p[1] + t * ey + off * ex / ln])
        elif kind == "offscreen":
            p = rng.uniform([[0.0], [0.0]], [[w], [h]], (2, n))
            q = rng.uniform([[0.0], [0.0]], [[w], [h]], (2, n))
            far = rng.choice([-1e4, 1e4], (2, n))
            add([p[0], p[0] + far[0], q[0]],
                [p[1], p[1] + rng.uniform(-20, 20, n),
                 q[1] + np.sign(far[1]) * rng.uniform(0, 20, n)])
        elif kind == "edge_centres":
            # fans around half-integer hubs with half-integer rims
            for _ in range(max(n // 6, 1)):
                hub = np.floor(rng.uniform([8, 8], [w - 8, h - 8])) + 0.5
                rim = hub + np.floor(rng.uniform(-40, 40, (6, 2))) + 0.0
                for i in range(6):
                    a, b = rim[i], rim[(i + 1) % 6]
                    add([hub[0], a[0], b[0]], [hub[1], a[1], b[1]])
            # right triangles whose legs run along pixel-centre lines and
            # end on 16x4 block boundaries (x = 16k + 15.5, y = 4m + 3.5)
            x0 = 16 * rng.integers(0, int(w) // 16, n) + 15.5
            y0 = 4 * rng.integers(0, int(h) // 4, n) + 3.5
            sx = rng.choice([-1.0, 1.0], n) * 16 * rng.integers(1, 4, n)
            sy = rng.choice([-1.0, 1.0], n) * 4 * rng.integers(1, 6, n)
            add([x0, x0 + sx, x0], [y0, y0, y0 + sy])
        elif kind == "near_plane":
            p = rng.uniform([[0.0], [0.0]], [[w], [h]], (2, n))
            add(p[0] + rng.uniform(-60, 60, (3, n)),
                p[1] + rng.uniform(-30, 30, (3, n)),
                rng.uniform(-0.5, 1.5, (3, n)))
        elif kind == "ties":
            base_x = rng.uniform(8, w - 40) + np.array([0.0, 30.0, 4.0])
            base_y = rng.uniform(4, h - 28) + np.array([0.0, 3.0, 24.0])
            add(np.repeat(base_x[:, None], 150, 1),
                np.repeat(base_y[:, None], 150, 1), 0.5)
        elif kind == "random":
            p = rng.uniform([[0.0], [0.0]], [[w], [h]], (2, n))
            add(p[0] + rng.uniform(-40, 40, (3, n)),
                p[1] + rng.uniform(-20, 20, (3, n)))
        else:
            raise ValueError(kind)
    xs = np.concatenate(xs, 1).astype(np.float32)
    ys = np.concatenate(ys, 1).astype(np.float32)
    zs = np.concatenate(zs, 1).astype(np.float32)
    t = xs.shape[1]
    ws = rng.uniform(0.5, 4.0, (3, t)).astype(np.float32)
    attrs = rng.uniform(-1, 1, (3, 3, t)).astype(np.float32)
    attrs[0] = np.arange(t, dtype=np.float32)  # tells tied copies apart
    return xs, ys, zs, ws, attrs


def binned_triangles(tris, image_wh=(384, 256), tile_wh=(64, 32),
                     device="cpu"):
    """(rows, range_start, range_end, n_pairs) of adversarial_triangles'
    output through the port's triangle_planes and bin_triangles."""
    from gswt_renderer_tpu_torch.ops import trirast as ttri

    xs, ys, zs, ws, attrs = (torch.from_numpy(a).to(device) for a in tris)
    planes, ok, bbox = ttri.triangle_planes(
        xs, ys, zs, ws, attrs,
        torch.ones(xs.shape[1], dtype=torch.bool, device=device))
    return ttri.bin_triangles(planes, bbox, ok, image_wh=image_wh,
                              tile_wh=tile_wh)


def adversarial_micro_binned(seed, name, tile_wh, grid=(2, 2)):
    """The micro-benchmark's table (benchmarks/micro_raster.py make_binned's
    layout: the exponent quadratic at global pixel coordinates in rows 0-5,
    z in row 6, colours in rows 8-10, the raw alpha in row 11) of
    adversarial_pairs around each of grid[0] x grid[1] tiles, as variant
    `name` reads it (recentred for the local variants). Every tile's run
    holds its own pairs, a few of them dead (k5 = -1e30, alpha 0); the runs
    start off chunk boundaries and dom is a multiple of 256. Every other
    pair has k5 moved so that its peak over its tile's pixel centres, in
    the variant's own precision, lands within 0.05 of the cutoff (as near
    as the f32 k5 allows); of the rest, a pair whose own exponent passes 0
    somewhere is dropped (no g above its alpha). Returns (binned, image_wh,
    kw), kw the variant's keywords for composite."""
    from gswt_renderer_tpu_torch.benchmarks import micro_raster as tmr

    tw, th = tile_wh
    ntx, nty = grid
    n_tiles = ntx * nty
    image_wh = (ntx * tw, nty * th)
    rng = np.random.default_rng(seed)
    cols, owner = [], []
    for t in range(n_tiles):
        cx, cy, qa, qb, qc = (x.astype(np.float64) for x in adversarial_pairs(
            seed * 10 + t))
        cx = cx + (t % ntx) * tw
        cy = cy + (t // ntx) * th
        n = cx.shape[0]
        k5 = -(qa * cx * cx + 2 * qb * cx * cy + qc * cy * cy)
        dead = rng.random(n) < 0.05
        tab = np.zeros((16, n), np.float32)
        for i, v in enumerate([-qa, -2 * qb, -qc, 2 * qa * cx + 2 * qb * cy,
                               2 * qb * cx + 2 * qc * cy,
                               np.where(dead, -1e30, k5),
                               rng.uniform(0, 1, n), np.zeros(n),
                               *rng.uniform(0, 1, (3, n)),
                               np.where(dead, 0.0, rng.uniform(0, 0.8, n))]):
            tab[i] = v
        cols.append(torch.from_numpy(tab))
        owner.append(torch.full((n,), t, dtype=torch.int64))
    table, pair_tile = torch.cat(cols, 1), torch.cat(owner)
    b, kw = tmr.variant_inputs(dict(table=table, pair_tile=pair_tile), name,
                               image_wh=image_wh, tile_wh=tile_wh)
    table = b["table"]
    # the peaks in the variant's own precision, at its own coordinates
    pix = torch.arange(tw * th)
    px = (pix % tw).to(torch.float32)
    py = torch.div(pix, tw, rounding_mode="floor").to(torch.float32)
    runs = []
    for t in range(n_tiles):
        tab = table[:, pair_tile == t].clone()
        ox, oy = (0.0, 0.0) if kw["local"] else (
            float((t % ntx) * tw), float((t // ntx) * th))
        x, y = (px + ox) + 0.5, (py + oy) + 0.5
        mono = [m[None] for m in (x * x, x * y, y * y, x, y)]

        def peak(tab):
            e = tmr._exponent([r[:, None] for r in tab[:6]], mono, kw["prec"])
            return e.amax(1)

        e_max = peak(tab)
        live = tab[5] > -1e29
        near = ((torch.arange(tab.shape[1]) % 2 == 0) & live
                & torch.isfinite(e_max))
        shift = torch.from_numpy(rng.uniform(-0.05, 0.05, tab.shape[1])
                                 .astype(np.float32))
        tab[5] = torch.where(near, tab[5] + (tmr.CUTOFF - e_max) + shift,
                             tab[5])
        runs.append(tab[:, ~(live & ~(peak(tab) <= 0.0))])
    n = 3  # a few dead columns before the first run
    parts, rs, re_ = [torch.zeros((16, n))], [], []
    for tab in runs:
        parts.append(tab)
        rs.append(n)
        n += tab.shape[1]
        re_.append(n)
    parts.append(torch.zeros((16, -(-n // 256) * 256 - n)))
    table = torch.cat(parts, 1)
    dead = torch.ones(table.shape[1], dtype=torch.bool)
    for a, b_ in zip(rs, re_):
        dead[a:b_] = False
    table[5] = torch.where(dead, -1e30, table[5])
    binned = dict(table=table.contiguous(),
                  range_start=torch.tensor(rs, dtype=torch.int32),
                  range_end=torch.tensor(re_, dtype=torch.int32))
    return binned, image_wh, kw
