"""Proxy ground pass (proxy.rs + proxy.wgsl), per-pixel formulation.

The reference draws two height-map-displaced grids before the splats with
depth write enabled (proxy.rs:119-125, 396-433): the tile-map grid (one
quad per map cell, vertices displaced by the height sampled at mip 0,
proxy.wgsl:42-97) and a 2048^2 camera-following ground grid; the splat pass
depth-tests against the result (renderer.rs:433-437). Fragments sample the
proxy texture's Lanczos mip chain with a trilinear Repeat sampler
(proxy.rs:324-338).

This version has two paths (render_proxy's use_grid):
- the grid (the default and the main path): the tile-map grid and the
  clipmap rings around it standing in for the reference's far grid
  (make_map_grid, PARITY.md #4) are RASTERIZED: vertex heights sampled from
  the same bilinear field at mip 0, screen-space linear depth, perspective-
  correct tex coords, min-z semantics (ops/trirast.py). A triangle with a
  vertex behind the camera is dropped whole; nothing else stands in for
  it, and at a viewer's height above the ground no such triangle reaches
  the view;
- the march: a per-pixel ray / height-field intersection against the same
  repeating height field;
- both sample the mip chain trilinearly with a footprint from screen-space
  uv derivatives, matching the reference's sampler.

Outputs: color [H,W,4] and the wgpu-remapped depth [H,W] consumed by the
splat rasterizer's per-splat depth test.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import hostprof
from ..core.hostprof import _hprof
from .project import _bilinear_wrap4
from .skybox import pixel_rays
from .texsample import factored_mip_trilinear
from .trirast import (on_image, rasterize_triangles, tiles_to_maps,
                      triangle_planes)


# ------------------------------------------------------------------ #
# mip atlas: all levels of the rgb 4-neighborhood pack in one table
# ------------------------------------------------------------------ #
def pack_mip_atlas(mips):
    """mips: list of [H,W,3] levels -> (atlas [4, total] f32 numpy holding
    u8 rgb packed in u32, meta tuple of (w, h, offset) per level). Rows are
    the 4-neighborhood (x,y),(x+1,y),(x,y+1),(x+1,y+1) with wrap -- each
    bilinear tap is ONE 4-component gather. u8 quantization is lossless vs
    the u8-sourced textures. The Renderer keeps the words as int32."""
    chunks = []
    meta = []
    off = 0
    for lv in mips:
        t = np.asarray(lv, np.float32)
        h, w = t.shape[0], t.shape[1]
        q = np.clip(np.round(t * 255.0), 0, 255).astype(np.uint32)
        packed = (q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)).astype(
            np.uint32
        )
        rows = [
            packed,
            np.roll(packed, -1, axis=1),
            np.roll(packed, -1, axis=0),
            np.roll(np.roll(packed, -1, axis=0), -1, axis=1),
        ]
        chunks.append(
            np.stack([r.reshape(-1) for r in rows], axis=0).view(np.float32)
        )
        meta.append((w, h, off))
        off += w * h
    return np.concatenate(chunks, axis=1), tuple(meta)


def atlas_words(atlas):
    """The atlas as an int32 tensor of raw words (from pack_mip_atlas's
    bit-cast float32 numpy array, or a tensor already made so)."""
    if isinstance(atlas, torch.Tensor):
        return atlas.view(torch.int32) if atlas.dtype == torch.float32 else atlas
    return torch.from_numpy(
        np.ascontiguousarray(atlas, np.float32).view(np.int32).copy())


def mip_table(meta, device):
    """The mip levels' (w, h, off) as an [L, 3] int64 tensor on `device`:
    made once per texture (Renderer.set_proxy), since a copy of it from
    host memory in the frame would wait for the device."""
    return torch.tensor(meta, dtype=torch.int64, device=device)


def _sample_level_rgb(atlas, tab, u, v, lvl_i):
    w, h, off = tab[lvl_i].unbind(-1)
    wf = w.to(torch.float32)
    hf = h.to(torch.float32)
    x = u * wf - 0.5
    y = v * hf - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    tx = x - x0f
    ty = y - y0f
    base = off + (y0f.long() % h) * w + (x0f.long() % w)
    u4 = atlas[:, base.reshape(-1)].reshape((4,) + base.shape)

    def bil(i00, i10, i01, i11):
        return (i00 * (1 - tx) + i10 * tx) * (1 - ty) + (
            i01 * (1 - tx) + i11 * tx
        ) * ty

    inv255 = 1.0 / 255.0
    return torch.stack(
        [
            bil(*(((u4[k] >> (8 * c)) & 0xFF).to(torch.float32) * inv255
                  for k in range(4)))
            for c in range(3)
        ],
        dim=-1,
    )


def sample_mip_trilinear(atlas, tab, u, v, rho):
    """Trilinear Repeat sampling of the mip atlas (int32 words, see
    atlas_words). tab: the levels' (w, h, off) as mip_table made it on the
    atlas's device. rho: footprint in level-0 texels per pixel."""
    n_lv = tab.shape[0]
    lvl = torch.clamp(
        torch.log2(torch.clamp(rho, min=1e-6)), 0.0, float(n_lv - 1)
    )
    l0 = torch.floor(lvl).long()
    frac = (lvl - l0.to(torch.float32))[..., None]
    c0 = _sample_level_rgb(atlas, tab, u, v, l0)
    c1 = _sample_level_rgb(
        atlas, tab, u, v, torch.clamp(l0 + 1, max=n_lv - 1)
    )
    return c0 * (1.0 - frac) + c1 * frac


def _uv_footprint(u, v, tex_w, tex_h):
    """Screen-space footprint (level-0 texels) from uv image derivatives,
    the GPU's implicit-derivative mip selection."""

    def deriv(img, axis):
        d = torch.diff(img, dim=axis)
        last = d[-1:, :] if axis == 0 else d[:, -1:]
        return torch.cat([d, last], dim=axis)

    dudx = deriv(u, 1) * tex_w
    dudy = deriv(u, 0) * tex_w
    dvdx = deriv(v, 1) * tex_h
    dvdy = deriv(v, 0) * tex_h
    return torch.maximum(
        torch.sqrt(dudx * dudx + dvdx * dvdx),
        torch.sqrt(dudy * dudy + dvdy * dvdy),
    )


# ------------------------------------------------------------------ #
# map grid (host-built, static per configure)
# ------------------------------------------------------------------ #
def _grid_patch(x_lo, y_lo, nx, ny, cell, hole=None):
    """One grid patch: verts [2, (nx+1)(ny+1)] + tris [3, 2*cells], with
    cells inside `hole` (x0, x1, y0, y1 world bounds) skipped."""
    vi, vj = np.meshgrid(np.arange(nx + 1), np.arange(ny + 1), indexing="ij")
    verts = np.stack(
        [x_lo + vi * cell, y_lo + vj * cell], axis=0
    ).reshape(2, -1).astype(np.float32)

    def vid(i, j):
        return i * (ny + 1) + j

    ci, cj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    ci = ci.reshape(-1)
    cj = cj.reshape(-1)
    if hole is not None:
        cx = x_lo + (ci + 0.5) * cell
        cy = y_lo + (cj + 0.5) * cell
        keep = ~(
            (cx > hole[0]) & (cx < hole[1]) & (cy > hole[2]) & (cy < hole[3])
        )
        ci = ci[keep]
        cj = cj[keep]
    # two triangles per cell, matching proxy.rs:226-247's vertex order
    t1 = np.stack([vid(ci, cj), vid(ci + 1, cj), vid(ci, cj + 1)], axis=0)
    t2 = np.stack([vid(ci + 1, cj), vid(ci + 1, cj + 1), vid(ci, cj + 1)], axis=0)
    return verts, np.concatenate([t1, t2], axis=1).astype(np.int32)


def make_map_grid(map_wh, map_half_wh, tile_width, far_dist: float = 2400.0):
    """The proxy mesh: the tile-map grid (proxy.rs:215-258, one quad per
    map cell) plus concentric clipmap rings standing in for the reference's
    2048^2 camera-following far grid (proxy.rs:136-166) -- each ring doubles
    the cell size, so screen-space triangle density stays roughly constant
    out to `far_dist`. Rings overlap their parent by one cell; min-z
    resolves the seam (no T-junction cracks). Vertex positions are world
    units RELATIVE to the map center (the center_coord offset is applied on
    device per frame). Returns (verts [2, Nv] f32, tris [3, T] i32)."""
    w, h = int(map_wh[0]), int(map_wh[1])
    hx, hy = int(map_half_wh[0]), int(map_half_wh[1])
    tw = float(tile_width)
    parts = [
        _grid_patch(-hx * tw, -hy * tw, w, h, tw)
    ]
    # clipmap rings: extent doubles, cell doubles. First ring cell = 4x the
    # tile width: ring 1 starts at ~48 tile widths out, so its triangles
    # still subtend only ~2-5 degrees (a far-field silhouette change well
    # inside the documented clipmap deviation, PARITY.md #4 vs
    # proxy.rs:136-166's uniform far grid).
    ext = max(hx, hy) * tw
    cell = 4.0 * tw
    while ext < far_dist:
        outer = ext * 2.0
        n = int(np.ceil(2.0 * outer / cell))
        lo = -0.5 * n * cell
        hole = (-ext + cell, ext - cell, -ext + cell, ext - cell)
        parts.append(_grid_patch(lo, lo, n, n, cell, hole=hole))
        ext = outer
        cell *= 2.0
    verts = []
    tris = []
    base = 0
    for v, t in parts:
        verts.append(v)
        tris.append(t + base)
        base += v.shape[1]
    return np.concatenate(verts, axis=1), np.concatenate(tris, axis=1)


def _height_at(scene, hm4, hm_wh, x, y):
    """Surface height via the shader's uv convention (proxy.wgsl:73-82)."""
    half = scene["map_half_wh"].to(torch.float32)
    tw = scene["tile_width"]
    hms = scene["height_map_scale"]
    hx = (2.0 * half[0] + 1.0) * tw * hms[0]
    hy = (2.0 * half[1] + 1.0) * tw * hms[1]
    hu = (x + half[0] * tw) / hx
    hv = (y + half[1] * tw) / hy
    w, h = int(hm_wh[0]), int(hm_wh[1])
    return _bilinear_wrap4(hm4, w, h, hu, hv) * hms[2]


def map_grid_planes(cam, scene, image_wh, hm4, hm_wh, verts, tris,
                    *, surface_type: int, height_offset: float):
    """Displace and project the tile-map grid; returns its triangles' plane
    rows, validity and pixel bboxes (ops/trirast.py triangle_planes) with
    the attributes (u, v, mapped height)."""
    w_img, h_img = image_wh
    cc = scene["center_coord"].to(torch.float32)
    tw = scene["tile_width"]
    rx = verts[0] + cc[0] * tw
    ry = verts[1] + cc[1] * tw
    if surface_type == 1:
        mh = _height_at(scene, hm4, hm_wh, rx, ry)
    else:
        mh = torch.zeros_like(rx)
    hz = mh + height_offset

    view = cam["view"]
    proj = cam["proj_wgpu"]

    def mat4(m, x, y, z):
        return tuple(
            m[r, 0] * x + m[r, 1] * y + m[r, 2] * z + m[r, 3] for r in range(4)
        )

    vx, vy, vz, _ = mat4(view, rx, ry, hz)
    p0, p1, p2, p3 = mat4(proj, vx, vy, vz)
    wc = torch.where(torch.abs(p3) < 1e-9, 1e-9, p3)
    px = (p0 / wc * 0.5 + 0.5) * w_img
    py = (0.5 - p1 / wc * 0.5) * h_img
    pz = p2 / wc
    uu = rx / tw / 4.0
    vv = ry / tw / 4.0
    tri_idx = tris.long()

    def tri_of(a):
        return a[tri_idx]  # [3, T]

    attrs = torch.stack([tri_of(uu), tri_of(vv), tri_of(mh)], dim=0)
    return triangle_planes(
        tri_of(px), tri_of(py), tri_of(pz), tri_of(p3), attrs,
        torch.ones(tris.shape[1], dtype=torch.bool, device=tris.device),
    )


def grid_counts(planes, ok, bbox, image_wh):
    """The grid's triangle counts as 0-d tensors: proxy_tris_live, those
    that reach the rasterizer (kept by triangle_planes, their box on the
    image), and proxy_tris_thin, the live ones of under one pixel of area
    (|area2| < 2; the b0 and b1 gradients' cross product is 1 / area2),
    whose depth their plane rows hold only when solved from the differences
    to a vertex (triangle_planes)."""
    live = ok & on_image(bbox, image_wh)
    inv_area2 = planes[0] * planes[4] - planes[1] * planes[3]
    return dict(proxy_tris_live=live.sum(),
                proxy_tris_thin=(live & (inv_area2.abs() > 0.5)).sum())


def raster_map_grid(cam, scene, image_wh, hm4, hm_wh, verts, tris,
                    *, surface_type: int, height_offset: float,
                    tile_wh, chunk: int, capacity: int, counts=None):
    """Rasterize the displaced tile-map grid into `capacity` pair slots
    (ops/trirast.py rasterize_triangles). Returns (z [H,W] wgpu depth,
    u, v, mapped_h [H,W], hit [H,W], n_pairs, overflow); with `counts` (a
    dict) also adds grid_counts' to it."""
    planes, ok, bbox = map_grid_planes(
        cam, scene, image_wh, hm4, hm_wh, verts, tris,
        surface_type=surface_type, height_offset=height_offset)
    if counts is not None:
        counts.update(grid_counts(planes, ok, bbox, image_wh))
    rast = rasterize_triangles(
        planes, bbox, ok, image_wh=image_wh, tile_wh=tile_wh, chunk=chunk,
        capacity=capacity,
    )
    z, at = tiles_to_maps(rast["tiles"], image_wh=image_wh, tile_wh=tile_wh)
    invw = at[0]
    hit = (z < 1.0) & (invw > 1e-12)
    invw_s = torch.where(invw <= 1e-12, 1.0, invw)
    u_px = at[1] / invw_s
    v_px = at[2] / invw_s
    mh_px = at[3] / invw_s
    return z, u_px, v_px, mh_px, hit, rast["n_pairs"], rast["overflow"]


# ------------------------------------------------------------------ #
# far-field ray march (stands in for the reference's 2048^2 ground grid)
# ------------------------------------------------------------------ #
def march_steps(n_steps: int, max_dist: float):
    """The march's sample distances, denser near the camera: (i / (n-1))^2
    * max_dist in float32. Built with numpy, so every device marches the
    same distances, and as i * (1 / (n-1)), the form in which the JAX
    package's linspace is evaluated, so both packages march the same ones."""
    inv = np.float32(1.0) / np.float32(max(n_steps - 1, 1))
    s = np.arange(n_steps, dtype=np.float32) * inv
    return (s * s * np.float32(max_dist)).astype(np.float32)


def march_height_field(
    cam, scene, image_wh, hm4, hm_wh,
    *, surface_type: int, height_offset: float,
    n_steps: int = 96, n_refine: int = 8, max_dist: float = 2400.0,
):
    """Ray-march the proxy height surface. Returns (z [H,W] wgpu depth,
    u, v, mapped_h [H,W], hit [H,W])."""
    w_img, h_img = image_wh
    rays = pixel_rays(cam, image_wh)
    dev = rays.device
    d = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
    o = cam["cam_pos"]

    def surf_h(x, y):
        if surface_type == 1:
            return _height_at(scene, hm4, hm_wh, x, y) + height_offset
        return torch.full_like(x, height_offset)

    def f(t):
        p = o[None, None, :] + d * t[..., None]
        return p[..., 2] - surf_h(p[..., 0], p[..., 1])

    t_prev = torch.zeros((h_img, w_img), dtype=torch.float32, device=dev)
    t_hit = torch.full((h_img, w_img), float("inf"), dtype=torch.float32,
                       device=dev)
    above_prev = f(t_prev) > 0
    t_lo = torch.zeros_like(t_prev)
    for t in march_steps(n_steps, max_dist).tolist():
        tt = torch.full((h_img, w_img), t, dtype=torch.float32, device=dev)
        above = f(tt) > 0
        crossed = above_prev & (~above) & torch.isinf(t_hit)
        t_hit = torch.where(crossed, tt, t_hit)
        t_lo = torch.maximum(t_lo, torch.where(crossed, t_prev, 0.0))
        t_prev, above_prev = tt, above
    hit = torch.isfinite(t_hit)
    t_hi = torch.where(hit, t_hit, max_dist)

    for _ in range(n_refine):
        mid = 0.5 * (t_lo + t_hi)
        below = f(mid) <= 0
        t_lo, t_hi = (torch.where(below, t_lo, mid),
                      torch.where(below, mid, t_hi))
    t = 0.5 * (t_lo + t_hi)
    p = o[None, None, :] + d * t[..., None]

    mapped_h = surf_h(p[..., 0], p[..., 1]) - height_offset

    view = cam["view"]
    proj = cam["proj_wgpu"]
    cam3 = p @ view[:3, :3].T + view[:3, 3]
    z_clip = cam3 @ proj[2, :3] + proj[2, 3]
    w_clip = cam3 @ proj[3, :3] + proj[3, 3]
    z = torch.where(hit, torch.clamp(z_clip / w_clip, 0.0, 1.0), 1.0)

    tw = scene["tile_width"]
    u = p[..., 0] / tw / 4.0
    v = p[..., 1] / tw / 4.0
    return z, u, v, mapped_h, hit


# ------------------------------------------------------------------ #
def render_proxy(
    cam, scene, image_wh, hm4, hm_wh, proxy, proxy_wh,
    *, surface_type: int, height_offset: float, brightness: float,
    black_background: bool, use_clip: bool, clip_height: float,
    mip_meta=None, mip_pyr=None, tile_wh=(64, 32), chunk: int = 128,
    use_grid: bool = True, n_steps: int = 96, max_dist: float = 2400.0,
    proxy_pairs: int,
):
    """The proxy pass. proxy: dict(atlas [4, total] int32 words, mip_tab:
    the levels' (w, h, off) as mip_table made it on the atlas's device,
    verts [2, Nv], tris [3, T], optional pyr: the packed rgb pyramid as
    texsample.sampler_pyramid lays it out on its device) with mip_meta the
    per-level (w, h, off) tuple. proxy_pairs: the grid raster's pair slots
    (ops/trirast.py rasterize_triangles); aux holds proxy_pairs, the
    demand, and proxy_overflow, and on the grid path while the host-section
    profiler is on the triangle counts of grid_counts (a few launches, so
    only then).
    The grid's raster is the section render.front.proxy.raster, the
    footprint, mip sampling and colour render.front.proxy.shade. When
    mip_pyr (the (meta, l_min) from
    texsample.pack_pyramid) is given and proxy carries the packed pyramid
    planes, mip sampling goes through the pyramid kernel (fast profile;
    levels finer than l_min clamp -- documented in PARITY.md); otherwise
    the per-pixel trilinear atlas path runs (exact).
    Returns (color [H,W,4], depth [H,W] wgpu clip z, hit [H,W], aux)."""
    w_img, h_img = image_wh
    dev = hm4.device
    if use_grid:
        # map grid + far clipmap rings rasterized together
        counts = {} if hostprof._PROF_ON else None
        with _hprof("render.front.proxy.raster", dev):
            z, u, v, mh, hit, npx, ovf = raster_map_grid(
                cam, scene, image_wh, hm4, hm_wh, proxy["verts"],
                proxy["tris"], surface_type=surface_type,
                height_offset=height_offset, tile_wh=tile_wh, chunk=chunk,
                capacity=proxy_pairs, counts=counts,
            )
        aux = dict(proxy_pairs=npx, proxy_overflow=ovf, **(counts or {}))
    else:
        z, u, v, mh, hit = march_height_field(
            cam, scene, image_wh, hm4, hm_wh,
            surface_type=surface_type, height_offset=height_offset,
            n_steps=n_steps, max_dist=max_dist,
        )
        zero = torch.zeros((), dtype=torch.int64, device=z.device)
        aux = dict(proxy_pairs=zero, proxy_overflow=zero > 0)

    with _hprof("render.front.proxy.shade", dev):
        # fragment clip discard (proxy.wgsl:100-102)
        if use_clip:
            hit = hit & ~(mh < clip_height)
        depth = torch.where(hit, z, 1.0)

        if black_background:
            rgb = torch.zeros((h_img, w_img, 3), dtype=torch.float32,
                              device=z.device)
        else:
            meta = mip_meta or ((int(proxy_wh[0]), int(proxy_wh[1]), 0),)
            rho = _uv_footprint(u, v, float(meta[0][0]), float(meta[0][1]))
            if mip_pyr is not None and proxy.get("pyr") is not None:
                pyr_meta, l_min = mip_pyr
                rgb = factored_mip_trilinear(
                    proxy["pyr"], pyr_meta, l_min, u, v, rho, n_ch=3,
                ).permute(1, 2, 0)
            else:
                rgb = sample_mip_trilinear(proxy["atlas"], proxy["mip_tab"],
                                           u, v, rho)
            rgb = rgb * brightness
        color = torch.cat(
            [rgb, torch.ones((h_img, w_img, 1), dtype=torch.float32,
                             device=z.device)], dim=-1
        )
        color = torch.where(hit[..., None], color, 0.0)
    return color, depth, hit, aux
