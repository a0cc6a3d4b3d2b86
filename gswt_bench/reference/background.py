"""The reference background: the skybox and the proxy ground.

Semantics of skybox.wgsl (an equirect HDRI sampled bilinearly, Reinhard,
gamma 2.2) and of the proxy ground (proxy.rs, proxy.wgsl): the height field
0.5 below the splat surface, textured with the checker's Lanczos mip chain
(proxy.rs:513-554) sampled trilinearly with the Repeat sampler, depth
written for the splats' test. As the fast profile states
(``RendererConfig.proxy_res_div``), the ground is found at half resolution
and brought up with nearest depth and hit and bilinear colour, and its mip
pyramid keeps the 8-bit levels from the first one of 128 texels or fewer.
The ground's surface is the port's stated mesh (PARITY.md #4): the
tile-map grid, one cell per map cell, and around it concentric rings whose
extent and cell double until they pass the far plane, standing in for the
reference renderer's camera-following far grid; two planar triangles per
cell, with vertices displaced by the height field and overlapping rings
resolved to the nearest surface. Each pixel's ray is marched to that
surface as a rasterizer finds it (ray_hit_mesh). The ring layout
(``make_map_grid``), the mip chain's Lanczos-3 filter and the footprint
from neighbouring pixels' coordinates are frozen copies, at commit
6240227d, of ``gswt_renderer_tpu_torch/ops/proxy.py`` (``make_map_grid``,
``_uv_footprint``) and ``io/textures.py`` (``_downsample2_lanczos``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .camera import OPENGL_TO_WGPU
from .project import sample_height

PROXY_HEIGHT = -0.5
PROXY_RES_DIV = 2
PYRAMID_MAX_W = 128
FAR_DIST = 2400.0
Z_FAR = 2400.0
# pixels around the far ground that are judged apart from the rest
FAR_MARGIN_PX = 8


def pixel_rays(cam, width, height, device):
    xs = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) / width * 2.0 - 1.0
    ys = 1.0 - (torch.arange(height, dtype=torch.float32, device=device) + 0.5) / height * 2.0
    nx, ny = torch.meshgrid(xs, ys, indexing="xy")
    hx, hy = float(cam["htan_fov"][0]), float(cam["htan_fov"][1])
    d_view = torch.stack([nx * hx, ny * hy, -torch.ones_like(nx)], dim=-1)
    r = torch.as_tensor(cam["view"][:3, :3], device=device)
    return d_view @ r


def skybox(cam, width, height, sky, device):
    """[H, W, 4] opaque sky from the equirect texture sky [h, w, 3]."""
    rays = pixel_rays(cam, width, height, device)
    d = torch.stack([rays[..., 0], -rays[..., 2], rays[..., 1]], dim=-1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    u = torch.atan2(d[..., 2], d[..., 0]) * 0.1591 + 0.5
    v = torch.asin(torch.clamp(d[..., 1], -1.0, 1.0)) * 0.3183 + 0.5
    tex = torch.as_tensor(np.asarray(sky, np.float32), device=device)
    th, tw = tex.shape[:2]
    x = torch.clamp(u * tw - 0.5, 0.0, tw - 1.0)
    y = torch.clamp(v * th - 0.5, 0.0, th - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = torch.clamp(x0 + 1, max=tw - 1), torch.clamp(y0 + 1, max=th - 1)
    c = ((tex[y0, x0] * (1 - fx) + tex[y0, x1] * fx) * (1 - fy)
         + (tex[y1, x0] * (1 - fx) + tex[y1, x1] * fx) * fy)
    c = c / (c + 1.0)
    c = torch.pow(torch.clamp(c, min=0.0), 1.0 / 2.2)
    return torch.cat([c, torch.ones_like(c[..., :1])], dim=-1)


def _lanczos_half(img):
    taps = np.arange(-5, 6)
    x = (taps + 0.5) / 2.0
    w = np.where(np.abs(x) < 3, np.sinc(x) * np.sinc(x / 3), 0.0)
    w = w / w.sum()

    def down_axis(a, axis):
        a = np.moveaxis(a, axis, 0)
        n = a.shape[0]
        idx = np.clip(np.arange(0, n, 2)[:, None] + taps[None, :], 0, n - 1)
        return np.moveaxis(np.einsum("t,ot...->o...", w, a[idx]), 0, axis)

    return down_axis(down_axis(img, 0), 1).astype(np.float32)


def mip_pyramid(tex, max_levels=12):
    """(levels kept, as 8-bit values over 255, l_min): the Lanczos chain
    from the first level of at most 128 texels across."""
    img = np.asarray(tex, np.float32)
    mips = [img]
    while min(img.shape[0], img.shape[1]) > 1 and len(mips) < max_levels:
        img = _lanczos_half(img)
        mips.append(img)
    l_min = 0
    while (mips[0].shape[1] >> l_min) > PYRAMID_MAX_W:
        l_min += 1
    return [np.clip(np.round(m * 255.0), 0, 255) / 255.0 for m in mips[l_min:]], l_min


def _bilinear_repeat(level, u, v):
    h, w = level.shape[:2]
    x = u * w - 0.5
    y = v * h - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    tx, ty = (x - x0f)[..., None], (y - y0f)[..., None]
    x0 = torch.remainder(x0f, w).long()
    y0 = torch.remainder(y0f, h).long()
    x1 = (x0 + 1) % w
    y1 = (y0 + 1) % h
    return ((level[y0, x0] * (1 - tx) + level[y0, x1] * tx) * (1 - ty)
            + (level[y1, x0] * (1 - tx) + level[y1, x1] * tx) * ty)


def _footprint(u, v, tex_w, tex_h):
    def deriv(img, axis):
        d = torch.diff(img, dim=axis)
        last = d[-1:, :] if axis == 0 else d[:, -1:]
        return torch.cat([d, last], dim=axis)

    dudx, dudy = deriv(u, 1) * tex_w, deriv(u, 0) * tex_w
    dvdx, dvdy = deriv(v, 1) * tex_h, deriv(v, 0) * tex_h
    return torch.maximum(torch.sqrt(dudx * dudx + dvdx * dvdx),
                         torch.sqrt(dudy * dudy + dvdy * dvdy))


def ground_patches(map_half, tile_width, far_dist=FAR_DIST):
    """The ground mesh's grid patches, in world units relative to the map's
    centre: (x_lo, y_lo, cells across, cell size, hole) with the hole the
    open square whose cells a ring leaves out (None for the tile map's
    own grid, of 2 map_half + 1 cells)."""
    tw = float(tile_width)
    patches = [(-map_half * tw, -map_half * tw, 2 * map_half + 1, tw, None)]
    ext = map_half * tw
    cell = 4.0 * tw
    while ext < far_dist:
        outer = ext * 2.0
        n = int(np.ceil(2.0 * outer / cell))
        lo = -0.5 * n * cell
        patches.append((lo, lo, n, cell, ext - cell))
        ext = outer
        cell *= 2.0
    return patches


def _patch_height(surf_h, patch, rx, ry, ox, oy, view_z):
    """(height, covered) of one patch at map-relative points (rx, ry): the
    plane of the cell's triangle (corners (0,0),(1,0),(0,1) and
    (1,0),(1,1),(0,1)) through the heights `surf_h` at the displaced
    vertices (world = map-relative + (ox, oy)). A point is covered where
    its cell is in the patch, and its triangle has no vertex behind the
    camera (`view_z` of a world point > 0: the rasterizer drops such a
    triangle whole)."""
    x_lo, y_lo, n, cell, hole = patch
    fx, fy = (rx - x_lo) / cell, (ry - y_lo) / cell
    ci, cj = torch.floor(fx), torch.floor(fy)
    on = (ci >= 0) & (ci < n) & (cj >= 0) & (cj < n)
    if hole is not None:
        cx, cy = x_lo + (ci + 0.5) * cell, y_lo + (cj + 0.5) * cell
        on &= ~((cx > -hole) & (cx < hole) & (cy > -hole) & (cy < hole))
    vx, vy = x_lo + ci * cell + ox, y_lo + cj * cell + oy
    h00, h10 = surf_h(vx, vy), surf_h(vx + cell, vy)
    h01, h11 = surf_h(vx, vy + cell), surf_h(vx + cell, vy + cell)
    a, b = fx - ci, fy - cj
    lower = a + b <= 1.0
    h = torch.where(lower, h00 + a * (h10 - h00) + b * (h01 - h00),
                    h11 + (1.0 - a) * (h01 - h11) + (1.0 - b) * (h10 - h11))
    z10, z01 = view_z(vx + cell, vy, h10), view_z(vx, vy + cell, h01)
    z_far = torch.where(lower, view_z(vx, vy, h00), view_z(vx + cell, vy + cell, h11))
    on &= (z10 > 1e-6) & (z01 > 1e-6) & (z_far > 1e-6)
    return h, on


def ray_hit_mesh(surf_h, patches, o, d, t_max, ox, oy, view_z, n_refine=12):
    """The nearest intersection t of rays o + t d (d [.., 3], t up to
    t_max [..]) with the ground mesh, inf where none, as a rasterizer
    without back-face culling finds it: each patch is marched on its own,
    at half a cell's horizontal step inside the ray's span over the
    patch's square, its first change of side bisected; overlapping patches
    resolve to the nearest. A ray that passes under a patch misses it."""
    t_hit = torch.full(t_max.shape, float("inf"), dtype=torch.float32, device=d.device)
    hd = torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)
    rox, roy = float(o[0]) - ox, float(o[1]) - oy
    for patch in patches:
        x_lo, y_lo, n, cell, _ = patch
        x_hi, y_hi = x_lo + n * cell, y_lo + n * cell
        # the ray's span over the patch's square (slabs in x and y)
        inv_x = 1.0 / torch.where(d[..., 0] == 0, 1e-12, d[..., 0])
        inv_y = 1.0 / torch.where(d[..., 1] == 0, 1e-12, d[..., 1])
        tx1, tx2 = (x_lo - rox) * inv_x, (x_hi - rox) * inv_x
        ty1, ty2 = (y_lo - roy) * inv_y, (y_hi - roy) * inv_y
        t0 = torch.clamp(torch.maximum(torch.minimum(tx1, tx2), torch.minimum(ty1, ty2)),
                         min=0.0)
        t1 = torch.minimum(torch.minimum(torch.maximum(tx1, tx2), torch.maximum(ty1, ty2)),
                           t_max)
        span = torch.clamp(t1 - t0, min=0.0)
        if not bool((span > 0).any()):
            continue
        steps = int(np.ceil(float((span * hd).max()) / (0.5 * cell))) + 1
        if steps < 2:
            continue

        def side(t):
            p = o + d * t[..., None]
            h, on = _patch_height(surf_h, patch, p[..., 0] - ox, p[..., 1] - oy, ox, oy, view_z)
            return p[..., 2] - h, on

        lo = torch.full_like(t0, float("nan"))
        hi = torch.full_like(t0, float("nan"))
        f_prev, on_prev = side(t0)
        t_prev = t0
        for i in range(1, steps):
            t = t0 + span * (i / (steps - 1))
            f, on = side(t)
            cross = on & on_prev & ((f > 0) != (f_prev > 0)) & torch.isnan(lo) & (span > 0)
            lo = torch.where(cross, t_prev, lo)
            hi = torch.where(cross, t, hi)
            f_prev, on_prev, t_prev = f, on, t
        found = ~torch.isnan(lo)
        if not bool(found.any()):
            continue
        lo, hi = torch.where(found, lo, 0.0), torch.where(found, hi, 0.0)
        f_lo = side(lo)[0] > 0
        for _ in range(n_refine):
            mid = 0.5 * (lo + hi)
            same = (side(mid)[0] > 0) == f_lo
            lo, hi = torch.where(same, mid, lo), torch.where(same, hi, mid)
        t_hit = torch.where(found, torch.minimum(t_hit, 0.5 * (lo + hi)), t_hit)
    return t_hit


def proxy(cam, scene, hm, hm_wh, pyramid, width, height, device):
    """(colour [H, W, 4], depth [H, W], hit [H, W], far [H, W]) of the
    proxy ground; `far` marks the ground beyond the tile map (dilated by
    FAR_MARGIN_PX), the rings'."""
    levels, l_min = pyramid
    pw, ph = -(-width // PROXY_RES_DIV), -(-height // PROXY_RES_DIV)
    rays = pixel_rays(cam, pw, ph, device)
    d = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
    o = torch.as_tensor(cam["cam_pos"], dtype=torch.float32, device=device)
    half, tw, hms = scene["map_half_wh"], scene["tile_width"], scene["height_map_scale"]
    hx = (2.0 * half[0] + 1.0) * tw * hms[0]
    hy = (2.0 * half[1] + 1.0) * tw * hms[1]
    # march each ray as far as the far plane: view depth Z_FAR
    fwd = -torch.as_tensor(cam["view"][2, :3], device=device)
    t_max = Z_FAR / torch.clamp(d @ fwd, min=1e-6)

    def surf_h(x, y):
        hu = (x + half[0] * tw) / hx
        hv = (y + half[1] * tw) / hy
        return sample_height(hm, hm_wh, hu, hv) * float(hms[2]) + PROXY_HEIGHT

    cc = scene["center_coord"]
    ox, oy = float(cc[0] * tw), float(cc[1] * tw)
    view = torch.as_tensor(cam["view"], device=device)

    def view_z(x, y, z):
        return -(view[2, 0] * x + view[2, 1] * y + view[2, 2] * z + view[2, 3])

    t_hit = ray_hit_mesh(surf_h, ground_patches(half[0], tw), o, d, t_max, ox, oy, view_z)
    hit = torch.isfinite(t_hit)
    p = o[None, None, :] + d * torch.where(hit, t_hit, t_max)[..., None]
    reach = torch.maximum((p[..., 0] - cc[0] * tw).abs(), (p[..., 1] - cc[1] * tw).abs())
    proj = torch.as_tensor(OPENGL_TO_WGPU @ cam["projection"], device=device)
    cam3 = p @ view[:3, :3].T + view[:3, 3]
    z_clip = cam3 @ proj[2, :3] + proj[2, 3]
    w_clip = cam3 @ proj[3, :3] + proj[3, 3]
    z = torch.clamp(z_clip / w_clip, 0.0, 1.0)
    hit &= z < 1.0
    z = torch.where(hit, z, 1.0)
    u = p[..., 0] / tw / 4.0
    v = p[..., 1] / tw / 4.0
    tex_w, tex_h = levels[0].shape[1] << l_min, levels[0].shape[0] << l_min
    rho = _footprint(u, v, float(tex_w), float(tex_h))
    lvl = torch.clamp(torch.log2(torch.clamp(rho, min=1e-6)) - l_min, 0.0,
                      float(len(levels) - 1))
    l0 = torch.floor(lvl).long()
    frac = (lvl - l0.to(torch.float32))[..., None]
    lv = [torch.as_tensor(m, dtype=torch.float32, device=device) for m in levels]
    rgb = torch.zeros((ph, pw, 3), dtype=torch.float32, device=device)
    for i, m in enumerate(lv):
        on0 = (l0 == i)[..., None]
        on1 = (torch.clamp(l0 + 1, max=len(lv) - 1) == i)[..., None]
        if not (on0.any() or on1.any()):
            continue
        s = _bilinear_repeat(m, u, v)
        rgb = rgb + torch.where(on0, s * (1.0 - frac), 0.0)
        rgb = rgb + torch.where(on1 & (l0 + 1 < len(lv))[..., None], s * frac, 0.0)
    color = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
    color = torch.where(hit[..., None], color, 0.0)
    depth = torch.where(hit, z, 1.0)
    far = (hit & (reach > (half[0] - 1) * tw)).to(torch.float32)
    far = F.max_pool2d(far[None, None], 2 * FAR_MARGIN_PX // PROXY_RES_DIV + 1, stride=1,
                       padding=FAR_MARGIN_PX // PROXY_RES_DIV)[0, 0] > 0
    far = far.repeat_interleave(PROXY_RES_DIV, 0).repeat_interleave(PROXY_RES_DIV, 1)
    depth = depth.repeat_interleave(PROXY_RES_DIV, 0).repeat_interleave(PROXY_RES_DIV, 1)
    hit = hit.repeat_interleave(PROXY_RES_DIV, 0).repeat_interleave(PROXY_RES_DIV, 1)
    color = F.interpolate(color.permute(2, 0, 1)[None], scale_factor=PROXY_RES_DIV,
                          mode="bilinear", align_corners=False)[0].permute(1, 2, 0)
    return (color[:height, :width], depth[:height, :width], hit[:height, :width],
            far[:height, :width])
