"""Skybox pass (skybox.rs + skybox.wgsl), per-pixel formulation.

The reference draws a 36-vertex cube with the translation-stripped view and
samples a cubemap (or an HDRI equirect baked into a 2048^2 cubemap through 6
offline passes with Reinhard + gamma, skybox.wgsl:61-97). Here there is no
raster pass: each pixel's world-space view ray is computed directly and the
source texture sampled per pixel -- equivalent to the cube pass without the
intermediate cubemap resampling.

Coordinate mapping replicates skybox.wgsl:32-38: sample dir = (x, -z, y) of
the world ray, with y negated again for cubemap sources (sky_directions).
"""

from __future__ import annotations

import torch

from .texsample import factored_bilinear


def pixel_rays(cam, image_wh):
    """World-space ray directions per pixel [H, W, 3] (unnormalized)."""
    w, h = image_wh
    dev = cam["view"].device
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w * 2.0 - 1.0
    ys = 1.0 - (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h * 2.0
    nx, ny = torch.meshgrid(xs, ys, indexing="xy")
    hx = cam["htan_fov"][0]
    hy = cam["htan_fov"][1]
    d_view = torch.stack([nx * hx, ny * hy, -torch.ones_like(nx)], dim=-1)
    r = cam["view"][:3, :3]  # world->view rotation
    return d_view @ r  # = R^T d_view


def equirect_texel_coords(dir_xyz, tex_hw):
    """SampleSphericalMap (skybox.wgsl:86-97): fractional texel coordinates
    (x, y) of directions [..., 3] in an equirect texture of (Ht, Wt) texels,
    clamped to the texel centres' range."""
    d = dir_xyz / torch.linalg.norm(dir_xyz, dim=-1, keepdim=True)
    u = torch.atan2(d[..., 2], d[..., 0]) * 0.1591 + 0.5
    v = torch.asin(torch.clamp(d[..., 1], -1.0, 1.0)) * 0.3183 + 0.5
    th, tw = tex_hw
    x = torch.clamp(u * tw - 0.5, 0.0, tw - 1.0)
    y = torch.clamp(v * th - 0.5, 0.0, th - 1.0)
    return x, y


def sky_directions(cam, image_wh, *, equirect: bool):
    """Per-pixel sample directions [H, W, 3]: (x, -z, y) of the world ray
    (skybox.wgsl:32-38), with y negated again for cubemap sources."""
    rays = pixel_rays(cam, image_wh)
    mid = -rays[..., 2] if equirect else rays[..., 2]
    return torch.stack([rays[..., 0], mid, rays[..., 1]], dim=-1)


def _sample_equirect(tex, dir_xyz):
    """SampleSphericalMap + bake tonemap (skybox.wgsl:74-97). tex [H,W,3].

    A texture of any size goes through the bilinear sampler
    (ops/texsample.py factored_bilinear: its kernel on the card, its plain
    version on the CPU). The JAX package sends a texture over its TPU
    kernel's size limit through four indexed taps instead; the two
    associations differ in the last ulp."""
    x, y = equirect_texel_coords(dir_xyz, tex.shape[:2])
    c = torch.movedim(
        factored_bilinear(
            torch.movedim(tex, -1, 0).contiguous(), x, y,
            wrap_x=False, wrap_y=False,
        ),
        0, -1,
    )
    # Reinhard + gamma done at bake time in the reference
    c = c / (c + 1.0)
    return torch.pow(torch.clamp(c, min=0.0), 1.0 / 2.2)


def _sample_cubemap(faces, dir_xyz):
    """faces [6, R, R, 3] in wgpu cube layout (+x,-x,+y,-y,+z,-z)."""
    d = dir_xyz
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    ax = torch.abs(dx)
    ay = torch.abs(dy)
    az = torch.abs(dz)
    # face selection
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = torch.where(
        is_x,
        torch.where(dx > 0, 0, 1),
        torch.where(is_y, torch.where(dy > 0, 2, 3), torch.where(dz > 0, 4, 5)),
    )
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az))
    # standard cubemap uv per face (WebGPU convention)
    u = torch.where(
        is_x,
        torch.where(dx > 0, -dz, dz),
        torch.where(is_y, dx, torch.where(dz > 0, dx, -dx)),
    )
    v = torch.where(is_y, torch.where(dy > 0, dz, -dz), -dy)
    uu = (u / ma + 1.0) * 0.5
    vv = (v / ma + 1.0) * 0.5
    r = faces.shape[1]
    x = torch.clamp(uu * r - 0.5, 0, r - 1)
    y = torch.clamp(vv * r - 0.5, 0, r - 1)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=r - 1)
    y1 = torch.clamp(y0 + 1, max=r - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    return (
        faces[face, y0, x0] * (1 - fx) * (1 - fy)
        + faces[face, y0, x1] * fx * (1 - fy)
        + faces[face, y1, x0] * (1 - fx) * fy
        + faces[face, y1, x1] * fx * fy
    )


def bake_hdri_to_cubemap(hdri, resolution: int = 2048):
    """Bake an equirect HDRI (a float32 tensor [H,W,3]) into cubemap faces
    [6, R, R, 3] on its device (the reference's 6-pass bake,
    skybox.rs:341-455 + 580-660, with Reinhard + gamma applied at bake time
    like its bake shader). Face directions are the inverse of
    _sample_cubemap's WebGPU uv convention, so
    _sample_cubemap(bake(h), d) == _sample_equirect(h, d) up to the
    cubemap's own bilinear resample."""
    r = resolution
    t = (torch.arange(r, dtype=torch.float32, device=hdri.device) + 0.5) / r * 2.0 - 1.0
    vg, ug = torch.meshgrid(t, t, indexing="ij")  # v' rows, u' cols
    one = torch.ones_like(ug)
    dirs = torch.stack(
        [
            torch.stack([one, -vg, -ug], dim=-1),    # +x
            torch.stack([-one, -vg, ug], dim=-1),    # -x
            torch.stack([ug, one, vg], dim=-1),      # +y
            torch.stack([ug, -one, -vg], dim=-1),    # -y
            torch.stack([ug, -vg, one], dim=-1),     # +z
            torch.stack([-ug, -vg, -one], dim=-1),   # -z
        ],
        dim=0,
    )  # [6, R, R, 3]
    return _sample_equirect(hdri, dirs)


def render_skybox(cam, image_wh, tex, *, equirect: bool):
    """Returns [H, W, 4] opaque background. tex: equirect [He,We,3] or
    cubemap faces [6,R,R,3]."""
    d = sky_directions(cam, image_wh, equirect=equirect)
    rgb = _sample_equirect(tex, d) if equirect else _sample_cubemap(tex, d)
    a = torch.ones(rgb.shape[:-1] + (1,), dtype=torch.float32,
                   device=rgb.device)
    return torch.cat([rgb, a], dim=-1)
