"""The reference's per-splat vertex math: the draw list flattened into a
stream, then projected.

Frozen copy, at commit 6240227d, of ``assemble_stream``, ``project_draw``,
``ewa_project_cov``, ``surface_mapping_gpu`` and ``sample_height`` of
``gswt_renderer_tpu_torch/refrender/oracle.py`` (the transcription of
gswt.wgsl's vs_main and renderer.rs's draw loop), cut to the flat and
height-map surfaces and the normal draw mode, and taking plain arrays in
place of the program's FrameInputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .camera import OPENGL_TO_WGPU

F32 = torch.float32
F64 = torch.float64


def _dev(a, device, dtype=None):
    t = torch.as_tensor(np.asarray(a))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def _sandwich(tt, m):
    out = torch.zeros_like(m)
    for j in range(3):
        for k in range(3):
            out = out + (tt[:, j, :, None] * m[:, j, k, None, None]) * tt[:, k, None, :]
    return out


def _sqrt(x):
    return torch.sqrt(x.to(F64)).to(x.dtype) if x.dtype == F32 else torch.sqrt(x)


def _norm3(v):
    s = v * v
    return _sqrt(s[:, 0] + s[:, 1] + s[:, 2])


def sample_height(height_map, wh, u, v):
    """Wrapping bilinear height (gswt.wgsl:576-583)."""
    w, h = int(wh[0]), int(wh[1])
    x = u * w - 0.5
    y = v * h - 0.5
    fx = torch.floor(x)
    fy = torch.floor(y)
    x0 = fx.to(torch.int64)
    y0 = fy.to(torch.int64)
    tx = (x - fx).to(F32)
    ty = (y - fy).to(F32)

    def texel(xi, yi):
        return height_map[(yi % h) * w + (xi % w)]

    i00, i10 = texel(x0, y0), texel(x0 + 1, y0)
    i01, i11 = texel(x0, y0 + 1), texel(x0 + 1, y0 + 1)
    return (i00 * (1 - tx) + i10 * tx) * (1 - ty) + (i01 * (1 - tx) + i11 * tx) * ty


def height_surface(scene, hm, hm_wh, pos_xy):
    """Height-map surface mapping (gswt.wgsl:565-623): (mapped centre [N,3],
    local frame [N,3,3])."""
    dev = pos_xy.device
    n = pos_xy.shape[0]
    half, tw, hms = scene["map_half_wh"], scene["tile_width"], scene["height_map_scale"]
    hx = (2.0 * half[0] + 1.0) * tw * hms[0]
    hy = (2.0 * half[1] + 1.0) * tw * hms[1]
    hu = (pos_xy[:, 0] + half[0] * tw) / float(hx)
    hv = (pos_xy[:, 1] + half[1] * tw) / float(hy)
    dt = 0.001
    z = float(hms[2])
    height = sample_height(hm, hm_wh, hu, hv) * z
    h_r = sample_height(hm, hm_wh, hu + dt, hv) * z
    h_l = sample_height(hm, hm_wh, hu - dt, hv) * z
    h_u = sample_height(hm, hm_wh, hu, hv + dt) * z
    h_d = sample_height(hm, hm_wh, hu, hv - dt) * z
    one = torch.ones(n, dtype=F32, device=dev)
    zero = torch.zeros(n, dtype=F32, device=dev)
    local_x = torch.stack([one, zero, (h_r - h_l) / float(2.0 * dt * hx)], dim=1)
    local_y = torch.stack([zero, one, (h_u - h_d) / float(2.0 * dt * hy)], dim=1)
    local_z = torch.linalg.cross(local_x, local_y, dim=1)
    local_z = local_z / _norm3(local_z)[:, None]
    new_pos = torch.stack([pos_xy[:, 0], pos_xy[:, 1], height], dim=1)
    return new_pos.to(F32), torch.stack([local_x, local_y, local_z], dim=2).to(F32)


def assemble_stream(draw, preload, cam, culling_dist, device):
    """Flatten the draw list into per-splat rows in draw order
    (renderer.rs:466-591), with render-time viewport culling: gs_index,
    map_id, lod_id, draw_id (int64 tensors)."""
    dev = torch.device(device)
    n = int(draw["n_draws"])
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    if n == 0:
        return dict(gs_index=empty, map_id=empty, lod_id=empty, draw_id=empty)
    vp = _dev(cam["projection"], dev) @ _dev(cam["view"], dev)
    corners = _dev(draw["corner_pos"][:n], dev, F32)
    hom = torch.cat([corners, torch.ones((n, 4, 1), dtype=F32, device=dev)], dim=2)
    p = hom @ vp.T
    p = p[..., :3] / p[..., 3:4]
    px = p[..., 0].abs().amin(dim=1)
    py = p[..., 1].abs().amin(dim=1)
    pz = p[..., 2].amax(dim=1)
    culled = (pz < -culling_dist) | (px > culling_dist) | (py > culling_dist)
    culled &= (_dev(draw["single_draw"][:n], dev) == 0) & (_dev(draw["has_corners"][:n], dev) != 0)
    keep = ~culled
    stream_idx = draw["stream_gs_index"]
    n_stream = int(stream_idx.shape[0]) if stream_idx is not None else 0
    cnt = _dev(draw["splat_count"][:n], dev, torch.int64)
    s0 = _dev(draw["stream_start"][:n], dev, torch.int64)
    poff = _dev(preload["offset"], dev, torch.int64)[
        _dev(draw["base_lod"][:n], dev, torch.int64),
        _dev(draw["base_tile"][:n], dev, torch.int64),
        _dev(draw["base_view"][:n], dev, torch.int64)]
    start = torch.where(s0 >= 0, s0, n_stream + poff)
    cnt = torch.where(keep, cnt, 0)
    draw_id = torch.repeat_interleave(torch.arange(n, device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    src = start[draw_id] + torch.arange(draw_id.shape[0], device=dev) - first[draw_id]

    def table(stream_part, preload_part):
        parts = [_dev(preload_part, dev, torch.int64)]
        if n_stream:
            parts.insert(0, _dev(stream_part, dev, torch.int64))
        return torch.cat(parts)[src]

    gs = table(stream_idx, preload["index"])
    lid = table(draw["stream_lod_id"], preload["lod"])
    mid = table(draw["stream_map_id"], np.zeros(preload["index"].shape, np.int64))
    return dict(gs_index=gs, map_id=mid, lod_id=lid, draw_id=draw_id)


def ewa_project_cov(Vrk, center, view3, cam_pos, focal, htan_fov):
    s = center.shape[0]
    dev = center.device
    t = (center - torch.as_tensor(cam_pos, device=dev)[None, :]) @ view3.T
    tz = t[:, 2]
    limx = float(1.3 * htan_fov[0])
    limy = float(1.3 * htan_fov[1])
    tx = torch.clamp(t[:, 0] / tz, -limx, limx) * tz
    ty = torch.clamp(t[:, 1] / tz, -limy, limy) * tz
    tz2 = tz * tz
    fx, fy = float(focal[0]), float(focal[1])
    J = torch.zeros((s, 3, 3), dtype=F32, device=dev)
    J[:, 0, 0] = torch.full_like(tz, fx) / tz
    J[:, 1, 1] = torch.full_like(tz, fy) / tz
    J[:, 2, 0] = -fx * tx / tz2
    J[:, 2, 1] = -fy * ty / tz2
    T = view3.T[None] @ J
    cov2d = _sandwich(T, Vrk)
    mid_ = 0.5 * (cov2d[:, 0, 0] + cov2d[:, 1, 1])
    half_d = 0.5 * (cov2d[:, 0, 0] - cov2d[:, 1, 1])
    radius = _sqrt(half_d * half_d + cov2d[:, 0, 1] * cov2d[:, 0, 1])
    lambda1 = mid_ + radius
    lambda2 = mid_ - radius
    diag = torch.stack([cov2d[:, 0, 1], lambda1 - cov2d[:, 0, 0]], dim=1)
    sq = diag * diag
    dn = _sqrt(sq[:, 0] + sq[:, 1])[:, None]
    diag = torch.where(dn > 0, diag / torch.where(dn == 0, 1.0, dn), diag)
    major = torch.clamp(_sqrt(2.0 * torch.clamp(lambda1, min=0.0)), max=1024.0)[:, None] * diag
    minor = torch.clamp(_sqrt(2.0 * torch.clamp(lambda2, min=0.0)), max=1024.0)[:, None] \
        * torch.stack([diag[:, 1], -diag[:, 0]], dim=1)
    return lambda2, major, minor


def project(draw, store, scene, cam, hm, hm_wh, stream):
    """vs_main over the stream: valid [S], center_ndc [S,2], z_ndc [S],
    major_px [S,2], minor_px [S,2], color [S,4] (straight, alpha faded)."""
    gs = stream["gs_index"]
    dev = gs.device
    s = gs.shape[0]
    lod_id = stream["lod_id"]
    row = stream["draw_id"]
    valid = torch.ones(s, dtype=torch.bool, device=dev)
    pos = _dev(store["pos"], dev, F32)[gs]

    def per_draw(a, dtype=torch.int64):
        return _dev(a, dev, dtype)[row]

    single = per_draw(draw["single_draw"])
    changing = per_draw(draw["changing"])
    to_lower = per_draw(draw["changing_to_lower"])
    tile_lod = per_draw(draw["tile_lod"])
    valid_lod = per_draw(draw["valid_lod_id"])
    offset = per_draw(draw["offset"], F32)
    valid &= ~((valid_lod >= 0) & (valid_lod != lod_id))
    half = scene["map_half_wh"]
    cc = scene["center_coord"]
    map_h = 2 * half[1] + 1
    mid = stream["map_id"]
    off_merged = torch.stack([
        (mid // map_h - half[0] + cc[0]).to(F64) * scene["tile_width"],
        (mid % map_h - half[1] + cc[1]).to(F64) * scene["tile_width"],
        torch.zeros(s, dtype=F64, device=dev)], dim=1).to(F32)
    offset = torch.where(single[:, None] == 1, off_merged, offset)
    center = pos + offset
    if scene["surface_type"] == 1:
        mapped, transform = height_surface(scene, hm, hm_wh, center[:, :2])
        zero = torch.zeros(s, dtype=F32, device=dev)
        center = mapped + torch.einsum(
            "nij,nj->ni", transform, torch.stack([zero, zero, center[:, 2]], dim=1))
    else:
        transform = None
    cam_pos = _dev(cam["cam_pos"], dev, F32)
    cam_dist = _norm3(center - cam_pos[None, :])
    trans = torch.zeros(16, dtype=F32, device=dev)
    td = torch.as_tensor(np.asarray(scene["transition_dist"], np.float32))[:16]
    trans[:td.shape[0]] = td.to(dev)
    num_lod = scene["num_lod"]
    hl_single = torch.where(
        lod_id == 0, 0,
        torch.where(lod_id == num_lod - 1, lod_id - 1,
                    torch.where((cam_dist - trans[torch.clamp(lod_id - 1, 0, 15)])
                                < (trans[torch.clamp(lod_id, 0, 15)] - cam_dist),
                                lod_id - 1, lod_id)))
    hl_tile = torch.where(to_lower == 1, tile_lod, tile_lod - 1)
    higher_lod = torch.clamp(torch.where(single == 1, hl_single, hl_tile), 0, 15)
    t_dist = trans[higher_lod]
    half_w = scene["transition_width_ratio"] * t_dist
    t_ratio = torch.clamp((cam_dist - t_dist) / half_w + 0.5, 0.0, 1.0)
    t_ratio = torch.nan_to_num(t_ratio, nan=1.0, posinf=1.0, neginf=0.0)
    is_changing = changing == 1
    discard_lo = (lod_id == higher_lod + 1) & (t_ratio == 0.0)
    discard_hi = (lod_id == higher_lod) & (t_ratio == 1.0)
    valid &= ~(is_changing & (discard_lo | discard_hi))
    amul = torch.where(lod_id != higher_lod, t_ratio, 1.0 - t_ratio)
    alpha_mul = torch.where(is_changing, amul, 1.0).to(F32)

    view = _dev(cam["view"], dev, F32)
    proj = _dev(OPENGL_TO_WGPU, dev, F32) @ _dev(cam["projection"], dev, F32)
    cam4 = torch.cat([center, torch.ones((s, 1), dtype=F32, device=dev)], dim=1) @ view.T
    pos2d = cam4 @ proj.T
    clip = 1.2 * pos2d[:, 3]
    valid &= ~((pos2d[:, 2] < -clip) | (pos2d[:, 0] < -clip) | (pos2d[:, 0] > clip)
               | (pos2d[:, 1] < -clip) | (pos2d[:, 1] > clip))
    cov6 = _dev(store["cov"], dev, F32)[gs]
    a, b, c, dd, e, f = (cov6[:, i] for i in range(6))
    Vrk = torch.stack([torch.stack([a, b, c], dim=1), torch.stack([b, dd, e], dim=1),
                       torch.stack([c, e, f], dim=1)], dim=1)
    if transform is not None:
        Vrk = _sandwich(transform.transpose(1, 2), Vrk)
    lambda2, major, minor = ewa_project_cov(
        Vrk, center, view[:3, :3], cam["cam_pos"], cam["focal"], cam["htan_fov"])
    valid &= ~(lambda2 < 0.0)
    color = _dev(store["rgba"], dev, F32)[gs] / 255.0
    color[:, 3] = color[:, 3] * alpha_mul
    fade = torch.clamp(pos2d[:, 2] / pos2d[:, 3] + 1.0, 0.0, 1.0)
    color = color * fade[:, None]
    center_ndc = pos2d[:, :2] / pos2d[:, 3:4]
    valid &= torch.isfinite(center_ndc).all(dim=1)
    valid &= torch.isfinite(major).all(dim=1) & torch.isfinite(minor).all(dim=1)
    return dict(valid=valid, center_ndc=center_ndc.to(F32),
                z_ndc=(pos2d[:, 2] / pos2d[:, 3]).to(F32),
                major_px=major.to(F32), minor_px=minor.to(F32), color=color.to(F32))
