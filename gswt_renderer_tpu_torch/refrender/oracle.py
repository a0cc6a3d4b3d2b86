"""Golden renderer on torch tensors: an exact, slow transcription of the
reference's render path (gswt.wgsl vertex/fragment math + renderer.rs draw
loop + premultiplied back-to-front blending, renderer.rs:118-129).

This is the parity oracle of the PyTorch port: a literal transcription of
the reference's per-splat math, independent of the pipeline's own
(``ops/project.py``, ``ops/binning.py`` and ``ops/raster.py`` are not used),
that runs on the card as well as on the CPU. WGSL column-major matrices
become math-layout matrices. The JAX package's ``refrender/oracle.py`` is
the NumPy form of the same transcription; every function here keeps its
name (the ``_np`` names are aliases) and its dtypes: where NumPy promotes a
float32 array to float64 (against an int64 array, a float64 array or
``np.zeros``/``np.ones``), the same step runs in float64 here and is cast
back where NumPy casts.

Rasterization model (verified against the wgpu pipeline semantics):
- a splat renders a +/-2 quad in "quad space" (renderer.rs:196-216); the
  fragment's quad coords (x, y) interpolate linearly; coverage is
  x^2 + y^2 <= 4 (the A < -4 discard, gswt.wgsl:427-430; the circle of
  radius 2 is inscribed in the quad so the quad bound never binds);
- fragment color = (exp(A) * a * rgb, exp(A) * a) premultiplied, blended
  ONE / ONE_MINUS_SRC_ALPHA back-to-front (renderer.rs:118-129);
- depth test Less against the proxy/cleared depth buffer, no depth write
  (renderer.rs:179-185); splat depth is constant across its quad;
- fragments with clip z outside [0, 1] are clipped (w == 1 always here).

Every function takes tensors on one device, or a ``device`` (default
``"cuda"``, resolved by ``ops.kernels.resolve_device``: no quiet fallback to
the CPU). ``render_oracle`` reads the projected table to the host once and
composites each splat's pixel box on the device, one splat at a time in
stream order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.mathutil import OPENGL_TO_WGPU
from ..ops.kernels import resolve_device
from ..render.uniforms import FrameInputs

F32 = torch.float32
F64 = torch.float64


def _dev(a, device, dtype=None):
    """A host array as a tensor on the device, in its own dtype or `dtype`."""
    t = torch.as_tensor(np.asarray(a))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def _sandwich(tt, m):
    """out[n,i,l] = sum over j, then k, of (tt[n,j,i] * m[n,j,k]) *
    tt[n,k,l], accumulated from zero: np.einsum's own order for its
    three-operand products ("nji,njk,nkl->nil")."""
    out = torch.zeros_like(m)
    for j in range(3):
        for k in range(3):
            out = out + (tt[:, j, :, None] * m[:, j, k, None, None]) * tt[:, k, None, :]
    return out


def _sqrt(x):
    """The correctly rounded square root, as NumPy's: PyTorch's vectorized
    float32 sqrt on the CPU can be an ulp off, so a float32 root is taken
    in float64 and rounded once."""
    return torch.sqrt(x.to(F64)).to(x.dtype) if x.dtype == F32 else torch.sqrt(x)


def _norm3(v):
    """np.linalg.norm(v, axis=1) of an [N,3] array: sqrt of the sum of
    squares, summed left to right in the array's dtype."""
    s = v * v
    return _sqrt(s[:, 0] + s[:, 1] + s[:, 2])


# --------------------------------------------------------------------- #
# height-map sampling as the shader does it: wrap + bilinear
# (gswt.wgsl:576-583; AddressMode::Repeat + FilterMode::Linear,
#  renderer.rs:376-388)
# --------------------------------------------------------------------- #
def sample_height(height_map, wh, u, v):
    """height_map: flat [h*w] tensor; u, v: tensors on its device."""
    w, h = int(wh[0]), int(wh[1])
    # WebGPU 'repeat' addressing: uv wraps into [0,1)
    x = u * w - 0.5
    y = v * h - 0.5
    fx = torch.floor(x)
    fy = torch.floor(y)
    x0 = fx.to(torch.int64)
    y0 = fy.to(torch.int64)
    # NumPy takes x - x0 in float64 and rounds it to float32; the fraction
    # of a float32 is exact in float32, so this is the same value
    tx = (x - fx).to(F32)
    ty = (y - fy).to(F32)

    def texel(xi, yi):
        # tensor % is Python's (floor) modulo, as NumPy's: negative indices
        # wrap to the far edge
        return height_map[(yi % h) * w + (xi % w)]

    i00 = texel(x0, y0)
    i10 = texel(x0 + 1, y0)
    i01 = texel(x0, y0 + 1)
    i11 = texel(x0 + 1, y0 + 1)
    return (i00 * (1 - tx) + i10 * tx) * (1 - ty) + (i01 * (1 - tx) + i11 * tx) * ty


def _sphere_get_uv(xmax, block_id_x, block_id_y, block_x, block_y):
    """tiles/surface.py sphere_get_uv (wangtile.rs:1411-1451) on tensors;
    xmax = tile_map_wh[0] * tile_width."""
    block_w = xmax / 5.0
    bx, by = block_x, block_y
    u = torch.zeros_like(bx)
    v = torch.zeros_like(bx)

    top = block_id_y == 0.0
    lower_tri = by < bx

    # top block, lower triangle
    m = top & lower_tri
    den = block_w - (bx - by)
    safe = torch.where(den.abs() < 1e-20, 1.0, den)
    u = torch.where(m, torch.where(bx - by == block_w, 0.0,
                                   (by / safe + block_id_x) / 5.0), u)
    v = torch.where(m, (block_w - (bx - by)) / block_w / 3.0, v)
    # top block, upper triangle
    m = top & ~lower_tri
    u = torch.where(m, (bx / block_w + block_id_x) / 5.0
                    + (by - bx) / block_w * 0.1, u)
    v = torch.where(m, (by - bx) / block_w / 3.0 + 1.0 / 3.0, v)
    # bottom block, lower triangle
    m = ~top & lower_tri
    u = torch.where(m, (bx / block_w + block_id_x) / 5.0
                    + (block_w - (bx - by)) / block_w * 0.1, u)
    v = torch.where(m, (block_w - (bx - by)) / block_w / 3.0 + 1.0 / 3.0, v)
    # bottom block, upper triangle
    m = ~top & ~lower_tri
    den = block_w - (by - bx)
    safe = torch.where(den.abs() < 1e-20, 1.0, den)
    u = torch.where(m, torch.where(by - bx == block_w, 0.0,
                                   (bx / safe + block_id_x) / 5.0 + 0.1), u)
    v = torch.where(m, (by - bx) / block_w / 3.0 + 2.0 / 3.0, v)

    u = u + 0.5 * torch.floor(v)
    u = u * 2.0 * math.pi
    v = (v - 0.5) * math.pi
    return torch.stack([u, v], dim=1)


def _sphere_uv_to_pos(uv):
    return torch.stack(
        [
            torch.cos(uv[:, 1]) * torch.cos(uv[:, 0]),
            torch.cos(uv[:, 1]) * torch.sin(uv[:, 0]),
            torch.sin(uv[:, 1]),
        ],
        dim=1,
    ).to(F32)


def surface_mapping_gpu(fi: FrameInputs, pos_xy, map_id, draw_row):
    """gswt.wgsl:565-623 vectorized: returns (mapped_center [N,3],
    transform [N,3,3]). pos_xy [N,2] float32, map_id [N] int64, both on
    the device the outputs are on."""
    sc = fi.scene
    dev = pos_xy.device
    n = pos_xy.shape[0]
    new_pos = torch.cat([pos_xy, torch.zeros((n, 1), dtype=F32, device=dev)],
                        dim=1)
    transform = torch.eye(3, dtype=F32, device=dev).expand(n, 3, 3).clone()
    if sc.surface_type == 1:
        # host scalars as NumPy forms them (a python float times the
        # float32 scale is a float32)
        hx = (2.0 * sc.map_half_wh[0] + 1.0) * sc.tile_width * sc.height_map_scale[0]
        hy = (2.0 * sc.map_half_wh[1] + 1.0) * sc.tile_width * sc.height_map_scale[1]
        hu = (pos_xy[:, 0] + sc.map_half_wh[0] * sc.tile_width) / float(hx)
        hv = (pos_xy[:, 1] + sc.map_half_wh[1] * sc.tile_width) / float(hy)
        dt = 0.001
        hm, wh = _dev(fi.height_map, dev, F32), fi.height_map_wh
        z = float(sc.height_map_scale[2])
        height = sample_height(hm, wh, hu, hv) * z
        h_r = sample_height(hm, wh, hu + dt, hv) * z
        h_l = sample_height(hm, wh, hu - dt, hv) * z
        h_u = sample_height(hm, wh, hu, hv + dt) * z
        h_d = sample_height(hm, wh, hu, hv - dt) * z
        new_pos[:, 2] = height
        one = torch.ones(n, dtype=F32, device=dev)
        zero = torch.zeros(n, dtype=F32, device=dev)
        local_x = torch.stack(
            [one, zero, (h_r - h_l) / float(2.0 * dt * hx)], dim=1)
        local_y = torch.stack(
            [zero, one, (h_u - h_d) / float(2.0 * dt * hy)], dim=1)
        local_z = torch.linalg.cross(local_x, local_y, dim=1)
        local_z = local_z / _norm3(local_z)[:, None]
        transform = torch.stack([local_x, local_y, local_z], dim=2)
    elif sc.surface_type == 2:
        xmax = sc.map_half_wh[0] * 2.0 * sc.tile_width
        ymax = sc.map_half_wh[1] * 2.0 * sc.tile_width
        block_w = xmax / 5.0
        px = pos_xy[:, 0] - (sc.center_coord[0] - sc.map_half_wh[0]) * sc.tile_width
        py = pos_xy[:, 1] - (sc.center_coord[1] - sc.map_half_wh[1]) * sc.tile_width
        if fi.draw.single_draw[draw_row] == 1:
            map_h = 2 * sc.map_half_wh[1]
            mi = map_id // map_h
            mj = map_id % map_h
        else:
            mi = torch.full((n,), int(fi.draw.map_coord[draw_row, 0]),
                            dtype=torch.int64, device=dev)
            mj = torch.full((n,), int(fi.draw.map_coord[draw_row, 1]),
                            dtype=torch.int64, device=dev)
        bidx = (5 * mi // (sc.map_half_wh[0] * 2)).to(F32)
        bidy = (2 * mj // (sc.map_half_wh[1] * 2)).to(F32)
        bx = px - bidx * block_w
        by = py - bidy * block_w
        r = sc.sphere_radius

        def uv(bx_, by_):
            return _sphere_get_uv(xmax, bidx, bidy, bx_, by_)

        local_z = _sphere_uv_to_pos(uv(bx, by))
        new_pos = local_z * r
        dt = 0.001 * ymax
        pr = _sphere_uv_to_pos(uv(bx + dt, by)) * r
        pl = _sphere_uv_to_pos(uv(bx - dt, by)) * r
        pu = _sphere_uv_to_pos(uv(bx, by + dt)) * r
        pd = _sphere_uv_to_pos(uv(bx, by - dt)) * r
        local_x = (pr - pl) / (2.0 * dt)
        local_y = (pu - pd) / (2.0 * dt)
        transform = torch.stack([local_x, local_y, local_z], dim=2).to(F32)
    return new_pos.to(F32), transform.to(F32)


def _rand(co):
    """WGSL rand() hash (gswt.wgsl:502-504). np.modf's fractional part is
    x - trunc(x) (torch.frac); % 1.0 takes it into [0, 1) as NumPy does."""
    return torch.remainder(
        torch.frac(torch.sin(co[..., 0] * 12.9898 + co[..., 1] * 78.233)
                   * 43758.5453), 1.0)


def _random_vec3(seed_xy):
    return torch.stack(
        [
            _rand(seed_xy),
            _rand(seed_xy + 23.45),
            _rand(seed_xy + 67.89),
        ],
        dim=-1,
    )


def assemble_stream(fi: FrameInputs, device="cuda"):
    """Flatten the draw table into per-splat instance streams in draw order
    (the renderer.rs:466-591 loop), applying render-time viewport culling and
    lod_enable filtering. Returns dict of int64 tensors on the device:
    gs_index, map_id, lod_id, draw_id (all [S])."""
    dev = resolve_device(device)
    d = fi.draw
    n = int(d.n_draws)
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    if n == 0:
        return dict(gs_index=empty, map_id=empty, lod_id=empty, draw_id=empty)
    vp = _dev(fi.cam.projection, dev) @ _dev(fi.cam.view, dev)
    # viewport culling for non-merged draws (renderer.rs:471-494), every
    # draw's four corners at once
    corners = _dev(d.corner_pos[:n], dev, F32)                    # [n,4,3]
    hom = torch.cat([corners, torch.ones((n, 4, 1), dtype=F32, device=dev)],
                    dim=2)
    p = hom @ vp.T
    p = p[..., :3] / p[..., 3:4]       # a zero w gives inf/nan, as in NumPy
    px = p[..., 0].abs().amin(dim=1)   # NaN propagates: a NaN culls nothing
    py = p[..., 1].abs().amin(dim=1)
    pz = p[..., 2].amax(dim=1)
    clip = fi.culling_dist
    culled = (pz < -clip) | (px > clip) | (py > clip)
    culled &= (_dev(d.single_draw[:n], dev) == 0) & (_dev(d.has_corners[:n], dev) != 0)
    lod_on = _dev(np.asarray(fi.lod_enable, bool), dev)[
        _dev(d.tile_lod[:n], dev, torch.int64)]
    keep = ~culled & lod_on

    # each draw reads splat_count rows from the merged stream (stream_start
    # >= 0) or from the preloaded (lod, tile, view) table; the two tables
    # are concatenated, the preloaded one after the stream
    n_stream = int(d.stream_gs_index.shape[0]) if d.stream_gs_index is not None else 0
    cnt = _dev(d.splat_count[:n], dev, torch.int64)
    s0 = _dev(d.stream_start[:n], dev, torch.int64)
    poff = _dev(fi.preload_offset, dev, torch.int64)[
        _dev(d.base_lod[:n], dev, torch.int64),
        _dev(d.base_tile[:n], dev, torch.int64),
        _dev(d.base_view[:n], dev, torch.int64)]
    start = torch.where(s0 >= 0, s0, n_stream + poff)
    cnt = torch.where(keep, cnt, 0)
    draw_id = torch.repeat_interleave(torch.arange(n, device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    src = (start[draw_id] + torch.arange(draw_id.shape[0], device=dev)
           - first[draw_id])

    def table(stream_part, preload_part):
        parts = [_dev(preload_part, dev, torch.int64)]
        if n_stream:
            parts.insert(0, _dev(stream_part, dev, torch.int64))
        return torch.cat(parts)[src]

    gs = table(d.stream_gs_index, fi.preload_gs_index)
    lid = table(d.stream_lod_id, fi.preload_gs_lod)
    # map_id is unused when single_draw == 0: zeros for the preloaded rows
    mid = table(d.stream_map_id, np.zeros(fi.preload_gs_index.shape, np.int64))
    return dict(gs_index=gs, map_id=mid, lod_id=lid, draw_id=draw_id)


def ewa_project_cov(Vrk, center, view3, cam_pos, focal, htan_fov):
    """The EWA covariance projection + eigen decomposition
    (gswt.wgsl:207-258), vectorized over splats. Inputs: Vrk [N,3,3]
    world-space covariance (already surface-transformed and
    scene-scaled), center [N,3] world, view3 [3,3], cam_pos [3] (tensors
    on one device, one float dtype), focal (fx, fy), htan_fov (hx, hy)
    (host numbers). Returns (cov2d [N,3,3], lambda1 [N], lambda2 [N],
    major [N,2], minor [N,2]).

    Anchored to WGSL-derived golden constants INDEPENDENT of this module
    (tests/test_wgsl_goldens.py, tests/test_torch_wgsl_goldens.py) — note
    the mat3x3 constructors at gswt.wgsl:228-232 are COLUMN-major, so J_T's
    first column is (fx/tz, 0, -fx*tx/tz^2): the transpose of the classic
    2x3 EWA Jacobian. As in the NumPy form, J is float32 whatever the
    inputs' dtype."""
    s = center.shape[0]
    dev = center.device
    t = (center - torch.as_tensor(cam_pos, device=dev)[None, :]) @ view3.T
    tz = t[:, 2]
    txtz = t[:, 0] / tz
    tytz = t[:, 1] / tz
    # host scalars as NumPy forms them: 1.3 times a float32 is a float32,
    # times a python float a python float
    limx = float(1.3 * htan_fov[0])
    limy = float(1.3 * htan_fov[1])
    tx = torch.clamp(txtz, -limx, limx) * tz
    ty = torch.clamp(tytz, -limy, limy) * tz
    tz2 = tz * tz
    fx, fy = float(focal[0]), float(focal[1])
    # J_T columns (gswt.wgsl:228-232): math matrix J with J[row][col]
    J = torch.zeros((s, 3, 3), dtype=F32, device=dev)
    # a number over a tensor is its reciprocal times the number in PyTorch:
    # divide two tensors, as NumPy does
    J[:, 0, 0] = torch.full_like(tz, fx) / tz
    J[:, 1, 1] = torch.full_like(tz, fy) / tz
    J[:, 2, 0] = -fx * tx / tz2
    J[:, 2, 1] = -fy * ty / tz2
    # T = transpose(view3) * J_T (gswt.wgsl:242)
    ct = torch.promote_types(view3.dtype, F32)
    T = view3.T.to(ct)[None] @ J.to(ct)
    ct = torch.promote_types(ct, Vrk.dtype)
    T = T.to(ct)
    cov2d = _sandwich(T, Vrk.to(ct))

    mid_ = 0.5 * (cov2d[:, 0, 0] + cov2d[:, 1, 1])
    # NumPy's ** 2 is a square (x * x); PyTorch's is a pow
    half_d = 0.5 * (cov2d[:, 0, 0] - cov2d[:, 1, 1])
    radius = _sqrt(half_d * half_d + cov2d[:, 0, 1] * cov2d[:, 0, 1])
    lambda1 = mid_ + radius
    lambda2 = mid_ - radius
    diag = torch.stack([cov2d[:, 0, 1], lambda1 - cov2d[:, 0, 0]], dim=1)
    sq = diag * diag
    dn = _sqrt(sq[:, 0] + sq[:, 1])[:, None]
    diag = torch.where(dn > 0, diag / torch.where(dn == 0, 1.0, dn), diag)
    # clamp propagates NaN, as np.maximum / np.minimum do
    major = torch.clamp(
        _sqrt(2.0 * torch.clamp(lambda1, min=0.0)), max=1024.0
    )[:, None] * diag
    minor = torch.clamp(
        _sqrt(2.0 * torch.clamp(lambda2, min=0.0)), max=1024.0
    )[:, None] * torch.stack([diag[:, 1], -diag[:, 0]], dim=1)
    return cov2d, lambda1, lambda2, major, minor


def blend_fragments(frags, device="cuda"):
    """The fragment shader + ROP blend (gswt.wgsl:424-435 +
    renderer.rs:118-129) for one pixel: frags = [(v_position (2,),
    rgb (3,), alpha)] in FRONT-TO-BACK draw order; the GPU composites
    back-to-front with ONE / ONE_MINUS_SRC_ALPHA. A < -4 discards.
    Returns premultiplied RGBA (4,), float64 as in the NumPy form."""
    dev = resolve_device(device)
    dst = torch.zeros(4, dtype=F64, device=dev)
    for (vp, rgb, a) in reversed(list(frags)):
        v = torch.as_tensor(vp, dtype=F64, device=dev)
        A = -(v[0] * v[0] + v[1] * v[1])
        B = torch.exp(A) * float(a)
        src = torch.cat([B * torch.as_tensor(rgb, dtype=F64, device=dev),
                         B[None]])
        # the discard (gswt.wgsl:427-430) leaves dst as it is
        dst = torch.where(A < -4.0, dst, src + (1.0 - src[3]) * dst)
    return dst


def project_draw(fi: FrameInputs, gs_index, map_id, lod_id, draw_id):
    """The vs_main math (gswt.wgsl:27-422), vectorized over a flat splat
    stream of tensors (as assemble_stream returns them). Returns dict of
    tensors on their device:
      valid [S] bool, center_ndc [S,2], z_ndc [S], major_px [S,2],
      minor_px [S,2], color [S,4] (straight alpha, alpha already faded).
    """
    d = fi.draw
    sc = fi.scene
    cam = fi.cam
    dev = gs_index.device
    s = gs_index.shape[0]
    gs = gs_index.to(torch.int64)
    lod_id = lod_id.to(torch.int64)
    valid = torch.ones(s, dtype=torch.bool, device=dev)

    pos = _dev(fi.pos, dev, F32)[gs]

    # per-instance tile uniforms
    row = draw_id.to(torch.int64)

    def per_draw(a, dtype=torch.int64):
        return _dev(a, dev, dtype)[row]

    single = per_draw(d.single_draw)
    changing = per_draw(d.changing)
    to_lower = per_draw(d.changing_to_lower)
    tile_lod = per_draw(d.tile_lod)
    valid_lod = per_draw(d.valid_lod_id)
    offset = per_draw(d.offset, F32)
    # the DRAW-uniform offset (u_tile.offset): the TileID debug tint is
    # seeded with this, one tint per merged draw (gswt.wgsl:277)
    offset_draw = offset.clone()

    # Early discard: wrong lod id (gswt.wgsl:39-42)
    valid &= ~((valid_lod >= 0) & (valid_lod != lod_id))

    # Offset: merged draws recompute from map_id (gswt.wgsl:52-64); an
    # int64 times a python float is float64 in NumPy, rounded to float32
    map_h = 2 * sc.map_half_wh[1] + (0 if sc.surface_type == 2 else 1)
    mid = map_id.to(torch.int64)
    off_merged = torch.stack(
        [
            (mid // map_h - sc.map_half_wh[0] + sc.center_coord[0]).to(F64) * sc.tile_width,
            (mid % map_h - sc.map_half_wh[1] + sc.center_coord[1]).to(F64) * sc.tile_width,
            torch.zeros(s, dtype=F64, device=dev),
        ],
        dim=1,
    ).to(F32)
    offset = torch.where(single[:, None] == 1, off_merged, offset)
    center = pos + offset
    center = center * _dev(sc.scene_scale, dev, F32)[None, :]

    # Surface mapping (gswt.wgsl:74-82). The shader maps per draw; this
    # vectorization calls it per unique draw row for the sphere path (which
    # reads u_tile.map_coord), and in one batch otherwise.
    mapped_center = torch.cat(
        [center[:, :2], torch.zeros((s, 1), dtype=F32, device=dev)], dim=1)
    if sc.surface_type > 0:
        if sc.surface_type == 2:
            mapped_center = torch.empty((s, 3), dtype=F32, device=dev)
            transform = torch.empty((s, 3, 3), dtype=F32, device=dev)
            for r_ in torch.unique(row).tolist():
                m = row == r_
                mapped_center[m], transform[m] = surface_mapping_gpu(
                    fi, center[m][:, :2], mid[m], int(r_)
                )
        else:
            mapped_center, transform = surface_mapping_gpu(
                fi, center[:, :2], mid, 0
            )
        zero = torch.zeros(s, dtype=F32, device=dev)
        center = mapped_center + torch.einsum(
            "nij,nj->ni", transform, torch.stack([zero, zero, center[:, 2]], dim=1))
    else:
        transform = torch.eye(3, dtype=F32, device=dev).expand(s, 3, 3)

    # z clip (gswt.wgsl:84-87)
    if sc.use_clip:
        valid &= ~(mapped_center[:, 2] < sc.clip_height)

    # LOD transition (gswt.wgsl:89-150)
    cam_pos = _dev(cam.cam_pos, dev, F32)
    cam_dist = _norm3(center - cam_pos[None, :])
    trans = _dev(sc.transition_dist_vec, dev, F32)
    num_lod = sc.num_lod
    # single-draw path: find higher lod from per-splat lod_id
    hl_single = torch.where(
        lod_id == 0,
        0,
        torch.where(
            lod_id == num_lod - 1,
            lod_id - 1,
            torch.where(
                (cam_dist - trans[torch.clamp(lod_id - 1, 0, 15)])
                < (trans[torch.clamp(lod_id, 0, 15)] - cam_dist),
                lod_id - 1,
                lod_id,
            ),
        ),
    )
    hl_tile = torch.where(to_lower == 1, tile_lod, tile_lod - 1)
    higher_lod = torch.where(single == 1, hl_single, hl_tile)
    higher_lod = torch.clamp(higher_lod, 0, 15)
    t_dist = trans[higher_lod]
    half_w = sc.transition_width_ratio * t_dist
    t_ratio = torch.clamp((cam_dist - t_dist) / half_w + 0.5, 0.0, 1.0)
    t_ratio = torch.nan_to_num(t_ratio, nan=1.0, posinf=1.0, neginf=0.0)
    is_changing = changing == 1
    discard_lo = (lod_id == higher_lod + 1) & (t_ratio == 0.0)
    discard_hi = (lod_id == higher_lod) & (t_ratio == 1.0)
    valid &= ~(is_changing & (discard_lo | discard_hi))
    amul = torch.where(lod_id != higher_lod, t_ratio, 1.0 - t_ratio)
    alpha_mul = torch.where(is_changing, amul, 1.0).to(F32)

    # projection (gswt.wgsl:152-167)
    view = _dev(cam.view, dev, F32)
    proj = _dev(OPENGL_TO_WGPU, dev, F32) @ _dev(cam.projection, dev, F32)
    cam4 = torch.cat([center, torch.ones((s, 1), dtype=F32, device=dev)],
                     dim=1) @ view.T
    pos2d = cam4 @ proj.T
    clip = 1.2 * pos2d[:, 3]
    valid &= ~(
        (pos2d[:, 2] < -clip)
        | (pos2d[:, 0] < -clip)
        | (pos2d[:, 0] > clip)
        | (pos2d[:, 1] < -clip)
        | (pos2d[:, 1] > clip)
    )

    # covariance (gswt.wgsl:169-205)
    cov6 = _dev(fi.cov, dev, F32)[gs]
    a, b, c, dd, e, f = (cov6[:, i] for i in range(6))
    Vrk = torch.stack([
        torch.stack([a, b, c], dim=1),
        torch.stack([b, dd, e], dim=1),
        torch.stack([c, e, f], dim=1),
    ], dim=1)
    if sc.point_cloud_radius > 0.0:
        p_r = torch.full((s,), sc.point_cloud_radius, dtype=F32, device=dev)
        if sc.draw_mode > 0:
            p_r = p_r * torch.pow(2.0, tile_lod.to(F64)).to(F32)
        Vrk = torch.diag_embed(torch.stack([p_r, p_r, p_r], dim=1))
    if sc.surface_type > 0:
        # np.einsum("nij,njk,nlk->nil", transform, Vrk, transform)
        Vrk = _sandwich(transform.transpose(1, 2), Vrk)
    ss = _dev(sc.scene_scale, dev, F32)
    Vrk = Vrk * (ss[None, :, None] * ss[None, None, :])

    cov2d, lambda1, lambda2, major, minor = ewa_project_cov(
        Vrk, center, view[:3, :3], cam.cam_pos, cam.focal, cam.htan_fov
    )
    valid &= ~(lambda2 < 0.0)

    # color (gswt.wgsl:260-265)
    rgba = _dev(fi.rgba, dev, F32)[gs] / 255.0
    color = rgba.clone()

    # debug draw modes (gswt.wgsl:267-399)
    dm = sc.draw_mode
    if dm == 1:  # TileID
        gray = torch.clamp((color[:, 0] + color[:, 1] + color[:, 2]) / 0.6,
                           0.0, 1.0)
        dbg = torch.stack([gray, gray, gray, color[:, 3]], dim=1)
        vpos = pos
        margin = 0.05 * sc.tile_width
        tile_id = per_draw(d.tile_id)

        def rgb3(*v):
            return torch.tensor(v, dtype=F32, device=dev)

        red = rgb3(1.0, 0.0, 0.0)
        green = rgb3(0.0, 1.0, 0.13)
        yellow = rgb3(1.0, 0.85, 0.0)
        blue = rgb3(0.0, 0.58, 1.0)
        gray5 = rgb3(0.5, 0.5, 0.5)
        on_sphere = sc.surface_type == 2
        c_a = red if on_sphere else yellow
        c_b = green if on_sphere else blue

        def set_rgb(mask, rgb):
            dbg[:, :3] = torch.where(mask[:, None], rgb, dbg[:, :3])

        in_y_margin = (vpos[:, 1] < margin) | (vpos[:, 1] > sc.tile_width - margin)
        west = vpos[:, 0] < margin
        east = vpos[:, 0] > sc.tile_width - margin
        south = vpos[:, 1] < margin
        north = vpos[:, 1] > sc.tile_width - margin
        set_rgb(west & in_y_margin, gray5)
        set_rgb(west & ~in_y_margin & (tile_id // 8 % 2 == 0), red)
        set_rgb(west & ~in_y_margin & (tile_id // 8 % 2 == 1), green)
        set_rgb(~west & east & in_y_margin, gray5)
        set_rgb(~west & east & ~in_y_margin & (tile_id // 2 % 2 == 0), red)
        set_rgb(~west & east & ~in_y_margin & (tile_id // 2 % 2 == 1), green)
        m = ~west & ~east & south
        set_rgb(m & (tile_id % 2 == 0), c_a)
        set_rgb(m & (tile_id % 2 == 1), c_b)
        m = ~west & ~east & ~south & north
        set_rgb(m & (tile_id // 4 % 2 == 0), c_a)
        set_rgb(m & (tile_id // 4 % 2 == 1), c_b)
        merged = single == 1
        # every row's tint is computed; the merged rows keep theirs
        set_rgb(merged, torch.stack([gray, gray, gray], dim=1)
                * _random_vec3(offset_draw[:, :2]))
        color = dbg
    elif dm == 2:  # TileLOD
        mid_t = (t_ratio > 0.0) & (t_ratio < 1.0)
        lodv = tile_lod.to(F32)
        cx = torch.where(tile_lod < 3, (3.0 - lodv) / 3.0, 0.0)
        cy = torch.where(tile_lod >= 3, (6.0 - lodv) / 3.0, 1.0)
        color = torch.stack(
            [torch.full((s,), 0.5, dtype=F32, device=dev), cx, cy, color[:, 3]],
            dim=1)
        color[:, :3] = torch.where(mid_t[:, None], 0.0, color[:, :3])
        color[:, :3] = torch.where((~mid_t & is_changing)[:, None],
                                   torch.tensor([0.0, 1.0, 0.0], dtype=F32,
                                                device=dev), color[:, :3])
    elif dm == 3:  # LOD
        mid_t = (t_ratio > 0.0) & (t_ratio < 1.0)
        sl = per_draw(d.single_lod_id)
        eff = torch.where(sl >= 0, sl, lod_id).to(F32)
        cx = torch.where(eff < 3, (3.0 - eff) / 3.0, 0.0)
        cy = torch.where(eff >= 3, (6.0 - eff) / 3.0, 1.0)
        color = torch.stack(
            [torch.full((s,), 0.5, dtype=F32, device=dev), cx, cy, color[:, 3]],
            dim=1)
        color[:, :3] = torch.where(mid_t[:, None], 0.0, color[:, :3])
    elif dm == 4:  # View
        vid = per_draw(d.view_id, F32)
        cx = torch.where(vid < 4, (4.0 - vid) / 4.0, 0.0)
        cy = torch.where(vid >= 4, (8.0 - vid) / 4.0, 0.0)
        cx = torch.where(vid >= 8, 1.0, cx)
        cy = torch.where(vid >= 8, 1.0, cy)
        color = torch.stack(
            [torch.full((s,), 0.5, dtype=F32, device=dev), cx, cy, color[:, 3]],
            dim=1)

    # LOD alpha + near-plane fade (gswt.wgsl:401-410)
    color[:, 3] = color[:, 3] * alpha_mul
    fade = torch.clamp(pos2d[:, 2] / pos2d[:, 3] + 1.0, 0.0, 1.0)
    color = color * fade[:, None]

    center_ndc = pos2d[:, :2] / pos2d[:, 3:4]
    z_ndc = pos2d[:, 2] / pos2d[:, 3]

    valid &= torch.isfinite(center_ndc).all(dim=1)
    valid &= torch.isfinite(major).all(dim=1) & torch.isfinite(minor).all(dim=1)

    return dict(
        valid=valid,
        center_ndc=center_ndc.to(F32),
        z_ndc=z_ndc.to(F32),
        major_px=(major * sc.splat_scale).to(F32),
        minor_px=(minor * sc.splat_scale).to(F32),
        color=color.to(F32),
    )


def render_oracle(fi: FrameInputs, width, height, background=None, depth=None,
                  device="cuda"):
    """Full-frame oracle render. background: [H,W,4] or None (black);
    depth: [H,W] proxy depth or None (cleared to 1.0); arrays or tensors.
    Returns float32 [H,W,4] premultiplied RGBA, a tensor on the device.

    The projected table is read to the host once; each splat's pixel box
    (from its float32 centre and extents, as NumPy computes them) is then
    composited on the device in stream order."""
    dev = resolve_device(device)
    stream = assemble_stream(fi, dev)
    p = project_draw(fi, **stream)
    img = (
        torch.zeros((height, width, 4), dtype=F32, device=dev)
        if background is None
        else torch.as_tensor(background, device=dev).to(F32).clone()
    )
    zbuf = (torch.full((height, width), 1.0, dtype=F32, device=dev)
            if depth is None else torch.as_tensor(depth, device=dev))

    # one read: [S, 11] = centre (2), z, major (2), minor (2), colour (4)
    table = torch.cat([p["center_ndc"], p["z_ndc"][:, None], p["major_px"],
                       p["minor_px"], p["color"]], dim=1)
    valid = p["valid"]
    host = torch.cat([table, valid[:, None].to(F32)], dim=1).cpu().numpy()
    order = np.where(host[:, 11] != 0)[0]
    # the straight colour with alpha 1 in its place: src = bfac * (r, g, b, 1)
    # is (bfac r, bfac g, bfac b, bfac), bit for bit
    colw = torch.cat([p["color"][:, :3],
                      torch.ones((table.shape[0], 1), dtype=F32, device=dev)],
                     dim=1)
    # the per-pixel terms that do not depend on the splat, in NumPy's order:
    # dndc_x = px / width * 2 - 1 - c_x, dndc_y = 1 - py / height * 2 - c_y
    gx = (torch.arange(width, dtype=F32, device=dev) + 0.5) / width * 2.0 - 1.0
    gy = 1.0 - (torch.arange(height, dtype=F32, device=dev) + 0.5) / height * 2.0
    for i in order:
        c = host[i, 0:2]
        z = host[i, 2]
        if z < 0.0 or z > 1.0:
            continue
        maj = host[i, 3:5]
        mnr = host[i, 5:7]
        col = host[i, 7:11]
        # pixel-space center; ndc y up -> pixel y down
        cx = (c[0] * 0.5 + 0.5) * width
        cy = (0.5 - c[1] * 0.5) * height
        # pixel offset = ndc_offset * viewport/2 = s*(x*maj + y*minor)/2
        # with |x|,|y| <= 2 -> extent per axis = |maj| + |minor|
        ext = np.abs(maj) + np.abs(mnr)
        x0 = max(int(np.floor(cx - ext[0])), 0)
        x1 = min(int(np.ceil(cx + ext[0])) + 1, width)
        y0 = max(int(np.floor(cy - ext[1])), 0)
        y1 = min(int(np.ceil(cy + ext[1])) + 1, height)
        if x0 >= x1 or y0 >= y1:
            continue
        m2 = maj @ maj
        n2 = mnr @ mnr
        if m2 <= 0 or n2 <= 0:
            continue
        # back to ndc deltas, then solve quad coords:
        # d_ndc*viewport = x*maj + y*minor (orthogonal)
        dx = ((gx[x0:x1] - float(c[0])) * width)[None, :]
        dy = ((gy[y0:y1] - float(c[1])) * height)[:, None]
        qx = (dx * float(maj[0]) + dy * float(maj[1])) / float(m2)
        qy = (dx * float(mnr[0]) + dy * float(mnr[1])) / float(n2)
        a_exp = -(qx * qx + qy * qy)
        # an all-false mask leaves the box as it is: no test on the host
        mask = (a_exp >= -4.0) & (float(z) < zbuf[y0:y1, x0:x1])
        bfac = torch.exp(a_exp) * float(col[3])
        src = bfac[..., None] * colw[i]
        dst = img[y0:y1, x0:x1]
        img[y0:y1, x0:x1] = torch.where(mask[..., None],
                                        src + (1.0 - src[..., 3:4]) * dst, dst)
    return img


# the NumPy form's names
assemble_stream_np = assemble_stream
ewa_project_cov_np = ewa_project_cov
blend_fragments_np = blend_fragments
project_draw_np = project_draw
