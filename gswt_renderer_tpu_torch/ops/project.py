"""Device-side stream assembly + splat projection (torch).

The reference issues one instanced draw per tile with per-instance u32
streams (renderer.rs:466-591) and does all per-splat math in vs_main
(gswt.wgsl:27-422). Here the whole frame's draws flatten into ONE splat
stream. On the card one kernel (csrc/project.cu) reads each lane's splat
where it lies and projects it; on the CPU the plain version assembles the
stream by one panel block-gather (ops/blockgather.py) and runs the vertex
math vectorized over it.
Semantics follow the JAX package's line for line, in the exact profile and
(the height-map path of surface_mapping) the fast one; the NumPy oracle
(refrender/oracle.py of the JAX package) is the test reference.

The stream is assembled directly front-to-back (reversed draw order,
reversed lanes within each draw) so the compositor needs no flips.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from . import kernels
from .blockgather import BLOCK, block_gather

GS_BITS = 26  # gs_index fits 26 bits (<= 67M splats); lod in bits 26..30


def pack_tex4(tex, w, h):
    """Pre-shifted 4-neighborhood texture [4, h*w] (numpy): rows (x,y),
    (x+1,y), (x,y+1), (x+1,y+1) with wrap — each bilinear tap is then ONE
    4-component gather."""
    t = np.asarray(tex, np.float32).reshape(h, w)
    return np.stack(
        [
            t,
            np.roll(t, -1, axis=1),
            np.roll(t, -1, axis=0),
            np.roll(np.roll(t, -1, axis=0), -1, axis=1),
        ],
        axis=0,
    ).reshape(4, h * w)


def _bilinear_wrap4(tex4, w, h, u, v):
    """textureSampleLevel with Repeat addressing + Linear filter
    (gswt.wgsl:576-583) from a pack_tex4 texture: one gather per tap."""
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = x - x0
    ty = y - y0
    base = (y0.long() % h) * w + (x0.long() % w)
    t4 = tex4[:, base]
    i00, i10, i01, i11 = t4[0], t4[1], t4[2], t4[3]
    return (i00 * (1 - tx) + i10 * tx) * (1 - ty) + (i01 * (1 - tx) + i11 * tx) * ty


def _sphere_get_uv(scene, block_id_x, block_id_y, bx, by):
    """gswt.wgsl:515-553."""
    xmax = scene["map_half_wh"][0].float() * 2.0 * scene["tile_width"]
    block_w = xmax / 5.0
    top = block_id_y == 0.0
    lower = by < bx
    den1 = block_w - (bx - by)
    den2 = block_w - (by - bx)
    safe1 = torch.where(torch.abs(den1) < 1e-20, 1.0, den1)
    safe2 = torch.where(torch.abs(den2) < 1e-20, 1.0, den2)

    u_tl = torch.where(bx - by == block_w, 0.0, (by / safe1 + block_id_x) / 5.0)
    v_tl = den1 / block_w / 3.0
    u_tu = (bx / block_w + block_id_x) / 5.0 + (by - bx) / block_w * 0.1
    v_tu = (by - bx) / block_w / 3.0 + 1.0 / 3.0
    u_bl = (bx / block_w + block_id_x) / 5.0 + den1 / block_w * 0.1
    v_bl = den1 / block_w / 3.0 + 1.0 / 3.0
    u_bu = torch.where(by - bx == block_w, 0.0,
                       (bx / safe2 + block_id_x) / 5.0 + 0.1)
    v_bu = (by - bx) / block_w / 3.0 + 2.0 / 3.0

    u = torch.where(top, torch.where(lower, u_tl, u_tu),
                    torch.where(lower, u_bl, u_bu))
    v = torch.where(top, torch.where(lower, v_tl, v_tu),
                    torch.where(lower, v_bl, v_bu))
    u = (u + 0.5 * torch.floor(v)) * (2.0 * math.pi)
    v = (v - 0.5) * math.pi
    return u, v


def _sphere_uv_to_pos(u, v):
    return (torch.cos(v) * torch.cos(u), torch.cos(v) * torch.sin(u),
            torch.sin(v))


def _smallmap_resized_bilinear(hm_src, hu, hv, reso_w, reso_h):
    """Bilinear sample of the bicubic-RESIZED height map, computed from the
    small [H, W] source map instead of the resized texture.

    The reference resizes the source to reso^2 by sampling its Catmull-Rom
    surface B at the grid points k/reso (wangtile.rs:1333-1349) and then
    fetches that texture bilinearly (gswt.wgsl:569-574). Bilinear weights
    are separable and B is bilinear in its weight vectors, so the sample is
    the lerp, in x then y, of B at the four surrounding resize-grid points:
    snap to the grid, take the four wrapped cubic taps per axis of the
    source map at each snapped coordinate, and lerp. Also returns the
    analytic derivatives of that bilinear patch in resized-texel units (the
    fast profile's gradient, PARITY.md #8)."""
    h_n, w_n = hm_src.shape

    def taps(u_grid, n):
        # wrapped Catmull-Rom taps of the source surface at uv u_grid
        x = u_grid * n - 0.5
        x0 = torch.floor(x)
        t = x - x0
        w = (((-0.5 * t + 1.0) * t - 0.5) * t,
             ((1.5 * t - 2.5) * t) * t + 1.0,
             ((-1.5 * t + 2.0) * t + 0.5) * t,
             ((0.5 * t - 0.5) * t) * t)
        x0i = x0.long()
        return [(x0i + (i - 1)) % n for i in range(4)], w

    def snap(u, reso):
        x = u * reso - 0.5
        x0 = torch.floor(x)
        return x0 / reso, (x0 + 1.0) / reso, x - x0

    def along_x(u_grid):  # [H, S]: every source row at column coordinate u
        pos, w = taps(u_grid, w_n)
        return sum(hm_src[:, pos[i]] * w[i] for i in range(4))

    def along_y(v_grid, cols):  # [S]: the [H, S] columns at row coordinate v
        pos, w = taps(v_grid, h_n)
        return sum(cols.gather(0, pos[i][None])[0] * w[i] for i in range(4))

    u0, u1, tx = snap(hu, reso_w)
    v0, v1, ty = snap(hv, reso_h)
    t0 = along_x(u0)
    dtx = along_x(u1) - t0
    tmp = t0 + tx * dtx                          # lerp in x -> [H, S]
    r0 = along_y(v0, tmp)
    dhdy = along_y(v1, tmp) - r0                 # per resized texel
    height = r0 + ty * dhdy
    d0 = along_y(v0, dtx)
    dhdx = d0 + ty * (along_y(v1, dtx) - d0)
    return height, dhdx, dhdy


def surface_mapping(scene, hm4, hm_wh, px, py, map_id, single,
                    mc_x, mc_y, surface_type: int, exact: bool = True,
                    hm_src=None):
    """gswt.wgsl:565-623, componentized. Returns (mx, my, mz) mapped
    surface point and the local frame as 9 [S] arrays in order
    (lx_x, lx_y, lx_z, ly_x, ly_y, ly_z, lz_x, lz_y, lz_z).

    exact=False (the fast profile, PARITY.md #8) takes the height-map
    gradient analytically from the bilinear patch of the height tap's own
    four texels, and, given hm_src (the small source map the height map was
    resized from; a [1, 1] tensor means none), height and gradient from
    _smallmap_resized_bilinear."""
    ones = torch.ones_like(px)
    zeros = torch.zeros_like(px)
    if surface_type == 0:
        return (px, py, zeros), (ones, zeros, zeros, zeros, ones, zeros,
                                 zeros, zeros, ones)
    if surface_type == 1:
        half = scene["map_half_wh"].float()
        tw = scene["tile_width"]
        hms = scene["height_map_scale"]
        hx = (2.0 * half[0] + 1.0) * tw * hms[0]
        hy = (2.0 * half[1] + 1.0) * tw * hms[1]
        hu = (px + half[0] * tw) / hx
        hv = (py + half[1] * tw) / hy
        w, h = int(hm_wh[0]), int(hm_wh[1])
        z = hms[2]
        if exact:
            # reference gradient: central differences of the bilinear
            # interpolant at +-0.001 uv (gswt.wgsl:569-574) — 5 taps
            dt = 0.001
            height = _bilinear_wrap4(hm4, w, h, hu, hv) * z
            h_r = _bilinear_wrap4(hm4, w, h, hu + dt, hv) * z
            h_l = _bilinear_wrap4(hm4, w, h, hu - dt, hv) * z
            h_u = _bilinear_wrap4(hm4, w, h, hu, hv + dt) * z
            h_d = _bilinear_wrap4(hm4, w, h, hu, hv - dt) * z
            gx = (h_r - h_l) / (2.0 * dt * hx)  # local_x = (1, 0, gx)
            gy = (h_u - h_d) / (2.0 * dt * hy)  # local_y = (0, 1, gy)
        else:
            if hm_src is not None and tuple(hm_src.shape) != (1, 1):
                height, dhdx, dhdy = _smallmap_resized_bilinear(
                    hm_src, hu, hv, w, h)
            else:
                # the reference's +-0.001-uv central difference spans ~1
                # texel of the upsampled map: a smoothed version of this
                # per-patch derivative
                x = hu * w - 0.5
                y = hv * h - 0.5
                x0 = torch.floor(x)
                y0 = torch.floor(y)
                tx = x - x0
                ty = y - y0
                t4 = hm4[:, (y0.long() % h) * w + (x0.long() % w)]
                i00, i10, i01, i11 = t4[0], t4[1], t4[2], t4[3]
                height = ((i00 * (1 - tx) + i10 * tx) * (1 - ty)
                          + (i01 * (1 - tx) + i11 * tx) * ty)
                dhdx = (i10 - i00) * (1 - ty) + (i11 - i01) * ty
                dhdy = (i01 - i00) * (1 - tx) + (i11 - i10) * tx
            height = height * z
            gx = dhdx * z * w / hx
            gy = dhdy * z * h / hy
        n = torch.sqrt(gx * gx + gy * gy + 1.0)
        return (px, py, height), (
            ones, zeros, gx,
            zeros, ones, gy,
            -gx / n, -gy / n, 1.0 / n,
        )
    # sphere (gswt.wgsl:590-623)
    half = scene["map_half_wh"].float()
    tw = scene["tile_width"]
    cc = scene["center_coord"].float()
    ymax = half[1] * 2.0 * tw
    block_w = half[0] * 2.0 * tw / 5.0
    wx = px - (cc[0] - half[0]) * tw
    wy = py - (cc[1] - half[1]) * tw
    map_h = 2 * scene["map_half_wh"][1]
    mi_s = torch.div(map_id, map_h, rounding_mode="floor")
    mj_s = map_id % map_h
    mi = torch.where(single == 1, mi_s, mc_x)
    mj = torch.where(single == 1, mj_s, mc_y)
    bidx = torch.div(5 * mi, 2 * scene["map_half_wh"][0],
                     rounding_mode="floor").float()
    bidy = torch.div(2 * mj, 2 * scene["map_half_wh"][1],
                     rounding_mode="floor").float()
    bx = wx - bidx * block_w
    by = wy - bidy * block_w
    r = scene["sphere_radius"]
    u, v = _sphere_get_uv(scene, bidx, bidy, bx, by)
    lzx, lzy, lzz = _sphere_uv_to_pos(u, v)
    dt = 0.001 * ymax

    def at(dbx, dby):
        uu, vv = _sphere_get_uv(scene, bidx, bidy, bx + dbx, by + dby)
        return _sphere_uv_to_pos(uu, vv)

    prx, pry, prz = at(dt, 0.0)
    plx, ply, plz = at(-dt, 0.0)
    pux, puy, puz = at(0.0, dt)
    pdx, pdy, pdz = at(0.0, -dt)
    sc = r / (2.0 * dt)
    return (lzx * r, lzy * r, lzz * r), (
        (prx - plx) * sc, (pry - ply) * sc, (prz - plz) * sc,
        (pux - pdx) * sc, (puy - pdy) * sc, (puz - pdz) * sc,
        lzx, lzy, lzz,
    )


def cull_draws(draw, cam, culling_dist, lod_enable):
    """Render-time per-draw viewport culling + lod filter
    (renderer.rs:466-497). Returns keep mask [D]."""
    vp = cam["view_proj"]  # math view_proj (no wgpu remap), renderer.rs:464
    corners = draw["corner_pos"]  # [D,4,3]
    hom = torch.cat([corners, torch.ones_like(corners[..., :1])], dim=-1)
    p = torch.einsum("rc,dkc->dkr", vp, hom)
    pw = p[..., 3]
    pdiv = p[..., :3] / pw[..., None]
    px = torch.amin(torch.abs(pdiv[..., 0]), dim=1)
    py = torch.amin(torch.abs(pdiv[..., 1]), dim=1)
    pz = torch.amax(pdiv[..., 2], dim=1)
    culled = (pz < -culling_dist) | (px > culling_dist) | (py > culling_dist)
    culled &= (draw["single_draw"] == 0) & (draw["has_corners"] == 1)
    keep = ~culled
    lod = torch.clamp(draw["tile_lod"], 0, lod_enable.shape[0] - 1).long()
    keep &= lod_enable[lod] != 0
    keep &= torch.arange(keep.shape[0], device=keep.device) < draw["n_draws"]
    return keep


def pack_draw_bits(single, changing, to_lower, tile_lod, valid_lod, view_id,
                   tile_id, map_index, single_lod, keep=1):
    """Per-draw uniform bit packing (numpy on the host). The per-draw tile
    offset is NOT stored: it always equals coord_to_pos(map_to_coord(
    map_coord)) and is recomputed per splat from map_index (wangtile.rs:
    1705,1734). to_lower/valid_lod/single_lod are stored +1 (so -1 becomes
    0)."""
    bits1 = (
        single
        | (changing << 1)
        | ((to_lower + 1) << 2)
        | (tile_lod << 4)
        | ((valid_lod + 1) << 9)
        | (view_id << 14)
        | (tile_id << 18)
        | (keep << 28)
    )
    bits2 = map_index | ((single_lod + 1) << 22)
    return bits1, bits2


def merged_scratch(merged, store_packed, rows: int):
    """The per-sort merged scratch [rows, M]: merged streams exist only as
    store indices (merged [2, M] i32: packed gs|lod<<26, map id), so one
    element gather of the store rows, then the packed index and map id as
    raw bits in rows 10 and 11 (rows 12+ pad, render/pipeline.py
    PANEL_ROWS)."""
    mp = merged[0]
    srows = store_packed[:, (mp & ((1 << GS_BITS) - 1)).long()]  # [10, M]
    return torch.cat(
        [srows, mp.view(torch.float32)[None], merged[1].view(torch.float32)[None],
         srows.new_zeros((rows - 12, mp.shape[0]))],
        dim=0,
    ).contiguous()


class UniformField(NamedTuple):
    """One field of the frame's uniform block: its dict in unpack's result
    ("cam", "scene" or "frame"), its name, its first word, its shape (() for
    a scalar) and the dtype unpack gives it."""
    group: str
    name: str
    word: int
    shape: tuple
    dtype: torch.dtype

    @property
    def words(self) -> int:
        return math.prod(self.shape)


# The frame's uniform block, [UNIFORMS_LEN] f32, in the JAX package's layout
# (its render/pipeline.py pack_frame_uniforms): the one statement of its
# offsets. render/pipeline.py pack_frame_uniforms writes it through
# pack_uniform_block, unpack_uniform_block reads it, and csrc/project.cu
# reads the words _UNIFORM_WORDS gives it. An int field travels as an
# integral f32 word.
_F32, _I32 = torch.float32, torch.int32
UNIFORMS = tuple(UniformField(*f) for f in (
    ("cam", "view", 0, (4, 4), _F32),
    ("cam", "proj_wgpu", 16, (4, 4), _F32),
    ("cam", "view_proj", 32, (4, 4), _F32),
    ("cam", "focal", 48, (2,), _F32),
    ("cam", "htan_fov", 50, (2,), _F32),
    ("cam", "cam_pos", 52, (3,), _F32),
    ("scene", "splat_scale", 55, (), _F32),
    ("scene", "tile_width", 56, (), _F32),
    ("scene", "use_clip", 57, (), _I32),
    ("scene", "clip_height", 58, (), _F32),
    ("scene", "sphere_radius", 59, (), _F32),
    ("scene", "point_cloud_radius", 60, (), _F32),
    ("scene", "transition_width_ratio", 61, (), _F32),
    ("scene", "num_lod", 62, (), _I32),
    ("scene", "map_half_wh", 63, (2,), _I32),
    ("scene", "center_coord", 65, (2,), _I32),
    ("scene", "transition_dist_vec", 67, (16,), _F32),
    ("scene", "height_map_scale", 83, (3,), _F32),
    ("scene", "scene_scale", 86, (3,), _F32),
    ("frame", "lod_enable", 89, (16,), _I32),
    ("frame", "culling_dist", 105, (), _F32),
    ("frame", "gs_enable", 106, (), _I32),
))
UNIFORMS_LEN = 112
# each field with its index into the block: its word for a scalar, else a
# slice (pack and unpack run every frame, so one indexing op a field)
_AT = tuple((f, f.word if not f.shape else slice(f.word, f.word + f.words))
            for f in UNIFORMS)


def pack_uniform_block(values) -> np.ndarray:
    """The uniform block [UNIFORMS_LEN] f32 holding values[name] (array-like
    of the field's shape) at each field of UNIFORMS; every other word 0."""
    v = np.zeros(UNIFORMS_LEN, np.float32)
    for f, at in _AT:
        x = values[f.name]
        v[at] = np.ravel(x) if len(f.shape) > 1 else x
    return v


def unpack_uniform_block(v):
    """(scene, cam, lod_enable, culling_dist, gs_enable) of a uniform block
    tensor v: the scene and cam dicts keyed by field name, every field a
    view of v in its shape, an int field a view of one int32 copy of v (the
    truncation of its integral word)."""
    vi = v.to(_I32)
    out = dict(cam={}, scene={}, frame={})
    for f, at in _AT:
        t = (vi if f.dtype == _I32 else v)[at]
        out[f.group][f.name] = t.view(f.shape) if len(f.shape) > 1 else t
    fr = out["frame"]
    return (out["scene"], out["cam"], fr["lod_enable"], fr["culling_dist"],
            fr["gs_enable"])


class _UniformWords(ctypes.Structure):
    """csrc/project.cu's UniformWords: the first word of each field the
    kernel reads."""
    _fields_ = [(n, ctypes.c_int) for n in (
        "view", "proj_wgpu", "focal", "htan_fov", "cam_pos", "splat_scale",
        "tile_width", "use_clip", "clip_height", "sphere_radius",
        "point_cloud_radius", "transition_width_ratio", "num_lod",
        "map_half_wh", "center_coord", "transition_dist_vec",
        "height_map_scale", "scene_scale", "gs_enable")]


_WORD = {f.name: f.word for f in UNIFORMS}
_UNIFORM_WORDS = _UniformWords(*(_WORD[n] for n, _ in _UniformWords._fields_))


class _ProjectArgs(ctypes.Structure):
    """csrc/project.cu's ProjectArgs."""
    _fields_ = [
        ("blocks", ctypes.c_void_p), ("nb", ctypes.c_longlong),
        ("merged", ctypes.c_void_p), ("merged_cols", ctypes.c_longlong),
        ("panels", ctypes.c_void_p), ("panel_cols", ctypes.c_longlong),
        ("store", ctypes.c_void_p), ("store_cols", ctypes.c_longlong),
        ("keep_draw", ctypes.c_void_p), ("n_draws", ctypes.c_longlong),
        ("hm4", ctypes.c_void_p), ("hm_src", ctypes.c_void_p),
        ("uniforms", ctypes.c_void_p), ("words", _UniformWords),
        ("out", ctypes.c_void_p), ("valid", ctypes.c_void_p),
        ("n_uniforms", ctypes.c_int),
        ("plan_rows", ctypes.c_int), ("hm_w", ctypes.c_int),
        ("hm_h", ctypes.c_int), ("src_w", ctypes.c_int),
        ("src_h", ctypes.c_int), ("draw_mode", ctypes.c_int),
        ("point_cloud", ctypes.c_int), ("img_w", ctypes.c_int),
        ("img_h", ctypes.c_int),
    ]


# the kernel's output rows (csrc/project.cu Row): binning's stacking order
ROWS = ("cx", "cy", "qa", "qb", "qc", "z", "r", "g", "b", "a", "ext_x",
        "ext_y")


def _checked(t, dtype, dev, name, numel=None):
    """t itself, after checking that it is a contiguous `dtype` tensor on
    dev (of `numel` values when given): the kernel reads it in place."""
    if (not torch.is_tensor(t) or t.dtype != dtype or t.device != dev
            or not t.is_contiguous()
            or (numel is not None and t.numel() != numel)):
        raise ValueError(f"{name} must be a contiguous {dtype} tensor on {dev}"
                         + ("" if numel is None else f" of {numel} values"))
    return t


def assemble_and_project(blocks, merged, panels, keep_draw, store_packed,
                         uniforms, hm4, hm_wh, *, surface_type: int,
                         draw_mode: int, image_wh,
                         point_cloud: bool = False, exact: bool = True,
                         hm_src=None):
    """Assemble the front-to-back splat stream from 256-wide panels and
    project it (vs_main math, gswt.wgsl:27-422); arguments and outputs as
    assemble_and_project_plain, but the scene, camera and gs_enable come as
    the frame's packed uniform block ([UNIFORMS_LEN] f32). CPU tensors
    unpack it and take the plain version; CUDA tensors launch the one
    kernel of csrc/project.cu, which reads the block whole, and whose
    outputs are row views of one [12, S] tensor (ROWS) and which writes
    zeros on every lane that is not valid."""
    if not blocks.is_cuda:
        scene, cam, _, _, gs_enable = unpack_uniform_block(uniforms)
        return assemble_and_project_plain(
            blocks, merged, panels, keep_draw, store_packed, scene, cam, hm4,
            hm_wh, surface_type=surface_type, draw_mode=draw_mode,
            image_wh=image_wh, point_cloud=point_cloud, gs_enable=gs_enable,
            exact=exact, hm_src=hm_src)
    dev = blocks.device
    _checked(blocks, torch.int32, dev, "blocks")
    rows, nb = blocks.shape
    if rows not in (5, 6):
        raise ValueError("blocks must be a [5 or 6, NB] plan")
    _checked(merged, torch.int32, dev, "merged")
    if merged.dim() != 2 or merged.shape[0] != 2:
        raise ValueError("merged must be [2, M]")
    for name, t, r in (("panels", panels, 12), ("store_packed", store_packed, 10)):
        _checked(t, torch.float32, dev, name)
        if t.dim() != 2 or t.shape[0] < r:
            raise ValueError(f"{name} must be [>= {r}, N]")
    if panels.shape[1] % BLOCK:
        raise ValueError(f"panels' width must be a multiple of {BLOCK}")
    _checked(keep_draw, torch.bool, dev, "keep_draw")
    _checked(uniforms, torch.float32, dev, "uniforms", UNIFORMS_LEN)
    surface_type, draw_mode = int(surface_type), int(draw_mode)
    if surface_type not in (0, 1, 2) or draw_mode not in range(5):
        raise ValueError(f"surface_type {surface_type} or draw_mode "
                         f"{draw_mode} unknown")
    w, h = int(hm_wh[0]), int(hm_wh[1])
    _checked(hm4, torch.float32, dev, "hm4", 4 * w * h)
    height_path, src_h, src_w = 0, 1, 1
    if surface_type == 1 and not exact:
        height_path = 1
        if hm_src is not None and tuple(hm_src.shape) != (1, 1):
            height_path = 2
            _checked(hm_src, torch.float32, dev, "hm_src")
            src_h, src_w = hm_src.shape

    s = nb * BLOCK
    out = torch.empty((len(ROWS), s), dtype=torch.float32, device=dev)
    valid = torch.empty(s, dtype=torch.bool, device=dev)
    if nb:
        args = _ProjectArgs(
            blocks.data_ptr(), nb, merged.data_ptr(), merged.shape[1],
            panels.data_ptr(), panels.shape[1], store_packed.data_ptr(),
            store_packed.shape[1], keep_draw.data_ptr(), keep_draw.numel(),
            hm4.data_ptr(), hm_src.data_ptr() if height_path == 2 else None,
            uniforms.data_ptr(), _UNIFORM_WORDS, out.data_ptr(),
            valid.data_ptr(), UNIFORMS_LEN, rows, w, h, src_w, src_h,
            draw_mode, int(bool(point_cloud)), int(image_wh[0]),
            int(image_wh[1]))
        lib = kernels.load("project", gswt_project=[
            ctypes.POINTER(_ProjectArgs), ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p])
        rc = lib.gswt_project(ctypes.byref(args), surface_type, height_path,
                              kernels.stream_ptr(out))
        kernels.LAUNCHES["project"] += 1
        kernels.check(rc, "project")
    o = dict(zip(ROWS, out))
    return dict(valid=valid, cx=o["cx"], cy=o["cy"], z=o["z"],
                q=(o["qa"], o["qb"], o["qc"]),
                color=(o["r"], o["g"], o["b"], o["a"]),
                ext_x=o["ext_x"], ext_y=o["ext_y"])


def assemble_and_project_plain(blocks, merged, panels, keep_draw,
                               store_packed, scene, cam, hm4, hm_wh, *,
                               surface_type: int, draw_mode: int, image_wh,
                               point_cloud: bool = False, gs_enable=None,
                               exact: bool = True, hm_src=None):
    """Assemble the front-to-back splat stream from 256-wide panels and
    project it (vs_main math, gswt.wgsl:27-422), in plain PyTorch: the CPU
    path and the kernel's oracle. exact and hm_src select the height-map
    path of surface_mapping; nothing else depends on them.

    The stream is a sequence of per-draw segments; every segment is a
    256-aligned contiguous slice of either `panels` (the materialized
    reversed presort tables, rows: pos xyz, cov 6, rgba u32, packed
    gs|lod<<26, map id) or the per-sort merged scratch built here from
    `merged`. Assembly is ONE panel block-gather reading both in place.

    blocks: [5, NB] or [6, NB] i32 host-staged plan, rows:
      0 src    — panel id into [panels | merged scratch]
      1 bits1  — per-draw uniform bits (pack_draw_bits); bit 28 set iff live
      2 bits2
      3 nvalid — live lanes in this block (0 for padding)
      4 draw   — draw id (indexes keep_draw)
      5 lo     — optional: first live lane; the stream split of
                 parallel/batched.py cuts a block between two segments with
                 it (a 5-row plan has lo = 0)
    Returns dict: valid [S], cx/cy/z [S], q (3 comps), color (4 comps),
    ext_x/ext_y [S]  (S = NB*256).
    """
    nb = blocks.shape[1]
    s = nb * BLOCK

    scratch = merged_scratch(merged, store_packed, panels.shape[0])
    params = block_gather(panels, blocks[0].contiguous(), scratch)

    pos_x, pos_y, pos_z = params[0], params[1], params[2]
    va0, vb0, vc0, vd0, ve0, vf0 = (params[3 + t] for t in range(6))
    rgba_bits = params[9].view(torch.int32)
    packed = params[10].view(torch.int32)
    mid = params[11].view(torch.int32)
    lod_id = (packed >> GS_BITS) & 0xF

    # per-draw uniforms broadcast per block (no gather, no scatter recovery)
    def bcast(row):
        return row.repeat_interleave(BLOCK)

    bits1 = bcast(blocks[1])
    bits2 = bcast(blocks[2])
    lane = torch.arange(BLOCK, device=blocks.device, dtype=torch.int32).repeat(nb)
    in_range = lane < bcast(blocks[3])
    if blocks.shape[0] >= 6:
        in_range &= lane >= bcast(blocks[5])
    keep_blk = keep_draw[blocks[4].long()].to(torch.int32)
    keep = bcast(keep_blk) & ((bits1 >> 28) & 1)
    if gs_enable is not None:
        keep = keep & gs_enable.to(torch.int32)
    single = bits1 & 1
    changing = (bits1 >> 1) & 1
    to_lower = ((bits1 >> 2) & 3) - 1
    tile_lod = (bits1 >> 4) & 31
    valid_lod = ((bits1 >> 9) & 31) - 1
    view_id = (bits1 >> 14) & 15
    tile_id = (bits1 >> 18) & 1023
    map_index = bits2 & ((1 << 22) - 1)
    single_lod = ((bits2 >> 22) & 31) - 1

    valid = in_range & (keep == 1)

    cr = (rgba_bits & 0xFF).float() / 255.0
    cg = ((rgba_bits >> 8) & 0xFF).float() / 255.0
    cb = ((rgba_bits >> 16) & 0xFF).float() / 255.0
    ca = ((rgba_bits >> 24) & 0xFF).float() / 255.0

    # map_coord for the sphere path from the draw's map_index
    half = scene["map_half_wh"]
    cc = scene["center_coord"]
    tw = scene["tile_width"]
    map_h = 2 * half[1] + (0 if surface_type == 2 else 1)
    mc_x = torch.div(map_index, map_h, rounding_mode="floor")
    mc_y = map_index % map_h

    # early discard: wrong lod id (gswt.wgsl:39-42)
    valid &= ~((valid_lod >= 0) & (valid_lod != lod_id))

    def tile_offset(src):
        return (
            (torch.div(src, map_h, rounding_mode="floor") - half[0] + cc[0])
            .float() * tw,
            ((src % map_h) - half[1] + cc[1]).float() * tw,
        )

    # offset (gswt.wgsl:52-64): merged draws use the per-splat map id,
    # non-merged draws the draw's own map index — same formula
    off_x, off_y = tile_offset(torch.where(single == 1, mid, map_index))
    # DRAW-uniform offset (u_tile.offset, gswt.wgsl:277): the TileID debug
    # tint seeds from this — ONE tint per merged draw, not per source tile
    doff_x, doff_y = tile_offset(map_index)
    off_z = torch.zeros_like(pos_z)
    ssc = scene["scene_scale"]
    cx_w = (pos_x + off_x) * ssc[0]
    cy_w = (pos_y + off_y) * ssc[1]
    cz_w = (pos_z + off_z) * ssc[2]

    # surface mapping (gswt.wgsl:74-82)
    (mx, my, mz), fr = surface_mapping(
        scene, hm4, hm_wh, cx_w, cy_w, mid, single, mc_x, mc_y, surface_type,
        exact=exact, hm_src=hm_src,
    )
    fxx, fxy, fxz, fyx, fyy, fyz, fzx, fzy, fzz = fr
    if surface_type > 0:
        cx_n = mx + fzx * cz_w
        cy_n = my + fzy * cz_w
        cz_n = mz + fzz * cz_w
    else:
        cx_n, cy_n, cz_n = cx_w, cy_w, cz_w

    # z clip (gswt.wgsl:84-87)
    valid &= ~((scene["use_clip"] == 1) & (mz < scene["clip_height"]))

    # LOD transition (gswt.wgsl:89-150)
    cp = cam["cam_pos"]
    dxc = cx_n - cp[0]
    dyc = cy_n - cp[1]
    dzc = cz_n - cp[2]
    cam_dist = torch.sqrt(dxc * dxc + dyc * dyc + dzc * dzc)
    trans = scene["transition_dist_vec"]
    num_lod = scene["num_lod"]

    def lut16(idx):
        return trans[torch.clamp(idx, 0, 15).long()]

    hl_single = torch.where(
        lod_id == 0,
        0,
        torch.where(
            lod_id == num_lod - 1,
            lod_id - 1,
            torch.where(
                (cam_dist - lut16(lod_id - 1)) < (lut16(lod_id) - cam_dist),
                lod_id - 1,
                lod_id,
            ),
        ),
    )
    hl_tile = torch.where(to_lower == 1, tile_lod, tile_lod - 1)
    higher_lod = torch.clamp(torch.where(single == 1, hl_single, hl_tile), 0, 15)
    t_dist = lut16(higher_lod)
    half_w = scene["transition_width_ratio"] * t_dist
    t_ratio = torch.clamp((cam_dist - t_dist) / half_w + 0.5, 0.0, 1.0)
    t_ratio = torch.nan_to_num(t_ratio, nan=1.0, posinf=1.0, neginf=0.0)
    is_changing = changing == 1
    valid &= ~(
        is_changing
        & (
            ((lod_id == higher_lod + 1) & (t_ratio == 0.0))
            | ((lod_id == higher_lod) & (t_ratio == 1.0))
        )
    )
    alpha_mul = torch.where(
        is_changing, torch.where(lod_id != higher_lod, t_ratio, 1.0 - t_ratio),
        1.0,
    )

    # projection (gswt.wgsl:152-167)
    view = cam["view"]
    proj = cam["proj_wgpu"]

    def mat4_apply_rows(m, x, y, z):
        return tuple(m[r, 0] * x + m[r, 1] * y + m[r, 2] * z + m[r, 3]
                     for r in range(4))

    vx, vy, vz, _ = mat4_apply_rows(view, cx_n, cy_n, cz_n)
    p0, p1, p2, p3 = mat4_apply_rows(proj, vx, vy, vz)
    clip = 1.2 * p3
    valid &= ~(
        (p2 < -clip) | (p0 < -clip) | (p0 > clip) | (p1 < -clip) | (p1 > clip)
    )

    # covariance (gswt.wgsl:169-205)
    if point_cloud:
        p_r = torch.full_like(pos_x, 1.0) * scene["point_cloud_radius"]
        if draw_mode > 0:
            p_r = p_r * torch.pow(2.0, tile_lod.float())
        va, vb, vc2, vd, ve, vf = p_r, 0.0 * p_r, 0.0 * p_r, p_r, 0.0 * p_r, p_r
    else:
        va, vb, vc2, vd, ve, vf = va0, vb0, vc0, vd0, ve0, vf0

    if surface_type > 0:
        f00, f01, f02 = fxx, fyx, fzx
        f10, f11, f12 = fxy, fyy, fzy
        f20, f21, f22 = fxz, fyz, fzz
        w00 = f00 * va + f01 * vb + f02 * vc2
        w01 = f00 * vb + f01 * vd + f02 * ve
        w02 = f00 * vc2 + f01 * ve + f02 * vf
        w10 = f10 * va + f11 * vb + f12 * vc2
        w11 = f10 * vb + f11 * vd + f12 * ve
        w12 = f10 * vc2 + f11 * ve + f12 * vf
        w20 = f20 * va + f21 * vb + f22 * vc2
        w21 = f20 * vb + f21 * vd + f22 * ve
        w22 = f20 * vc2 + f21 * ve + f22 * vf
        va = w00 * f00 + w01 * f01 + w02 * f02
        vb = w00 * f10 + w01 * f11 + w02 * f12
        vc2 = w00 * f20 + w01 * f21 + w02 * f22
        vd = w10 * f10 + w11 * f11 + w12 * f12
        ve = w10 * f20 + w11 * f21 + w12 * f22
        vf = w20 * f20 + w21 * f21 + w22 * f22
    va = va * ssc[0] * ssc[0]
    vb = vb * ssc[0] * ssc[1]
    vc2 = vc2 * ssc[0] * ssc[2]
    vd = vd * ssc[1] * ssc[1]
    ve = ve * ssc[1] * ssc[2]
    vf = vf * ssc[2] * ssc[2]

    # EWA Jacobian (gswt.wgsl:207-245)
    r3 = view[:3, :3]
    tx3 = r3[0, 0] * dxc + r3[0, 1] * dyc + r3[0, 2] * dzc
    ty3 = r3[1, 0] * dxc + r3[1, 1] * dyc + r3[1, 2] * dzc
    tz3 = r3[2, 0] * dxc + r3[2, 1] * dyc + r3[2, 2] * dzc
    limx = 1.3 * cam["htan_fov"][0]
    limy = 1.3 * cam["htan_fov"][1]
    txc = torch.clamp(tx3 / tz3, -limx, limx) * tz3
    tyc = torch.clamp(ty3 / tz3, -limy, limy) * tz3
    tz2 = tz3 * tz3
    fx = cam["focal"][0]
    fy = cam["focal"][1]
    j00 = fx / tz3
    j20 = -fx * txc / tz2
    j11 = fy / tz3
    j21 = -fy * tyc / tz2
    t0x = r3[0, 0] * j00 + r3[2, 0] * j20
    t0y = r3[0, 1] * j00 + r3[2, 1] * j20
    t0z = r3[0, 2] * j00 + r3[2, 2] * j20
    t1x = r3[1, 0] * j11 + r3[2, 0] * j21
    t1y = r3[1, 1] * j11 + r3[2, 1] * j21
    t1z = r3[1, 2] * j11 + r3[2, 2] * j21

    def quad(ax, ay, az, bx, by, bz):
        return (
            ax * (va * bx + vb * by + vc2 * bz)
            + ay * (vb * bx + vd * by + ve * bz)
            + az * (vc2 * bx + ve * by + vf * bz)
        )

    c00 = quad(t0x, t0y, t0z, t0x, t0y, t0z)
    c01 = quad(t0x, t0y, t0z, t1x, t1y, t1z)
    c11 = quad(t1x, t1y, t1z, t1x, t1y, t1z)

    mid2 = 0.5 * (c00 + c11)
    radius = torch.sqrt((0.5 * (c00 - c11)) ** 2 + c01 * c01)
    lam1 = mid2 + radius
    lam2 = mid2 - radius
    valid &= ~(lam2 < 0.0)
    dgx = c01
    dgy = lam1 - c00
    dn = torch.sqrt(dgx * dgx + dgy * dgy)
    dns = torch.where(dn == 0, 1.0, dn)
    dgx = torch.where(dn > 0, dgx / dns, dgx)
    dgy = torch.where(dn > 0, dgy / dns, dgy)
    len1 = torch.clamp(torch.sqrt(2.0 * torch.clamp(lam1, min=0.0)), max=1024.0)
    len2 = torch.clamp(torch.sqrt(2.0 * torch.clamp(lam2, min=0.0)), max=1024.0)
    sscale = scene["splat_scale"]
    maj_x = len1 * dgx * sscale
    maj_y = len1 * dgy * sscale
    min_x = len2 * dgy * sscale
    min_y = -len2 * dgx * sscale

    # color + debug modes + lod alpha + near fade
    cr, cg, cb, ca = _apply_draw_mode(
        draw_mode, cr, cg, cb, ca, pos_x, pos_y, doff_x, doff_y, tile_lod,
        lod_id, single, is_changing, t_ratio, view_id, single_lod, tile_id,
        scene, surface_type
    )
    ca = ca * alpha_mul
    fade = torch.clamp(p2 / p3 + 1.0, 0.0, 1.0)
    cr = cr * fade
    cg = cg * fade
    cb = cb * fade
    ca = ca * fade

    # NDC -> pixel space
    w_img, h_img = image_wh
    z_ndc = p2 / p3
    cx_px = (p0 / p3 * 0.5 + 0.5) * w_img
    cy_px = (0.5 - p1 / p3 * 0.5) * h_img
    valid &= (z_ndc >= 0.0) & (z_ndc <= 1.0)

    # exponent coefficients over pixel coords (y-down => flip axis y)
    mjx, mjy = maj_x, -maj_y
    mnx, mny = min_x, -min_y
    m2 = mjx * mjx + mjy * mjy
    n2 = mnx * mnx + mny * mny
    valid &= (m2 > 0) & (n2 > 0)
    m2s = torch.where(m2 == 0, 1.0, m2)
    n2s = torch.where(n2 == 0, 1.0, n2)
    q_a = 4.0 * (mjx * mjx / m2s**2 + mnx * mnx / n2s**2)
    q_b = 4.0 * (mjx * mjy / m2s**2 + mnx * mny / n2s**2)
    q_c = 4.0 * (mjy * mjy / m2s**2 + mny * mny / n2s**2)
    # the monomial exponent coefficients are reconstructed from (q, center)
    # in ops/binning.py RECENTERED to each pair's raster tile origin

    # tight pixel bbox of the coverage ellipse: per-axis extent
    # sqrt(maj_c^2 + min_c^2) in pixels
    ext_x = torch.sqrt(mjx * mjx + mnx * mnx)
    ext_y = torch.sqrt(mjy * mjy + mny * mny)

    valid &= torch.isfinite(cx_px) & torch.isfinite(cy_px)
    for q in (q_a, q_b, q_c):
        valid &= torch.isfinite(q)

    vf32 = valid.float()
    return dict(
        valid=valid,
        cx=cx_px,
        cy=cy_px,
        z=z_ndc,
        q=(q_a, q_b, q_c),
        color=(cr * vf32, cg * vf32, cb * vf32, ca * vf32),
        ext_x=ext_x,
        ext_y=ext_y,
    )


def _apply_draw_mode(draw_mode, cr, cg, cb, ca, pos_x, pos_y, off_x, off_y,
                     tile_lod, lod_id, single, is_changing, t_ratio, view_id,
                     single_lod, tile_id, scene, surface_type):
    """Debug draw modes (gswt.wgsl:267-399), componentized."""
    if draw_mode == 0:
        return cr, cg, cb, ca
    half_gray = torch.full_like(cr, 0.5)
    if draw_mode == 1:  # TileID
        gray = torch.clamp((cr + cg + cb) / 0.6, 0.0, 1.0)
        r, g, b = gray, gray, gray
        tw = scene["tile_width"]
        margin = 0.05 * tw
        on_sphere = surface_type == 2
        c_a = (1.0, 0.0, 0.0) if on_sphere else (1.0, 0.85, 0.0)
        c_b = (0.0, 1.0, 0.13) if on_sphere else (0.0, 0.58, 1.0)
        west = pos_x < margin
        east = pos_x > tw - margin
        south = pos_y < margin
        north = pos_y > tw - margin
        ym = south | north

        def pick(cond, col3, r, g, b):
            return (
                torch.where(cond, col3[0], r),
                torch.where(cond, col3[1], g),
                torch.where(cond, col3[2], b),
            )

        def bit(k):
            return torch.div(tile_id, k, rounding_mode="floor") % 2

        red = (1.0, 0.0, 0.0)
        green = (0.0, 1.0, 0.13)
        gray5 = (0.5, 0.5, 0.5)
        r, g, b = pick(west & ym, gray5, r, g, b)
        r, g, b = pick(west & ~ym & (bit(8) == 0), red, r, g, b)
        r, g, b = pick(west & ~ym & (bit(8) == 1), green, r, g, b)
        r, g, b = pick(~west & east & ym, gray5, r, g, b)
        r, g, b = pick(~west & east & ~ym & (bit(2) == 0), red, r, g, b)
        r, g, b = pick(~west & east & ~ym & (bit(2) == 1), green, r, g, b)
        m = ~west & ~east & south
        r, g, b = pick(m & (bit(1) == 0), c_a, r, g, b)
        r, g, b = pick(m & (bit(1) == 1), c_b, r, g, b)
        m = ~west & ~east & ~south & north
        r, g, b = pick(m & (bit(4) == 0), c_a, r, g, b)
        r, g, b = pick(m & (bit(4) == 1), c_b, r, g, b)

        def wgsl_rand(x, y):
            # jnp.mod semantics: the result takes the divisor's sign
            return torch.remainder(
                torch.sin(x * 12.9898 + y * 78.233) * 43758.5453, 1.0)

        mm = single == 1
        r = torch.where(mm, gray * wgsl_rand(off_x, off_y), r)
        g = torch.where(mm, gray * wgsl_rand(off_x + 23.45, off_y + 23.45), g)
        b = torch.where(mm, gray * wgsl_rand(off_x + 67.89, off_y + 67.89), b)
        return r, g, b, ca
    if draw_mode == 2:  # TileLOD
        mid_t = (t_ratio > 0.0) & (t_ratio < 1.0)
        lodv = tile_lod.float()
        cx = torch.where(tile_lod < 3, (3.0 - lodv) / 3.0, 0.0)
        cy = torch.where(tile_lod >= 3, (6.0 - lodv) / 3.0, 1.0)
        r = half_gray
        g, b = cx, cy
        chang = ~mid_t & is_changing
        r = torch.where(chang, 0.0, r)
        g = torch.where(chang, 1.0, g)
        b = torch.where(chang, 0.0, b)
        r = torch.where(mid_t, 0.0, r)
        g = torch.where(mid_t, 0.0, g)
        b = torch.where(mid_t, 0.0, b)
        return r, g, b, ca
    if draw_mode == 3:  # LOD
        mid_t = (t_ratio > 0.0) & (t_ratio < 1.0)
        eff = torch.where(single_lod >= 0, single_lod, lod_id).float()
        cx = torch.where(eff < 3, (3.0 - eff) / 3.0, 0.0)
        cy = torch.where(eff >= 3, (6.0 - eff) / 3.0, 1.0)
        r = torch.where(mid_t, 0.0, half_gray)
        g = torch.where(mid_t, 0.0, cx)
        b = torch.where(mid_t, 0.0, cy)
        return r, g, b, ca
    # View (draw_mode 4)
    vid = view_id.float()
    cx = torch.where(vid < 4, (4.0 - vid) / 4.0, 0.0)
    cy = torch.where(vid >= 4, (8.0 - vid) / 4.0, 0.0)
    cx = torch.where(vid >= 8, 1.0, cx)
    cy = torch.where(vid >= 8, 1.0, cy)
    return half_gray, cx, cy, ca
