"""Texture sampling kernels: 4-tap bilinear of a small texture, and the
whole-mip-chain trilinear fetch from a packed pyramid.

``factored_bilinear`` samples a small ``[C, Ht, Wt]`` texture at fractional
texel coordinates with Repeat or ClampToEdge per axis, associating

    A0 = i00 (1-tx) + i10 tx ;  A1 = i01 (1-tx) + i11 tx
    out = A0 (1-ty) + A1 ty

It is used by the equirect skybox pass (skybox.wgsl:74-97 sampling).
``factored_mip_trilinear`` is trilinear Repeat sampling
(1-f) * bilinear(level l0) + f * bilinear(l0 + 1) of a mip chain that
``pack_pyramid`` lays out block-diagonally in one plane per channel (level k
at rows [ro_k, ro_k + h_k), cols [co_k, co_k + w_k), zeros elsewhere). The
planes hold the u8 texel values as integers 0..255, which bf16 represents
exactly; the tap weights of the columns are rounded to bf16 (<= 2^-9
relative, so <= ~0.5/255 absolute on the result), the sums run in f32 and
the /255 happens last.

On the card both are CUDA kernels (``csrc/bilinear.cu``,
``csrc/miptrilinear.cu``) in which every thread reads its own taps; on the
CPU they are the plain PyTorch versions beside them, which do the same
arithmetic in the same order.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import kernels

MAX_PYR_LEVELS = 16  # the CUDA kernel takes the level table by value


def _flat_f32(name, t, n=None, device=None):
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32")
    t = t.reshape(-1).contiguous()
    if n is not None and t.shape[0] != n:
        raise ValueError(f"{name} must have {n} elements")
    if device is not None and t.device != device:
        raise ValueError(f"{name} must lie on {device}")
    return t


# ====================================================================== #
# 4-tap bilinear of a small texture
# ====================================================================== #
def _axis_taps(c, n, wrap):
    """floor / fraction / the two tap indices of one axis."""
    c0f = torch.floor(c)
    t = c - c0f
    c0i = c0f.long()
    if wrap:
        return t, c0i % n, (c0i + 1) % n
    return t, torch.clamp(c0i, 0, n - 1), torch.clamp(c0i + 1, 0, n - 1)


def factored_bilinear_plain(tex_planes, x, y, *, wrap_x: bool, wrap_y: bool):
    """Plain PyTorch version of factored_bilinear (same arguments)."""
    shape = x.shape
    tx, x0, x1 = _axis_taps(x.reshape(-1), tex_planes.shape[2], wrap_x)
    ty, y0, y1 = _axis_taps(y.reshape(-1), tex_planes.shape[1], wrap_y)
    a0 = tex_planes[:, y0, x0] * (1.0 - tx) + tex_planes[:, y0, x1] * tx
    a1 = tex_planes[:, y1, x0] * (1.0 - tx) + tex_planes[:, y1, x1] * tx
    out = a0 * (1.0 - ty) + a1 * ty
    return out.reshape((tex_planes.shape[0],) + tuple(shape))


def factored_bilinear(tex_planes, x, y, *, wrap_x: bool, wrap_y: bool):
    """Bilinear-sample a small texture at fractional texel coords.

    tex_planes: [C, Ht, Wt] f32; x, y: [...] fractional texel coordinates
    (the caller applies the -0.5 texel-center convention). wrap selects
    Repeat vs ClampToEdge per axis. Returns [C, ...]. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if not tex_planes.is_cuda:
        return factored_bilinear_plain(tex_planes, x, y, wrap_x=wrap_x,
                                       wrap_y=wrap_y)
    if (tex_planes.dtype != torch.float32 or tex_planes.dim() != 3
            or not tex_planes.is_contiguous()):
        raise ValueError("tex_planes must be a contiguous float32 [C, Ht, Wt]")
    dev = tex_planes.device
    n_ch, ht, wt = tex_planes.shape
    shape = x.shape
    xf = _flat_f32("x", x, device=dev)
    yf = _flat_f32("y", y, xf.shape[0], dev)
    p = xf.shape[0]
    out = torch.empty((n_ch, p), dtype=torch.float32, device=dev)
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib = kernels.load("bilinear", gswt_bilinear=[
        vp, ci, ci, ci, vp, vp, ll, ci, ci, vp, vp])
    rc = lib.gswt_bilinear(
        kernels.ptr(tex_planes), n_ch, ht, wt, kernels.ptr(xf),
        kernels.ptr(yf), p, int(bool(wrap_x)), int(bool(wrap_y)),
        kernels.ptr(out), kernels.stream_ptr(out))
    kernels.LAUNCHES["bilinear"] += 1
    kernels.check(rc, "bilinear")
    return out.reshape((n_ch,) + tuple(shape))


def factored_fits(tex_shape) -> bool:
    """True if [C, Ht, Wt] is a small texture in the JAX package's sense
    (its resident-texture kernel's limit). The CUDA kernel has no such
    limit; only the CPU path of the skybox pass asks, so that it samples a
    given texture with the JAX package's association."""
    n_ch, ht, wt = tex_shape
    return n_ch * ht <= 512 and wt <= 512 and n_ch * ht * wt * 4 <= 2 << 20


# ====================================================================== #
# Whole-mip-chain trilinear sampling of a packed pyramid
# ====================================================================== #
def pyramid_l_min(w0: int) -> int:
    """Finest level the packed pyramid keeps: levels wider than 128 are
    skipped (a 512^2 texture clamps to level 2; <= 128^2 keeps every
    level)."""
    l = 0
    while (w0 >> l) > 128:
        l += 1
    return l


def pack_pyramid(mips):
    """mips: list of [H,W,3] f32 levels (values in [0,1]). Returns (planes
    f32 numpy [3, Hp, Wp] holding 0..255 integer texel values, meta tuple of
    (w, h, row_off, col_off) per KEPT level, l_min). Levels finer than
    `pyramid_l_min` are dropped (sampling clamps to l_min). The Renderer
    stores the planes as torch.bfloat16, which holds these integers
    exactly."""
    w0 = int(np.asarray(mips[0]).shape[1])
    l_min = pyramid_l_min(w0)
    kept = mips[l_min:]
    hs = [int(np.asarray(m).shape[0]) for m in kept]
    ws = [int(np.asarray(m).shape[1]) for m in kept]
    hp = -(-sum(hs) // 8) * 8
    wp = -(-sum(ws) // 128) * 128
    planes = np.zeros((3, hp, wp), np.float32)
    meta = []
    ro = co = 0
    for m, h, w in zip(kept, hs, ws):
        q = np.clip(np.round(np.asarray(m, np.float32) * 255.0), 0, 255)
        planes[:, ro : ro + h, co : co + w] = q.transpose(2, 0, 1)
        meta.append((w, h, ro, co))
        ro += h
        co += w
    return planes, tuple(meta), l_min


def _level_params(meta, l_i):
    """Per-pixel (w, h, ro, co) f32 of the kept level l_i."""
    tab = torch.tensor(meta, dtype=torch.float32, device=l_i.device)
    return tab[l_i].unbind(-1)


def _tap_rows(meta, l_i, u, v, lw):
    """One level's taps: wrapped (col, w) x2 and (row, w) x2, with the
    level weight lw folded into the COLUMN weights (rows carry plain
    bilinear weights; the block-diagonal pack keeps levels separable)."""
    w, h, ro, co = _level_params(meta, l_i)
    x = u * w - 0.5
    y = v * h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    tx = x - x0f
    ty = y - y0f
    # float modulo wrap (Repeat)
    x0 = x0f - torch.floor(x0f / w) * w
    x1 = x0 + 1.0
    x1 = torch.where(x1 >= w, 0.0, x1)
    y0 = y0f - torch.floor(y0f / h) * h
    y1 = y0 + 1.0
    y1 = torch.where(y1 >= h, 0.0, y1)
    return [
        co + x0, (1.0 - tx) * lw, co + x1, tx * lw,
        ro + y0, 1.0 - ty, ro + y1, ty,
    ]


def _merge_taps(idx, wts):
    """Sum the weights of coinciding taps: for each of the 4 taps, the f32
    sum (in tap order) of every tap's weight at its index, and whether the
    tap is the first at that index. idx, wts: lists of 4 [P] tensors."""
    summed, first = [], []
    for k in range(4):
        s = torch.zeros_like(wts[k])
        for j in range(4):
            s = s + torch.where(idx[j] == idx[k], wts[j], 0.0)
        summed.append(s)
        f = torch.ones_like(idx[k], dtype=torch.bool)
        for j in range(k):
            f &= idx[j] != idx[k]
        first.append(f)
    return summed, first


def factored_mip_trilinear_plain(planes, meta, l_min, u, v, rho):
    """Plain PyTorch version of factored_mip_trilinear (same arguments)."""
    n_kept = len(meta)
    shape = u.shape
    uf = u.reshape(-1)
    vf = v.reshape(-1)
    rf = rho.reshape(-1)
    lvl = torch.clamp(torch.log2(torch.clamp(rf, min=1e-6)) - l_min,
                      0.0, float(n_kept - 1))
    l0 = torch.floor(lvl).long()
    frac = lvl - l0.to(torch.float32)
    l1 = torch.clamp(l0 + 1, max=n_kept - 1)
    rows0 = _tap_rows(meta, l0, uf, vf, 1.0 - frac)
    rows1 = _tap_rows(meta, l1, uf, vf, frac)
    # At the coarsest level l0 == l1: the column taps coincide and their
    # folded level weights sum correctly ((1-f)+f, with f exactly 0 there),
    # but the row taps carry plain bilinear weights -- accumulated twice
    # they would double the output. Zero the second level's row weights.
    dup = (l0 == l1).to(torch.float32)
    rows1[5] = rows1[5] * (1.0 - dup)
    rows1[7] = rows1[7] * (1.0 - dup)
    cols = [r.long() for r in (rows0[0], rows0[2], rows1[0], rows1[2])]
    wxs, cfirst = _merge_taps(cols, [rows0[1], rows0[3], rows1[1], rows1[3]])
    # column weights are rounded to bf16 AFTER coinciding taps are summed
    wxs = [w.to(torch.bfloat16).to(torch.float32) for w in wxs]
    rws = [r.long() for r in (rows0[4], rows0[6], rows1[4], rows1[6])]
    wys, rfirst = _merge_taps(rws, [rows0[5], rows0[7], rows1[5], rows1[7]])
    out = torch.zeros((planes.shape[0], uf.shape[0]), dtype=torch.float32,
                      device=uf.device)
    for r in range(4):
        acc = torch.zeros_like(out)
        for c in range(4):
            tex = planes[:, rws[r], cols[c]].to(torch.float32)
            acc = acc + torch.where(cfirst[c], tex * wxs[c], 0.0)
        out = out + torch.where(rfirst[r], wys[r] * acc, 0.0)
    out = out * (1.0 / 255.0)
    return out.reshape((planes.shape[0],) + tuple(shape))


def factored_mip_trilinear(planes, meta, l_min, u, v, rho):
    """Trilinear Repeat mip sampling of a pack_pyramid chain.

    planes: [3, Hp, Wp] bf16; meta/l_min from pack_pyramid; u, v: [...] uv
    in texture-repeat units; rho: footprint in LEVEL-0 texels per pixel
    (levels below l_min clamp to l_min). Returns [3, ...] f32 rgb. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if not planes.is_cuda:
        return factored_mip_trilinear_plain(planes, meta, l_min, u, v, rho)
    if (planes.dtype != torch.bfloat16 or planes.dim() != 3
            or not planes.is_contiguous()):
        raise ValueError("planes must be a contiguous bfloat16 [C, Hp, Wp]")
    n_kept = len(meta)
    if not 1 <= n_kept <= MAX_PYR_LEVELS:
        raise ValueError(f"the CUDA sampler takes 1..{MAX_PYR_LEVELS} levels")
    dev = planes.device
    n_ch, hp, wp = planes.shape
    shape = u.shape
    uf = _flat_f32("u", u, device=dev)
    vf = _flat_f32("v", v, uf.shape[0], dev)
    rf = _flat_f32("rho", rho, uf.shape[0], dev)
    p = uf.shape[0]
    out = torch.empty((n_ch, p), dtype=torch.float32, device=dev)
    flat = [int(x) for lv in meta for x in lv]
    meta_c = (ctypes.c_int * len(flat))(*flat)
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib = kernels.load("miptrilinear", gswt_mip_trilinear=[
        vp, ci, ci, ci, ctypes.POINTER(ctypes.c_int), ci, ci,
        vp, vp, vp, ll, vp, vp])
    rc = lib.gswt_mip_trilinear(
        kernels.ptr(planes), n_ch, hp, wp, meta_c, n_kept, int(l_min),
        kernels.ptr(uf), kernels.ptr(vf), kernels.ptr(rf), p,
        kernels.ptr(out), kernels.stream_ptr(out))
    kernels.LAUNCHES["mip_trilinear"] += 1
    kernels.check(rc, "mip_trilinear")
    return out.reshape((n_ch,) + tuple(shape))
