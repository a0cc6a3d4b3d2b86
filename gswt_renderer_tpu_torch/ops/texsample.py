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
arithmetic in the same order. The pyramid kernel reads a texel-interleaved
copy of the planes (``interleave_pyramid``, one 8-byte load per tap; the
pyramid on each device is laid out by ``sampler_pyramid``) and wraps in
integers where that is exact;
``factored_mip_trilinear_texels_plain`` is that form in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import kernels

MAX_PYR_LEVELS = 16  # the CUDA kernel takes the level table by value
MAX_MIP_CHANNELS = 4  # texels of the CUDA sampler: 4 bf16 (8 bytes)
# the sampler's integer wrap is exact below these (see _wrap)
_INT_WRAP_COORD = float(1 << 24)
_INT_WRAP_SIZE = float(1 << 12)


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


def interleave_pyramid(planes):
    """[C <= 4, Hp, Wp] -> [Hp, Wp, 4]: the pyramid texel-interleaved (the
    channels of a texel side by side, zero-padded to 4), the CUDA sampler's
    layout: one 8-byte load per tap fetches every channel of a bf16 texel.
    Built once per texture (Renderer.set_proxy), never per frame."""
    n_ch, hp, wp = planes.shape
    if n_ch > MAX_MIP_CHANNELS:
        raise ValueError(f"the CUDA sampler takes <= {MAX_MIP_CHANNELS} "
                         f"channels")
    out = torch.zeros((hp, wp, MAX_MIP_CHANNELS), dtype=planes.dtype,
                      device=planes.device)
    out[..., :n_ch] = planes.permute(1, 2, 0)
    return out


def _level_params(meta, l_i):
    """Per-pixel (w, h, ro, co) f32 of the kept level l_i."""
    tab = torch.tensor(meta, dtype=torch.float32, device=l_i.device)
    return tab[l_i].unbind(-1)


def _wrap(x0f, n, int_wrap):
    """Repeat wrap of the tap index floor(x) into [0, n): the float modulo
    x0f - floor(x0f / n) n. With int_wrap, the integer modulo where that is
    exact (|x0f| < 2^24 and n <= 2^12: the quotient then cannot round
    across an integer, so both give the same value), as the kernel does."""
    flt = x0f - torch.floor(x0f / n) * n
    if not int_wrap:
        return flt
    small = (x0f.abs() < _INT_WRAP_COORD) & (n <= _INT_WRAP_SIZE)
    xi = torch.where(small, x0f, 0.0).long()
    return torch.where(small, (xi % n.long()).to(torch.float32), flt)


def _tap_rows(meta, l_i, u, v, lw, int_wrap=False):
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
    # modulo wrap (Repeat)
    x0 = _wrap(x0f, w, int_wrap)
    x1 = x0 + 1.0
    x1 = torch.where(x1 >= w, 0.0, x1)
    y0 = _wrap(y0f, h, int_wrap)
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


def _mip_plain(fetch, n_ch, meta, l_min, u, v, rho, int_wrap):
    """The sampler over any texel layout: fetch(rows, cols) -> [C, P] f32."""
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
    rows0 = _tap_rows(meta, l0, uf, vf, 1.0 - frac, int_wrap)
    rows1 = _tap_rows(meta, l1, uf, vf, frac, int_wrap)
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
    out = torch.zeros((n_ch, uf.shape[0]), dtype=torch.float32,
                      device=uf.device)
    for r in range(4):
        acc = torch.zeros_like(out)
        for c in range(4):
            tex = fetch(rws[r], cols[c])
            acc = acc + torch.where(cfirst[c], tex * wxs[c], 0.0)
        out = out + torch.where(rfirst[r], wys[r] * acc, 0.0)
    out = out * (1.0 / 255.0)
    return out.reshape((n_ch,) + tuple(shape))


def factored_mip_trilinear_plain(planes, meta, l_min, u, v, rho):
    """Plain PyTorch version of factored_mip_trilinear (same arguments)."""
    return _mip_plain(lambda r, c: planes[:, r, c].to(torch.float32),
                      planes.shape[0], meta, l_min, u, v, rho, False)


def factored_mip_trilinear_texels_plain(texels, n_ch, meta, l_min, u, v,
                                        rho):
    """The CUDA sampler's form in plain PyTorch: taps read from the
    interleaved copy (interleave_pyramid), wrapped in integers where that is
    exact. Equal to the bit to factored_mip_trilinear_plain."""
    return _mip_plain(
        lambda r, c: texels[r, c, :n_ch].to(torch.float32).T, n_ch, meta,
        l_min, u, v, rho, True)


_mip_entry = None
_mip_tables: dict = {}


def _mip_launch_fn():
    """The C entry, resolved once."""
    global _mip_entry
    if _mip_entry is None:
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        _mip_entry = kernels.load("miptrilinear", gswt_mip_trilinear=[
            vp, ci, ci, ci, ctypes.POINTER(ctypes.c_int), ci, ci,
            vp, vp, vp, ll, vp, vp]).gswt_mip_trilinear
    return _mip_entry


def _mip_level_table(meta):
    """The level table as the C entry takes it, built once per pyramid."""
    tab = _mip_tables.get(meta)
    if tab is None:
        flat = [int(x) for lv in meta for x in lv]
        tab = _mip_tables[meta] = (ctypes.c_int * len(flat))(*flat)
    return tab


def sampler_pyramid(planes):
    """The packed pyramid [C, Hp, Wp] bf16 in the layout that
    factored_mip_trilinear reads on its device: the planes themselves on
    the CPU, their texel-interleaved copy (interleave_pyramid) on CUDA.
    Built once per texture (the Renderer keeps it), never per frame."""
    return interleave_pyramid(planes) if planes.is_cuda else planes


def factored_mip_trilinear(pyr, meta, l_min, u, v, rho, *, n_ch=None):
    """Trilinear Repeat mip sampling of a pack_pyramid chain.

    pyr: the chain as sampler_pyramid lays it out: on the CPU the planes
    [C, Hp, Wp] bf16, taken by the plain version; on CUDA the interleaved
    texels [Hp, Wp, 4] bf16, read by the kernel, with n_ch (<= 4) the
    number of channels they carry. meta/l_min from pack_pyramid; u, v:
    [...] uv in texture-repeat units; rho: footprint in LEVEL-0 texels per
    pixel (levels below l_min clamp to l_min). Returns [n_ch, ...] f32."""
    if not pyr.is_cuda:
        if n_ch is not None and n_ch != pyr.shape[0]:
            raise ValueError(f"the planes carry {pyr.shape[0]} channels, "
                             f"not {n_ch}")
        return factored_mip_trilinear_plain(pyr, meta, l_min, u, v, rho)
    dev = pyr.device
    if (pyr.dtype != torch.bfloat16 or pyr.dim() != 3
            or pyr.shape[2] != MAX_MIP_CHANNELS or not pyr.is_contiguous()):
        raise ValueError(f"on CUDA the pyramid must be the contiguous "
                         f"bfloat16 texels [Hp, Wp, {MAX_MIP_CHANNELS}] of "
                         f"sampler_pyramid")
    if n_ch is None or not 1 <= n_ch <= MAX_MIP_CHANNELS:
        raise ValueError(f"n_ch must be 1..{MAX_MIP_CHANNELS}")
    hp, wp, _ = pyr.shape
    if not isinstance(meta, tuple):
        meta = tuple(tuple(lv) for lv in meta)
    n_kept = len(meta)
    if not 1 <= n_kept <= MAX_PYR_LEVELS:
        raise ValueError(f"the CUDA sampler takes 1..{MAX_PYR_LEVELS} levels")
    uf = _flat_f32("u", u, device=dev)
    p = uf.shape[0]
    vf = _flat_f32("v", v, p, dev)
    rf = _flat_f32("rho", rho, p, dev)
    out = torch.empty((n_ch,) + tuple(u.shape), dtype=torch.float32,
                      device=dev)
    rc = _mip_launch_fn()(
        pyr.data_ptr(), n_ch, hp, wp, _mip_level_table(meta), n_kept,
        int(l_min), uf.data_ptr(), vf.data_ptr(), rf.data_ptr(), p,
        out.data_ptr(), kernels.stream_ptr(out))
    kernels.LAUNCHES["mip_trilinear"] += 1
    kernels.check(rc, "mip_trilinear")
    return out
