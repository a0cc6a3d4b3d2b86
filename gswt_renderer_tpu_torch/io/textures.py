"""Texture uploads: height maps, skybox (cubemap faces / EXR HDRI), proxy.

Reproduces the reference's upload paths:
- height map PNG/JPG -> red channel, flipped vertically, normalized to
  [-1, 1] over its min/max (wangtile.rs:1849-1901);
- skybox: 6 cubemap face images, or an equirectangular EXR HDRI
  (skybox.rs:703-805) — a minimal scanline EXR reader (half/float,
  uncompressed or ZIP) is included since no EXR library is vendored;
- proxy texture with a Lanczos-filtered mip chain (proxy.rs:513-554).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _load_image_rgb(path) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return np.asarray(img, np.float32) / 255.0


def load_height_map(path):
    """PNG/JPG -> (flat f32 [h*w], (w, h)) normalized to [-1, 1]
    (wangtile.rs:1856-1896): red channel, vertical flip, min/max normalize."""
    rgb = _load_image_rgb(path)
    h, w = rgb.shape[:2]
    hm = rgb[::-1, :, 0].reshape(-1)  # flip rows (wangtile.rs:1869-1874)
    h_min, h_max = float(hm.min()), float(hm.max())
    rng = (h_max - h_min) or 1.0
    hm = (hm - h_min) / rng * 2.0 - 1.0
    return hm.astype(np.float32), (w, h)


def load_skybox_faces(paths):
    """6 face images (+x,-x,+y,-y,+z,-z order) -> [6, R, R, 3] f32."""
    faces = [_load_image_rgb(p) for p in paths]
    r = faces[0].shape[0]
    assert all(f.shape == (r, r, 3) for f in faces), "faces must be square/equal"
    return np.stack(faces)


# ------------------------------------------------------------------ #
# minimal EXR reader (scanline, half/float, NO/ZIP compression)
# ------------------------------------------------------------------ #
def load_exr(path):
    """Read a scanline EXR into [H, W, 3] float32 (R, G, B channels)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"\x76\x2f\x31\x01":
        raise ValueError("not an EXR file")
    pos = 8

    def read_str():
        nonlocal pos
        end = data.index(b"\x00", pos)
        s = data[pos:end].decode()
        pos = end + 1
        return s

    channels = []
    compression = 0
    dw = None
    while True:
        name = read_str()
        if not name:
            break
        attr_type = read_str()
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        val = data[pos : pos + size]
        pos += size
        if name == "channels":
            cpos = 0
            while val[cpos] != 0:
                cend = val.index(b"\x00", cpos)
                cname = val[cpos:cend].decode()
                (ptype,) = struct.unpack_from("<i", val, cend + 1)
                channels.append((cname, ptype))  # 0=uint,1=half,2=float
                cpos = cend + 1 + 16
        elif name == "compression":
            compression = val[0]
        elif name == "dataWindow":
            dw = struct.unpack("<4i", val)
    if dw is None:
        raise ValueError("EXR missing dataWindow")
    w = dw[2] - dw[0] + 1
    h = dw[3] - dw[1] + 1
    if compression not in (0, 3):  # NO_COMPRESSION, ZIP_COMPRESSION
        raise ValueError(f"unsupported EXR compression {compression}")
    channels.sort(key=lambda c: c[0])  # EXR stores channels alphabetically
    lines_per_block = 1 if compression == 0 else 16

    n_blocks = -(-h // lines_per_block)
    # scanline offset table
    offsets = struct.unpack_from(f"<{n_blocks}Q", data, pos)
    pos += 8 * n_blocks

    out = {c: np.zeros((h, w), np.float32) for c, _ in channels}
    for off in offsets:
        (y0,) = struct.unpack_from("<i", data, off)
        (nbytes,) = struct.unpack_from("<i", data, off + 4)
        block = data[off + 8 : off + 8 + nbytes]
        ny = min(lines_per_block, h - (y0 - dw[1]))
        raw_size = sum(
            (2 if t == 1 else 4) * w for _, t in channels
        ) * ny
        if compression == 3:
            raw = zlib.decompress(block)
            # EXR zip: un-delta then de-interleave
            arr = np.frombuffer(raw, np.uint8).astype(np.int16)
            arr = np.cumsum(
                np.concatenate([arr[:1], (arr[1:] - 128) % 256])
            ).astype(np.uint8)
            half_n = (len(arr) + 1) // 2
            out_b = np.zeros(len(arr), np.uint8)
            out_b[0::2] = arr[:half_n]
            out_b[1::2] = arr[half_n : half_n + len(arr) - half_n]
            raw = out_b.tobytes()
        else:
            raw = block
        assert len(raw) >= raw_size, "EXR block short"
        line_stride = raw_size // ny
        for li in range(ny):
            y = y0 - dw[1] + li
            lpos = li * line_stride
            for cname, ptype in channels:
                if ptype == 1:
                    vals = np.frombuffer(
                        raw, np.float16, count=w, offset=lpos
                    ).astype(np.float32)
                    lpos += 2 * w
                else:
                    vals = np.frombuffer(raw, np.float32, count=w, offset=lpos)
                    lpos += 4 * w
                out[cname][y] = vals
    rgb = np.stack(
        [out.get("R", 0 * out[channels[0][0]]),
         out.get("G", 0 * out[channels[0][0]]),
         out.get("B", 0 * out[channels[0][0]])],
        axis=-1,
    )
    return rgb.astype(np.float32)


def load_skybox_hdri(path):
    """EXR equirect HDRI -> [H, W, 3] float32 radiance (tone mapping happens
    at sampling, matching the bake shader, skybox.wgsl:74-84)."""
    return load_exr(path)


# ------------------------------------------------------------------ #
# proxy texture + Lanczos mip chain (proxy.rs:513-554)
# ------------------------------------------------------------------ #
def _lanczos_kernel(a=3):
    def k(x):
        x = np.asarray(x, np.float64)
        out = np.sinc(x) * np.sinc(x / a)
        return np.where(np.abs(x) < a, out, 0.0)

    return k


def _downsample2_lanczos(img):
    """Halve each axis with a Lanczos-3 filter (separable)."""
    k = _lanczos_kernel(3)
    taps = np.arange(-5, 6)
    w = k((taps + 0.5) / 2.0)
    w = w / w.sum()

    def down_axis(x, axis):
        x = np.moveaxis(x, axis, 0)
        n = x.shape[0]
        idx = np.arange(0, n, 2)[:, None] + taps[None, :]
        idx = np.clip(idx, 0, n - 1)
        out = np.einsum("t,ot...->o...", w, x[idx])
        return np.moveaxis(out, 0, axis)

    return down_axis(down_axis(img, 0), 1).astype(np.float32)


def build_mip_chain(img, max_levels=12):
    """[H, W, 3] -> list of mip levels down to 1x1-ish (proxy.rs:513-554)."""
    img = np.asarray(img, np.float32)
    mips = [img]
    while min(img.shape[0], img.shape[1]) > 1 and len(mips) < max_levels:
        img = _downsample2_lanczos(img)
        mips.append(img)
    return mips


def load_proxy_texture(path):
    """Proxy ground texture + mips; returns (level0 [H,W,3], mip list)."""
    img = _load_image_rgb(path)
    return img, build_mip_chain(img)
