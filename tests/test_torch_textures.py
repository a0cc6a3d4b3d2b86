"""The port's own copy of io/textures.py against the JAX package's JAX-free
original, on the same files and arrays: every loader and the Lanczos mip
chain give identical arrays (the copy is the same numpy code)."""

import struct

import numpy as np
import pytest

from gswt_renderer_tpu.io import textures as jtx
from gswt_renderer_tpu.viewer.headless import write_png
from gswt_renderer_tpu_torch.io import textures as ttx


@pytest.mark.parametrize("size", [(64, 64), (32, 48), (5, 7)])
def test_build_mip_chain_equal(size):
    rng = np.random.default_rng(0)
    img = rng.uniform(size=size + (3,)).astype(np.float32)
    a = jtx.build_mip_chain(img)
    b = ttx.build_mip_chain(img)
    assert len(a) == len(b) and len(a) >= 2
    for la, lb in zip(a, b):
        np.testing.assert_array_equal(la, lb)
    assert min(b[-1].shape[:2]) == 1


def test_image_loaders_equal(tmp_path):
    pytest.importorskip("PIL")
    rng = np.random.default_rng(1)
    img = rng.uniform(size=(8, 16, 3)).astype(np.float32)
    path = write_png(tmp_path / "h.png", img)
    ha, wha = jtx.load_height_map(path)
    hb, whb = ttx.load_height_map(path)
    assert wha == whb == (16, 8)
    np.testing.assert_array_equal(ha, hb)
    paths = [write_png(tmp_path / f"f{i}.png",
                       np.full((8, 8, 3), i / 6.0, np.float32))
             for i in range(6)]
    np.testing.assert_array_equal(jtx.load_skybox_faces(paths),
                                  ttx.load_skybox_faces(paths))
    (img_a, mips_a), (img_b, mips_b) = (jtx.load_proxy_texture(path),
                                        ttx.load_proxy_texture(path))
    np.testing.assert_array_equal(img_a, img_b)
    assert len(mips_a) == len(mips_b)
    for la, lb in zip(mips_a, mips_b):
        np.testing.assert_array_equal(la, lb)


def _write_float_exr(path, rgb):
    """Uncompressed scanline EXR (float channels B, G, R)."""
    h, w = rgb.shape[:2]
    out = bytearray(struct.pack("<II", 20000630, 2))

    def attr(name, typ, data):
        out.extend(name.encode() + b"\0" + typ.encode() + b"\0")
        out.extend(struct.pack("<I", len(data)) + data)

    ch = b"".join(c + b"\0" + struct.pack("<IBBBBii", 2, 0, 0, 0, 0, 1, 1)
                  for c in (b"B", b"G", b"R")) + b"\0"
    attr("channels", "chlist", ch)
    attr("compression", "compression", b"\0")
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    attr("dataWindow", "box2i", box)
    attr("displayWindow", "box2i", box)
    attr("lineOrder", "lineOrder", b"\0")
    attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    out.extend(b"\0")
    row_bytes = 3 * w * 4
    first = len(out) + 8 * h
    for y in range(h):
        out.extend(struct.pack("<Q", first + y * (8 + row_bytes)))
    for y in range(h):
        out.extend(struct.pack("<iI", y, row_bytes))
        for c in (2, 1, 0):
            out.extend(rgb[y, :, c].astype("<f4").tobytes())
    path.write_bytes(bytes(out))
    return str(path)


def test_exr_reader_equal(tmp_path):
    rng = np.random.default_rng(2)
    rgb = rng.uniform(0.0, 8.0, (6, 12, 3)).astype(np.float32)
    path = _write_float_exr(tmp_path / "sky.exr", rgb)
    a = jtx.load_exr(path)
    b = ttx.load_exr(path)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(b, rgb, rtol=0, atol=0)
    np.testing.assert_array_equal(jtx.load_skybox_hdri(path),
                                  ttx.load_skybox_hdri(path))
