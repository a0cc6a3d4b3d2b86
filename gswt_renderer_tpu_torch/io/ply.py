"""Splat container, PLY/.splat parsing and 32-byte packing (scene.rs).

The reference supports two serialized PLY layouts:
- INRIA 62-float rows: pos(3) n(3) color(48) alpha(1) scale(3) rot(4)
  (scene.rs:19-26)
- Scaniverse/SPZ 59-float rows: pos(3) scale(3) rot(4) alpha(1) color(48)
  (scene.rs:35-42)

Loading importance-sorts splats by volume*opacity descending (scene.rs:127-147)
then packs each splat into a 32-byte row: pos 3xf32, exp(scale) 3xf32,
RGBA u8 (SH DC via SH_C0, sigmoid opacity), quaternion normalized to 4xu8
(scene.rs:149-211). ``generate_arrays`` replaces scene.rs:306-411's GPU
texture: instead of a 2048-wide Rgba32Uint texture we keep dense arrays
(pos f32[N,3], cov f32[N,6], rgba u8[N,4]) — but the covariance is still
computed from the *quantized* u8 quaternion and stored with f16 rounding and
the x4 scale factor, so values match the reference texture bit-for-bit after
unpacking.
"""

from __future__ import annotations

import io as _io
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

SH_C0 = 0.28209479177387814  # scene.rs:15
MAX_HEADER_LINES = 65  # scene.rs:14

ROW_LENGTH = 32  # bytes per packed splat (scene.rs:154)


def parse_ply_header(data: bytes) -> Tuple[int, int]:
    """Return (header_size_bytes, splat_count) (scene.rs:72-112)."""
    pos = 0
    splat_count = 0
    for _ in range(MAX_HEADER_LINES + 1):
        nl = data.find(b"\n", pos)
        if nl < 0:
            break
        line = data[pos : nl + 1]
        pos = nl + 1
        if line == b"end_header\n":
            return pos, splat_count
        if line.startswith(b"element vertex "):
            splat_count = int(line[15:-1])
    raise ValueError("PLY file is not correctly formatted (no end_header)")


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _f32_to_u8_saturate(x: np.ndarray) -> np.ndarray:
    """Rust `as u8` float->int cast: truncate toward zero, saturate, NaN->0
    (scene.rs:180-182)."""
    x = np.nan_to_num(np.asarray(x, dtype=np.float64), nan=0.0)
    return np.clip(np.trunc(x), 0, 255).astype(np.uint8)


def pack_splats(
    position: np.ndarray,
    log_scale: np.ndarray,
    color_dc: np.ndarray,
    alpha_logit: np.ndarray,
    rotation: np.ndarray,
) -> bytes:
    """Importance-sort and pack raw splat fields into 32-byte rows
    (scene.rs:127-211). Inputs are the *serialized* values: log-scales,
    SH DC color coefficients, pre-sigmoid alpha, unnormalized quaternion."""
    n = position.shape[0]
    scale = np.exp(np.asarray(log_scale, np.float32))
    opacity = _sigmoid(np.asarray(alpha_logit, np.float32))
    # importance = volume * opacity, descending (scene.rs:129-142).
    # NumPy stable argsort on negated keys == Rust sort_by descending for
    # distinct keys; ties keep original order (Rust sort_by is stable too).
    size_list = (scale[:, 0] * scale[:, 1] * scale[:, 2]) * opacity
    order = np.argsort(-size_list, kind="stable")

    pos = np.asarray(position, np.float32)[order]
    scl = scale[order]
    col = np.asarray(color_dc, np.float32)[order]
    op = opacity[order]
    rot = np.asarray(rotation, np.float32)[order]

    rgba = np.empty((n, 4), np.uint8)
    rgba[:, 0] = _f32_to_u8_saturate((0.5 + SH_C0 * col[:, 0]) * 255.0)
    rgba[:, 1] = _f32_to_u8_saturate((0.5 + SH_C0 * col[:, 1]) * 255.0)
    rgba[:, 2] = _f32_to_u8_saturate((0.5 + SH_C0 * col[:, 2]) * 255.0)
    rgba[:, 3] = _f32_to_u8_saturate(op * 255.0)

    qlen = np.sqrt(np.sum(rot.astype(np.float64) ** 2, axis=1))
    qlen = np.where(qlen == 0, 1.0, qlen)
    rot_u8 = _f32_to_u8_saturate(
        ((rot / qlen[:, None]).astype(np.float32) + 1.0) * 0.5 * 255.0
    )

    buf = np.empty((n, ROW_LENGTH), np.uint8)
    buf[:, 0:12] = pos.astype("<f4").view(np.uint8).reshape(n, 12)
    buf[:, 12:24] = scl.astype("<f4").view(np.uint8).reshape(n, 12)
    buf[:, 24:28] = rgba
    buf[:, 28:32] = rot_u8
    return buf.tobytes()


@dataclass
class Scene:
    """A point cloud of Gaussian splats over its packed 32-byte buffer
    (scene.rs:50-57). ``buffer`` uses the reference's exact layout so .splat
    files round-trip; the derived arrays live in ``pos``/``cov``/``rgba``."""

    splat_count: int = 0
    buffer: bytes = b""

    # generated by generate_arrays (lazy)
    pos: Optional[np.ndarray] = None   # f32 [N,3]
    cov: Optional[np.ndarray] = None   # f32 [N,6] upper-tri of 4*Sigma, f16-rounded
    rgba: Optional[np.ndarray] = None  # u8  [N,4]

    # --- construction ------------------------------------------------------
    @staticmethod
    def from_ply_bytes(data: bytes) -> "Scene":
        header_size, count = parse_ply_header(data)
        body = np.frombuffer(data, dtype=np.uint8, offset=header_size)
        n62 = count * 62 * 4
        n59 = count * 59 * 4
        if len(body) >= n62:
            f = np.frombuffer(body[:n62].tobytes(), dtype="<f4").reshape(count, 62)
            pos, col, alpha = f[:, 0:3], f[:, 6:9], f[:, 54]
            scale, rot = f[:, 55:58], f[:, 58:62]
        elif len(body) >= n59:
            # Scaniverse / SPZ layout (scene.rs:35-42)
            f = np.frombuffer(body[:n59].tobytes(), dtype="<f4").reshape(count, 59)
            pos, scale, rot = f[:, 0:3], f[:, 3:6], f[:, 6:10]
            alpha, col = f[:, 10], f[:, 11:14]
        else:
            raise ValueError("PLY body too short for either splat layout")
        buf = pack_splats(pos, scale, col, alpha, rot)
        return Scene(splat_count=count, buffer=buf)

    @staticmethod
    def from_splat_bytes(data: bytes) -> "Scene":
        """.splat files are already 32-byte packed rows (scene.rs:920-922)."""
        return Scene(splat_count=len(data) // ROW_LENGTH, buffer=bytes(data))

    # --- views over the packed buffer --------------------------------------
    def _f32_view(self) -> np.ndarray:
        return np.frombuffer(self.buffer, dtype="<f4").reshape(self.splat_count, 8)

    def _u8_view(self) -> np.ndarray:
        return np.frombuffer(self.buffer, dtype=np.uint8).reshape(self.splat_count, 32)

    def positions(self) -> np.ndarray:
        return self._f32_view()[:, 0:3]

    def scales(self) -> np.ndarray:
        return self._f32_view()[:, 3:6]

    def colors_u8(self) -> np.ndarray:
        return self._u8_view()[:, 24:28]

    def quats_u8(self) -> np.ndarray:
        return self._u8_view()[:, 28:32]

    # --- derived arrays (scene.rs:306-411) ----------------------------------
    def generate_arrays(self):
        """Compute pos/cov/rgba arrays. The covariance is R S S^T R^T built
        from the u8-dequantized quaternion (scene.rs:360-398), scaled x4 and
        rounded through f16 exactly like pack_half_2x16 (scene.rs:403-405)."""
        n = self.splat_count
        if n == 0:
            self.pos = np.zeros((0, 3), np.float32)
            self.cov = np.zeros((0, 6), np.float32)
            self.rgba = np.zeros((0, 4), np.uint8)
            return self
        f = self._f32_view()
        self.pos = np.ascontiguousarray(f[:, 0:3])
        self.rgba = np.ascontiguousarray(self.colors_u8())

        scale = f[:, 3:6]
        q = self.quats_u8().astype(np.float32) / 255.0 * 2.0 - 1.0  # w,x,y,z
        w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
        # Rotation matrix entries (math layout), scene.rs:369-380
        r00 = 1.0 - 2.0 * (y * y + z * z)
        r01 = 2.0 * (x * y - w * z)
        r02 = 2.0 * (x * z + w * y)
        r10 = 2.0 * (x * y + w * z)
        r11 = 1.0 - 2.0 * (x * x + z * z)
        r12 = 2.0 * (y * z - w * x)
        r20 = 2.0 * (x * z - w * y)
        r21 = 2.0 * (y * z + w * x)
        r22 = 1.0 - 2.0 * (x * x + y * y)
        # M = R * S; Sigma = M M^T (scene.rs:384-398)
        m00, m01, m02 = r00 * scale[:, 0], r01 * scale[:, 1], r02 * scale[:, 2]
        m10, m11, m12 = r10 * scale[:, 0], r11 * scale[:, 1], r12 * scale[:, 2]
        m20, m21, m22 = r20 * scale[:, 0], r21 * scale[:, 1], r22 * scale[:, 2]
        s00 = m00 * m00 + m01 * m01 + m02 * m02
        s01 = m00 * m10 + m01 * m11 + m02 * m12
        s02 = m00 * m20 + m01 * m21 + m02 * m22
        s11 = m10 * m10 + m11 * m11 + m12 * m12
        s12 = m10 * m20 + m11 * m21 + m12 * m22
        s22 = m20 * m20 + m21 * m21 + m22 * m22
        cov = np.stack([s00, s01, s02, s11, s12, s22], axis=1) * 4.0
        # f16 round-trip matches pack_half_2x16 storage (scene.rs:403-405)
        self.cov = cov.astype(np.float16).astype(np.float32)
        return self

    # --- scene ops (scene.rs:801-873) ---------------------------------------
    def merge(self, other: "Scene"):
        self.buffer = self.buffer + other.buffer
        self.splat_count += other.splat_count
        return self

    def translate(self, offset) -> "Scene":
        arr = np.frombuffer(self.buffer, dtype=np.uint8).reshape(-1, 32).copy()
        f = arr[:, 0:12].view("<f4").reshape(-1, 3)
        f += np.asarray(offset, np.float32)
        self.buffer = arr.tobytes()
        self.pos = None  # invalidate derived arrays
        return self

    def translated(self, offset) -> "Scene":
        s = Scene(self.splat_count, self.buffer)
        return s.translate(offset)

    def compute_aabb_and_center(self):
        p = self.positions()
        aabb = (p.min(axis=0).copy(), p.max(axis=0).copy())
        center = (p.astype(np.float64).sum(axis=0) / self.splat_count).astype(np.float32)
        return aabb, center

    def compute_scale_sum(self) -> float:
        return float(self.scales().astype(np.float64).sum())


def load_ply(path_or_bytes) -> Scene:
    data = path_or_bytes
    if not isinstance(data, (bytes, bytearray)):
        with open(path_or_bytes, "rb") as fh:
            data = fh.read()
    return Scene.from_ply_bytes(bytes(data))


def load_splat_bytes(data: bytes) -> Scene:
    return Scene.from_splat_bytes(data)
