"""Camera / matrix math compatible with the reference's cgmath conventions.

All matrices here are *mathematical* (row index = row), stored row-major in
float32 NumPy arrays, so ``M @ v`` matches cgmath's ``M * v``. The reference
flattens cgmath matrices column-major (``view_proj[col][row]``); helpers below
produce those flattened views where the reference indexes them directly
(e.g. the depth key uses vp[2], vp[6], vp[10] = third *row*, scene.rs:459-461).
"""

from __future__ import annotations

import numpy as np

# WebGPU clip-space remap applied in the vertex shader (gswt.wgsl:152-157):
# z' = 0.5 z + 0.5 w (OpenGL [-1,1] depth -> WebGPU [0,1]).
OPENGL_TO_WGPU = np.array(
    [
        [1.0, 0.0, 0.0, 0.0],
        [0.0, 1.0, 0.0, 0.0],
        [0.0, 0.0, 0.5, 0.5],
        [0.0, 0.0, 0.0, 1.0],
    ],
    dtype=np.float32,
)


def normalize(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, dtype=np.float32)
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def look_at_rh(eye, center, up) -> np.ndarray:
    """Right-handed look-at view matrix, identical to cgmath::Matrix4::look_at_rh
    (used at camera.rs:94-98 and for the 9 presort views, wangtile.rs:162-173)."""
    eye = np.asarray(eye, dtype=np.float32)
    f = normalize(np.asarray(center, dtype=np.float32) - eye)
    s = normalize(np.cross(f, np.asarray(up, dtype=np.float32)))
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective(fovy_rad: float, aspect: float, near: float, far: float) -> np.ndarray:
    """OpenGL-style perspective projection, identical to cgmath::perspective
    (camera.rs:115-120; the shader remaps depth to WebGPU, gswt.wgsl:152-160)."""
    f = 1.0 / np.tan(fovy_rad / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = (2.0 * far * near) / (near - far)
    m[3, 2] = -1.0
    return m


def colmajor_flat(m: np.ndarray) -> np.ndarray:
    """Flatten a math matrix the way cgmath lays it out in memory
    ([col0.xyzw, col1.xyzw, ...]); this is the 16-float slice the reference
    passes to its sorters (wangtile.rs:184-201)."""
    return np.asarray(m, dtype=np.float32).T.reshape(-1)


def vp_z_row(view_proj: np.ndarray) -> np.ndarray:
    """Third row (z row) of a view-projection matrix: the depth-key direction
    (vp[2], vp[6], vp[10] in the reference's column-major flattening,
    scene.rs:459-461)."""
    return np.asarray(view_proj, dtype=np.float32)[2, :3].copy()


def quat_to_mat3(w: float, x: float, y: float, z: float) -> np.ndarray:
    """Rotation matrix from quaternion using the exact expansion in
    scene.rs:369-380 (column-major there; returned as a math matrix here)."""
    return np.array(
        [
            [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z), 2.0 * (x * z + w * y)],
            [2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - w * x)],
            [2.0 * (x * z - w * y), 2.0 * (y * z + w * x), 1.0 - 2.0 * (x * x + y * y)],
        ],
        dtype=np.float32,
    )


def pack_half_2x16(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Two f32 -> one u32 holding two f16s, low half = x (utils.rs:68-73)."""
    xb = np.asarray(x, dtype=np.float16).view(np.uint16).astype(np.uint32)
    yb = np.asarray(y, dtype=np.float16).view(np.uint16).astype(np.uint32)
    return xb | (yb << np.uint32(16))


def unpack_half_2x16(v: np.ndarray):
    """Inverse of pack_half_2x16 (gswt.wgsl:496-500)."""
    v = np.asarray(v, dtype=np.uint32)
    lo = (v & np.uint32(0xFFFF)).astype(np.uint16).view(np.float16).astype(np.float32)
    hi = ((v >> np.uint32(16)) & np.uint32(0xFFFF)).astype(np.uint16).view(np.float16).astype(np.float32)
    return lo, hi


def rotation_between(source_dir: np.ndarray, target_dir: np.ndarray) -> np.ndarray:
    """Shortest-arc rotation taking source_dir to target_dir, as
    cgmath::Basis3::between_vectors (control.rs:582-586). Returns a 3x3."""
    a = normalize(source_dir)
    b = normalize(target_dir)
    c = float(np.dot(a, b))
    if c > 1.0 - 1e-12:
        return np.eye(3, dtype=np.float32)
    if c < -1.0 + 1e-12:
        # 180 degrees: rotate around any orthogonal axis
        axis = np.cross(a, np.array([1.0, 0.0, 0.0], dtype=np.float32))
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross(a, np.array([0.0, 1.0, 0.0], dtype=np.float32))
        axis = normalize(axis)
        return rodrigues(axis, np.pi)
    axis = np.cross(a, b)
    s = np.linalg.norm(axis)
    return rodrigues(axis / s, float(np.arctan2(s, c)))


def rodrigues(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = normalize(axis)
    kx, ky, kz = (float(axis[0]), float(axis[1]), float(axis[2]))
    k = np.array([[0, -kz, ky], [kz, 0, -kx], [-ky, kx, 0]], dtype=np.float32)
    return (np.eye(3, dtype=np.float32) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)).astype(np.float32)
