"""The reference camera: view, projection and the shader's camera constants.

The arithmetic of ``look_at_rh``, ``perspective`` (cgmath's, camera.rs) and
``CameraUniforms`` (camera.rs:160-189), as frozen at commit 6240227d in
``gswt_renderer_tpu_torch/core/{mathutil,camera}.py``; the startup camera's
fovy 45 degrees, near 0.1, far 2400 and up +z (state.rs:114-122).
"""

from __future__ import annotations

import numpy as np

FOVY_DEG = 45.0
Z_NEAR = 0.1
Z_FAR = 2400.0
UP = np.array([0.0, 0.0, 1.0], np.float32)
# the startup camera's position (state.rs:114-122): the first build's pose
STARTUP_POSITION = (0.0, 0.0, 5.0)

# OpenGL clip depth to WebGPU's [0, 1] (gswt.wgsl:152-160)
OPENGL_TO_WGPU = np.array([[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0],
                           [0.0, 0.0, 0.5, 0.5], [0.0, 0.0, 0.0, 1.0]],
                          np.float32)


def _normalize(v):
    v = np.asarray(v, np.float32)
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def look_at_rh(eye, center, up):
    eye = np.asarray(eye, np.float32)
    f = _normalize(np.asarray(center, np.float32) - eye)
    s = _normalize(np.cross(f, np.asarray(up, np.float32)))
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective(fovy_rad, aspect, near, far):
    f = 1.0 / np.tan(fovy_rad / 2.0)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = (2.0 * far * near) / (near - far)
    m[3, 2] = -1.0
    return m


def camera(position, target, width, height) -> dict:
    """The shader's camera constants for a pose: projection, view, focal,
    htan_fov, cam_pos (numpy float32)."""
    fovy = float(np.deg2rad(FOVY_DEG))
    proj = perspective(fovy, width / height, Z_NEAR, Z_FAR)
    view = look_at_rh(position, target, UP)
    fx = 0.5 * proj[0, 0] * width
    fy = -0.5 * proj[1, 1] * height
    htany = np.tan(fovy / 2.0)
    return dict(
        projection=proj, view=view,
        focal=np.array([abs(fx), abs(fy)], np.float32),
        htan_fov=np.array([htany / height * width, htany], np.float32),
        cam_pos=np.asarray(position, np.float32).copy(),
    )
