"""Perspective camera with the reference's exact conventions (camera.rs).

Position/target/up + cgmath-style perspective; pitch/yaw rotate the target in
view space (camera.rs:137-155). ``CameraUniforms`` reproduces camera.rs:168-189:
fx = |0.5*P00*w|, fy = |-0.5*P11*h|, htany = tan(fovy/2), htanx = htany*w/h.
"""

from __future__ import annotations

import numpy as np

from .mathutil import look_at_rh, perspective, normalize, rodrigues


class Camera:
    def __init__(self, viewport_wh, position, target, up, fovy_rad, z_near, z_far):
        self.viewport = (int(viewport_wh[0]), int(viewport_wh[1]))
        self.fovy = float(fovy_rad)
        self.z_near = float(z_near)
        self.z_far = float(z_far)
        self.position = np.asarray(position, np.float32)
        self.target = np.asarray(target, np.float32)
        self.up = np.asarray(up, np.float32)
        self._update_view()
        self._update_proj()

    @staticmethod
    def default(viewport_wh=(1920, 1080)) -> "Camera":
        """Startup camera (state.rs:114-122): pos (0,0,5) looking +y, up +z,
        fovy 45deg, near 0.1, far 2400."""
        return Camera(
            viewport_wh,
            position=(0.0, 0.0, 5.0),
            target=(0.0, 1.0, 5.0),
            up=(0.0, 0.0, 1.0),
            fovy_rad=np.deg2rad(45.0),
            z_near=0.1,
            z_far=2400.0,
        )

    # --- state -------------------------------------------------------------
    def _update_view(self):
        self.view = look_at_rh(self.position, self.target, self.up)

    def _update_proj(self):
        w, h = self.viewport
        self.projection = perspective(self.fovy, w / h, self.z_near, self.z_far)

    def set_view(self, position, target, up):
        self.position = np.asarray(position, np.float32)
        self.target = np.asarray(target, np.float32)
        self.up = np.asarray(up, np.float32)
        self._update_view()

    def set_viewport(self, width: int, height: int):
        self.viewport = (int(width), int(height))
        self._update_proj()

    def view_proj(self) -> np.ndarray:
        return (self.projection @ self.view).astype(np.float32)

    def view_direction(self) -> np.ndarray:
        return normalize(self.target - self.position)

    def right_direction(self) -> np.ndarray:
        return np.cross(self.view_direction(), self.up)

    def translate(self, change):
        change = np.asarray(change, np.float32)
        self.set_view(self.position + change, self.target + change, self.up)

    # --- rotations (camera.rs:137-155) ------------------------------------
    def _rotate_target_view_space(self, rot4: np.ndarray):
        inv_view = np.linalg.inv(self.view)
        t = np.append(self.target, 1.0).astype(np.float32)
        new_t = (inv_view @ rot4 @ self.view @ t)[:3]
        return new_t

    def pitch(self, delta_rad: float):
        r = np.eye(4, dtype=np.float32)
        r[:3, :3] = rodrigues(np.array([1.0, 0.0, 0.0]), delta_rad)
        new_target = self._rotate_target_view_space(r)
        # guard against gimbal flip (camera.rs:143)
        d = normalize(new_target - self.position)
        if abs(float(np.dot(d, self.up))) < 0.999:
            self.set_view(self.position, new_target, self.up)

    def yaw(self, delta_rad: float):
        r = np.eye(4, dtype=np.float32)
        r[:3, :3] = rodrigues(np.array([0.0, 1.0, 0.0]), delta_rad)
        new_target = self._rotate_target_view_space(r)
        self.set_view(self.position, new_target, self.up)


class CameraUniforms:
    """Per-frame camera constants fed to the projection kernel
    (camera.rs:160-189)."""

    def __init__(self, cam: Camera):
        w, h = cam.viewport
        self.projection = cam.projection.copy()
        self.view = cam.view.copy()
        fx = 0.5 * cam.projection[0, 0] * w
        fy = -0.5 * cam.projection[1, 1] * h
        self.focal = np.array([abs(fx), abs(fy)], np.float32)
        self.viewport = np.array([w, h], np.float32)
        htany = np.tan(cam.fovy / 2.0)
        htanx = htany / h * w
        self.htan_fov = np.array([htanx, htany], np.float32)
        self.cam_pos = cam.position.copy()
