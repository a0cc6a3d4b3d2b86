"""Camera controllers (control.rs): keyboard fly + scripted fly path.

KeyboardFlyControl reproduces control.rs:15-292: WASD/R/F movement with
per-axis acceleration/deceleration scaled by frame time (min 10 ms), IJKL
look, Space sprint, z-locked horizontal movement, optional orbit-lock around
the origin. FlyPathControl reproduces control.rs:294-579: timestamped
keyframes, Catmull-Rom interpolation with endpoint extrapolation, JSON
save/load in the reference's exact schema (FlyPathFrameJSON field names), and
drives the benchmark harness.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from ..core.camera import Camera
from ..core.mathutil import normalize, rotation_between
from ..core.metrics import Timer

# key slots (control.rs:90-127)
MOVE_KEYS = {"w": 0, "s": 1, "a": 2, "d": 3, "r": 4, "f": 5}
ROT_KEYS = {"i": 0, "k": 1, "j": 2, "l": 3}


class KeyboardFlyControl:
    def __init__(self):
        # control.rs:35-39
        self.max_speed = 0.002
        self.max_speed_sprint = 0.005
        self.acc = 0.00001
        self.acc_sprint = 0.0001
        self.rot_speed = 0.001
        self.speed = [0.0] * 6
        self.moving = [False] * 6
        self.rotating = [False] * 4
        self.sprinting = False

    def handle_key(self, key: str, pressed: bool):
        key = key.lower()
        if key in MOVE_KEYS:
            self.moving[MOVE_KEYS[key]] = pressed
        elif key in ROT_KEYS:
            self.rotating[ROT_KEYS[key]] = pressed
        elif key == " " or key == "space":
            self.sprinting = pressed

    def _handle_speed(self, i, moving, frame_time):
        # control.rs:47-75
        frame_time = max(frame_time, 10.0)
        v = self.speed[i]
        if moving:
            if self.sprinting:
                v = min(v + self.acc_sprint * frame_time, self.max_speed_sprint) \
                    if v < self.max_speed_sprint else self.max_speed_sprint
            else:
                v = v + self.acc * frame_time if v < self.max_speed else self.max_speed
        else:
            if v > self.max_speed:
                v -= self.acc_sprint * frame_time
            elif v > 0.0:
                v -= self.acc * frame_time
            else:
                v = 0.0
        self.speed[i] = v

    def rotate_around(self, cam: Camera, center, d_forward, d_right):
        # control.rs:77-87
        center = np.asarray(center, np.float32)
        up = normalize(cam.position - center)
        right = normalize(np.cross(cam.view_direction(), up))
        fwd = normalize(np.cross(up, right))
        new_up = normalize(
            cam.position - center + fwd * d_forward + right * d_right
        )
        rot = rotation_between(up, new_up)
        new_pos = rot @ (cam.position - center) + center
        new_target = rot @ (cam.target - center) + center
        cam.set_view(new_pos, new_target, new_up)

    def update(self, cam: Camera, frame_time: float, lock_center: bool = False):
        # control.rs:168-291
        for i in range(6):
            self._handle_speed(i, self.moving[i], frame_time)

        def horiz(vec):
            v = vec.copy()
            v[2] = 0.0
            return normalize(v)

        if self.speed[0] > 0.0:  # forward
            delta = self.speed[0] * frame_time
            if lock_center:
                self.rotate_around(cam, [0, 0, 0], delta, 0.0)
            else:
                cam.translate(horiz(cam.view_direction()) * delta)
        if self.speed[1] > 0.0:  # backward
            delta = -self.speed[1] * frame_time
            if lock_center:
                self.rotate_around(cam, [0, 0, 0], delta, 0.0)
            else:
                cam.translate(horiz(cam.view_direction()) * delta)
        if self.speed[2] > 0.0:  # left
            delta = -self.speed[2] * frame_time
            if lock_center:
                self.rotate_around(cam, [0, 0, 0], 0.0, delta)
            else:
                cam.translate(horiz(cam.right_direction()) * delta)
        if self.speed[3] > 0.0:  # right
            delta = self.speed[3] * frame_time
            if lock_center:
                self.rotate_around(cam, [0, 0, 0], 0.0, delta)
            else:
                cam.translate(horiz(cam.right_direction()) * delta)
        if self.speed[4] > 0.0:  # up
            cam.translate(cam.up * self.speed[4] * frame_time)
        if self.speed[5] > 0.0:  # down
            cam.translate(cam.up * -self.speed[5] * frame_time)

        if self.rotating[0]:
            cam.pitch(self.rot_speed * frame_time)
        if self.rotating[1]:
            cam.pitch(-self.rot_speed * frame_time)
        if self.rotating[2]:
            cam.yaw(self.rot_speed * frame_time)
        if self.rotating[3]:
            cam.yaw(-self.rot_speed * frame_time)
        return True


@dataclass
class FlyPathFrame:
    timestamp: float = 0.0
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    target: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    up: np.ndarray = field(default_factory=lambda: np.array([0, 0, 1], np.float32))


def _catmull_rom(p0, p1, p2, p3, t):
    # control.rs:502-506
    t2 = t * t
    t3 = t2 * t
    return 0.5 * (
        2.0 * p1
        + (-p0 + p2) * t
        + (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3) * t2
        + (-p0 + 3.0 * p1 - 3.0 * p2 + p3) * t3
    )


class FlyPathControl:
    def __init__(self):
        self.keyframes: list[FlyPathFrame] = []
        self.timer = Timer()
        self.ready = False
        self.finished = False
        self._cur = 0
        self._refresh = False

    def reset_path(self):
        # control.rs:428-447
        self.timer.reset()
        self._cur = 0
        if len(self.keyframes) >= 2:
            self.ready = True
            self._refresh = True
        else:
            self.ready = False
            self._refresh = False
        self.finished = False

    def start_path(self):
        self.timer.start()

    def pause_path(self):
        self.timer.pause()

    def handle_events(self, cam: Camera, now_ms: float | None = None) -> bool:
        # control.rs:459-532
        if not self.ready:
            return False
        if self._refresh:
            self._refresh = False
        elif self.timer.is_paused:
            return False

        ela = (self.timer.elapsed() if now_ms is None else now_ms) / 1000.0
        if ela >= self.keyframes[-1].timestamp:
            self.pause_path()
            self.finished = True
            return False

        if ela >= self.keyframes[self._cur + 1].timestamp:
            self._cur += 1
        fi = self._cur
        kf = self.keyframes
        t = (ela - kf[fi].timestamp) / (kf[fi + 1].timestamp - kf[fi].timestamp)

        def seg(attr):
            arr = [getattr(k, attr) for k in kf]
            p1 = arr[fi]
            p2 = arr[fi + 1]
            p0 = arr[0] * 2.0 - arr[1] if fi == 0 else arr[fi - 1]
            p3 = (
                arr[fi + 1] * 2.0 - arr[fi]
                if fi + 2 >= len(arr)
                else arr[fi + 2]
            )
            return _catmull_rom(p0, p1, p2, p3, t)

        pos = seg("position")
        target = seg("target")
        cam.set_view(pos, target, np.array([0, 0, 1], np.float32))
        return True

    # --- JSON round trip, schema-compatible with the reference
    #     (control.rs:383-405) ---
    def to_json(self) -> str:
        return json.dumps(
            [
                dict(
                    timestamp=float(k.timestamp),
                    position_x=float(k.position[0]),
                    position_y=float(k.position[1]),
                    position_z=float(k.position[2]),
                    target_x=float(k.target[0]),
                    target_y=float(k.target[1]),
                    target_z=float(k.target[2]),
                )
                for k in self.keyframes
            ],
            indent=2,
        )

    @staticmethod
    def from_json(s: str) -> "FlyPathControl":
        data = json.loads(s)
        fp = FlyPathControl()
        for d in data:
            fp.keyframes.append(
                FlyPathFrame(
                    timestamp=float(d["timestamp"]),
                    position=np.array(
                        [d["position_x"], d["position_y"], d["position_z"]],
                        np.float32,
                    ),
                    target=np.array(
                        [d["target_x"], d["target_y"], d["target_z"]], np.float32
                    ),
                )
            )
        fp.reset_path()
        return fp
