"""The bench scene's textures, path interpolation and user data.

Frozen copies, at commit 6240227d, of:
- ``bench_textures`` from ``gswt_renderer_tpu_torch/benchmarks/headline.py``
  (the skybox's vertical HDR ramp and the proxy ground's checker);
- ``_catmull_rom`` and the interpolation of ``FlyPathControl.handle_events``
  from ``gswt_renderer_tpu_torch/engine/control.py``;
- the user data of ``bench_user_data`` (``headline.py``) and of
  ``dense_row`` (the same map and merge settings), whose numbers are in the
  configuration files.
"""

from __future__ import annotations

import numpy as np


def bench_textures(sky_hw=(64, 128), cells=64, cell=8):
    """The skybox (equirect [H, W, 3], a vertical ramp 0..4 clipped at 4)
    and the proxy ground texture (a checker of `cells` x `cells` cells of
    `cell` texels)."""
    sky = np.clip(
        np.linspace(0, 4, sky_hw[0])[:, None, None]
        * np.ones(tuple(sky_hw) + (3,), np.float32), 0, 4)
    c = np.kron(np.indices((cells, cells)).sum(0) % 2,
                np.ones((cell, cell))).astype(np.float32)
    return sky, np.stack([c * 0.8 + 0.1, c * 0.5 + 0.2, c * 0.3 + 0.1],
                         axis=-1)


def catmull_rom(p0, p1, p2, p3, t):
    t2 = t * t
    t3 = t2 * t
    return 0.5 * (
        2.0 * p1
        + (-p0 + p2) * t
        + (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3) * t2
        + (-p0 + 3.0 * p1 - 3.0 * p2 + p3) * t3
    )


def mirrored_pose(keyframes, t):
    """(position, target) float32 at path time `t` of the leg `keyframes`
    [(time, position, target), ...] (equally spaced) flown forth and back
    without end: keyframe k of the endless path is leg keyframe k mod 2n
    mirrored, and each segment is the Catmull-Rom spline through its two
    neighbours, as FlyPathControl interpolates."""
    n = len(keyframes) - 1
    step = float(keyframes[1][0] - keyframes[0][0])
    k = int(np.floor(t / step))
    frac = t / step - k

    def key(i):
        i %= 2 * n
        return keyframes[i if i <= n else 2 * n - i]

    pts = [key(k + d) for d in (-1, 0, 1, 2)]
    pos = catmull_rom(*[np.asarray(p[1], np.float32) for p in pts], frac)
    tgt = catmull_rom(*[np.asarray(p[2], np.float32) for p in pts], frac)
    return pos.astype(np.float32), tgt.astype(np.float32)
