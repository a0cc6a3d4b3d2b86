"""Headless rendering utilities: PNG writing + fly-path frame dumps.

The reference is an interactive browser app; the port's primary surfaces
are headless (benchmarks, dataset generation) plus the HTTP viewer
(viewer/server.py) for interactive fly-through. Numpy only, as in the JAX
package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path, img):
    """Write [H,W,3|4] float (0..1) or uint8 image as PNG (no deps)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    h, w = img.shape[:2]
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    channels = img.shape[2]
    color_type = {3: 2, 4: 6}[channels]
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)
    return path


def render_flypath_frames(engine, fly_path, out_dir, fps=10.0, max_frames=1000):
    """Replay a fly path at fixed timesteps, writing frame_%04d.png files.
    Drives the path by explicit timestamps (deterministic, not wall-clock)."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    engine.camera_control = "keyboard"  # manual camera driving below
    fly_path.reset_path()
    fly_path.start_path()
    t_end = fly_path.keyframes[-1].timestamp
    n = min(int(t_end * fps), max_frames)
    paths = []
    for i in range(n):
        t_ms = i / fps * 1000.0
        fly_path.handle_events(engine.camera, now_ms=t_ms)
        img = engine.frame(update_worker=True, readback=True)
        if img is None:
            continue
        p = os.path.join(out_dir, f"frame_{i:04d}.png")
        write_png(p, img[..., :3])
        paths.append(p)
    return paths
