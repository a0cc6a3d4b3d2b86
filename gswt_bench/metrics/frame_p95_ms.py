"""frame_p95_ms: the 95th percentile of the gaps between successive
Engine.frame() returns over every frame of the window, the first gap from
the window's start (host clock)."""

import numpy as np


def read(ctx):
    w = ctx["win"]
    if not ctx["n_frames"]:
        return None
    gaps = np.diff(np.concatenate([[w["t_start"]], w["ret"]]))
    return float(np.percentile(gaps, 95)) * 1e3
