"""latency_p95_ms: the 95th percentile, over every frame of the window, of
the time from entering Engine.frame() (where the camera pose is taken) to
the device completing the frame's last operation. Completion is a CUDA
event recorded on the frame's stream after frame() returns, placed on the
host clock through an anchor event taken at a synchronised point before
the window. Without a card (tests) a frame is complete when it returns."""

import numpy as np


def read(ctx):
    w = ctx["win"]
    if not ctx["n_frames"]:
        return None
    done = w["done"] if w["done"] is not None else w["ret"]
    return float(np.percentile(done - w["enter"], 95)) * 1e3
