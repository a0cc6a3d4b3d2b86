"""frame_ms: the window's wall time, ending after the final drain, over
the frames completed in it (host clock)."""


def read(ctx):
    w = ctx["win"]
    if not ctx["n_frames"]:
        return None
    return (w["t_end"] - w["t_start"]) / ctx["n_frames"] * 1e3
