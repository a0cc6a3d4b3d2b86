"""proxy.host_ms: the render thread's host time in the proxy ground pass per
frame: the HOST_PROF total (its own time with that of the sections nested
in it, render.front.proxy.raster and .shade where the program has them) of
the section render.front.proxy over the window's frames (the profiler on
for the whole traced window). Nothing where no frame drew the ground."""


def read(ctx):
    hp = ctx["win"]["host_prof"]
    if not hp or not ctx["n_frames"] or "render.front.proxy" not in hp:
        return None
    return hp["render.front.proxy"][1] / ctx["n_frames"] * 1e3
