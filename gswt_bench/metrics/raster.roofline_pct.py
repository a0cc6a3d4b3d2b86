"""raster.roofline_pct: the compositor kernel (raster_kernel) against its
bound, over the judged frames of the traced slice: the sum of their bounds
(frozen/peaks.py, from each frame's kept pair-pixels as the reference
counts them, the rows of the splats that have one, the output and the
depth) over the sum of their raster kernels' device times."""


def read(ctx):
    dev = ctx["device"]
    first = ctx["win"]["prof_frames"][0]
    if not dev or first is None:
        return None
    raster = dev.get("raster_s", [])
    bound = took = 0.0
    for idx, b in zip(ctx["judged"], ctx["bounds"]):
        k = idx - first
        if 0 <= k < len(raster):
            bound += b
            took += raster[k]
    if took <= 0 or bound <= 0:
        return None
    return bound / took * 100.0
