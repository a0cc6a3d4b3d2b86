"""host.dispatch_ms: the render thread's host-section time per frame
(HOST_PROF self times, the profiler on for the whole traced window),
without the waits for the device (sync.*, render.drain) and without the
builder thread's sections (stage.*)."""


def read(ctx):
    hp = ctx["win"]["host_prof"]
    if not hp or not ctx["n_frames"]:
        return None
    total = sum(v[2] for k, v in hp.items()
                if not (k.startswith("sync.") or k.startswith("stage.") or k == "render.drain"))
    return total / ctx["n_frames"] * 1e3
