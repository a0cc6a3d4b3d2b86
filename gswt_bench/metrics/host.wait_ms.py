"""host.wait_ms: the render thread's waits for the device per frame: the
HOST_PROF self time of every sync.* section and of render.drain."""


def read(ctx):
    hp = ctx["win"]["host_prof"]
    if not hp or not ctx["n_frames"]:
        return None
    total = sum(v[2] for k, v in hp.items() if k.startswith("sync.") or k == "render.drain")
    return total / ctx["n_frames"] * 1e3
