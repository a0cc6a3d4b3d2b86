"""device.launches_per_frame: kernels in the traced slice over the frames
dispatched while it was traced (torch.profiler)."""


def read(ctx):
    dev = ctx["device"]
    a, b = ctx["win"]["prof_frames"]
    if not dev or a is None or b is None or b <= a:
        return None
    return dev["kernels"] / (b - a)
