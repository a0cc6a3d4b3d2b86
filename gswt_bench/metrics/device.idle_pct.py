"""device.idle_pct: the traced slice's time with no device operation
running, over the slice from its first operation's start to its last
one's end (torch.profiler)."""


def read(ctx):
    dev = ctx["device"]
    if not dev or dev["window_s"] <= 0:
        return None
    return (1.0 - dev["busy_s"] / dev["window_s"]) * 100.0
