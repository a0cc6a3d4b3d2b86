"""builder.sort_ms: Engine.sort_time_ma at the window's end, cleared at its
start: the mean of the window's last (up to 200) sorts on the builder
thread. Nothing to read where the window re-sorted nothing."""


def read(ctx):
    return ctx["win"]["sort_ms"]
