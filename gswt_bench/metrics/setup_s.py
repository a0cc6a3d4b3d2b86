"""setup_s: from the process's start to the window's first frame: loading,
making the scene from the seed, building the kernels when the checkout has
none, the Engine's presort and the warm-up (host clock)."""


def read(ctx):
    return ctx["setup_s"]
