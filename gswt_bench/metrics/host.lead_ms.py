"""host.lead_ms: how far the device runs behind the render thread: the
median over the window's frames of the device start less the host start of
the frame's first device-timed span (the span `frame`, all of one
Engine.frame), from the program's span log (core/hostprof.py trace(), on
for the whole traced window; device times on the host clock through one
anchor event). Near 0 the device waits for the host; near a frame's time
the host's launches wait for the device. Nothing without a card or in a
program without the span log."""

import numpy as np

from gswt_bench.spanlog import trace


def read(ctx):
    tr = trace()
    if tr is None:
        return None
    first = {}
    for s in tr.spans:
        if s.device_start is not None and (
                s.frame not in first or s.host_start < first[s.frame].host_start):
            first[s.frame] = s
    if not first:
        return None
    return float(np.median([s.device_start - s.host_start for s in first.values()])) * 1e3
