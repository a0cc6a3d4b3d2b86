"""host.hidden_syncs: synchronising calls per frame that no sync.* section
or render.drain names: the calls PyTorch's sync debug mode ("warn", every
occurrence) flags during the traced window, counted by the program's span
log (core/hostprof.py) on the innermost section open at each, or with none
open, over the window's frames (spans `frame`). Counted on the card only;
nothing without one or in a program without the span log."""

from gswt_bench.spanlog import trace


def read(ctx):
    tr = trace()
    if tr is None:
        return None
    frames = sum(1 for s in tr.spans if s.name == "frame")
    if not tr.syncs_counted or not frames:
        return None
    hidden = tr.unsectioned_syncs + sum(
        s.syncs for s in tr.spans
        if not (s.name.startswith("sync.") or s.name == "render.drain"))
    return hidden / frames
