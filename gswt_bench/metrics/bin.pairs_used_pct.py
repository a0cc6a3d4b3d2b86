"""bin.pairs_used_pct: the share of the pair slots binning sorts that hold
a pair: over the window's frames (spans `frame`), the sum of each frame's
pair demand (n_pairs) over the sum of the capacity its pair expansion was
launched with (PairBudget: 1.5x the largest demand seen), both filed under
the frame's id when the render thread reads its counts back
(core/hostprof.py trace().frames). Nothing in a program without the span
log."""

from gswt_bench.spanlog import trace


def read(ctx):
    tr = trace()
    if tr is None:
        return None
    window = {s.frame for s in tr.spans if s.name == "frame"}
    counts = [c for f, c in tr.frames.items()
              if f in window and c.get("capacity") and "n_pairs" in c]
    capacity = sum(c["capacity"] for c in counts)
    if not capacity:
        return None
    return sum(c["n_pairs"] for c in counts) / capacity * 100.0
