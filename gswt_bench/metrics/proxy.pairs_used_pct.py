"""proxy.pairs_used_pct: the share of the ground raster's pair slots that
hold a (tile, triangle) pair: over the window's frames (spans `frame`), the
sum of each frame's proxy pair demand (proxy_pairs) over the sum of the
capacity the ground's pair expansion was launched with (proxy_capacity;
PairBudget: 1.5x the largest demand seen), both filed under the frame's id
when the render thread reads its counts back (core/hostprof.py
trace().frames). Nothing in a program without the span log, or where no
frame drew the ground."""

from gswt_bench.spanlog import trace


def read(ctx):
    tr = trace()
    if tr is None:
        return None
    window = {s.frame for s in tr.spans if s.name == "frame"}
    counts = [c for f, c in tr.frames.items()
              if f in window and c.get("proxy_capacity") and "proxy_pairs" in c]
    capacity = sum(c["proxy_capacity"] for c in counts)
    if not capacity:
        return None
    return sum(c["proxy_pairs"] for c in counts) / capacity * 100.0
