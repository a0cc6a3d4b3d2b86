#!/usr/bin/env python
"""A/B of the sorted merge (benchmarks/mergesorted.py) against torch.sort at
binning scale: k pre-sorted tables of (int32 key + R payload rows), n lanes
in all -- the shape of the pair-table ordering problem once a splat-level
sort makes every elementwise path's keys ascend.

    python -m gswt_renderer_tpu_torch.benchmarks.micro_merge \
        [--n 4194304] [--k 5] [--rows 6] [--block 2048] [--device cuda]

Prints each side's ms and ns/lane, and the number of merged keys that differ
from numpy's sort (0 is right). The sort side is one torch.sort of the
concatenated keys plus a gather of the payload rows.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.kernels import resolve_device
from . import mergesorted as ms
from .timing import device_label, time_ms


def make_tables(n: int, k: int, n_rows: int, seed: int = 0):
    """k sorted numpy tables [n_rows, ~n/k] with unique int32 keys spanning
    both signs, payload row r = key * 0.1 (r + 1); also all keys, unsorted."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(np.int64(1) << 31, size=n, replace=False)
    keys = (keys - (np.int64(1) << 30)).astype(np.int32)
    parts = [np.sort(p) for p in np.array_split(rng.permutation(keys), k)]

    def table(kk):
        rows = [kk.view(np.float32)]
        for r in range(n_rows - 1):
            rows.append((kk * (0.1 * (r + 1))).astype(np.float32))
        return np.stack(rows)

    return [table(p) for p in parts], keys


def sort_and_gather(flat):
    """The library route: one sort of the concatenated keys, one gather of
    every row. flat: [R, n] float32."""
    order = torch.sort(flat[0].view(torch.int32))[1]
    return flat[:, order]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 22)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--rows", type=int, default=6, help="payload rows")
    ap.add_argument("--block", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    tabs_np, keys = make_tables(args.n, args.k, 1 + args.rows)
    tabs = [torch.from_numpy(t).to(dev) for t in tabs_np]
    flat = torch.cat(tabs, dim=1)
    print(f"n={args.n} k={args.k} rows={args.rows} block={args.block} on "
          f"{device_label(dev)}")

    ms_sort = time_ms(lambda: sort_and_gather(flat), args.reps, dev)
    print(f"torch.sort + gather (1 key + {args.rows} payload): "
          f"{ms_sort:8.3f} ms ({ms_sort / args.n * 1e6:.3f} ns/lane)",
          flush=True)
    ms_merge = time_ms(lambda: ms.merge_sorted(tabs, block=args.block),
                       args.reps, dev)
    print(f"merge (k={args.k} tournament):                    "
          f"{ms_merge:8.3f} ms ({ms_merge / args.n * 1e6:.3f} ns/lane)",
          flush=True)

    out = ms.merge_sorted(tabs, block=args.block)
    got = out[0, :args.n].view(torch.int32).cpu().numpy()
    mismatched = int((got != np.sort(keys)).sum())
    print(f"mismatched keys vs numpy: {mismatched}")
    return dict(sort_ms=ms_sort, merge_ms=ms_merge, mismatched=mismatched,
                out_cols=int(out.shape[1]))


if __name__ == "__main__":
    main()
