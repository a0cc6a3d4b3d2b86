#!/usr/bin/env python
"""Microbenchmark: assemble a stream of NB blocks of B columns from a table,
given NB block ids, several ways.

    python -m gswt_renderer_tpu_torch.benchmarks.micro_blockgather \
        [--np 4194304] [--nb 12288] [--device cuda]

From a [K, NP] table to a [K, NB * B] stream:
  1. slice gather: index_select of (K, B) slices of the table viewed
     [K, NP / B, B];
  2. element gather: column ids expanded to one per element;
  3. the strided block gather kernel (csrc/micro_blockgather.cu).
From a block-contiguous [NP / B, 16, B] table (one panel = one contiguous
16 KiB run) to [NB, 16, B]:
  4. the contiguous block gather kernel, `group` 8 and 1 panels per CTA;
  5. the same followed by a transpose to [16, NB * B];
  6. a row gather (table[src]) with and without that transpose.
Prints ms and GB/s (bytes read + written over the time) for each.
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from ..ops import kernels
from ..ops.kernels import resolve_device
from .timing import device_label, time_ms

K = 11    # rows of the strided table
K16 = 16  # rows of a block-contiguous panel
B = 256   # block width in columns


def _lib():
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return kernels.load(
        "micro_blockgather",
        gswt_micro_gather_strided=[vp, ll, vp, ll, vp, ci, vp],
        gswt_micro_gather_contig=[vp, ll, vp, ll, vp, ci, ci, vp])


def _check(name, t, src):
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous float32")
    if (src.dtype != torch.int32 or src.dim() != 1 or not src.is_contiguous()
            or src.device != t.device):
        raise ValueError("src must be contiguous int32 [NB] on the table's "
                         "device")


def gather_strided_plain(table, src):
    """Plain PyTorch version of gather_strided: index_select on the table
    viewed as [K, NP / B, B], moved as raw 32-bit words."""
    k = table.shape[0]
    words = table.view(torch.int32).reshape(k, -1, B)
    out = torch.index_select(words, 1, src.long())
    return out.reshape(k, -1).view(table.dtype)


def gather_strided(table, src):
    """table [K, NP] float32 (NP a multiple of 256), src [NB] int32 block
    ids in [0, NP / 256). Returns [K, NB * 256] with block b a copy of the
    table's block src[b]. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if table.dim() != 2 or table.shape[1] % B:
        raise ValueError(f"table must be [K, NP] with NP a multiple of {B}")
    if not table.is_cuda:
        return gather_strided_plain(table, src)
    _check("table", table, src)
    k, n = table.shape
    nb = src.shape[0]
    out = torch.empty((k, nb * B), dtype=table.dtype, device=table.device)
    if nb == 0:
        return out
    rc = _lib().gswt_micro_gather_strided(
        kernels.ptr(table), n, kernels.ptr(src), nb, kernels.ptr(out), k,
        kernels.stream_ptr(table))
    kernels.LAUNCHES["micro_blockgather_strided"] += 1
    kernels.check(rc, "micro_blockgather_strided")
    return out


def gather_contig_plain(table_bc, src):
    """Plain PyTorch version of gather_contig: whole panels by index, moved
    as raw 32-bit words."""
    return table_bc.view(torch.int32)[src.long()].view(table_bc.dtype)


def gather_contig(table_bc, src, *, group: int = 8):
    """table_bc [NPB, K, B] float32 (a panel is contiguous; K * B a multiple
    of 4; 16-B aligned on the card), src [NB] int32 panel ids. Returns [NB,
    K, B] with panel b a copy of panel src[b] (zeros for an id outside the
    table); `group` panels per thread block (any NB). CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if table_bc.dim() != 3 or (table_bc.shape[1] * table_bc.shape[2]) % 4:
        raise ValueError("table_bc must be [NPB, K, B] with K * B a multiple "
                         "of 4")
    if group < 1:
        raise ValueError("group must be at least 1")
    if not table_bc.is_cuda:
        return gather_contig_plain(table_bc, src)
    _check("table_bc", table_bc, src)
    if table_bc.data_ptr() % 16:
        raise ValueError("table_bc must be 16-B aligned (the kernel moves "
                         "panels with bulk copies)")
    npb, k, b = table_bc.shape
    nb = src.shape[0]
    out = torch.empty((nb, k, b), dtype=table_bc.dtype,
                      device=table_bc.device)
    if nb == 0:
        return out
    rc = _lib().gswt_micro_gather_contig(
        kernels.ptr(table_bc), npb, kernels.ptr(src), nb, kernels.ptr(out),
        k * b, group, kernels.stream_ptr(table_bc))
    kernels.LAUNCHES["micro_blockgather_contig"] += 1
    kernels.check(rc, "micro_blockgather_contig")
    return out


def make_inputs(n_cols: int, nb: int, device, seed: int = 0):
    """The strided table [K, n_cols], the block-contiguous table
    [n_cols / B, K16, B] and nb block ids, from a seed."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.random((K, n_cols), np.float32)).to(device)
    src = torch.from_numpy(
        rng.integers(0, n_cols // B - 1, nb, dtype=np.int32)).to(device)
    table_bc = torch.from_numpy(
        rng.random((n_cols // B, K16, B), np.float32)).to(device)
    return table, table_bc, src


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--np", type=int, default=4 << 20, dest="n_cols",
                    help="table columns (a multiple of 512)")
    ap.add_argument("--nb", type=int, default=12 << 10, help="blocks gathered")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    nb = args.nb
    table, table_bc, src = make_inputs(args.n_cols, nb, dev)
    table_rows = table_bc.reshape(-1, K16 * B)
    src_l = src.long()
    elem_idx = (src_l[:, None] * B + torch.arange(B, device=dev)).reshape(-1)

    def transposed(out):  # [NB, K16, B] -> [K16, NB * B]
        return out.permute(1, 0, 2).reshape(K16, nb * B)

    bytes_k = K * nb * B * 4 * 2
    bytes_16 = K16 * nb * B * 4 * 2
    cases = [
        ("slice gather (index_select)", bytes_k,
         lambda: gather_strided_plain(table, src)),
        ("element gather", bytes_k, lambda: table[:, elem_idx]),
        ("kernel strided", bytes_k, lambda: gather_strided(table, src)),
        ("kernel blk-contig g8", bytes_16,
         lambda: gather_contig(table_bc, src, group=8)),
        ("kernel blk-contig g1", bytes_16,
         lambda: gather_contig(table_bc, src, group=1)),
        ("kernel blk-contig + transpose", bytes_16 * 2,
         lambda: transposed(gather_contig(table_bc, src, group=8))),
        ("row gather (16 KiB rows)", bytes_16, lambda: table_rows[src_l]),
        ("row gather + transpose", bytes_16 * 2,
         lambda: transposed(table_rows[src_l].reshape(nb, K16, B))),
    ]
    print(f"stream: K={K} x {nb * B / 1e6:.1f}M ({bytes_k / 1e9:.2f} GB r+w), "
          f"K={K16}: {bytes_16 / 1e9:.2f} GB, on {device_label(dev)}")
    results = {}
    for name, n_bytes, fn in cases:
        t = time_ms(fn, args.reps, dev)
        results[name] = t
        print(f"  {name:32s} {t:8.4f} ms  ({n_bytes / t / 1e6:7.1f} GB/s)",
              flush=True)
    return results


if __name__ == "__main__":
    main()
