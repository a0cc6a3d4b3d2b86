"""Merge of pre-sorted key + payload tables (parked beside the benchmarks).

Binning's joint pair sort (ops/binning.py) sorts a domain whose order is
mostly known already: after one splat-level sort every elementwise expansion
path emits pairs whose keys ascend, so a k-way merge of a few sorted
sequences would do. This module is that merge; ``bin_pairs`` does not use it
(it sorts with ``torch.sort``), and ``benchmarks/micro_merge.py`` measures
one against the other.

A table is [R, N] float32: row 0 carries int32 keys bit-cast to float32,
ascending and unique across all tables (INT32_MAX is reserved as the padding
sentinel); rows 1.. are payload that follows its key. Words move raw, so any
payload bit pattern survives.

On the card ``merge_path_splits`` and ``merge_sorted_pair`` launch the CUDA
kernels of ``csrc/mergesorted.cu``; on CPU tensors they run the plain
versions below.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import kernels

SENTINEL = 0x7FFFFFFF
# the CUDA kernel stages keys and indices (8 B a column) in 48 KiB
MAX_BLOCK = 48 * 1024 // 8


def _keys(t):
    """Row 0 of a table as its int32 keys."""
    return t[0].view(torch.int32)


def merge_path_splits_plain(ka, kb, *, block: int, n_blocks: int):
    """Plain PyTorch version of merge_path_splits: a binary search per
    boundary over ia in [max(0, m - Nb), min(m, Na)] for the largest ia with
    ka[ia - 1] < kb[m - ia], in a fixed number of rounds (no host sync)."""
    na, nb = ka.shape[0], kb.shape[0]
    m = torch.arange(n_blocks, device=ka.device, dtype=torch.int64) * block
    m = torch.clamp(m, max=na + nb)
    lo = torch.clamp(m - nb, min=0)
    hi = torch.clamp(m, max=na)
    if na == 0 or nb == 0:
        return lo.to(torch.int32)
    for _ in range(max(na, 1).bit_length() + 1):
        mid = torch.div(lo + hi + 1, 2, rounding_mode="floor")
        a_prev = ka[torch.clamp(mid - 1, 0, na - 1)]
        b_at = kb[torch.clamp(m - mid, 0, nb - 1)]
        # taking `mid` from A is feasible iff the last taken A key is below
        # the first key left in B (mid == 0 always; m - mid >= nb: B used up)
        feasible = (mid == 0) | (m - mid >= nb) | (a_prev < b_at)
        live = lo < hi  # a converged lane stays where it is
        lo = torch.where(live & feasible, mid, lo)
        hi = torch.where(live & ~feasible, mid - 1, hi)
    return lo.to(torch.int32)


def merge_path_splits(ka, kb, *, block: int, n_blocks: int):
    """For the output block boundaries m = min(b * block, Na + Nb), b in
    [0, n_blocks): the number of A keys among the first m merged keys.
    ka, kb: int32, ascending, unique across both. Returns int32 [n_blocks].
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not ka.is_cuda:
        return merge_path_splits_plain(ka, kb, block=block, n_blocks=n_blocks)
    for name, t in (("ka", ka), ("kb", kb)):
        if (t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous()
                or t.device != ka.device):
            raise ValueError(f"{name} must be contiguous int32 [N] on "
                             f"{ka.device}")
    if block <= 0:
        raise ValueError("block must be positive")
    splits = torch.empty((n_blocks,), dtype=torch.int32, device=ka.device)
    if n_blocks == 0:
        return splits
    rc = _lib().gswt_merge_splits(
        kernels.ptr(ka), ka.shape[0], kernels.ptr(kb), kb.shape[0], block,
        n_blocks, kernels.ptr(splits), kernels.stream_ptr(ka))
    kernels.LAUNCHES["merge_path_splits"] += 1
    kernels.check(rc, "merge_path_splits")
    return splits


def _lib():
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return kernels.load(
        "mergesorted",
        gswt_merge_splits=[vp, ll, vp, ll, ll, ci, vp, vp],
        gswt_merge_pair=[vp, ll, vp, ll, vp, vp, ll, ci, ci, vp])


def _out_cols(na: int, nb: int, block: int) -> int:
    return -(-(na + nb) // block) * block


def merge_sorted_pair_plain(ta, tb, *, block: int = 2048):
    """Plain PyTorch version of merge_sorted_pair: concatenate, sort the
    int32 keys (B ahead of A, stable, so equal keys order B first as in the
    kernel), gather the columns, pad the tail."""
    na, nb = ta.shape[1], tb.shape[1]
    both = torch.cat([tb, ta], dim=1).view(torch.int32)
    order = torch.sort(both[0], stable=True)[1]
    out = torch.zeros((ta.shape[0], _out_cols(na, nb, block)),
                      dtype=torch.int32, device=ta.device)
    out[0] = SENTINEL
    out[:, :na + nb] = both[:, order]
    return out.view(torch.float32)


def merge_sorted_pair(ta, tb, *, block: int = 2048):
    """Merge two sorted tables [R, Na] and [R, Nb] (row 0 = int32 keys
    bit-cast to float32, ascending, unique across both; INT32_MAX reserved).
    Returns [R, No], No = Na + Nb rounded up to `block`; the tail columns
    hold the sentinel key and zero payload.

    CPU tensors take the plain version; CUDA tensors launch the kernels."""
    if ta.dim() != 2 or tb.dim() != 2 or ta.shape[0] != tb.shape[0]:
        raise ValueError("tables must be [R, N] with the same R")
    if ta.shape[0] < 1 or block <= 0:
        raise ValueError("need at least the key row and a positive block")
    if not ta.is_cuda:
        return merge_sorted_pair_plain(ta, tb, block=block)
    if block > MAX_BLOCK:
        raise ValueError(f"the CUDA merge takes block <= {MAX_BLOCK}")
    for name, t in (("ta", ta), ("tb", tb)):
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != ta.device):
            raise ValueError(f"{name} must be contiguous float32 on "
                             f"{ta.device}")
    rows, na = ta.shape
    nb = tb.shape[1]
    no = _out_cols(na, nb, block)
    out = torch.empty((rows, no), dtype=torch.float32, device=ta.device)
    if no == 0:
        return out
    # one boundary more than blocks: block g merges the columns between
    # boundaries g and g + 1
    splits = merge_path_splits(_keys(ta), _keys(tb), block=block,
                               n_blocks=no // block + 1)
    rc = _lib().gswt_merge_pair(
        kernels.ptr(ta), na, kernels.ptr(tb), nb, kernels.ptr(splits),
        kernels.ptr(out), no, rows, block, kernels.stream_ptr(ta))
    kernels.LAUNCHES["merge_sorted_pair"] += 1
    kernels.check(rc, "merge_sorted_pair")
    return out


def _tournament(tables, merge_pair, block: int):
    seqs = list(tables)
    if not seqs:
        raise ValueError("need at least one table")
    while len(seqs) > 1:
        seqs.sort(key=lambda t: t.shape[1])
        a = seqs.pop(0)
        b = seqs.pop(0)
        seqs.append(merge_pair(a, b, block=block))
    return seqs[0]


def merge_sorted(tables, *, block: int = 2048):
    """Tournament merge of k sorted tables: pairwise rounds, the two
    shortest first, which keeps the rounds balanced. Returns [R, No]; every
    round rounds its width up to `block`, and a later round merges the
    earlier one's sentinel tail like any column."""
    return _tournament(tables, merge_sorted_pair, block)


def merge_sorted_plain(tables, *, block: int = 2048):
    """Plain PyTorch version of merge_sorted: the same tournament over
    merge_sorted_pair_plain, on whatever device the tables lie."""
    return _tournament(tables, merge_sorted_pair_plain, block)
