"""Block-panel gather: copy whole 256-column panels out of a resident table.

The frame's splat stream is a concatenation of per-draw segments, and every
segment is a 256-aligned contiguous slice of either the materialized presort
panel table or the per-sort merged scratch (render/pipeline.py stages the
layout). On the card the copy is the CUDA kernel ``csrc/blockgather.cu``,
which reads both sources in place; on the CPU it is ``block_gather_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels

BLOCK = 256


def block_gather_plain(table, src_blocks, scratch=None, *, block: int = BLOCK):
    """Plain PyTorch version of block_gather: a gather of panels of the
    concatenation [table | scratch], moved as raw 32-bit words so payload
    bit patterns (NaNs included) survive."""
    k = table.shape[0]
    if scratch is not None:
        table = torch.cat([table, scratch], dim=1)
    words = table.view(torch.int32).reshape(k, -1, block)
    return words[:, src_blocks.long()].reshape(k, -1).view(table.dtype)


def block_gather(table, src_blocks, scratch=None, *, block: int = BLOCK):
    """table [K, N] f32 (N a multiple of `block`), optional scratch [K, M]
    (M a multiple of `block`), src_blocks [NB] i32 panel ids into
    [table | scratch].

    Returns out [K, NB*block] with
      out[:, b*block:(b+1)*block] == [table | scratch][:, s*block:(s+1)*block]
    for s = src_blocks[b]. Source ids must be in range (the host stager
    guarantees this). CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    k, n = table.shape
    if n % block or (scratch is not None and scratch.shape[1] % block):
        raise ValueError(f"table widths must be multiples of {block}")
    if scratch is not None and scratch.shape[0] != k:
        raise ValueError("table and scratch must have the same rows")
    if not table.is_cuda:
        return block_gather_plain(table, src_blocks, scratch, block=block)
    if block != BLOCK:
        raise ValueError(f"the CUDA kernel copies {BLOCK}-column panels")
    for name, t in (("table", table), ("scratch", scratch)):
        if t is not None and (t.dtype != torch.float32
                              or not t.is_contiguous()
                              or t.device != table.device):
            raise ValueError(f"{name} must be contiguous float32 on {table.device}")
    if src_blocks.dtype != torch.int32 or src_blocks.device != table.device:
        raise ValueError("src_blocks must be int32 on the table's device")
    src_blocks = src_blocks.contiguous()
    nb = src_blocks.shape[0]
    out = torch.empty((k, nb * block), dtype=table.dtype, device=table.device)
    if nb == 0:
        return out
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib = kernels.load("blockgather", gswt_block_gather=[
        vp, ll, vp, ll, vp, ll, vp, ctypes.c_int, vp])
    m = 0 if scratch is None else scratch.shape[1]
    rc = lib.gswt_block_gather(
        kernels.ptr(table), n,
        ctypes.c_void_p(None) if scratch is None else kernels.ptr(scratch), m,
        kernels.ptr(src_blocks), nb, kernels.ptr(out), k,
        kernels.stream_ptr(table),
    )
    kernels.LAUNCHES["block_gather"] += 1
    kernels.check(rc, "block_gather")
    return out
