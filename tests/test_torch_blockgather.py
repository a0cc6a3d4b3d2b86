"""The port's block gather against the JAX package's block_gather.

Inputs are numpy arrays made from a seed and handed to both sides. The
tolerance is bit equality: the gather moves raw 32-bit words, and rows 9-11
of a real table carry bit-cast integer payload whose patterns include NaNs
and denormals."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswt_renderer_tpu.ops.blockgather import block_gather as jax_block_gather
from gswt_renderer_tpu_torch.ops import kernels
from gswt_renderer_tpu_torch.ops.blockgather import block_gather, block_gather_plain

BLOCK = 256
# quiet and signalling NaNs, infinities, denormals, -0 (u32 bit patterns)
SPECIAL = np.array([0x7FC00001, 0xFFFFFFFF, 0x7F800001, 0xFF800000, 0x00000001,
                    0x807FFFFF, 0x80000000, 0x7F800000], np.uint32)


def _table(rng, k, n_blocks):
    t = rng.standard_normal((k, n_blocks * BLOCK)).astype(np.float32)
    bits = rng.integers(0, 2**32, (3, n_blocks * BLOCK), dtype=np.uint64)
    t[9:12] = bits.astype(np.uint32).view(np.float32)
    cols = rng.integers(0, n_blocks * BLOCK, SPECIAL.size * 4)
    for i, c in enumerate(cols):
        t[9 + i % 3, c] = SPECIAL[i % SPECIAL.size].view(np.float32)
    return t


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint32)


@pytest.mark.parametrize("n_blocks,nb,seed", [(8, 20, 0), (33, 64, 1), (5, 5, 2)])
def test_plain_matches_jax_interpret_bit_exact(n_blocks, nb, seed):
    rng = np.random.default_rng(seed)
    table = _table(rng, 16, n_blocks)
    src = rng.integers(0, n_blocks, nb).astype(np.int32)
    ref = jax_block_gather(jnp.asarray(table), jnp.asarray(src), interpret=True)
    got = block_gather_plain(torch.from_numpy(table), torch.from_numpy(src))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))


def test_two_sources_equal_gather_of_concatenation():
    """The panels + merged-scratch form (what the kernel reads in place)
    equals JAX block_gather over the concatenated table."""
    rng = np.random.default_rng(3)
    panels = _table(rng, 16, 12)
    scratch = _table(rng, 16, 4)
    src = rng.integers(0, 16, 40).astype(np.int32)
    ref = jax_block_gather(jnp.asarray(np.concatenate([panels, scratch], 1)),
                           jnp.asarray(src), interpret=True)
    before = kernels.LAUNCHES["block_gather"]
    got = block_gather(torch.from_numpy(panels), torch.from_numpy(src),
                       torch.from_numpy(scratch))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))
    # CPU tensors take the plain version: no kernel launch is counted
    assert kernels.LAUNCHES["block_gather"] == before


def test_rejects_unaligned_table():
    with pytest.raises(ValueError):
        block_gather(torch.zeros((16, 300)), torch.zeros(1, dtype=torch.int32))

