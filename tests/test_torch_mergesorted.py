"""The port's sorted merge against the JAX package's parked Pallas merge
(benchmarks/mergesorted.py, run with interpret=True) and against numpy.

Every case of tests/test_mergesorted.py goes through both on the same
numpy-seeded inputs. Tolerance: none. Keys must be equal, and payload rows
and the sentinel tail bit-equal: the merge moves raw 32-bit words."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks"))
import mergesorted as jms  # noqa: E402

from gswt_renderer_tpu_torch.benchmarks import mergesorted as tms  # noqa: E402
from gswt_renderer_tpu_torch.ops import kernels  # noqa: E402


def _table(keys):
    """[3, N] table: row 0 = i32 keys bit-cast to f32; rows 1-2 = payload
    derived from the key, so a column that lost its key is detectable."""
    k = np.asarray(keys, np.int32)
    return np.stack([k.view(np.float32),
                     (k.astype(np.float64) * 0.5).astype(np.float32),
                     (k.astype(np.float64) * -3.0 + 7.0).astype(np.float32)])


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _split_unique(rng, n_total, k, span=30):
    keys = rng.choice(np.int64(1) << span, size=n_total, replace=False)
    parts = np.array_split(rng.permutation(keys.astype(np.int32)), k)
    return [np.sort(p) for p in parts]


def _check(parts, block):
    """Merge `parts` (sorted key arrays) through JAX and through the port;
    both must be numpy's merge with its payload, bit for bit."""
    tabs = [_table(p) for p in parts]
    if len(parts) == 2:
        ref = jms.merge_sorted_pair(jnp.asarray(tabs[0]), jnp.asarray(tabs[1]),
                                    block=block, interpret=True)
        got = tms.merge_sorted_pair(torch.from_numpy(tabs[0]),
                                    torch.from_numpy(tabs[1]), block=block)
    else:
        ref = jms.merge_sorted([jnp.asarray(t) for t in tabs], block=block,
                               interpret=True)
        got = tms.merge_sorted([torch.from_numpy(t) for t in tabs],
                               block=block)
    got = got.numpy()
    assert got.shape == np.asarray(ref).shape
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    want = np.sort(np.concatenate(parts))
    n = want.shape[0]
    np.testing.assert_array_equal(_bits(got[:, :n]), _bits(_table(want)))
    tail = _bits(got[:, n:])
    assert (tail[0] == tms.SENTINEL).all() and not tail[1:].any()


def test_merge_path_splits_match_jax_and_numpy():
    rng = np.random.default_rng(0)
    a, b = _split_unique(rng, 3000, 2)
    block = 256
    n_blocks = -(-(a.size + b.size) // block)
    ref = np.asarray(jms.merge_path_splits(
        jnp.asarray(a), jnp.asarray(b), block=block, n_blocks=n_blocks))
    got = tms.merge_path_splits(torch.from_numpy(a), torch.from_numpy(b),
                                block=block, n_blocks=n_blocks).numpy()
    np.testing.assert_array_equal(got, ref)
    from_a = np.argsort(np.concatenate([a, b]), kind="stable") < a.size
    cum_a = np.concatenate([[0], np.cumsum(from_a)])
    np.testing.assert_array_equal(
        got, cum_a[np.minimum(np.arange(n_blocks) * block, a.size + b.size)])
    # one boundary past the last block (what merge_sorted_pair asks for):
    # clamped to the end, where every A key is taken
    more = tms.merge_path_splits(torch.from_numpy(a), torch.from_numpy(b),
                                 block=block, n_blocks=n_blocks + 1).numpy()
    np.testing.assert_array_equal(more[:-1], got)
    assert more[-1] == a.size


@pytest.mark.parametrize("na,nb", [(1024, 1024), (3000, 777), (64, 4000)])
def test_merge_pair_matches_jax_and_numpy(na, nb):
    rng = np.random.default_rng(na * 31 + nb)
    keys = rng.choice(np.int64(1) << 30, size=na + nb, replace=False)
    keys = keys.astype(np.int32)
    _check([np.sort(keys[:na]), np.sort(keys[na:])], block=512)


def test_merge_pair_negative_keys():
    """Sign-flip-packed binning keys span the full i32 range: the compare
    is on the int32 view, not on the float bits."""
    rng = np.random.default_rng(9)
    keys = (rng.choice(np.int64(1) << 31, size=2048, replace=False)
            - (np.int64(1) << 30)).astype(np.int32)
    _check([np.sort(keys[:900]), np.sort(keys[900:])], block=256)


def test_merge_pair_block_128():
    rng = np.random.default_rng(77)
    keys = rng.choice(np.int64(1) << 30, size=1500, replace=False)
    keys = keys.astype(np.int32)
    _check([np.sort(keys[:640]), np.sort(keys[640:])], block=128)


@pytest.mark.parametrize("k", [3, 5])
def test_merge_tournament(k):
    """k tables, pairwise, the two shortest first: a later round merges an
    earlier round's sentinel tail like any column, and the width is rounded
    up to the block in every round."""
    rng = np.random.default_rng(k)
    _check(_split_unique(rng, 4096 + 123 * k, k), block=512)


@pytest.mark.parametrize("order", ["a_below_b", "b_below_a", "interleaved"])
def test_merge_pair_extreme_splits(order):
    """Every block taken from one table only, and strict alternation."""
    n = 700
    lo, hi = np.arange(n, dtype=np.int32) - 350, np.arange(n, dtype=np.int32) + 1000
    parts = {"a_below_b": [lo, hi], "b_below_a": [hi, lo],
             "interleaved": [np.arange(0, 2 * n, 2, dtype=np.int32),
                             np.arange(1, 2 * n, 2, dtype=np.int32)]}[order]
    _check(parts, block=256)


def test_merge_moves_raw_words_and_handles_an_empty_table():
    """Payload bit patterns (NaNs, denormals, -0) survive, an empty table
    merges, and a CPU tensor counts no kernel launch."""
    special = np.array([0x7FC00001, 0xFFFFFFFF, 0x7F800001, 0x00000001,
                        0x80000000, 0xFF800000], np.uint32)
    ka = np.arange(0, 12, 2, dtype=np.int32)
    kb = np.arange(1, 13, 2, dtype=np.int32)
    ta = np.stack([ka.view(np.float32), special.view(np.float32)])
    tb = np.stack([kb.view(np.float32), special[::-1].copy().view(np.float32)])
    before = dict(kernels.LAUNCHES)
    got = tms.merge_sorted_pair(torch.from_numpy(ta), torch.from_numpy(tb),
                                block=8).numpy()
    assert got.shape == (2, 16)
    np.testing.assert_array_equal(_bits(got[0, :12]).view(np.int32),
                                  np.arange(12))
    np.testing.assert_array_equal(_bits(got[1, 0:12:2]), special)
    np.testing.assert_array_equal(_bits(got[1, 1:12:2]), special[::-1])
    empty = torch.zeros((2, 0))
    alone = tms.merge_sorted_pair(torch.from_numpy(ta), empty, block=4).numpy()
    np.testing.assert_array_equal(_bits(alone[:, :6]), _bits(ta))
    assert (_bits(alone[0, 6:]) == tms.SENTINEL).all()
    assert dict(kernels.LAUNCHES) == before


def test_merge_rejects_bad_inputs():
    t = torch.zeros((3, 8))
    with pytest.raises(ValueError):
        tms.merge_sorted_pair(t, torch.zeros((2, 8)))
    with pytest.raises(ValueError):
        tms.merge_sorted_pair(t, t, block=0)
    with pytest.raises(ValueError):
        tms.merge_sorted([])
