"""The port's micro-benchmark kernels' plain versions against the JAX
package's micro-benchmarks and numpy.

Micro-raster: the five precision variants at a small size (128x64 image,
32x16 tiles, chunk 128, 16384 pairs so that tiles saturate and the early
exit fires, raw alpha in row 11; three quarters of the tiles under depth 1,
the last quarter under a random depth) against
benchmarks/micro_raster._kernel, run through a pallas_call that this test
builds with that script's grid spec and interpret=True. Both sides read the
same table. Tolerances, per variant (the port walks a chunk's pairs one by
one where the Pallas kernel takes a cumulative product by doubling, so T
differs in its last bits):
  A   5e-4: global monomials reach 128^2, their products with k ~1e3, and
      the two sides sum the exponent in another order (6e-5 measured);
  C2  5e-5: the same with tile-local monomials (products ~1e2);
  B   one bf16 step of a weight (2^-8) on top of A's: a last-bit change of a
      weight may round it to the neighbouring bf16; mean 5e-5;
  C   one bf16 step of a weight; the split2 exponent itself is bit-equal
      (products of bf16 values are exact in f32), mean 1e-6;
  D   has no JAX reference on the CPU: XLA:CPU evaluates an f32 dot in f32
      whatever precision is asked, so Precision.DEFAULT does not round the
      operands there as the TPU's single bf16 pass does. It is held against
      a numpy composite written from the stated semantics instead, to one
      bf16 step of a weight.
Block gathers: bit-equal to numpy indexing (raw 32-bit words)."""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks"))
import micro_raster as jmr  # noqa: E402

from gswt_renderer_tpu.ops.binning import build_worklist  # noqa: E402
from gswt_renderer_tpu_torch.benchmarks import micro_blockgather as tbg  # noqa: E402
from gswt_renderer_tpu_torch.benchmarks import micro_raster as tmr  # noqa: E402
from gswt_renderer_tpu_torch.ops import kernels  # noqa: E402

IMAGE_WH, TILE_WH, CHUNK, PAIRS = (128, 64), (32, 16), 128, 1 << 14
N_TILES, P_N = 16, 32 * 16
BF16_STEP = 2.0 ** -8
JAX_PREC = {"highest": jax.lax.Precision.HIGHEST, "split2": "split2"}
# variant -> (max abs, mean abs) against the JAX kernel
TOL = {"A": (5e-4, 1e-5), "C2": (5e-5, 1e-6),
       "B": (BF16_STEP + 5e-4, 5e-5), "C": (BF16_STEP + 5e-5, 1e-6)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for these small tensors: under the suite's
    parallel workers PyTorch's default pool (a thread per core in every
    worker) oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _inputs():
    binned = tmr.make_binned(PAIRS, IMAGE_WH, TILE_WH, seed=0)
    rng = np.random.default_rng(1)
    depth = rng.uniform(0.3, 1.0, (N_TILES, P_N)).astype(np.float32)
    depth[:N_TILES * 3 // 4] = 1.0
    return binned, depth


def _jax_variant(key, table, depth, *, local, prec, bf2):
    """benchmarks/micro_raster._kernel over the JAX worklist of `key`, with
    run_variant's grid spec, in interpret mode."""
    tw, th = TILE_WH
    ntx = IMAGE_WH[0] // tw
    wl = build_worklist(jnp.asarray(key), n_tiles=N_TILES, max_pairs=PAIRS,
                        chunk=CHUNK)
    kernel = functools.partial(jmr._kernel, tw=tw, th=th, ntx=ntx, chunk=CHUNK,
                               local=local, prec1=prec, bf2=bf2)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=4,
        grid=(wl["entry_tf"].shape[0],),
        in_specs=[
            pl.BlockSpec((16, CHUNK), lambda g, etf, ec, rs, re: (0, ec[g])),
            pl.BlockSpec((1, 1, P_N),
                         lambda g, etf, ec, rs, re: (etf[g] & 0xFFFFFF, 0, 0)),
        ],
        out_specs=pl.BlockSpec(
            (1, 4, P_N), lambda g, etf, ec, rs, re: (etf[g] & 0xFFFFFF, 0, 0)),
        scratch_shapes=[pltpu.VMEM((4, P_N), jnp.float32),
                        pltpu.VMEM((1, P_N), jnp.float32)],
    )
    out = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((N_TILES, 4, P_N), jnp.float32),
        grid_spec=grid_spec, interpret=True,
    )(wl["entry_tf"], wl["entry_chunk"], wl["range_start"], wl["range_end"],
      jnp.asarray(table), jnp.asarray(depth[:, None, :]))
    return np.asarray(out)


def _port_variant(name, stats=None):
    binned, depth = _inputs()
    b, kw = tmr.variant_inputs(binned, name, image_wh=IMAGE_WH,
                               tile_wh=TILE_WH)
    kw.update(image_wh=IMAGE_WH, tile_wh=TILE_WH, chunk=CHUNK)
    if stats is not None:
        out = tmr.composite_plain(b, torch.from_numpy(depth), stats=stats, **kw)
    else:
        out = tmr.composite(b, torch.from_numpy(depth), **kw)
    return b, out.numpy()


@pytest.mark.parametrize("name", ["A", "B", "C", "C2"])
def test_micro_raster_variant_matches_jax_kernel(name):
    binned, depth = _inputs()
    local, prec, bf2, _ = tmr.VARIANTS[name]
    before = kernels.LAUNCHES["micro_raster"]
    b, got = _port_variant(name)
    assert kernels.LAUNCHES["micro_raster"] == before  # CPU: plain version
    ref = _jax_variant(binned["key"].numpy(), b["table"].numpy(), depth,
                       local=local, prec=JAX_PREC[prec], bf2=bf2)
    diff = np.abs(got - ref)
    tol_max, tol_mean = TOL[name]
    assert np.isfinite(got).all() and ref[:, 3].mean() > 0.5
    assert diff.max() <= tol_max and diff.mean() <= tol_mean, (
        diff.max(), diff.mean())


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def _default_semantics(b):
    """Variant D over _inputs() with its table `b` (recentred): tile-local
    monomials, coefficients and monomials each rounded to bf16 once,
    products summed in f32 left to right; colours and weights rounded to
    bf16, f32 sums. A numpy composite, pixel-parallel and pair by pair, of
    exactly that."""
    binned, depth = _inputs()
    table = b["table"].numpy()
    rs, re_ = binned["range_start"].numpy(), binned["range_end"].numpy()
    tw = TILE_WH[0]
    p = np.arange(P_N)
    x = (p % tw).astype(np.float32) + np.float32(0.5)
    y = (p // tw).astype(np.float32) + np.float32(0.5)
    f = [_bf16(m) for m in (x * x, x * y, y * y, x, y)]
    k = _bf16(table[0:6])
    col = _bf16(table[8:11])
    want = np.zeros((N_TILES, 4, P_N), np.float32)
    for t in range(N_TILES):
        first = rs[t] // CHUNK * CHUNK
        t_carry = np.ones(P_N, np.float32)
        t_loc = np.ones(P_N, np.float32)
        for j in range(first, re_[t]):
            if j % CHUNK == 0 and j != first:
                t_carry, t_loc = t_carry * t_loc, np.ones(P_N, np.float32)
                if t_carry.max() < tmr.MIN_T:
                    break
            if j < rs[t]:
                continue
            e = k[0, j] * f[0]
            for i in range(1, 5):
                e = e + k[i, j] * f[i]
            e = e + k[5, j]
            keep = (e >= tmr.CUTOFF) & (table[6, j] < depth[t])
            g = np.where(keep, np.exp(e) * table[11, j], np.float32(0.0))
            w = _bf16((g * t_loc) * t_carry)
            want[t, :3] += col[:, j, None] * w
            want[t, 3] += w
            t_loc = t_loc * (np.float32(1.0) - g)
    return want


def test_micro_raster_default_precision_matches_its_stated_semantics():
    """Variant D against _default_semantics, to one bf16 step of a
    weight."""
    b, got = _port_variant("D")
    want = _default_semantics(b)
    diff = np.abs(got - want)
    assert want[:, 3].mean() > 0.5
    assert diff.max() <= BF16_STEP + 5e-5 and diff.mean() <= 5e-5, (
        diff.max(), diff.mean())


def test_micro_raster_variants_against_a():
    """What the script prints: B, C, C2 stay close to A, D (bf16 exponent)
    does not; and the early exit leaves pairs uncomposited."""
    stats = {}
    _, ref = _port_variant("A", stats=stats)
    live = int((_inputs()[0]["key"] < N_TILES).sum())
    assert 0 < stats["pairs"] < live
    # few pair-pixels pass the cutoff and the depth test, and A's weights
    # (g in [0, 0.8]) sum to the pixel's alpha
    assert 0 < stats["kept"] < stats["pairs"] * P_N // 2
    np.testing.assert_allclose(stats["mag"].numpy(), ref[:, 3], atol=1e-5)
    err = {n: float(np.abs(_port_variant(n)[1] - ref).max())
           for n in ("B", "C", "C2", "D")}
    assert err["C2"] < 5e-4 and err["B"] < 2e-2 and err["C"] < 2e-2
    assert err["D"] > 10 * err["C"]


def test_make_binned_and_recentre():
    """Row 11 is the raw alpha the variants multiply by (not its log), dead
    pairs cannot contribute, and recentring leaves the exponent unchanged."""
    binned, _ = _inputs()
    table, key = binned["table"], binned["key"]
    live = key < N_TILES
    assert int(live.sum()) == int(PAIRS / 1.6)
    assert float(table[11][live].min()) >= 0.0
    assert float(table[11].max()) <= 0.8
    assert bool((table[11][~live] == 0).all())
    assert bool((table[5][~live] == -1e30).all())
    rs, re_ = binned["range_start"].long(), binned["range_end"].long()
    assert int((re_ - rs).sum()) == int(live.sum())
    ntx, (tw, th) = IMAGE_WH[0] // TILE_WH[0], TILE_WH
    loc = tmr.recentre(table, binned["pair_tile"], ntx=ntx, tile_wh=TILE_WH)
    j = torch.nonzero(live).flatten()[::37]
    tile = binned["pair_tile"][j]
    u, v = 7.5, 3.5
    x = (tile % ntx * tw).double() + u
    y = (torch.div(tile, ntx, rounding_mode="floor") * th).double() + v

    def quad(k, a, b):
        k = k[:, j].double()
        return k[0] * a * a + k[1] * a * b + k[2] * b * b + k[3] * a + k[4] * b + k[5]

    e_glob, e_loc = quad(table, x, y), quad(loc, u, v)
    assert float((e_glob - e_loc).abs().max()) < 1e-2 * (
        1.0 + float(e_glob.abs().max()) * 1e-3)


SPECIAL = np.array([0x7FC00001, 0xFFFFFFFF, 0x7F800001, 0xFF800000, 0x00000001,
                    0x807FFFFF, 0x80000000, 0x7F800000], np.uint32)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint32)


def _word_table(rng, shape):
    t = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    t.reshape(-1)[:SPECIAL.size] = SPECIAL
    return t.view(np.float32)


@pytest.mark.parametrize("k,n_blocks,nb", [(11, 16, 40), (16, 5, 5), (3, 9, 1)])
def test_strided_block_gather_equals_numpy(k, n_blocks, nb):
    rng = np.random.default_rng(k)
    table = _word_table(rng, (k, n_blocks * tbg.B))
    src = rng.integers(0, n_blocks, nb).astype(np.int32)
    before = kernels.LAUNCHES["micro_blockgather_strided"]
    got = tbg.gather_strided(torch.from_numpy(table), torch.from_numpy(src))
    assert kernels.LAUNCHES["micro_blockgather_strided"] == before
    want = table.reshape(k, n_blocks, tbg.B)[:, src].reshape(k, nb * tbg.B)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("group,nb", [(8, 40), (1, 7), (8, 13)])
def test_contiguous_block_gather_equals_numpy(group, nb):
    rng = np.random.default_rng(group + nb)
    table = _word_table(rng, (12, tbg.K16, tbg.B))
    src = rng.integers(0, 12, nb).astype(np.int32)
    got = tbg.gather_contig(torch.from_numpy(table), torch.from_numpy(src),
                            group=group)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(table[src]))


def test_block_gathers_reject_bad_inputs():
    with pytest.raises(ValueError):
        tbg.gather_strided(torch.zeros((11, 300)),
                           torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        tbg.gather_contig(torch.zeros((4, 16, 256)),
                          torch.zeros(1, dtype=torch.int32), group=0)
    with pytest.raises(ValueError):
        tmr.composite(_inputs()[0], torch.ones((N_TILES, P_N)),
                      image_wh=IMAGE_WH, tile_wh=TILE_WH, chunk=CHUNK,
                      local=False, prec="tf32", bf2=False)


def test_micro_scripts_run_small_on_the_cpu(capsys):
    """Each script's main() end to end at a small size."""
    r = tmr.main(["--pairs", "2048", "--width", "64", "--height", "32",
                  "--tile", "32", "16", "--chunk", "128", "--reps", "1",
                  "--device", "cpu"])
    assert set(r) == set(tmr.VARIANTS) and r["A"]["err_vs_a"] == 0.0
    r = tbg.main(["--np", "8192", "--nb", "24", "--reps", "1",
                  "--device", "cpu"])
    assert "kernel strided" in r and "kernel blk-contig g1" in r
    from gswt_renderer_tpu_torch.benchmarks import micro_merge

    r = micro_merge.main(["--n", "5000", "--k", "5", "--rows", "6", "--block",
                          "256", "--reps", "1", "--device", "cpu"])
    assert r["mismatched"] == 0
    out = capsys.readouterr().out
    assert "mismatched keys vs numpy: 0" in out and "GB/s" in out
