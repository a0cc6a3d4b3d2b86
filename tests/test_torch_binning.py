"""The port's binning against the JAX package's bin_pairs, both profiles.

The same projection outputs (numpy, from a seed) go through both. What must
match: each tile's run of stream slots (the joint (tile, slot) order) and
range_start/range_end exactly, the pair-table rows 0-12 of the live pairs
within 1e-5 relative, and the dead-pair encoding (k5 = -1e30, ln a = -inf).
In the fast profile (exact=False) the z row and the colours are bit-equal
(the same integer codes times the same f32 constant), ln alpha is equal to
the last ulp of the two libraries' log, and the k rows keep the 1e-5 relative (of the row's scale) that the recentring's
products may differ by."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswt_renderer_tpu.ops import binning as jbin
from gswt_renderer_tpu_torch.ops import binning as tbin

IMAGE_WH, TILE_WH, CHUNK = (256, 128), (64, 32), 128


def _proj(n, seed):
    w, h = IMAGE_WH
    rng = np.random.default_rng(seed)
    qa = rng.uniform(0.002, 0.1, n).astype(np.float32)
    qc = rng.uniform(0.002, 0.1, n).astype(np.float32)
    qb = (rng.uniform(-0.9, 0.9, n) * np.sqrt(qa * qc)).astype(np.float32)
    det = qa * qc - qb * qb
    col = rng.uniform(0.0, 1.0, (4, n)).astype(np.float32)
    col[3, rng.random(n) < 0.05] = 0.0  # transparent splats: ln a = -inf
    return dict(
        cx=rng.uniform(-30, w + 30, n).astype(np.float32),
        cy=rng.uniform(-30, h + 30, n).astype(np.float32),
        ext_x=np.sqrt(4.0 * qc / det).astype(np.float32),
        ext_y=np.sqrt(4.0 * qa / det).astype(np.float32),
        q=(qa, qb, qc), color=tuple(col),
        z=rng.uniform(0.0, 1.0, n).astype(np.float32),
        valid=rng.random(n) > 0.4,
    )


def _torch_tree(p):
    return jax.tree_util.tree_map(torch.from_numpy, p)


def _runs(table, rs, re_):
    return [table[12, a:b].tolist() for a, b in zip(rs, re_)]


@pytest.mark.parametrize("cull_exact", [True, False])
@pytest.mark.parametrize("seed,compact", [(0, False), (1, True), (2, True)])
def test_bin_pairs_matches_jax(cull_exact, seed, compact):
    p = _proj(2000, seed)
    kw = dict(max_live=1024, live_buckets=(1024,)) if compact else {}
    jb = jbin.bin_pairs(jax.tree_util.tree_map(jnp.asarray, p),
                        image_wh=IMAGE_WH, tile_wh=TILE_WH, max_pairs=1 << 15,
                        chunk=CHUNK, exact=True, cull_exact=cull_exact,
                        elem_paths=2, **kw)
    assert not bool(jb["overflow"])
    tb = tbin.bin_pairs(_torch_tree(p), image_wh=IMAGE_WH, tile_wh=TILE_WH,
                        chunk=CHUNK, cull_exact=cull_exact,
                        capacity=tbin.fit_capacity(jb["n_pairs"], CHUNK))
    jt = np.asarray(jb["table"])
    tt = tb["table"].numpy()
    rs, re_ = np.asarray(jb["range_start"]), np.asarray(jb["range_end"])
    np.testing.assert_array_equal(tb["range_start"].numpy(), rs)
    np.testing.assert_array_equal(tb["range_end"].numpy(), re_)
    assert _runs(tt, rs, re_) == _runs(jt, rs, re_)
    n_kept = int(jb["n_pairs_kept"])
    assert int(tb["n_pairs_kept"]) == n_kept
    assert tb["n_pairs"] == int(jb["n_pairs"])
    assert int(tb["n_live"]) == int(jb["n_live"])
    np.testing.assert_allclose(tt[:13, :n_kept], jt[:13, :n_kept],
                               rtol=1e-5, atol=0)
    # dead pairs (culled, and the chunk padding) sort after every run
    assert tt.shape[1] % CHUNK == 0
    assert np.all(tt[5, n_kept:] == np.float32(-1e30))
    assert np.all(np.isneginf(tt[11, n_kept:]))


@pytest.mark.parametrize("cull_exact", [True, False])
@pytest.mark.parametrize("seed,compact", [(0, False), (1, True), (5, True)])
def test_bin_pairs_fast_matches_jax(cull_exact, seed, compact):
    """exact=False: the quantized payload (bf16 Cholesky factors, u16
    floored z, u8 colours) and the ellipse cull on the quantized
    coefficients. Colours carry NaN, +-inf and out-of-range values."""
    p = _proj(2000, seed)
    rng = np.random.default_rng(100 + seed)
    col = [c.copy() for c in p["color"]]
    for c, bad in zip(col, (np.nan, np.inf, -np.inf, 1.7)):
        c[rng.random(c.shape[0]) < 0.02] = bad
    p["color"] = tuple(col)
    # z on and beyond the [0, 1] ends of the fixed-point range
    p["z"][:8] = [0.0, 1.0, -0.1, 1.3, 0.5, 65534.5 / 65535, 1e-6, 0.999999]
    kw = dict(max_live=1024, live_buckets=(1024,)) if compact else {}
    jb = jbin.bin_pairs(jax.tree_util.tree_map(jnp.asarray, p),
                        image_wh=IMAGE_WH, tile_wh=TILE_WH, max_pairs=1 << 15,
                        chunk=CHUNK, exact=False, cull_exact=cull_exact,
                        elem_paths=2, **kw)
    assert not bool(jb["overflow"])
    cap = tbin.fit_capacity(jb["n_pairs"], CHUNK)
    tb = tbin.bin_pairs(_torch_tree(p), image_wh=IMAGE_WH, tile_wh=TILE_WH,
                        chunk=CHUNK, exact=False, cull_exact=cull_exact,
                        capacity=cap)
    jt = np.asarray(jb["table"])
    tt = tb["table"].numpy()
    rs, re_ = np.asarray(jb["range_start"]), np.asarray(jb["range_end"])
    np.testing.assert_array_equal(tb["range_start"].numpy(), rs)
    np.testing.assert_array_equal(tb["range_end"].numpy(), re_)
    assert _runs(tt, rs, re_) == _runs(jt, rs, re_)
    n_kept = int(jb["n_pairs_kept"])
    assert int(tb["n_pairs_kept"]) == n_kept and n_kept > 1000
    assert tb["n_pairs"] == int(jb["n_pairs"])
    # z key, colours and slot: bit-equal; ln alpha to the last ulp of the
    # two libraries' log (-inf for alpha 0 in both)
    for row in (6, 8, 9, 10, 12):
        np.testing.assert_array_equal(tt[row, :n_kept], jt[row, :n_kept],
                                      err_msg=f"row {row}")
    np.testing.assert_allclose(tt[11, :n_kept], jt[11, :n_kept], rtol=3e-7,
                               atol=0)
    assert np.isneginf(tt[11, :n_kept]).sum() > 10
    codes = tt[6, :n_kept] * 65535.0
    np.testing.assert_allclose(codes, np.round(codes), atol=2e-3)
    assert np.isfinite(tt[8:11, :n_kept]).all()
    for row in range(6):
        scale = np.abs(jt[row, :n_kept]).max()
        np.testing.assert_allclose(tt[row, :n_kept], jt[row, :n_kept],
                                   rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=f"row {row}")
    # the fast table differs from the exact one: the payload was quantized
    te = tbin.bin_pairs(_torch_tree(p), image_wh=IMAGE_WH, tile_wh=TILE_WH,
                        chunk=CHUNK, exact=True, cull_exact=cull_exact,
                        capacity=cap)
    assert not np.array_equal(te["table"].numpy()[6], tt[6])


def test_quantize_z_floors_to_u16_steps():
    """One helper makes the depth key of the table and of both levels of
    the occlusion cull: floor(clip(z) * 65535) / 65535, never above z."""
    z = np.array([0.0, 1.0, -0.5, 2.0, 0.5, 0.3333333, 1e-6, 0.9999999,
                  12345.99 / 65535], np.float32)
    got = tbin.quantize_z(torch.from_numpy(z)).numpy()
    want = (np.floor(np.clip(z, 0.0, 1.0) * np.float32(65535.0))
            * np.float32(1.0 / 65535.0)).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    assert (got <= np.clip(z, 0.0, 1.0)).all()
    zj = jnp.floor(jnp.clip(jnp.asarray(z), 0.0, 1.0) * 65535.0) \
        * jnp.float32(1.0 / 65535.0)
    np.testing.assert_array_equal(got, np.asarray(zj))


def test_expand_bboxes_matches_jax():
    rng = np.random.default_rng(3)
    n, ntx, nty = 300, 7, 5
    x0 = rng.integers(0, ntx, n)
    y0 = rng.integers(0, nty, n)
    x1 = np.minimum(x0 + rng.integers(0, 3, n), ntx - 1)
    y1 = np.minimum(y0 + rng.integers(0, 3, n), nty - 1)
    ok = rng.random(n) > 0.3
    jk, jp, jtot, _ = jbin.expand_bboxes(
        *(jnp.asarray(a.astype(np.int32)) for a in (x0, x1, y0, y1)),
        jnp.asarray(ok), ntx=ntx, n_tiles=ntx * nty, max_pairs=4096)
    tk, tp, ttot, tover = tbin.expand_bboxes(
        *(torch.from_numpy(a) for a in (x0, x1, y0, y1)),
        torch.from_numpy(ok), ntx=ntx, n_tiles=ntx * nty,
        capacity=int(jtot))
    assert int(ttot) == int(jtot) == tk.shape[0] and not bool(tover)
    ttot = int(ttot)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk)[:ttot])
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp)[:ttot])


def test_worklist_matches_jax_live_entries():
    """The port's (tile, chunk) worklist equals the JAX worklist's entries
    of the tiles that have pairs (JAX adds one dead entry per empty tile
    and pads the tail)."""
    p = _proj(2000, 4)
    jb = jbin.bin_pairs(jax.tree_util.tree_map(jnp.asarray, p),
                        image_wh=IMAGE_WH, tile_wh=TILE_WH, max_pairs=1 << 15,
                        chunk=CHUNK, exact=True, cull_exact=True)
    rs = np.asarray(jb["range_start"])
    re_ = np.asarray(jb["range_end"])
    etf = np.asarray(jb["entry_tf"])
    tile = etf & 0xFFFFFF
    alive = ((etf >> 26) & 1) == 1
    keep = alive & (re_[tile] > rs[tile])
    wl = tbin.build_worklist(torch.tensor(rs), torch.tensor(re_),
                             chunk=CHUNK)
    np.testing.assert_array_equal(wl["entry_tile"].numpy(), tile[keep])
    np.testing.assert_array_equal(wl["entry_chunk"].numpy(),
                                  np.asarray(jb["entry_chunk"])[keep])


def test_grid_dims_rejects_oversized_grids():
    assert tbin.grid_dims((1920, 1080), (64, 32)) == (30, 34, 1020)
    with pytest.raises(ValueError):
        tbin.grid_dims((8192, 64), (16, 16))
