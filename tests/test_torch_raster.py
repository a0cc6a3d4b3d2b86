"""The port's compositor against the JAX package's.

The same binned tables (from JAX bin_pairs, or built by hand) go through
JAX rasterize_pallas (interpret mode, one and four worklist entries per grid
step), the NumPy rasterize_reference and the port's rasterize (its plain
version on the CPU). Exact profile: max abs 1e-4 per channel, the slack for
FP32 summation order. Fast profile (exact=False): FAST_MAX / FAST_MEAN /
FAST_FRAC below, with their reasons. The saturation-slot record (emit_zcut)
is integers + 0.5 and must be EQUAL in all three."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswt_renderer_tpu.ops import binning as jbin
from gswt_renderer_tpu.ops import raster as jr
from gswt_renderer_tpu_torch.ops import kernels
from gswt_renderer_tpu_torch.ops import raster as tr
from torch_tables import adversarial_binned, adversarial_table


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for these small tensors: under the suite's
    parallel workers PyTorch's default pool (a thread per core in every
    worker) oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TOL = 1e-4
# Fast profile against the JAX fast kernel. Both round weights and colours to
# bf16 before the f32 accumulate, but the JAX kernel forms the exponent from
# bf16 hi/lo halves (~1e-3 absolute by its own comment, where the port
# evaluates it in f32) and the weights as T_excl - T_incl: a fragment at the
# e >= -4 cutoff may flip (worth up to exp(-4) * alpha ~ 0.018), a weight may
# round to the neighbouring bf16 value (2^-8 of it), and every weight moves by
# ~1e-3 of itself. All of it is inside tests/test_fastmode.py's 2/255.
FAST_MAX = 0.02
FAST_MEAN = 2e-4
FAST_FRAC = 0.05  # share of values more than 1e-3 apart


def _proj(n, seed, w, h):
    """Synthetic projection outputs with PSD quadratics (numpy)."""
    rng = np.random.default_rng(seed)
    cx = rng.uniform(-20, w + 20, n).astype(np.float32)
    cy = rng.uniform(-20, h + 20, n).astype(np.float32)
    qa = rng.uniform(0.002, 0.1, n).astype(np.float32)
    qc = rng.uniform(0.002, 0.1, n).astype(np.float32)
    qb = (rng.uniform(-0.6, 0.6, n) * np.sqrt(qa * qc)).astype(np.float32)
    # extent of the exp(-4) ellipse: sqrt(4 * [Q^-1]_ii)
    det = qa * qc - qb * qb
    ext_x = np.sqrt(4.0 * qc / det).astype(np.float32)
    ext_y = np.sqrt(4.0 * qa / det).astype(np.float32)
    col = rng.uniform(0.0, 1.0, (4, n)).astype(np.float32)
    col[3] = rng.uniform(0.3, 0.99, n)
    return dict(cx=cx, cy=cy, ext_x=ext_x, ext_y=ext_y, q=(qa, qb, qc),
                color=tuple(col), z=rng.uniform(0.0, 1.0, n).astype(np.float32),
                valid=rng.random(n) > 0.3)


def _jax_tree(p):
    return jax.tree_util.tree_map(jnp.asarray, p)


def _port_binned(b):
    return dict(table=torch.from_numpy(np.array(b["table"])),
                range_start=torch.from_numpy(np.array(b["range_start"])),
                range_end=torch.from_numpy(np.array(b["range_end"])))


def _compare(b, depth, *, image_wh, tile_wh, chunk, use_depth):
    got = tr.rasterize(_port_binned(b), torch.from_numpy(depth),
                       image_wh=image_wh, tile_wh=tile_wh, chunk=chunk,
                       use_depth=use_depth).numpy()
    for step in (1, 4):
        want = np.asarray(jr.rasterize_pallas(
            b, jnp.asarray(depth), image_wh=image_wh, tile_wh=tile_wh,
            chunk=chunk, interpret=True, exact=True, use_depth=use_depth,
            step=step))
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    if use_depth:  # the reference always tests depth
        bn = {k: np.asarray(v) for k, v in b.items()}
        ref = jr.rasterize_reference(bn, depth, image_wh=image_wh,
                                     tile_wh=tile_wh, chunk=chunk)
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    return got


@pytest.mark.parametrize("use_depth", [False, True])
def test_plain_matches_jax_on_binned_pairs(use_depth):
    image_wh, tile_wh, chunk = (256, 128), (64, 32), 128
    b = jbin.bin_pairs(_jax_tree(_proj(1500, 0, *image_wh)),
                       image_wh=image_wh, tile_wh=tile_wh, max_pairs=1 << 14,
                       chunk=chunk, exact=True, cull_exact=True)
    assert not bool(b["overflow"])
    n_tiles = 4 * 4
    rng = np.random.default_rng(1)
    depth = (rng.uniform(0.2, 1.0, (n_tiles, 64 * 32)).astype(np.float32)
             if use_depth else np.ones((n_tiles, 64 * 32), np.float32))
    got = _compare(b, depth, image_wh=image_wh, tile_wh=tile_wh, chunk=chunk,
                   use_depth=use_depth)
    assert got[:, 3].max() > 0.5


def _saturating_table(chunk, rs0, alpha):
    """Two 64x32 tiles over a hand-built table. Tile 0's run [rs0, rs0+300)
    starts off a chunk boundary and holds full-coverage splats of `alpha`
    sized so its max T drops just under MIN_T exactly at the first GLOBAL
    chunk boundary; tile 1 holds weaker splats and never saturates."""
    n_dom = 8 * chunk
    table = np.zeros((16, n_dom), np.float32)
    table[5] = -1e30
    table[11] = -np.inf
    key = np.full(n_dom, 2, np.int32)
    rng = np.random.default_rng(5)
    runs = [(rs0, rs0 + 300, alpha), (rs0 + 300, rs0 + 600, 0.02)]
    for tile, (lo, hi, a) in enumerate(runs):
        m = hi - lo
        table[5, lo:hi] = 0.0  # exponent 0 at every pixel: full coverage
        table[6, lo:hi] = rng.uniform(0.0, 1.0, m)
        table[8:11, lo:hi] = rng.uniform(0.2, 1.0, (3, m))
        table[11, lo:hi] = np.log(a)
        table[12, lo:hi] = np.arange(lo, hi)
        key[lo:hi] = tile
    wl = jbin.build_worklist(jnp.asarray(key), n_tiles=2, max_pairs=n_dom,
                             chunk=chunk)
    return dict(table=jnp.asarray(table), **{
        k: wl[k] for k in ("entry_tf", "entry_chunk", "range_start",
                           "range_end")})


@pytest.mark.parametrize("use_depth", [False, True])
def test_early_exit_falls_on_global_chunk_boundaries(use_depth):
    """A tile that saturates mid-run: the kernel may only skip where a
    global multiple of `chunk` begins. Skipping anywhere else (or never)
    changes alpha by ~T * 1 ~ 1.5e-3, fifteen times the tolerance."""
    chunk, rs0 = 128, 100
    # (1 - a)^(128 - rs0) = 1.5e-3 < MIN_T at the first global boundary
    alpha = 1.0 - 1.5e-3 ** (1.0 / (chunk - rs0))
    b = _saturating_table(chunk, rs0, alpha)
    depth = np.full((2, 64 * 32), 2.0, np.float32)
    got = _compare(b, depth, image_wh=(128, 32), tile_wh=(64, 32),
                   chunk=chunk, use_depth=use_depth)
    t_at_cut = (1.0 - alpha) ** (chunk - rs0)
    assert t_at_cut < jr.MIN_T
    # tile 0 stopped at the cut: its alpha is 1 - T there, to float32
    np.testing.assert_allclose(got[0, 3], 1.0 - t_at_cut, atol=1e-5)


def test_random_depth_masks_fragments():
    chunk = 128
    b = _saturating_table(chunk, 0, 0.05)
    rng = np.random.default_rng(6)
    depth = rng.uniform(0.0, 1.0, (2, 64 * 32)).astype(np.float32)
    with_depth = _compare(b, depth, image_wh=(128, 32), tile_wh=(64, 32),
                          chunk=chunk, use_depth=True)
    without = _compare(b, depth, image_wh=(128, 32), tile_wh=(64, 32),
                       chunk=chunk, use_depth=False)
    assert with_depth[:, 3].mean() < without[:, 3].mean() - 0.1


def test_cpu_path_counts_no_launch_and_rejects_emit_zcut():
    """On CPU tensors every variant takes the plain version and counts no
    launch. (emit_zcut was rejected until the fast profile was ported; it
    now returns the record, [n_tiles, SAT_BANDS], beside unchanged tiles.)"""
    b = _port_binned(_saturating_table(128, 0, 0.05))
    depth = torch.ones((2, 64 * 32))
    kw = dict(image_wh=(128, 32), tile_wh=(64, 32), chunk=128)
    before = kernels.LAUNCHES["raster"]
    base = tr.rasterize(b, depth, **kw)
    tiles, zcut = tr.rasterize(b, depth, emit_zcut=True, **kw)
    tr.rasterize(b, depth, exact=False, **kw)
    assert kernels.LAUNCHES["raster"] == before
    assert torch.equal(tiles, base)
    assert tuple(zcut.shape) == (2, tr.SAT_BANDS)
    assert tr.SAT_NOCUT == jr.SAT_NOCUT and tr.SAT_BANDS == jr.SAT_BANDS


def _proj_opaque(n, seed):
    """tests/test_sat_cull.py's opaque scene (numpy): a mix of big stackers
    and small splats with alpha 0.85-0.99, so tiles saturate early."""
    rng = np.random.default_rng(seed)
    cx = rng.uniform(0, 256, n).astype(np.float32)
    cy = rng.uniform(0, 128, n).astype(np.float32)
    big = rng.random(n) < 0.5
    ex = np.where(big, rng.uniform(40, 90, n),
                  rng.uniform(3, 12, n)).astype(np.float32)
    ey = np.where(big, rng.uniform(25, 60, n),
                  rng.uniform(3, 12, n)).astype(np.float32)
    qa = np.where(big, rng.uniform(0.001, 0.01, n),
                  rng.uniform(0.05, 0.4, n)).astype(np.float32)
    qc = np.where(big, rng.uniform(0.001, 0.01, n),
                  rng.uniform(0.05, 0.4, n)).astype(np.float32)
    qb = (0.3 * np.sqrt(qa * qc)).astype(np.float32)
    z = np.sort(rng.uniform(0.1, 0.9, n)).astype(np.float32)
    col = [rng.random(n).astype(np.float32) for _ in range(3)]
    col.append(rng.uniform(0.85, 0.99, n).astype(np.float32))
    return dict(cx=cx, cy=cy, ext_x=ex, ext_y=ey, q=(qa, qb, qc), z=z,
                color=tuple(col), valid=np.ones(n, bool))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("seed", [2, 3])
def test_zcut_equals_jax_kernel_and_reference(seed, exact):
    """emit_zcut on the opaque scene: the port's record equals the Pallas
    kernels' (per-entry and blocked, interpret mode) and the NumPy
    reference's, entry for entry, in both profiles; emitting it leaves the
    colour output unchanged."""
    image_wh, tile_wh, chunk = (256, 128), (64, 32), 128
    b = jbin.bin_pairs(_jax_tree(_proj_opaque(1024, seed)), image_wh=image_wh,
                       tile_wh=tile_wh, max_pairs=8192, chunk=chunk,
                       exact=exact, elem_paths=2)
    depth = np.ones((16, 64 * 32), np.float32)
    kw = dict(image_wh=image_wh, tile_wh=tile_wh, chunk=chunk)
    pb = _port_binned(b)
    base = tr.rasterize(pb, torch.from_numpy(depth), use_depth=False,
                        exact=exact, **kw)
    tiles, zcut = tr.rasterize(pb, torch.from_numpy(depth), use_depth=False,
                               exact=exact, emit_zcut=True, **kw)
    assert torch.equal(tiles, base)
    zc = zcut.numpy()
    assert zc.shape == (16, tr.SAT_BANDS)
    assert (zc < tr.SAT_NOCUT).sum() >= 4, "the scene must saturate bands"
    assert ((zc == tr.SAT_NOCUT) | ((zc > 0.0) & (zc < 2 ** 24))).all()
    for step in (1, 4):
        jcol, jz = jr.rasterize_pallas(
            b, jnp.asarray(depth), interpret=True, exact=exact,
            use_depth=False, emit_zcut=True, step=step, **kw)
        np.testing.assert_array_equal(zc, np.asarray(jz))
        d = np.abs(tiles.numpy() - np.asarray(jcol))
        if exact:
            assert d.max() <= TOL
        else:
            assert d.max() <= FAST_MAX and d.mean() <= FAST_MEAN
    bn = {k: np.asarray(v) for k, v in b.items() if k != "grid_info"}
    _, rz = jr.rasterize_reference(bn, depth, emit_zcut=True, **kw)
    np.testing.assert_array_equal(zc, rz)


@pytest.mark.parametrize("use_depth", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_fast_plain_matches_jax_fast_kernel(seed, use_depth):
    """rasterize(exact=False) against rasterize_pallas(exact=False) on the
    fast profile's own pair table, within FAST_MAX / FAST_MEAN / FAST_FRAC;
    and the fast variant stays within one bf16 step (2^-8) per channel of
    the port's exact variant on the same table."""
    image_wh, tile_wh, chunk = (256, 128), (64, 32), 128
    b = jbin.bin_pairs(_jax_tree(_proj(1500, seed, *image_wh)),
                       image_wh=image_wh, tile_wh=tile_wh, max_pairs=1 << 14,
                       chunk=chunk, exact=False, cull_exact=True)
    rng = np.random.default_rng(1)
    depth = (rng.uniform(0.2, 1.0, (16, 64 * 32)).astype(np.float32)
             if use_depth else np.ones((16, 64 * 32), np.float32))
    kw = dict(image_wh=image_wh, tile_wh=tile_wh, chunk=chunk,
              use_depth=use_depth)
    got = tr.rasterize(_port_binned(b), torch.from_numpy(depth), exact=False,
                       **kw).numpy()
    assert got[:, 3].max() > 0.5
    for step in (1, 4):
        want = np.asarray(jr.rasterize_pallas(
            b, jnp.asarray(depth), interpret=True, exact=False, step=step,
            **kw))
        d = np.abs(got - want)
        assert d.max() <= FAST_MAX, d.max()
        assert d.mean() <= FAST_MEAN, d.mean()
        assert (d > 1e-3).mean() <= FAST_FRAC, (d > 1e-3).mean()
    exact = tr.rasterize(_port_binned(b), torch.from_numpy(depth), **kw).numpy()
    assert 1e-5 < np.abs(got - exact).max() <= 2.0 ** -8


def test_fast_variant_rounds_weight_and_colour_to_bf16():
    """One opaque-ish pair covering a tile at exponent 0: the fast variant's
    colour is bf16(c) * bf16(alpha) and its alpha bf16(alpha), exactly; the
    exact variant's is c * alpha."""
    table = np.zeros((16, 128), np.float32)
    table[5] = -1e30
    table[11] = -np.inf
    rgb = np.array([0.3, 100 / 255, 0.77], np.float32)
    alpha = np.float32(0.7)
    table[5, 0] = 0.0
    table[8:11, 0] = rgb
    table[11, 0] = np.log(alpha)
    b = dict(table=torch.from_numpy(table),
             range_start=torch.tensor([0], dtype=torch.int32),
             range_end=torch.tensor([1], dtype=torch.int32))
    kw = dict(image_wh=(64, 32), tile_wh=(64, 32), chunk=128, use_depth=False)
    g = torch.exp(torch.tensor(np.log(alpha)))

    def bf16(x):
        return torch.as_tensor(x).to(torch.bfloat16).to(torch.float32)

    fast = tr.rasterize(b, torch.ones((1, 2048)), exact=False, **kw)
    want = torch.cat([bf16(rgb) * bf16(g), bf16(g)[None]])
    assert torch.equal(fast[0, :, 0], want)
    assert torch.equal(fast[0], want[:, None].expand(4, 2048))
    exact = tr.rasterize(b, torch.ones((1, 2048)), **kw)
    np.testing.assert_allclose(exact[0, :, 0].numpy(),
                               np.append(rgb * float(g), float(g)), rtol=1e-6)
    assert not torch.equal(fast, exact)


@pytest.mark.parametrize("wh", [(256, 128), (200, 90)])
def test_tile_image_layouts_match_jax(wh):
    tile_wh = (64, 32)
    rng = np.random.default_rng(7)
    ntx, nty = -(-wh[0] // 64), -(-wh[1] // 32)
    acc = rng.standard_normal((ntx * nty, 4, 64 * 32)).astype(np.float32)
    np.testing.assert_array_equal(
        tr.tiles_to_image(torch.from_numpy(acc), image_wh=wh,
                          tile_wh=tile_wh).numpy(),
        np.asarray(jr.tiles_to_image(jnp.asarray(acc), image_wh=wh,
                                     tile_wh=tile_wh)))
    depth = rng.uniform(0, 1, (wh[1], wh[0])).astype(np.float32)
    np.testing.assert_array_equal(
        tr.image_to_depth_tiles(torch.from_numpy(depth), image_wh=wh,
                                tile_wh=tile_wh).numpy(),
        np.asarray(jr.image_to_depth_tiles(jnp.asarray(depth), image_wh=wh,
                                           tile_wh=tile_wh)))



# --------------------------------------------------------------------- #
# the kernel's per-pair warp-block mask (csrc/raster.cu pair_block_mask)
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("tile_wh", [(64, 32), (64, 30), (48, 40), (16, 128),
                                     (100, 20)])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_block_mask_is_conservative_on_adversarial_pairs(seed, exact, tile_wh):
    """Every pixel whose exponent, evaluated in the kernel's f32 order,
    reaches the cutoff lies in a warp block whose bit is set; dead pairs get
    no bit, pairs that cannot be bounded get every block they may reach, and
    the mask still leaves most blocks of the small splats."""
    table = adversarial_table(seed, tile_wh, exact)
    rects, warp = tr.warp_layout(tile_wh)
    e = tr._exponent(table[:6], tr._pixel_monomials(*tile_wh, "cpu"))
    reach = tr.pair_block_mask(table[:6], table[6], rects)  # [N, 32]
    hit = e >= tr.CUTOFF
    assert int(hit.sum()) > 1000, "the table must hit pixels"
    assert not bool((hit & ~reach[:, warp]).any()), "a hit pixel's block is left out"
    dead = table[5] == -1e30
    assert bool(dead.any()) and not bool(reach[dead].any())
    # the small splats and the near-cutoff ones leave blocks out
    n_blocks = int((rects[:, 0] <= rects[:, 1]).sum())
    assert float(reach[~dead].float().mean()) < 0.75 * n_blocks / 32


@pytest.mark.parametrize("exact", [True, False])
def test_block_mask_with_depth_covers_kept_pixels(exact):
    """With a depth: every pixel that passes the cutoff AND z < depth lies in
    a reached block, and a block whose pixels all lie in front of z (depth
    <= z) is left out."""
    tile_wh = (64, 32)
    table = adversarial_table(3, tile_wh, exact)
    rects, warp = tr.warp_layout(tile_wh)
    rng = np.random.default_rng(4)
    depth = torch.from_numpy(rng.uniform(0, 1, (1, 2048)).astype(np.float32))
    depth[0, warp == 5] = 0.0  # nothing passes z < depth in block 5
    depth[0, 7] = float("nan")
    dmax = tr.warp_depth_max(depth, warp)
    e = tr._exponent(table[:6], tr._pixel_monomials(*tile_wh, "cpu"))
    keep = (e >= tr.CUTOFF) & (table[6][:, None] < depth)
    reach = tr.pair_block_mask(table[:6], table[6], rects, dmax)
    assert int(keep.sum()) > 500
    assert not bool((keep & ~reach[:, warp]).any())
    assert not bool(reach[:, 5].any())


def _fixture_binned(exact, seed=0):
    image_wh, tile_wh, chunk = (256, 128), (64, 32), 128
    b = jbin.bin_pairs(_jax_tree(_proj(1500, seed, *image_wh)),
                       image_wh=image_wh, tile_wh=tile_wh, max_pairs=1 << 14,
                       chunk=chunk, exact=exact, cull_exact=True)
    return _port_binned(b), dict(image_wh=image_wh, tile_wh=tile_wh,
                                 chunk=chunk)


@pytest.mark.parametrize("use_depth", [False, True])
@pytest.mark.parametrize("exact", [True, False])
def test_masked_plain_compositor_is_bit_equal(exact, use_depth):
    """rasterize_plain skipping, as the kernel does, the pair-pixels of the
    blocks the mask leaves out gives the same bits as without: the argument
    that the new kernel changes no pixel. On the JAX binning's table the
    mask leaves no kept pair-pixel out and skips most block visits; the
    stats count the load (kept share, visits, run lengths)."""
    pb, kw = _fixture_binned(exact)
    rng = np.random.default_rng(1)
    depth = (torch.from_numpy(rng.uniform(0.2, 1.0, (16, 2048))
                              .astype(np.float32)) if use_depth
             else torch.ones((16, 2048)))
    st = {}
    want = tr.rasterize_plain(pb, depth, use_depth=use_depth, exact=exact,
                              stats=st, **kw)
    got = tr.rasterize_plain(pb, depth, use_depth=use_depth, exact=exact,
                             block_mask=True, **kw)
    assert torch.equal(got, want)
    assert st["missed"] == 0
    assert 0 < st["kept"] < st["pair_pixels"] == st["pairs"] * 2048
    assert 0 < st["visits"] < 0.6 * st["blocks"]
    assert st["blocks"] == 32 * st["pairs"]
    assert int(st["tile_pairs"].sum()) == st["pairs"]
    assert bool((st["tile_pairs"] <= st["runs"]).all())


@pytest.mark.parametrize("tile_wh", [(64, 32), (100, 20)])
def test_masked_plain_compositor_is_bit_equal_on_adversarial_table(tile_wh):
    """The same on the adversarial pairs, in both profiles' variants and
    with the saturation-slot record, in the block and the flat warp
    layout: colours and record to the bit."""
    b, image_wh = adversarial_binned(5, tile_wh, exact=True)
    n_px = tile_wh[0] * tile_wh[1]
    depth = torch.from_numpy(np.random.default_rng(6).uniform(
        0, 1, (4, n_px)).astype(np.float32))
    kw = dict(image_wh=image_wh, tile_wh=tile_wh, chunk=128, use_depth=True,
              emit_zcut=True)
    for exact in (True, False):
        want, wz = tr.rasterize_plain(b, depth, exact=exact, **kw)
        got, gz = tr.rasterize_plain(b, depth, exact=exact, block_mask=True,
                                     **kw)
        assert torch.equal(got, want) and torch.equal(gz, wz)
        assert float(want[:, 3].max()) > 0.5


@pytest.mark.parametrize("tile_wh", [(64, 32), (64, 30), (48, 40), (256, 8),
                                     (100, 20), (2048, 1)])
def test_warp_layout_partitions_the_tile(tile_wh):
    """Every pixel has one owner warp with at most 64 pixels, and its centre
    lies in that warp's rectangle; 64x32 takes 32 blocks of 16x4."""
    rects, warp = tr.warp_layout(tile_wh)
    tw, th = tile_wh
    p = torch.arange(tw * th)
    u = (p % tw).float() + 0.5
    v = (p // tw).float() + 0.5
    r = rects[warp]
    assert bool(((r[:, 0] <= u) & (u <= r[:, 1]) & (r[:, 2] <= v)
                 & (v <= r[:, 3])).all())
    assert int(torch.bincount(warp, minlength=32).max()) <= 64
    assert int(warp.max()) < 32
    if tile_wh == (64, 32):
        assert torch.equal(rects[11], torch.tensor([48.5, 63.5, 8.5, 11.5]))
