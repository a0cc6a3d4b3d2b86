"""The micro-benchmark compositor's design for the card in its plain form
(gswt_renderer_tpu_torch/benchmarks/micro_raster.py): the per-pair
warp-block mask with the margin of each precision (block_reach, MASK_REL)
and the composite that skips what it leaves out
(composite_plain(block_mask=True)).

On adversarial micro tables (tests/torch_tables.py adversarial_micro_binned:
needle-thin, edge-on, sub-pixel, tile-sized, off-tile, non-definite and dead
pairs, half of the peaks moved to just around the cutoff in the variant's
own precision) the masked composite is BIT-equal to the unmasked one in
each of A, B, C, C2 and D, in the 16x4-block warp layout (64x32 tiles) and
the flat one (100x20), under depth 1 and a random depth. Each variant's own
margin leaves out no kept pair-pixel, and the f32 margin (2^-20 S) does
leave some out in D and in C: their margins are needed. One small case (the
inputs of tests/test_torch_micro.py) holds the masked composite against the
JAX package's benchmarks/micro_raster._kernel in interpret mode with that
file's tolerances, and D against its numpy statement of semantics there."""

import numpy as np
import pytest
import torch

from gswt_renderer_tpu_torch.benchmarks import micro_raster as tmr
from gswt_renderer_tpu_torch.ops import raster as traster
from test_torch_micro import (BF16_STEP, IMAGE_WH, TILE_WH, TOL, CHUNK,
                              JAX_PREC, _default_semantics, _inputs,
                              _jax_variant)
from torch_tables import adversarial_micro_binned

NAMES = list(tmr.VARIANTS)
TILES = [(64, 32), (100, 20)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for these small tensors: under the suite's
    parallel workers PyTorch's default pool (a thread per core in every
    worker) oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _depth(kind, n_tiles, p_n):
    if kind == "one":
        return torch.ones((n_tiles, p_n))
    rng = np.random.default_rng(4)
    return torch.from_numpy(rng.uniform(0, 1, (n_tiles, p_n))
                            .astype(np.float32))


@pytest.mark.parametrize("depth_kind", ["one", "random"])
@pytest.mark.parametrize("tile_wh", TILES)
@pytest.mark.parametrize("name", NAMES)
def test_masked_composite_bit_equal(name, tile_wh, depth_kind):
    """The mask keeps every block in which the variant's own exponent
    passes the cutoff, skips some, and the masked composite is the
    unmasked one's bits."""
    b, image_wh, kw = adversarial_micro_binned(5, name, tile_wh)
    n_tiles = b["range_start"].shape[0]
    depth = _depth(depth_kind, n_tiles, tile_wh[0] * tile_wh[1])
    kw.update(image_wh=image_wh, tile_wh=tile_wh, chunk=128)
    spec = tmr.composite_plain(b, depth, **kw)
    st = {}
    masked = tmr.composite_plain(b, depth, block_mask=True, stats=st, **kw)
    assert torch.equal(masked, spec)
    assert st["missed"] == 0
    assert 0 < st["visits"] < st["blocks"]
    assert 0 < st["kept"] and float(spec[:, 3].max()) > 0.5


def _kept_missed(name, tile_wh, rel, seed=6):
    """(kept pair-pixels, those of them outside the blocks that the mask
    with relative margin `rel` keeps) over every pair of every run of the
    adversarial table, in the variant's own precision, under depth 1."""
    b, image_wh, kw = adversarial_micro_binned(seed, name, tile_wh)
    tab, rs, re_ = b["table"], b["range_start"], b["range_end"]
    tw, th = tile_wh
    ntx = image_wh[0] // tw
    rects, warp = traster.warp_layout(tile_wh)
    dmax = traster.warp_depth_max(torch.ones((1, tw * th)), warp)
    pix = torch.arange(tw * th)
    px = (pix % tw).to(torch.float32)
    py = torch.div(pix, tw, rounding_mode="floor").to(torch.float32)
    kept = missed = 0
    for t in range(rs.shape[0]):
        blk = tab[:, int(rs[t]):int(re_[t])]
        ox, oy = (0.0, 0.0) if kw["local"] else (
            float(t % ntx * tw), float(t // ntx * th))
        x, y = (px + ox) + 0.5, (py + oy) + 0.5
        e = tmr._exponent([r[:, None] for r in blk[:6]],
                          [m[None] for m in (x * x, x * y, y * y, x, y)],
                          kw["prec"])
        keep = (e >= tmr.CUTOFF) & (blk[6][:, None] < 1.0)
        reach = tmr.block_reach(blk[:, None, :], torch.tensor([t]), rects,
                                dmax, ntx=ntx, tile_wh=tile_wh,
                                local=kw["local"], rel=rel)[0]
        kept += int(keep.sum())
        missed += int((keep & ~reach[:, warp]).sum())
    return kept, missed


@pytest.mark.parametrize("tile_wh", TILES)
@pytest.mark.parametrize("name", NAMES)
def test_each_margin_is_needed(name, tile_wh):
    """Each variant's own margin (MASK_REL, derived in
    csrc/micro_raster.cu) misses no kept pair-pixel; the compositor's f32
    margin, 2^-20 S, misses some in D (bf16 operands: off by up to 2^-7 S)
    and in C (split2: up to 3.1 * 2^-16 S)."""
    prec = tmr.VARIANTS[name][1]
    kept, missed = _kept_missed(name, tile_wh, tmr.MASK_REL[prec])
    assert kept > 0 and missed == 0
    if prec != "highest":
        assert tmr.MASK_REL[prec] > 2.0 ** -20
        assert _kept_missed(name, tile_wh, 2.0 ** -20)[1] > 0


def _masked_port(name):
    binned, depth = _inputs()
    b, kw = tmr.variant_inputs(binned, name, image_wh=IMAGE_WH,
                               tile_wh=TILE_WH)
    kw.update(image_wh=IMAGE_WH, tile_wh=TILE_WH, chunk=CHUNK)
    st = {}
    out = tmr.composite_plain(b, torch.from_numpy(depth), block_mask=True,
                              stats=st, **kw)
    assert st["missed"] == 0 and st["visits"] < st["blocks"]
    return b, out.numpy()


@pytest.mark.parametrize("name", ["A", "B", "C", "C2"])
def test_masked_composite_matches_jax_kernel(name):
    """The masked composite against benchmarks/micro_raster._kernel
    (interpret mode) with tests/test_torch_micro.py's tolerances."""
    binned, depth = _inputs()
    local, prec, bf2, _ = tmr.VARIANTS[name]
    b, got = _masked_port(name)
    ref = _jax_variant(binned["key"].numpy(), b["table"].numpy(), depth,
                       local=local, prec=JAX_PREC[prec], bf2=bf2)
    diff = np.abs(got - ref)
    tol_max, tol_mean = TOL[name]
    assert np.isfinite(got).all() and ref[:, 3].mean() > 0.5
    assert diff.max() <= tol_max and diff.mean() <= tol_mean, (
        diff.max(), diff.mean())


def test_masked_default_matches_its_stated_semantics():
    """Variant D, masked, against tests/test_torch_micro.py's numpy
    composite of its stated semantics, to one bf16 step of a weight."""
    b, got = _masked_port("D")
    want = _default_semantics(b)
    diff = np.abs(got - want)
    assert want[:, 3].mean() > 0.5
    assert diff.max() <= BF16_STEP + 5e-5 and diff.mean() <= 5e-5, (
        diff.max(), diff.mean())


def test_ab_probes_replace_one_piece_each():
    """benchmarks/micro_raster_ab builds its probes by replacing pieces of
    csrc/micro_raster.cu: each piece is found exactly once, and each probe
    is the source with those pieces replaced and nothing else; the phases
    build clocks every step of a chunk."""
    from gswt_renderer_tpu_torch.benchmarks import micro_raster_ab as ab
    from gswt_renderer_tpu_torch.ops import kernels

    with open(f"{kernels.CSRC}/micro_raster.cu") as f:
        src = f.read()
    out = ab.sources()
    assert out["as_is"] == src
    assert set(out) == {"as_is", "phases", *ab.PROBES}
    for name, pieces in ab.PROBES.items():
        want = src
        for old, new in pieces:
            assert src.count(old) == 1, (name, old)
            want = want.replace(old, new)
        assert out[name] == want != src
    assert "pair_setup<kPrec>(" not in out["no_mask"]
    assert out["phases"].count("atomicAdd(&g_phase[") == len(ab.PHASE_STEPS)
    assert "gswt_micro_raster_phases" in out["phases"]


def test_ptxas_report_is_kept_beside_the_build(tmp_path, monkeypatch):
    """chip_smoke.py prints each micro-raster instantiation's registers and
    spill from the ptxas report kernels.build_all keeps beside the library,
    so a build made before the run still reports them."""
    from gswt_renderer_tpu_torch.ops import kernels

    report = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119micro_"
        "raster_kernelILb1ELi2ELb1EEEvPKfxPKiS4_S2_Pfiiiii' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_119micro_"
        "raster_kernelILb1ELi2ELb1EEEvPKfxPKiS4_S2_Pfiiiii\n"
        "    48 bytes stack frame, 72 bytes spill stores, 64 bytes spill "
        "loads\n"
        "ptxas info    : Used 64 registers, 37152 bytes smem\n")
    monkeypatch.setattr(kernels, "BUILD", str(tmp_path))
    assert kernels.ptxas_report("micro_raster") == ""
    (tmp_path / "libmicro_raster.ptxas.txt").write_text(report)
    assert tmr.ptxas_by_variant(kernels.ptxas_report("micro_raster")) == {
        (1, 2, 1): "48 bytes stack frame, 72 bytes spill stores, 64 bytes "
                   "spill loads; Used 64 registers, 37152 bytes smem"}
