"""The binning kernel (csrc/binning.cu) against its plain PyTorch version,
on the card.

Every test but the last two needs a CUDA device and skips without one
(the kernel has no CPU mode). Like tests/test_torch_cuda.py this file imports
nothing of JAX:

    GSWT_TEST_TPU=1 python -m pytest tests/test_torch_binning_cuda.py -q

Both versions get the same device tensors. What must match, with the
tolerances tests/test_torch_binning.py states: the runs (row 12 of each
tile's range), range_start / range_end and the counts exactly, so every cull
decision; rows 6-10 and 12 of the kept pairs bit-equal; ln alpha (row 11)
within 3e-7 relative (the kernel's logf against the library's); the k rows
within 1e-5 of their scale. Past n_pairs_kept the kernel writes only the
dead code (k5 = -1e30, ln a = -inf) and, up to the end of the chunk that
holds n_pairs_kept, zeros in the other rows 0-12."""

import os

import numpy as np
import pytest
import torch

from gswt_renderer_tpu_torch.ops import binning, kernels

IMAGE_WH, TILE_WH, CHUNK = (256, 128), (64, 32), 128
HD_WH = (1920, 1080)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def projected(n, seed, image_wh=IMAGE_WH, size=(0.002, 0.1), device="cpu",
              bad_colours=True):
    """A projected stream of n lanes (bin_pairs' `p`) from a seed: random
    ellipses over and around the image, 40% of the lanes invalid, 1% ten
    times as large, transparent splats and, with bad_colours, NaN, +-inf
    and out-of-range colours and z at and past the ends of [0, 1]."""
    w, h = image_wh
    rng = np.random.default_rng(seed)
    qa = rng.uniform(*size, n).astype(np.float32)
    qc = rng.uniform(*size, n).astype(np.float32)
    qb = (rng.uniform(-0.9, 0.9, n) * np.sqrt(qa * qc)).astype(np.float32)
    det = qa * qc - qb * qb
    col = rng.uniform(0.0, 1.0, (4, n)).astype(np.float32)
    col[3, rng.random(n) < 0.05] = 0.0
    z = rng.uniform(0.0, 1.0, n).astype(np.float32)
    if bad_colours:
        for c, bad in zip(col, (np.nan, np.inf, -np.inf, 1.7)):
            c[rng.random(n) < 0.02] = bad
        z[:8] = [0.0, 1.0, -0.1, 1.3, 0.5, 65534.5 / 65535, 1e-6, 0.999999]
    ext = np.sqrt(4.0 * np.stack([qc, qa]) / det).astype(np.float32)
    ext[:, rng.random(n) < 0.01] *= 10.0
    p = dict(cx=rng.uniform(-30, w + 30, n).astype(np.float32),
             cy=rng.uniform(-30, h + 30, n).astype(np.float32),
             ext_x=ext[0], ext_y=ext[1], q=(qa, qb, qc), color=tuple(col),
             z=z, valid=rng.random(n) > 0.4)

    def put(v):
        if isinstance(v, tuple):
            return tuple(put(x) for x in v)
        return torch.from_numpy(v).to(device)
    return {k: put(v) for k, v in p.items()}


def culls(variant, image_wh, tile_wh, device, seed=9):
    """(occ_zimg, sat_simg) of a variant: a random max proxy depth per tile
    and a random saturation cut per band row, each with one NaN."""
    ntx, nty, _ = binning.grid_dims(image_wh, tile_wh)
    rng = np.random.default_rng(seed)
    occ = sat = None
    if "occ" in variant:
        occ = torch.from_numpy(
            rng.uniform(0.2, 1.0, (nty, ntx)).astype(np.float32)).to(device)
        occ[0, min(1, ntx - 1)] = float("nan")
    if "sat" in variant:
        sat = torch.from_numpy(rng.uniform(
            0, 2500, (nty * 4, ntx)).astype(np.float32)).to(device)
        sat[min(3, nty * 4 - 1), min(2, ntx - 1)] = float("nan")
    return occ, sat


def both(p, capacity, **kw):
    """(kernel's, plain version's) binning of p; checks the one launch."""
    before = kernels.LAUNCHES["binning"]
    got = binning.bin_pairs(p, capacity=capacity, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["binning"] == before + 1
    return got, binning.bin_pairs_plain(p, capacity=capacity, **kw)


def assert_binned_equal(got, want, chunk):
    """The module docstring's tolerances. Returns n_pairs_kept."""
    for k in ("range_start", "range_end"):
        assert got[k].dtype == torch.int32
        assert torch.equal(got[k], want[k]), k
    for k in ("n_pairs", "overflow", "n_pairs_kept", "n_live", "max_run"):
        assert got[k].shape == () and got[k].dtype == want[k].dtype, k
        assert got[k].item() == want[k].item(), (k, got[k], want[k])
    if "block_demand" in want:
        assert torch.equal(got["block_demand"], want["block_demand"])
    else:
        assert "block_demand" not in got
    gt, wt = got["table"].cpu().numpy(), want["table"].cpu().numpy()
    assert gt.shape == wt.shape
    n = int(want["n_pairs_kept"])
    for row in (6, 7, 8, 9, 10, 12):
        np.testing.assert_array_equal(gt[row, :n], wt[row, :n],
                                      err_msg=f"row {row}")
    np.testing.assert_array_equal(np.isneginf(gt[11, :n]),
                                  np.isneginf(wt[11, :n]))
    np.testing.assert_allclose(gt[11, :n], wt[11, :n], rtol=3e-7, atol=0)
    for row in range(6):
        scale = np.abs(wt[row, :n]).max() if n else 0.0
        np.testing.assert_allclose(gt[row, :n], wt[row, :n], rtol=0,
                                   atol=1e-5 * scale, err_msg=f"row {row}")
    assert np.all(gt[5, n:] == np.float32(-1e30))
    assert np.all(np.isneginf(gt[11, n:]))
    end = min(gt.shape[1], -(-n // chunk) * chunk)
    rows = [r for r in range(13) if r not in (5, 11)]
    assert not gt[rows, n:end].any()
    return n


VARIANTS = ["none", "occ", "sat", "occ_sat_demand"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("cull_exact", [True, False])
@pytest.mark.parametrize("exact", [True, False])
def test_kernel_matches_plain(cuda, exact, cull_exact, variant):
    seed = 8 * exact + 4 * cull_exact + VARIANTS.index(variant)
    p = projected(3000, seed, device=cuda)
    occ, sat = culls(variant, IMAGE_WH, TILE_WH, cuda)
    kw = dict(image_wh=IMAGE_WH, tile_wh=TILE_WH, chunk=CHUNK, exact=exact,
              cull_exact=cull_exact, occ_zimg=occ, sat_simg=sat,
              emit_block_demand="demand" in variant)
    demand = binning.bin_pairs_plain(p, capacity=CHUNK, **kw)["n_pairs"]
    got, want = both(p, binning.fit_capacity(demand, CHUNK), **kw)
    assert not bool(want["overflow"])
    n = assert_binned_equal(got, want, CHUNK)
    assert n > 1000
    if cull_exact or occ is not None:
        assert n < int(want["n_pairs"]), "the culls should drop pairs"
    if sat is not None:
        no_sat = binning.bin_pairs_plain(
            p, capacity=CHUNK, **dict(kw, sat_simg=None))["n_live"]
        assert int(want["n_live"]) < int(no_sat), "the sat cull should cull"


@pytest.mark.parametrize("exact", [True, False])
def test_kernel_overflow_keeps_the_front_most_pairs(cuda, exact):
    """A capacity of half the demand: the same front-most pairs as the plain
    version, and overflow set."""
    p = projected(3000, 21, device=cuda)
    kw = dict(image_wh=IMAGE_WH, tile_wh=TILE_WH, chunk=CHUNK, exact=exact,
              cull_exact=True, occ_zimg=None, sat_simg=None,
              emit_block_demand=True)
    demand = int(binning.bin_pairs_plain(p, capacity=CHUNK, **kw)["n_pairs"])
    cap = max(CHUNK, demand // 2 // CHUNK * CHUNK)
    got, want = both(p, cap, **kw)
    assert bool(got["overflow"]) and int(got["n_pairs"]) == demand
    assert assert_binned_equal(got, want, CHUNK) > 0


def test_kernel_on_an_empty_stream(cuda):
    p = projected(100, 3, device=cuda)
    p = {k: (tuple(x[:0] for x in v) if isinstance(v, tuple) else v[:0])
         for k, v in p.items()}
    kw = dict(image_wh=IMAGE_WH, tile_wh=TILE_WH, chunk=CHUNK, exact=False,
              cull_exact=True, occ_zimg=None, sat_simg=None,
              emit_block_demand=True)
    got, want = both(p, CHUNK, **kw)
    assert assert_binned_equal(got, want, CHUNK) == 0
    assert int(got["n_pairs"]) == 0 and got["block_demand"].shape == (0,)


@pytest.mark.parametrize("exact", [True, False])
def test_kernel_on_a_1080p_stream_of_a_million_lanes(cuda, exact):
    """The main path's frame size and a stream of 2^20 lanes, in the 64x32
    tiles of the renderer's default configuration."""
    p = projected(1 << 20, 5 + exact, HD_WH, size=(0.01, 0.5), device=cuda,
                  bad_colours=False)
    kw = dict(image_wh=HD_WH, tile_wh=(64, 32), chunk=256, exact=exact,
              cull_exact=True, occ_zimg=None, sat_simg=None,
              emit_block_demand=False)
    demand = binning.bin_pairs_plain(p, capacity=256, **kw)["n_pairs"]
    got, want = both(p, binning.fit_capacity(demand, 256), **kw)
    assert assert_binned_equal(got, want, 256) > 500_000


def test_kernel_takes_the_grid_at_its_limit_and_raises_past_it(cuda):
    """The largest grid whose one-warp histogram fits shared memory
    (binning.max_tiles) bins as the plain version does; one more row of
    tiles raises."""
    limit = binning.max_tiles(cuda)
    assert limit >= 4080, "the 4K frame at 64x32 tiles must fit"
    ntx, tile = 256, (4, 4)
    nty = limit // ntx
    assert nty < 256, "this test assumes a limit below grid_dims' 256x256"
    image_wh = (ntx * tile[0], nty * tile[1])
    p = projected(6000, 13, image_wh, size=(0.05, 1.0), device=cuda)
    kw = dict(image_wh=image_wh, tile_wh=tile, chunk=CHUNK, exact=False,
              cull_exact=True, occ_zimg=None, sat_simg=None,
              emit_block_demand=False)
    demand = binning.bin_pairs_plain(p, capacity=CHUNK, **kw)["n_pairs"]
    got, want = both(p, binning.fit_capacity(demand, CHUNK), **kw)
    assert assert_binned_equal(got, want, CHUNK) > 1000
    with pytest.raises(ValueError, match="binning kernel"):
        binning.bin_pairs(p, capacity=CHUNK, **dict(
            kw, image_wh=(image_wh[0], (nty + 1) * tile[1])))


def test_kernel_rejects_bad_inputs(cuda):
    p = projected(500, 4, device=cuda)
    kw = dict(image_wh=IMAGE_WH, tile_wh=TILE_WH, chunk=CHUNK, capacity=CHUNK)
    with pytest.raises(ValueError):
        binning.bin_pairs(dict(p, cx=p["cx"].double()), **kw)
    with pytest.raises(ValueError):
        binning.bin_pairs(dict(p, valid=p["valid"].int()), **kw)
    with pytest.raises(ValueError):
        binning.bin_pairs(p, occ_zimg=torch.ones((3, 3), device=cuda), **kw)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper is the plain version and launches nothing."""
    p = projected(2000, 1)
    occ, sat = culls("occ_sat", IMAGE_WH, TILE_WH, "cpu")
    kw = dict(image_wh=IMAGE_WH, tile_wh=TILE_WH, chunk=CHUNK, exact=False,
              cull_exact=True, occ_zimg=occ, sat_simg=sat,
              emit_block_demand=True, capacity=8 * CHUNK)
    before = kernels.LAUNCHES["binning"]
    got = binning.bin_pairs(p, **kw)
    want = binning.bin_pairs_plain(p, **kw)
    assert kernels.LAUNCHES["binning"] == before
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_a_newer_shared_header_makes_a_library_stale(tmp_path, monkeypatch):
    """A kernel library is rebuilt when its source or any csrc/*.cuh header
    is newer than it (binning.cu shares csrc/torch_semantics.cuh with the
    projection and the compositors)."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(kernels, "CSRC", str(csrc))
    monkeypatch.setattr(kernels, "BUILD", str(build))
    src, hdr = csrc / "binning.cu", csrc / "shared.cuh"
    lib = build / "libbinning.so"
    for f in (src, hdr):
        f.write_text("")
    assert kernels._stale("binning")  # no library yet
    lib.write_text("")
    for f, t in ((src, 100), (hdr, 100), (lib, 200)):
        os.utime(f, (t, t))
    assert not kernels._stale("binning")
    os.utime(hdr, (300, 300))
    assert kernels._stale("binning")
    os.utime(hdr, (100, 100))
    os.utime(src, (300, 300))
    assert kernels._stale("binning")
