"""The port's batched_ab and sweep_shapes scripts end to end on the CPU at
64x64 (their card runs are chip_smoke.py's [bench] lines)."""

import pytest
import torch

from gswt_renderer_tpu_torch.benchmarks import batched_ab, sweep_shapes

SMALL = ["--device", "cpu", "--width", "64", "--height", "64", "--splats",
         "32", "--lods", "2", "--map-half", "4"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_batched_ab_small():
    rows = {r["variant"]: r for r in batched_ab.main(
        SMALL + ["-b", "2", "-n", "1"])}
    assert set(rows) == {"interactive", "batch_same", "batch_diff",
                         "segments2", "segments4", "interactive2"}
    for name in ("batch_same", "batch_diff"):
        assert rows[name]["batch"] == 2 and rows[name]["ms_per_cam"] > 0
    kept = rows["interactive"]["n_pairs_kept"]
    for n in (2, 4):
        seg = rows[f"segments{n}"]
        assert len(seg["pairs"]) == n and len(seg["bounds"]) == n + 1
        # the fast profile: each segment's early exit and bf16 weights
        # round on its own T (a few 1/255 at most)
        assert seg["max_err"] < 8 / 255, seg
        assert abs(sum(seg["pairs"]) - kept) <= 0.05 * kept, (seg, kept)


def test_sweep_shapes_grid_and_cull_flag():
    assert sweep_shapes.parse_grid(sweep_shapes.DEFAULT_GRID) == [
        (64, 32, 256, False), (64, 32, 256, True), (32, 32, 256, False),
        (32, 16, 128, False), (32, 16, 128, True), (16, 16, 128, False),
        (16, 16, 128, True)]
    res = sweep_shapes.main(SMALL + ["--frames", "9", "--warm-stride", "5",
                                     "--grid", "32x16x128,16x16x64c"])
    assert list(res) == ["32x16x128", "16x16x64c"]
    for r in res.values():
        assert r["frame_ms_median"] > 0 and r["n_windows"] == 1
        assert 0 < r["n_pairs_kept"] <= r["n_pairs"]


def test_sweep_shapes_fails_on_a_config_that_raises():
    with pytest.raises(ZeroDivisionError):
        sweep_shapes.main(SMALL + ["--frames", "9", "--warm-stride", "5",
                                   "--grid", "0x16x64"])
