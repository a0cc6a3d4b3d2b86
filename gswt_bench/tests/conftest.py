"""Shared set-up of the benchmark's own tests (CPU, small sizes).

    python -m pytest gswt_bench/tests -q

The `card` marker selects the tests that need an NVIDIA card; they skip
inside the test when none is present.
"""

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# a cell small enough for the CPU: 96x64 pixels, a 25x25 tile map of 32
# splats per tile, two LODs; the limits were read from its CPU runs
SMALL_CONFIG = dict(width=96, height=64, tile_map_half=12, splats_per_tile=32, n_lod=2,
                    renderer={"max_stream": 1 << 17, "max_draws": 1024, "chunk": 128})
SMALL_LIMITS = {"store_rows_off": 0, "height_map_off": 0, "presort_lists_off": 0,
                "presort_inversions": 0, "frame_mean_abs": 0.001,
                "frame_bad_px_share": 0.004, "far_ground_mean_abs": 0,
                "draw_cells_off": 0, "merged_streams_off": 0, "wang_edges_off": 0,
                "draw_lod_off": 0, "presort_views_off": 0, "merged_stream_inversions": 0,
                "draw_order_wrong_share": 0.05}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


def make_checkout(dst, *, with_program=True):
    """A checkout at `dst` holding BENCHMARK.json and gswt_bench/, with the
    small cells `small.fly` and `small.still` added as files and entries
    (and the program linked in unless with_program is False)."""
    os.makedirs(dst, exist_ok=True)
    here = os.path.join(dst, "gswt_bench")
    shutil.copytree(os.path.join(REPO, "gswt_bench"), here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    cfg = json.load(open(os.path.join(here, "configs", "paper_sky_1080p.json")))
    cfg.update(SMALL_CONFIG, name="small")
    with open(os.path.join(here, "configs", "small.json"), "w") as f:
        json.dump(cfg, f)
    bench["configs"].append(dict(name="small", source="tests", file="gswt_bench/configs/small.json",
                                 reduced=[], why="tests"))
    for t in ("fly", "still"):
        bench["workloads"].append(dict(name=f"small.{t}", config="small", traffic=t,
                                       chips=1, why="tests"))
        with open(os.path.join(here, "limits", f"small.{t}.json"), "w") as f:
            json.dump(SMALL_LIMITS, f)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    if with_program:
        os.symlink(os.path.join(REPO, "gswt_renderer_tpu_torch"),
                   os.path.join(dst, "gswt_renderer_tpu_torch"))
    return dst


@pytest.fixture
def checkout(tmp_path):
    return make_checkout(str(tmp_path / "checkout"))
