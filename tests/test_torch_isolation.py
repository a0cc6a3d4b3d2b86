"""The port stands alone: it imports neither jax nor the JAX package nor the
JAX package's benchmark scripts, and it never falls back to the CPU unless
asked."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "gswt_renderer_tpu_torch"
# top-level module names the port must not load: jax, the JAX package, and
# the root bench.py / benchmarks/ scripts (which put their folder on sys.path
# and import one another by bare name)
FORBIDDEN = ("jax", "jaxlib", "gswt_renderer_tpu", "bench", "benchmarks",
             "mergesorted", "micro_merge", "micro_raster",
             "micro_blockgather", "sweep_shapes", "batched_ab",
             "profile_hostloop", "profile_frame", "stage_times",
             "quick_full", "cull_ab", "depth_cull_ab", "proxydiv_ab",
             "saturation", "configs", "micro_background", "inversion_ab")
# the port's scripts that run the fixed-camera scene or the host profile
NEW_SCRIPTS = ["profile_hostloop", "profile_frame",
               "quick_full", "cull_ab", "depth_cull_ab", "proxydiv_ab",
               "saturation", "configs", "micro_background", "inversion_ab"]


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_entry_points_default_to_the_card():
    """Without an explicit device="cpu", Engine and Renderer ask for CUDA
    and raise on a host without it; they never fall back quietly."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from gswt_renderer_tpu_torch.engine import Engine
    from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec
    from gswt_renderer_tpu_torch.render.pipeline import Renderer, RendererConfig
    from gswt_renderer_tpu_torch.tiles import WangTileEngine

    sv = synthetic_scene_vec(n_lod=1, splats_per_tile=16)
    cfg = RendererConfig(width=64, height=64, max_draws=16, exact=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(sv, viewport=(64, 64), renderer_config=cfg, synchronous=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Renderer(WangTileEngine(sv), cfg)
    eng = Engine(sv, viewport=(64, 64), renderer_config=cfg,
                 synchronous=True, device="cpu")
    assert eng.renderer.device.type == "cpu"
    eng.shutdown()


@pytest.mark.parametrize("module", ["headline", "micro_merge", "micro_raster",
                                    "micro_blockgather", "batched_ab",
                                    "sweep_shapes"] + NEW_SCRIPTS)
def test_benchmark_scripts_default_to_the_card(module):
    """Every script of the benchmarks sub-package asks for CUDA unless given
    --device cpu, and raises before doing any work on a host without it."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    import importlib

    main = importlib.import_module(
        f"gswt_renderer_tpu_torch.benchmarks.{module}").main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([])


def test_the_benchmarks_sub_package_is_covered():
    names = {m.rsplit(".", 1)[1] for m in _modules()
             if m.startswith("gswt_renderer_tpu_torch.benchmarks.")}
    assert {"headline", "mergesorted", "micro_merge", "micro_raster",
            "micro_blockgather", "timing", "batched_ab",
            "sweep_shapes", *NEW_SCRIPTS} <= names


def test_the_viewer_and_parallel_modules_are_covered():
    """The JAX package's last modules that import jax have their
    counterparts, which the import test above loads."""
    mods = set(_modules())
    assert {"gswt_renderer_tpu_torch.viewer.cli",
            "gswt_renderer_tpu_torch.viewer.headless",
            "gswt_renderer_tpu_torch.viewer.server",
            "gswt_renderer_tpu_torch.parallel.batched"} <= mods


def test_parallel_entry_points_default_to_the_card():
    """make_mesh and the group of one ask for CUDA (NCCL) unless given
    "cpu", and raise on a host without it before touching a process
    group."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    import torch.distributed as dist

    from gswt_renderer_tpu_torch.parallel.batched import (
        group_of_one, make_mesh)

    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with group_of_one():
            pass
    assert not dist.is_initialized()


def test_unported_paths_raise():
    """Nothing of the Renderer's configuration is left to port: the fast
    profile (the default), sat_cull, depth_cull, the skybox and the proxy
    all construct and render, and no source of the port raises
    NotImplementedError any more."""
    from gswt_renderer_tpu_torch.core import UserData
    from gswt_renderer_tpu_torch.engine import Engine
    from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec
    from gswt_renderer_tpu_torch.render.pipeline import RendererConfig

    sv = synthetic_scene_vec(n_lod=1, splats_per_tile=16)

    def engine(**cfg):
        return Engine(sv, viewport=(64, 64),
                      renderer_config=RendererConfig(width=64, height=64,
                                                     max_draws=16, **cfg),
                      synchronous=True, device="cpu")

    assert RendererConfig().exact is False, "fast is the default profile"
    for cfg in (dict(), dict(exact=False, sat_cull=True), dict(exact=True)):
        eng = engine(**cfg)
        eng.configure(UserData.from_ui(tile_map_half_wh=(2, 2),
                                       lod_max_dist=8.0))
        img = eng.frame()
        assert img.shape == (64, 64, 4) and np.isfinite(img).all()
        eng.shutdown()
    for path in sorted(PKG.rglob("*.py")):
        assert "NotImplementedError" not in path.read_text(), path
    eng = engine(depth_cull=True)
    eng.set_skybox(None)
    eng.set_proxy(None)
    assert not eng.use_skybox and not eng.use_proxy
    eng.set_skybox(np.ones((4, 8, 3), np.float32))
    eng.set_proxy(np.ones((4, 4, 3), np.float32))
    assert eng.use_skybox and eng.use_proxy
    eng.shutdown()


def test_oracle_defaults_to_the_card(monkeypatch):
    """render_oracle, like every entry point, asks for CUDA unless given
    device="cpu", and raises before any work on a host without it."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from gswt_renderer_tpu_torch.refrender import oracle

    def ran(*args, **kw):
        raise AssertionError("the oracle ran on the CPU")

    monkeypatch.setattr(oracle, "assemble_stream", ran)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        oracle.render_oracle(None, 64, 64)
