"""The port stands alone: it imports neither jax nor the JAX package, and it
never falls back to the CPU unless asked."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "gswt_renderer_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "gswt_renderer_tpu")


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
    cfg = RendererConfig(width=64, height=64, max_draws=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(sv, viewport=(64, 64), renderer_config=cfg, synchronous=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Renderer(WangTileEngine(sv), cfg)
    eng = Engine(sv, viewport=(64, 64), renderer_config=cfg,
                 synchronous=True, device="cpu")
    assert eng.renderer.device.type == "cpu"
    eng.shutdown()


def test_unported_paths_raise():
    from gswt_renderer_tpu_torch.engine import Engine
    from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec
    from gswt_renderer_tpu_torch.render.pipeline import RendererConfig

    sv = synthetic_scene_vec(n_lod=1, splats_per_tile=16)
    eng = Engine(sv, viewport=(64, 64),
                 renderer_config=RendererConfig(width=64, height=64,
                                                max_draws=16),
                 synchronous=True, device="cpu")
    with pytest.raises(NotImplementedError):
        eng.set_skybox(None)
    with pytest.raises(NotImplementedError):
        eng.set_proxy(None)
    for bad in (dict(exact=False), dict(depth_cull=True), dict(sat_cull=True)):
        with pytest.raises(NotImplementedError):
            Engine(sv, viewport=(64, 64),
                   renderer_config=RendererConfig(width=64, height=64, **bad),
                   synchronous=True, device="cpu")
    eng.shutdown()
