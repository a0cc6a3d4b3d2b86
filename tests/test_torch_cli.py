"""The port's CLI end to end on the CPU (`--device cpu`): counterparts of
the first two tests of tests/test_cli.py (a headless fly-path render on a
tiny synthetic scene, and the bench subcommand's dump), and the CLI's
default device, the card."""

import json
import os

import pytest
import torch

from gswt_renderer_tpu_torch.viewer import cli

SMALL = ["--size", "64x64", "--half", "1", "--surface", "none",
         "--merge", "none", "--tile-sort", "distance", "--synth-lods", "2",
         "--synth-splats", "32", "--sync"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_cli_render_headless(tmp_path):
    fp = [
        dict(timestamp=0.0, position_x=0.0, position_y=0.0, position_z=5.0,
             target_x=0.0, target_y=5.0, target_z=1.0),
        dict(timestamp=0.5, position_x=1.0, position_y=1.0, position_z=5.0,
             target_x=1.0, target_y=6.0, target_z=1.0),
    ]
    fp_path = tmp_path / "path.json"
    fp_path.write_text(json.dumps(fp))
    out_dir = tmp_path / "frames"
    cli.main(["render", "--fly-path", str(fp_path), "--out", str(out_dir),
              "--fps", "4", "--device", "cpu"] + SMALL)
    frames = sorted(os.listdir(out_dir))
    assert len(frames) >= 1
    data = (out_dir / frames[0]).read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"


def test_cli_bench_headless(capsys):
    cli.main(["bench", "--device", "cpu"] + SMALL)
    out = capsys.readouterr().out
    assert "fps" in out and "\\pm" in out


def test_cli_defaults_to_the_card():
    """Without --device cpu the CLI asks for CUDA and raises on a host
    without it."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["bench"] + SMALL)
