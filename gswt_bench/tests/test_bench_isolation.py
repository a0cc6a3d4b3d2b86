"""What the benchmark may load and where it may write (CPU).

Top-level module names are compared whole (the part before the first dot):
the port's name only begins with the JAX package's."""

import os
import subprocess
import sys

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "gswt_renderer_tpu"}


def _top_level_after(code):
    r = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return set(r.stdout.split())


def test_reference_loads_nothing_of_either_package():
    mods = _top_level_after(
        "import gswt_bench.reference.frame, gswt_bench.reference.store, "
        "gswt_bench.reference.drawlist, gswt_bench.frozen.peaks, gswt_bench.frozen.synth, "
        "gswt_bench.frozen.scene")
    assert not mods & (FORBIDDEN | {"gswt_renderer_tpu_torch"})


def test_harness_run_loads_the_port_and_no_jax(tmp_path):
    from conftest import make_checkout
    dst = make_checkout(str(tmp_path / "co"))
    mods = _top_level_after(
        f"import sys; sys.path.insert(0, {dst!r})\n"
        "from gswt_bench import harness\n"
        f"out = harness.run_cell('small.still', 5, 1.0, False, device='cpu', root={dst!r}, "
        f"here={dst + '/gswt_bench'!r})\n"
        "assert out['attempted'] > 0 and not harness.forbidden_modules()")
    assert "gswt_renderer_tpu_torch" in mods and not mods & FORBIDDEN


def test_sources_name_no_fixed_shared_path():
    here = os.path.join(REPO, "gswt_bench")
    for d, _, files in os.walk(here):
        for f in files:
            if f.endswith(".py") and d != os.path.join(here, "tests"):
                text = open(os.path.join(d, f)).read()
                assert "/dev/shm" not in text and "/tmp/" not in text, f
