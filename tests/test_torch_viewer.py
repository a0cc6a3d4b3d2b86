"""The port's viewer: counterparts of tests/test_viewer.py's nine endpoint
tests (fly-path editor record/play/remove/clear and JSON load, camera
get/set, live /config, /hud counters, /frame.jpg, a malformed POST, /bench,
/quit) on a 64x64 Engine on the CPU, plus the render loop's error count on
/hud and write_png byte-equal to the JAX package's."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gswt_renderer_tpu.viewer.headless import write_png as jax_write_png
from gswt_renderer_tpu_torch.core import UserData
from gswt_renderer_tpu_torch.core.config import (
    SelectiveMergeType, SurfaceType, TileSortType,
)
from gswt_renderer_tpu_torch.engine import Engine
from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec
from gswt_renderer_tpu_torch.render.pipeline import RendererConfig
from gswt_renderer_tpu_torch.viewer.headless import write_png
from gswt_renderer_tpu_torch.viewer.server import serve


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for these small tensors: under the suite's
    parallel workers PyTorch's default pool oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def viewer(_two_threads):
    sv = synthetic_scene_vec(n_lod=2, splats_per_tile=48)
    eng = Engine(
        sv, viewport=(64, 64),
        renderer_config=RendererConfig(
            width=64, height=64, max_draws=64, max_stream=1 << 13, chunk=128,
        ),
        synchronous=False, device="cpu",
    )
    eng.configure(UserData.from_ui(
        tile_map_half_wh=(2, 2), height_map_scale=(1.0, 0.0),
        lod_max_dist=8.0, surface_type=SurfaceType.HEIGHT_MAP,
        merge_type=SelectiveMergeType.NONE,
        tile_sort_type=TileSortType.DISTANCE, lod_blending=False,
    ))
    assert eng.wait_ready(timeout_s=300)
    stop = threading.Event()
    bound = {}
    evt = threading.Event()

    def on_bound(p):
        bound["port"] = p
        evt.set()

    t = threading.Thread(
        target=serve,
        args=(eng, "127.0.0.1", 0),
        kwargs=dict(scale=1, stream_ms=50.0, stop_event=stop,
                    on_bound=on_bound),
        daemon=True,
    )
    t.start()
    assert evt.wait(timeout=30)
    yield eng, bound["port"], stop, t
    if not stop.is_set():
        try:
            _post(bound["port"], "/quit", {})
        except Exception:
            pass
    t.join(timeout=10)
    eng.shutdown()


def _get(port, path):
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10
        ) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:  # 503 before the first frame lands
        return e.code, b""


def _post(port, path, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, r.read()


def _hud(port):
    code, body = _get(port, "/hud")
    assert code == 200
    return json.loads(body)


def test_hud_counters(viewer):
    eng, port, _, _ = viewer
    h = _hud(port)
    for k in ("fps", "frame_ms", "sort_ms", "build_ms", "display_fps",
              "lod_splat_count", "lod_instance_count", "splats",
              "stream_truncated", "overflow_frames", "render_errors",
              "last_render_error"):
        assert k in h, k
    assert h["splats"] > 0
    assert len(h["lod_instance_count"]) == 2
    assert sum(h["lod_instance_count"]) > 0
    assert h["render_errors"] == 0 and h["last_render_error"] == ""


def test_frame_jpg_streams(viewer):
    _, port, _, _ = viewer
    deadline = time.time() + 60
    while time.time() < deadline:
        code, body = _get(port, "/frame.jpg")
        if code == 200 and body[:2] == b"\xff\xd8":
            import io

            from PIL import Image

            assert Image.open(io.BytesIO(body)).size == (64, 64)
            return
        time.sleep(0.3)
    pytest.fail("no JPEG frame within 60s")


def test_flypath_record_play_pause_remove_clear(viewer):
    eng, port, _, _ = viewer
    _post(port, "/flypath", {"action": "clear"})
    _, b = _post(port, "/flypath", {"action": "record"})
    assert json.loads(b)["n"] == 1
    _, b = _post(port, "/flypath", {"action": "record", "interval": 1.5})
    assert json.loads(b)["n"] == 2
    assert eng.fly_path.keyframes[1].timestamp == pytest.approx(
        eng.fly_path.keyframes[0].timestamp + 1.5
    )
    _, b = _post(port, "/flypath", {"action": "play"})
    assert json.loads(b)["playing"] is True
    assert eng.camera_control == "flypath"
    _, b = _post(port, "/flypath", {"action": "pause"})
    assert json.loads(b)["playing"] is False
    assert eng.camera_control == "keyboard"
    _, b = _post(port, "/flypath", {"action": "remove", "index": 0})
    assert json.loads(b)["n"] == 1
    _, b = _post(port, "/flypath", {"action": "clear"})
    assert json.loads(b)["n"] == 0


def test_flypath_json_roundtrip(viewer):
    eng, port, _, _ = viewer
    # the reference's fly-path JSON schema (control.rs:383-405)
    fp = {"flypath": [
        dict(timestamp=0.0, position_x=0.0, position_y=0.0, position_z=5.0,
             target_x=0.0, target_y=5.0, target_z=2.0),
        dict(timestamp=2.0, position_x=1.0, position_y=2.0, position_z=5.0,
             target_x=1.0, target_y=7.0, target_z=2.0),
    ]}
    _post(port, "/flypath", {"action": "load", **fp})
    code, body = _get(port, "/flypath")
    assert code == 200
    out = json.loads(body)
    assert len(out) == 2
    assert out[1]["timestamp"] == 2.0
    _post(port, "/flypath", {"action": "clear"})


def test_camera_get_set(viewer):
    eng, port, _, _ = viewer
    _post(port, "/camera", {"position": [1.0, 2.0, 3.0],
                            "target": [1.0, 9.0, 2.0], "fovy_deg": 50.0})
    code, body = _get(port, "/camera")
    cam = json.loads(body)
    assert cam["position"] == [1.0, 2.0, 3.0]
    assert cam["fovy_deg"] == pytest.approx(50.0)


def test_config_post(viewer):
    eng, port, _, _ = viewer
    _post(port, "/config", {"splat_scale": 1.25, "freeze_frame": True})
    assert eng.render_config.splat_scale == 1.25
    assert eng.freeze_frame is True
    _post(port, "/config", {"freeze_frame": False})
    assert eng.freeze_frame is False


def test_malformed_post_is_400(viewer):
    _, port, _, _ = viewer
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/key", data=b"not json", method="POST"
    )
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    assert ei.value.code == 400


def test_bench_button(viewer):
    """/bench (the reference's benchmark-start button, gui.rs:955-997):
    replays the recorded fly path and answers the timing summary."""
    eng, port, _, _ = viewer
    _post(port, "/flypath", {"action": "clear"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(port, "/bench", {})  # needs >= 2 keyframes
    assert ei.value.code == 400
    _post(port, "/flypath", {"action": "record"})
    _post(port, "/flypath", {"action": "record", "interval": 0.5})
    code, b = _post(port, "/bench", {})
    assert code == 200
    res = json.loads(b)
    assert res["frames"] >= 1
    assert res["median_frame_ms"] > 0
    assert "Render & Sort & Update" in res["dump"]
    # the interactive loop resumes afterwards
    assert eng.camera_control == "keyboard"
    _post(port, "/flypath", {"action": "clear"})


def test_render_loop_error_shows_on_hud(viewer):
    """An exception in the render loop keeps the server up, and /hud counts
    it and shows the last one."""
    eng, port, _, _ = viewer
    before = _hud(port)["render_errors"]
    frame = eng.frame

    def fail_once(*args, **kwargs):
        eng.frame = frame
        raise RuntimeError("injected render failure")

    eng.frame = fail_once
    deadline = time.time() + 30
    while time.time() < deadline:
        h = _hud(port)
        if h["render_errors"] > before:
            break
        time.sleep(0.1)
    assert h["render_errors"] == before + 1
    assert h["last_render_error"] == "RuntimeError: injected render failure"
    code, body = _get(port, "/frame.jpg")  # still serving
    assert code == 200 and body[:2] == b"\xff\xd8"


def test_quit_shuts_down(viewer):
    eng, port, stop, t = viewer
    _post(port, "/quit", {})
    t.join(timeout=15)
    assert not t.is_alive()
    assert stop.is_set()


def _png_input(kind):
    rng = np.random.default_rng(7)
    if kind == "rgb_float":
        # out of [0, 1] on purpose: both clip before the u8 cast
        return rng.uniform(-0.2, 1.2, (17, 23, 3)).astype(np.float32)
    if kind == "rgba_float":
        return rng.uniform(0.0, 1.0, (9, 31, 4)).astype(np.float32)
    if kind == "rgba_u8":
        return rng.integers(0, 256, (12, 12, 4), dtype=np.uint8)
    return rng.uniform(0.0, 1.0, (8, 5)).astype(np.float64)  # gray


@pytest.mark.parametrize("kind", ["rgb_float", "rgba_float", "rgba_u8",
                                  "gray_float64"])
def test_write_png_bytes_equal_jax(tmp_path, kind):
    img = _png_input(kind)
    ours = write_png(tmp_path / "ours.png", img)
    theirs = jax_write_png(tmp_path / "jax.png", img)
    data = (tmp_path / "ours.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert data == (tmp_path / "jax.png").read_bytes()
    assert (ours, theirs) == (tmp_path / "ours.png", tmp_path / "jax.png")
