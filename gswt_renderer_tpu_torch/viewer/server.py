"""Interactive browser viewer: JPEG streaming + key capture + GUI controls.

The reference renders into a browser canvas with an egui overlay (gui.rs);
the port serves frames over HTTP instead:
- a single-page app polls /frame.jpg and posts keydown/keyup events (the
  same WASD/R/F move + IJKL look + Space sprint bindings, control.rs:90-127);
- /hud exposes the perf counters (the Render/Perf windows, gui.rs:414-881)
  and the render loop's error count;
- /config POSTs live RenderConfig tweaks (the Render window's switches);
- /camera GETs/POSTs the camera pose as JSON text — the camera get/set
  text boxes (gui.rs:884-953);
- /flypath implements the fly-path keyframe editor (gui.rs:677-781 +
  control.rs:294-579): record the current camera as a keyframe, remove,
  clear, play/pause, and import/export the reference's fly-path JSON.

Throughput: the render loop runs pipelined full-rate frames (Engine.frame
without readback keeps Engine.pipeline_depth frames in flight; /hud's
overflow_frames counts those that overflowed a pair budget); readback is
decoupled — every `stream_ms` the latest frame is downscaled and converted
to u8 ON THE FRAME'S DEVICE (a full 1080p f32 frame is 33 MB a grab; the
downscaled u8 one 1.5 MB) and JPEG-encoded on the host.

The render loop keeps serving through an exception, as a user-facing server
should, but counts each one and keeps the last (/hud's render_errors and
last_render_error), so a failure cannot hide.
"""

from __future__ import annotations

import sys
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch


_PAGE = """<!DOCTYPE html>
<html><head><title>gswt_renderer_tpu_torch</title><style>
body { margin:0; background:#111; color:#ddd; font-family:monospace; }
#hud { position:fixed; top:8px; left:8px; background:#000a; padding:8px; }
#panel { position:fixed; top:8px; right:8px; background:#000a; padding:8px;
         width: 330px; }
#panel textarea { width: 100%; background:#222; color:#ddd; }
#panel button { margin: 2px; }
img { display:block; margin:auto; }
</style></head>
<body>
<div id="hud"></div>
<div id="panel">
  <div>
    <button onclick="fly('record')">record keyframe</button>
    <button onclick="fly('play')">play</button>
    <button onclick="fly('pause')">pause</button>
    <button onclick="fly('clear')">clear</button>
    <button onclick="bench()">benchmark</button>
  </div>
  <div id="kf"></div>
  <div>camera (editable JSON):</div>
  <textarea id="cam" rows="5"></textarea>
  <div>
    <button onclick="getCam()">get</button>
    <button onclick="setCam()">set</button>
  </div>
</div>
<img id="frame"/>
<script>
const img = document.getElementById('frame');
function tick() { img.src = '/frame.jpg?' + Date.now(); }
img.onload = () => setTimeout(tick, 30);
img.onerror = () => setTimeout(tick, 300);
tick();
setInterval(async () => {
  const r = await fetch('/hud'); const h = await r.json();
  document.getElementById('hud').innerText =
    `fps ${h.fps.toFixed(1)}  frame ${h.frame_ms.toFixed(1)}ms  ` +
    `sort ${h.sort_ms.toFixed(1)}ms (${(100*h.sort_trigger).toFixed(0)}%)  ` +
    `build ${h.build_ms.toFixed(1)}ms  splats ${h.splats}`;
}, 500);
async function fly(action) {
  const r = await fetch('/flypath', {method:'POST',
      body: JSON.stringify({action})});
  const fp = await r.json();
  document.getElementById('kf').innerText =
    `keyframes: ${fp.n} ${fp.playing ? '(playing)' : ''}`;
}
async function bench() {
  document.getElementById('kf').innerText = 'benchmark running...';
  const r = await fetch('/bench', {method:'POST', body:'{}'});
  const b = await r.json();
  document.getElementById('kf').innerText = b.error ? b.error :
    `bench: ${b.frames} frames, ${b.fps.toFixed(2)} fps, ` +
    `median ${b.median_frame_ms.toFixed(1)} ms`;
  if (b.dump) console.log(b.dump);
}
async function getCam() {
  const r = await fetch('/camera');
  document.getElementById('cam').value = await r.text();
}
async function setCam() {
  await fetch('/camera', {method:'POST',
      body: document.getElementById('cam').value});
}
for (const ev of ['keydown','keyup']) {
  window.addEventListener(ev, e => {
    if (e.target.tagName === 'TEXTAREA') return;
    fetch('/key', {method:'POST', body: JSON.stringify(
      {key: e.key, pressed: ev === 'keydown'})});
    e.preventDefault();
  });
}
</script></body></html>"""


def encode_jpeg(arr_u8, quality=82):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr_u8, "RGB").save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def serve(engine, host="0.0.0.0", port=8080, scale: int = 2,
          stream_ms: float = 150.0, stop_event: threading.Event | None = None,
          on_bound=None):
    """Run the render loop + HTTP server until interrupted (or stop_event)."""
    stop = stop_event or threading.Event()
    state = {"jpg": b"", "lock": threading.Lock(),
             # serializes engine.frame ownership between the render loop
             # and the /bench handler
             "rlock": threading.Lock(),
             "errors": 0, "last_error": ""}

    def render_loop():
        while not stop.is_set():
            try:
                _render_tick()
            except Exception as e:  # keep serving; count it, show it on /hud
                import traceback

                with state["lock"]:
                    state["errors"] += 1
                    state["last_error"] = f"{type(e).__name__}: {e}"
                print(f"[viewer] render loop error: {e}", file=sys.stderr)
                traceback.print_exc()
                time.sleep(0.5)

    grab = {"next": 0.0, "stamps": []}

    def _render_tick():
        if state.get("benching"):
            # the benchmark endpoint owns the frame loop while it replays
            # the fly path (gui.rs:955-997)
            time.sleep(0.05)
            return
        with state["rlock"]:
            img = engine.frame(readback=False)
        if img is None:
            time.sleep(0.01)
            return
        now = time.time()
        if now < grab["next"]:
            return
        grab["next"] = now + stream_ms / 1e3
        # downscale + quantize on the frame's device: the copy to the host
        # moves H/s x W/s x 3 bytes
        small = torch.clamp(
            img[:: scale, :: scale, :3] * 255.0, 0, 255
        ).to(torch.uint8)
        arr = small.cpu().numpy()
        jpg = encode_jpeg(arr)
        with state["lock"]:
            state["jpg"] = jpg
            grab["stamps"] = (grab["stamps"] + [now])[-20:]

    t = threading.Thread(target=render_loop, daemon=True)
    t.start()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/frame.jpg"):
                with state["lock"]:
                    jpg = state["jpg"]
                self.send_response(200 if jpg else 503)
                self.send_header("Content-Type", "image/jpeg")
                self.end_headers()
                self.wfile.write(jpg)
            elif self.path.startswith("/hud"):
                f_avg, _ = engine.frame_time_ma.calc()
                s_avg, _ = engine.sort_time_ma.calc()
                b_avg, _ = engine.build_time_ma.calc()
                with state["lock"]:
                    stamps = list(grab["stamps"])
                    errors, last_error = state["errors"], state["last_error"]
                display_fps = (
                    (len(stamps) - 1) / (stamps[-1] - stamps[0])
                    if len(stamps) > 1 and stamps[-1] > stamps[0]
                    else 0.0
                )
                self._json(dict(
                    fps=1000.0 / f_avg if f_avg > 0 else 0.0,
                    frame_ms=f_avg,
                    sort_ms=s_avg,
                    build_ms=b_avg,
                    sort_trigger=engine.sort_trigger_ma.calc()[0],
                    # measured viewer display rate (JPEG grabs landing)
                    display_fps=display_fps,
                    splats=(
                        engine.cur_scene.splat_count if engine.cur_scene else 0
                    ),
                    # per-LOD splat/instance counts (gui.rs:846-880)
                    lod_splat_count=(
                        list(engine.cur_scene.lod_splat_count)
                        if engine.cur_scene else []
                    ),
                    lod_instance_count=(
                        list(engine.cur_scene.lod_instance_count)
                        if engine.cur_scene else []
                    ),
                    stream_truncated=getattr(
                        engine.renderer, "last_stream_truncated", 0
                    ),
                    overflow_frames=engine.renderer.overflow_frames,
                    # exceptions the render loop caught, and the last one
                    render_errors=errors,
                    last_render_error=last_error,
                ))
            elif self.path.startswith("/camera"):
                c = engine.camera
                self._json(dict(
                    position=c.position.tolist(),
                    target=c.target.tolist(),
                    up=c.up.tolist(),
                    fovy_deg=float(np.rad2deg(c.fovy)),
                ))
            elif self.path.startswith("/flypath"):
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(engine.fly_path.to_json().encode())
            else:
                body = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(body)

        def do_POST(self):
            try:
                self._do_post()
            except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
                # malformed body: answer 400 instead of a handler traceback
                self._json(dict(error=f"{type(e).__name__}: {e}"), code=400)

        def _do_post(self):
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n) if n else b"{}"
            if self.path.startswith("/key"):
                data = json.loads(raw)
                engine.handle_key(str(data.get("key", "")), bool(data["pressed"]))
                self.send_response(204)
                self.end_headers()
            elif self.path.startswith("/camera"):
                # camera set (gui.rs:884-953)
                data = json.loads(raw)
                c = engine.camera
                if "position" in data:
                    c.position = np.asarray(data["position"], np.float32)
                if "target" in data:
                    c.target = np.asarray(data["target"], np.float32)
                if "up" in data:
                    c.up = np.asarray(data["up"], np.float32)
                if "fovy_deg" in data:
                    c.fovy = float(np.deg2rad(data["fovy_deg"]))
                self.send_response(204)
                self.end_headers()
            elif self.path.startswith("/flypath"):
                # keyframe editor (gui.rs:677-781)
                from ..engine.control import FlyPathControl, FlyPathFrame

                data = json.loads(raw)
                action = data.get("action", "")
                fp = engine.fly_path
                if action == "record":
                    dt = float(data.get("interval", 2.0))
                    t0 = fp.keyframes[-1].timestamp + dt if fp.keyframes else 0.0
                    fp.keyframes.append(FlyPathFrame(
                        float(data.get("time", t0)),
                        engine.camera.position.copy(),
                        engine.camera.target.copy(),
                    ))
                elif action == "remove" and fp.keyframes:
                    idx = int(data.get("index", len(fp.keyframes) - 1))
                    if 0 <= idx < len(fp.keyframes):
                        fp.keyframes.pop(idx)
                elif action == "clear":
                    fp.keyframes.clear()
                    engine.camera_control = "keyboard"
                elif action == "play":
                    fp.reset_path()
                    fp.start_path()
                    engine.camera_control = "flypath"
                elif action == "pause":
                    fp.pause_path()
                    engine.camera_control = "keyboard"
                elif action == "load":
                    engine.fly_path = FlyPathControl.from_json(
                        json.dumps(data.get("flypath", {}))
                    )
                playing = engine.camera_control == "flypath"
                self._json(dict(n=len(engine.fly_path.keyframes),
                                playing=playing))
            elif self.path.startswith("/config"):
                # live render-config tweaks (the reference's Render window,
                # gui.rs:414-781): POST {"splat_scale": 1.5, "draw_mode": 1,
                # "use_clip": true, ...} with RenderConfig field names; also
                # "freeze_frame"/"step_frame"/"lock_tile"/"lock_sort".
                data = json.loads(raw)
                from ..core.config import DrawMode

                for k, v in data.items():
                    if k in ("freeze_frame", "step_frame", "lock_tile",
                             "lock_sort", "use_skybox", "use_proxy",
                             "render_gs"):
                        setattr(engine, k, bool(v))
                    elif hasattr(engine.render_config, k):
                        if k == "draw_mode":
                            v = DrawMode(int(v))
                        elif isinstance(v, list):
                            v = tuple(v)
                        setattr(engine.render_config, k, v)
                self.send_response(204)
                self.end_headers()
            elif self.path.startswith("/bench"):
                # benchmark-start button (gui.rs:955-997): replay the
                # recorded fly path with the interactive loop paused and
                # answer the timing summary + the LaTeX-style dump
                if len(engine.fly_path.keyframes) < 2:
                    self._json(dict(error="need >= 2 keyframes"), code=400)
                    return
                state["benching"] = True
                try:
                    with state["rlock"]:
                        res = engine.run_benchmark(engine.fly_path,
                                                   readback=False)
                finally:
                    state["benching"] = False
                self._json(dict(
                    frames=res["frames"],
                    fps=res["fps"],
                    median_frame_ms=res["median_frame_ms"],
                    dump=engine.format_benchmark(res),
                ))
            elif self.path.startswith("/quit"):
                stop.set()
                self.send_response(204)
                self.end_headers()
                threading.Thread(target=server.shutdown, daemon=True).start()
            else:
                self.send_response(404)
                self.end_headers()

    server = ThreadingHTTPServer((host, port), Handler)
    if on_bound is not None:
        on_bound(server.server_address[1])  # ephemeral-port tests
    print(f"viewer at http://{host}:{server.server_address[1]}/  "
          f"(POST /quit to stop)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        stop.set()
        server.server_close()
