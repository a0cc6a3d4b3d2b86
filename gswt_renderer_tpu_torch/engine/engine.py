"""Session engine: frame orchestration + async builder thread.

Reproduces the reference's session layer (state.rs):
- a builder thread owning the WangTileEngine, polling queues for
  (re)configuration, camera positions (rebuild when moved >= update_distance2)
  and view-projections (re-sort when the L1 matrix delta >= 0.01 unless
  always_sort) — state.rs:440-564;
- id-paired double buffering: SceneData and DrawTable produced by the builder
  are promoted together only when their scene ids match — state.rs:337-376;
- config generations (config_id) so stale builder replies are dropped —
  state.rs:261-289;
- per-frame metrics: frame/sort/build moving averages + trigger rates —
  state.rs:293-311;
- checkpoint/resume: full UserData + camera + RNG state to JSON (extending
  the reference's fly-path-only persistence, control.rs:535-578).

The builder stages each sort's block plan as host numpy; the render thread
uploads it, so no CUDA stream crosses threads.

Engine.frame numbers its frames (core/hostprof.py next_frame). While the
host-section profiler is on, a frame is the span ``frame`` (device-timed:
its device end is the frame's completion), and the builder's work carries
the id of the frame whose pose it was given: ``stage.build`` around
build_tiles, ``stage.sort`` around sort_tiles (with the sort's merged
groups, LRU hits and misses and splats sorted exactly, and the id of the
frame that first draws it, ``drawn_frame``; benchmarks/profile_hostloop.py
reads them), and the sort's staging (``stage.plan``, ``stage.prep``).
"""

from __future__ import annotations

import enum
import json
import queue
import threading

import numpy as np

from ..core import hostprof
from ..core.camera import Camera
from ..core.config import RenderConfig, UserData
from ..core.metrics import IncrementalMA, get_time_milliseconds
from ..ops.kernels import resolve_device
from ..render.pipeline import Renderer, RendererConfig, _hprof
from ..render.uniforms import SceneParams
from ..tiles.wangtile import WangTileEngine
from .control import FlyPathControl, KeyboardFlyControl


class EngineStatus(enum.Enum):
    CONFIG = "config"          # structure.rs:429-433
    POST_CONFIG = "post_config"
    RENDER = "render"


class _Builder:
    """The worker thread (state.rs:440-564). Besides building/sorting it also
    STAGES each SortData (the host block plan) so that work overlaps the
    render thread's device work."""

    def __init__(self, wang: WangTileEngine, stage_fn=None):
        self.wang = wang
        self.stage_fn = stage_fn
        self.q_user_data = queue.Queue()
        self.q_build_info = queue.Queue()
        self.q_vp = queue.Queue()
        self.out_user_data = queue.Queue()
        self.out_scene = queue.Queue()
        self.out_sort = queue.Queue()
        self.out_build_time = queue.Queue()
        self.out_sort_time = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)

    @staticmethod
    def _drain(q):
        item = None
        got = False
        while True:
            try:
                item = q.get_nowait()
                got = True
            except queue.Empty:
                return got, item

    def _run(self):
        cur_camera_pos = None
        prev_vp = None
        next_scene_id = 0
        while not self._stop.is_set():
            idle = True
            got, user_data = self._drain(self.q_user_data)
            if got:
                cfg = self.wang.configure(user_data)
                self.out_user_data.put(cfg)
                cur_camera_pos = None
                prev_vp = None
                idle = False

            got, binfo = self._drain(self.q_build_info)
            if got:
                do_build, camera_pos, frame = binfo
                hostprof.set_thread_frame(frame)
                cur_camera_pos = np.asarray(camera_pos, np.float32)
                if do_build and self.wang.check_update(cur_camera_pos):
                    start = get_time_milliseconds()
                    with _hprof("stage.build"):
                        scene_data = self.wang.build_tiles(cur_camera_pos)
                    scene_data.scene_id = next_scene_id
                    self.out_scene.put(scene_data)
                    self.out_build_time.put(get_time_milliseconds() - start)
                    next_scene_id += 1
                idle = False

            got, item = self._drain(self.q_vp)
            if got and cur_camera_pos is not None:
                vp, frame = item
                hostprof.set_thread_frame(frame)
                skip = False
                if not self.wang.user_data.always_sort and prev_vp is not None:
                    if float(np.abs(prev_vp - vp).sum()) < 0.01:
                        skip = True  # state.rs:527-548
                if not skip:
                    prev_vp = vp
                    start = get_time_milliseconds()
                    dt, span = _sort(self.wang, cur_camera_pos, vp)
                    dt.scene_id = next_scene_id - 1
                    staged = (
                        self.stage_fn(dt, vp) if self.stage_fn is not None else None
                    )
                    self.out_sort.put((dt, staged, span))
                    self.out_sort_time.put(get_time_milliseconds() - start)
                idle = False

            if idle:
                self._stop.wait(0.001)


def _sort(wang: WangTileEngine, camera_pos, vp):
    """sort_tiles as the span stage.sort (sort_tiles adds its merge counts
    to it). Returns (DrawTable, the span or None while the profiler is
    off)."""
    with _hprof("stage.sort") as sec:
        dt = wang.sort_tiles(camera_pos, vp)
    return dt, sec.span()


class Engine:
    """The renderer session (State in state.rs). Runs on `device` ("cuda"
    by default; the CPU only when asked for)."""

    def __init__(self, scene_vec, viewport=(1920, 1080),
                 renderer_config: RendererConfig | None = None,
                 synchronous: bool = False, device="cuda"):
        device = resolve_device(device)
        self.camera = Camera.default(viewport)
        self.keyboard = KeyboardFlyControl()
        self.fly_path = FlyPathControl()
        self.camera_control = "keyboard"  # or "flypath"
        self.lockon_center = False
        self.lock_tile = False      # freeze the builder's tile map (gui lock)
        self.lock_sort = False      # freeze sorting (structure.rs:247-248)
        self.freeze_frame = False   # frozen-frame stepping (state.rs:378-382)
        self.step_frame = False
        self.synchronous = synchronous
        # frames kept in flight when not reading back: a frame returns once
        # launched and completes pipeline_depth frames later
        # (Renderer.render), so the host's dispatch overlaps the device
        self.pipeline_depth = 2

        self.wang = WangTileEngine(scene_vec)
        rc = renderer_config or RendererConfig(
            width=viewport[0], height=viewport[1]
        )
        self.renderer = Renderer(self.wang, rc, device=device)
        self.render_config = RenderConfig.new(self.wang.n_tiles[0])
        self.use_skybox = False
        self.use_proxy = False
        self.render_gs = True

        self.status = EngineStatus.CONFIG
        self.config_user_data: UserData | None = None
        self._config_id = 0

        # double buffering (state.rs:337-376)
        self.cur_scene = None
        self.next_scene = None
        self.cur_sort = None
        self.next_sort = None
        self._staged = None
        self._staged_sort = None   # the DrawTable object _staged was built from
        self._next_staged = None
        self._next_sort_span = None  # next_sort's stage.sort span, if traced
        self.frame_id = 0            # the last frame's id (frame())

        # metrics (structure.rs:224-230)
        window = 200
        self.frame_time_ma = IncrementalMA(window)
        self.sort_time_ma = IncrementalMA(window)
        self.build_time_ma = IncrementalMA(window)
        self.sort_trigger_ma = IncrementalMA(window)
        self.build_trigger_ma = IncrementalMA(window)
        self._frame_prev = get_time_milliseconds()

        self.builder = (
            None
            if synchronous
            else _Builder(
                self.wang,
                stage_fn=lambda dt, vp: self.renderer.stage_vp(
                    dt, vp, self.render_config.culling_dist
                ),
            )
        )
        self.scene_params: SceneParams | None = None
        self.last_image = None

    # ------------------------------------------------------------------ #
    def configure(self, user_data: UserData):
        """Submit a configuration (GUI Confirm, gui.rs:394-408)."""
        self._config_id += 1
        user_data.config_id = self._config_id
        self.status = EngineStatus.POST_CONFIG
        if self.synchronous:
            cfg = self.wang.configure(user_data)
            self._finish_configure(cfg)
        else:
            self.builder.q_user_data.put(user_data)

    def _finish_configure(self, cfg: UserData):
        if cfg.config_id != self._config_id:
            return  # stale reply (state.rs:261-262)
        self.config_user_data = cfg
        self.renderer.configure(cfg)
        self.status = EngineStatus.RENDER
        self.cur_scene = self.next_scene = None
        self.cur_sort = self.next_sort = None
        self._staged = None
        self._staged_sort = None

    # ------------------------------------------------------------------ #
    def set_skybox(self, tex, equirect=True, bake=False):
        """Upload a skybox (equirect HDRI [H,W,3] or faces [6,R,R,3]);
        mirrors the GUI skybox upload (skybox.rs:703-805). bake=True runs
        the reference's HDRI->cubemap bake."""
        self.renderer.set_skybox(tex, equirect=equirect, bake=bake)
        self.use_skybox = tex is not None

    def set_proxy(self, tex):
        """Upload the proxy ground texture (proxy.rs:447-554)."""
        self.renderer.set_proxy(tex)
        self.use_proxy = tex is not None

    # ------------------------------------------------------------------ #
    def handle_key(self, key: str, pressed: bool):
        if self.camera_control == "keyboard":
            self.keyboard.handle_key(key, pressed)

    def update(self) -> bool:
        """Per-frame camera update (state.rs:221-235)."""
        if self.camera_control == "keyboard":
            return self.keyboard.update(
                self.camera, self.frame_time_ma.calc()[0], self.lockon_center
            )
        return self.fly_path.handle_events(self.camera)

    # ------------------------------------------------------------------ #
    def _pump_builder(self, update_worker: bool):
        """Send camera state, receive build/sort results, promote pairs."""
        if self.synchronous:
            if update_worker:
                if not self.lock_tile and self.wang.check_update(self.camera.position):
                    start = get_time_milliseconds()
                    with _hprof("stage.build"):
                        sd = self.wang.build_tiles(self.camera.position)
                    sd.scene_id = getattr(self, "_sync_id", 0)
                    self.build_time_ma.add(get_time_milliseconds() - start)
                    self.build_trigger_ma.add(1.0)
                    self.next_scene = sd
                    self._sync_id = sd.scene_id + 1
                else:
                    self.build_trigger_ma.add(0.0)
                if not self.lock_sort:
                    start = get_time_milliseconds()
                    dt, self._next_sort_span = _sort(
                        self.wang, self.camera.position, self.camera.view_proj()
                    )
                    dt.scene_id = getattr(self, "_sync_id", 1) - 1
                    self.sort_time_ma.add(get_time_milliseconds() - start)
                    self.sort_trigger_ma.add(1.0)
                    self.next_sort = dt
        else:
            b = self.builder
            if update_worker:
                b.q_build_info.put((not self.lock_tile, self.camera.position.copy(),
                                    self.frame_id))
                if not self.lock_sort:
                    b.q_vp.put((self.camera.view_proj(), self.frame_id))
            got, t = b._drain(b.out_sort_time)
            self.sort_time_ma.add(t) if got else None
            self.sort_trigger_ma.add(1.0 if got else 0.0)
            got, t = b._drain(b.out_build_time)
            self.build_time_ma.add(t) if got else None
            self.build_trigger_ma.add(1.0 if got else 0.0)
            got, sd = b._drain(b.out_scene)
            if got:
                self.next_scene = sd
            got, item = b._drain(b.out_sort)
            if got:
                self.next_sort, self._next_staged, self._next_sort_span = item
            got, cfg = b._drain(b.out_user_data)
            if got and self.status == EngineStatus.POST_CONFIG:
                self._finish_configure(cfg)

        # fast path (state.rs:350-359): a re-sort of the CURRENT scene (e.g.
        # the camera rotated in place, so no rebuild happened) replaces
        # cur_sort directly — otherwise it would park in next_sort forever
        # waiting for a next_scene that never comes, rendering stale order.
        if (
            self.next_sort is not None
            and self.cur_scene is not None
            and self.next_sort.scene_id == self.cur_scene.scene_id
        ):
            self._promote_sort()

        # promote a matching (scene, sort) pair (state.rs:361-376)
        if (
            self.next_scene is not None
            and self.next_sort is not None
            and self.next_scene.scene_id == self.next_sort.scene_id
        ):
            self.cur_scene = self.next_scene
            self.next_scene = None
            self._promote_sort()

    def _promote_sort(self):
        hostprof.annotate(self._next_sort_span, drawn_frame=self.frame_id)
        self._next_sort_span = None
        self.cur_sort = self.next_sort
        if self._next_staged is not None:
            self._staged = self._next_staged
            self._staged_sort = self.cur_sort
        self._next_staged = None
        self.next_sort = None

    def frame(self, update_worker: bool = True, readback: bool = True):
        """One frame: update camera, pump the builder, render.
        Returns the image ([H,W,4] numpy, or a device tensor without
        readback) or None while not ready. Without readback the frame is
        rendered at pipeline_depth (complete only after a later frame or
        renderer.drain(); renderer.last_aux is then an older frame's), with
        readback at depth 0 (exact, its counts in last_aux). Each call is
        one frame id (hostprof.next_frame) and, while the host-section
        profiler is on, one span ``frame``."""
        self.frame_id = hostprof.next_frame()
        with _hprof("frame", self.renderer.device):
            return self._frame(update_worker, readback)

    def _frame(self, update_worker: bool, readback: bool):
        now = get_time_milliseconds()
        self.frame_time_ma.add(now - self._frame_prev)
        self._frame_prev = now

        if self.status == EngineStatus.POST_CONFIG and not self.synchronous:
            self._pump_builder(False)
        if self.status != EngineStatus.RENDER:
            return None

        with _hprof("frame.update_pump"):
            moved = self.update()
            self._pump_builder(update_worker and moved)
        if self.cur_scene is None or self.cur_sort is None:
            return None
        if self.freeze_frame and not self.step_frame:
            return self.last_image
        self.step_frame = False

        if self._staged_sort is not self.cur_sort:
            with _hprof("frame.stage"):
                self._staged = self.renderer.stage(
                    self.cur_sort, self.camera,
                    self.render_config.culling_dist
                )
            self._staged_sort = self.cur_sort

        self.scene_params = SceneParams.from_data(
            self.config_user_data, self.cur_scene.center_coord, self.render_config
        )
        img = self.renderer.render(
            self.cur_sort, self.camera, self.scene_params, self.render_config,
            render_gs=self.render_gs, use_skybox=self.use_skybox,
            use_proxy=self.use_proxy, staged=self._staged, as_numpy=readback,
            pipeline_depth=0 if readback else self.pipeline_depth,
        )
        self.last_image = img
        return img

    def wait_ready(self, timeout_s: float = 60.0):
        """Block until the first (scene, sort) pair is renderable."""
        start = get_time_milliseconds()
        while get_time_milliseconds() - start < timeout_s * 1000.0:
            img = self.frame(readback=False)
            if img is not None:
                return True
        return False

    # ------------------------------------------------------------------ #
    def run_benchmark(self, fly_path: FlyPathControl, readback: bool = False,
                      max_frames: int = 100000):
        """Fly-path benchmark (gui.rs:955-997): clears all MAs, replays the
        path in real time, returns mean/std of frame/sort/build time, the
        trigger rates, the windowed frame-time statistics and the run's
        frames that overflowed a pair budget (overflow_frames, which
        bench.py reports)."""
        for ma in (
            self.frame_time_ma, self.sort_time_ma, self.build_time_ma,
            self.sort_trigger_ma, self.build_trigger_ma,
        ):
            ma.clear()
        self.fly_path = fly_path
        self.camera_control = "flypath"
        fly_path.reset_path()
        fly_path.start_path()
        overflow0 = self.renderer.overflow_frames
        frames = 0
        stamps = [get_time_milliseconds()]
        t0 = stamps[0]
        while not fly_path.finished and frames < max_frames:
            self.frame(readback=readback)
            stamps.append(get_time_milliseconds())
            frames += 1
        # the wall clock stops only once the device has finished every
        # frame: without readback a frame returns when it is enqueued
        self.renderer.drain()
        wall = get_time_milliseconds() - t0
        self.camera_control = "keyboard"
        f_avg, f_std = self.frame_time_ma.calc()
        s_avg, s_std = self.sort_time_ma.calc()
        b_avg, b_std = self.build_time_ma.calc()
        # median over 16-frame windows: a single frame's stamp says when it
        # was enqueued, a window's span is throughput
        win = 16
        wins = [
            (stamps[i + win] - stamps[i]) / win
            for i in range(0, len(stamps) - win, win)
        ]
        swins = sorted(wins)
        median_ms = swins[len(swins) // 2] if swins else (
            wall / frames if frames else 0.0
        )
        # windows over 3x the median are stalls of the host, not of the
        # renderer; they are left out of the clean mean and their count is
        # reported, so a run that stalls dominate is visibly suspect
        kept = [w for w in wins if w <= 3.0 * median_ms] or wins
        stall_windows = len(wins) - len(kept)
        clean_ms = float(np.mean(kept)) if kept else median_ms
        sort_trigger = self.sort_trigger_ma.calc()[0]
        build_trigger = self.build_trigger_ma.calc()[0]
        return dict(
            frames=frames,
            wall_ms=wall,
            fps=frames / (wall / 1000.0) if wall > 0 else 0.0,
            median_frame_ms=median_ms,
            clean_frame_ms=clean_ms,
            n_windows=len(wins),
            stall_windows=stall_windows,
            frame_ms=(f_avg, f_std),
            sort_ms=(s_avg, s_std),
            build_ms=(b_avg, b_std),
            sort_trigger=sort_trigger,
            build_trigger=build_trigger,
            overflow_frames=self.renderer.overflow_frames - overflow0,
            # the share of the frame budget the builder thread's work would
            # take if it were serialized: < 1 means sorting fully overlaps
            builder_load=(
                (s_avg * sort_trigger + b_avg * build_trigger) / median_ms
                if median_ms > 0 else 0.0
            ),
        )

    def hud_text(self) -> str:
        """Terminal HUD: the reference's Render/Perf window counters
        (gui.rs:424-453, 790-828) as one line."""
        f_avg, f_std = self.frame_time_ma.calc()
        s_avg, _ = self.sort_time_ma.calc()
        b_avg, _ = self.build_time_ma.calc()
        fps = 1000.0 / f_avg if f_avg > 0 else 0.0
        splats = self.cur_scene.splat_count if self.cur_scene else 0
        per_lod = (
            "/".join(str(c) for c in self.cur_scene.lod_instance_count)
            if self.cur_scene
            else "-"
        )
        return (
            f"fps {fps:6.2f} | frame {f_avg:7.1f}±{f_std:5.1f} ms | "
            f"sort {s_avg:6.1f} ms ({self.sort_trigger_ma.calc()[0] * 100:3.0f}%) | "
            f"build {b_avg:6.1f} ms ({self.build_trigger_ma.calc()[0] * 100:3.0f}%) | "
            f"splats {splats:,} | tiles/lod {per_lod}"
        )

    @staticmethod
    def format_benchmark(r) -> str:
        """LaTeX-style dump like the reference (gui.rs:980-997), and on a
        line of its own the frames that overflowed a pair budget when the
        result counts them."""
        text = (
            "Render & Sort & Update\\\\\n"
            f"${r['frame_ms'][0]:.2f} \\pm {r['frame_ms'][1]:.2f}$ & "
            f"${r['sort_ms'][0]:.2f} \\pm {r['sort_ms'][1]:.2f}$ & "
            f"${r['build_ms'][0]:.2f} \\pm {r['build_ms'][1]:.2f}$"
        )
        if "overflow_frames" in r:
            text += f"\noverflow_frames {r['overflow_frames']}"
        return text

    # ------------------------------------------------------------------ #
    def save_checkpoint(self, path):
        """Full session checkpoint: UserData + camera + RNG state."""
        state = dict(
            user_data=json.loads(self.config_user_data.to_json())
            if self.config_user_data
            else None,
            camera=dict(
                position=self.camera.position.tolist(),
                target=self.camera.target.tolist(),
                up=self.camera.up.tolist(),
                fovy=self.camera.fovy,
                z_near=self.camera.z_near,
                z_far=self.camera.z_far,
                viewport=list(self.camera.viewport),
            ),
            rng_state=(
                dict(
                    stdrng=dict(
                        key=self.wang.rng.std.key.hex(),
                        counter=self.wang.rng.std._counter,
                        buf=list(self.wang.rng.std._buf),
                        word_width=self.wang.rng.std.word_width,
                    )
                )
                if hasattr(self.wang.rng, "std")
                else json.loads(json.dumps(self.wang.rng.bit_generator.state))
            ),
        )
        with open(path, "w") as f:
            json.dump(state, f, indent=2)

    def load_checkpoint(self, path):
        with open(path) as f:
            state = json.load(f)
        cam = state["camera"]
        self.camera = Camera(
            cam["viewport"], cam["position"], cam["target"], cam["up"],
            cam["fovy"], cam["z_near"], cam["z_far"],
        )
        if state.get("user_data"):
            ud = UserData.from_json(json.dumps(state["user_data"]))
            ud.reset_rng = False
            self.configure(ud)
        if state.get("rng_state"):
            rs = state["rng_state"]
            if isinstance(rs, dict) and "stdrng" in rs:
                from ..core.stdrng import NumpyCompatRng, StdRng

                s = rs["stdrng"]
                std = StdRng(0, word_width=s["word_width"])
                std.key = bytes.fromhex(s["key"])
                std._counter = int(s["counter"])
                std._buf = list(s["buf"])
                self.wang.rng = NumpyCompatRng(std)
            else:
                self.wang.rng.bit_generator.state = rs

    def shutdown(self):
        if self.builder is not None:
            self.builder.stop()
