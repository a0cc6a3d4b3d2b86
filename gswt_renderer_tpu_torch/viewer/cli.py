"""Command-line entry point: `python -m gswt_renderer_tpu_torch.viewer.cli ...`.

Subcommands mirror the reference's user surface (state.rs/gui.rs recast for
GPU sessions):
  view     load a tile zip (or synthetic set), start the HTTP viewer
  render   replay a fly-path JSON headless, writing PNG frames
  bench    run the fly-path benchmark and print the metrics
Every subcommand runs on the card unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _load_scene(args):
    from ..io import load_scene_zip, load_scene_dir
    from ..io.synth import synthetic_scene_vec

    if args.zip:
        return load_scene_zip(args.zip)
    if args.dir:
        return load_scene_dir(args.dir)
    return synthetic_scene_vec(
        n_lod=args.synth_lods, splats_per_tile=args.synth_splats
    )


def _make_engine(args):
    from ..core.config import (
        HeightMapType,
        SelectiveMergeType,
        SurfaceType,
        TileSortType,
        UserData,
    )
    from ..engine import Engine
    from ..render.pipeline import RendererConfig

    w, h = (int(x) for x in args.size.split("x"))
    eng = Engine(
        _load_scene(args),
        viewport=(w, h),
        renderer_config=RendererConfig(width=w, height=h),
        synchronous=args.sync,
        device=args.device,
    )
    from ..io.textures import (
        load_height_map,
        load_proxy_texture,
        load_skybox_faces,
        load_skybox_hdri,
    )

    height_tex = None
    if args.height_tex:
        hm, wh = load_height_map(args.height_tex)
        height_tex = (hm, wh)
    if args.config:
        with open(args.config) as f:
            ud = UserData.from_json(f.read())
        if height_tex is not None:
            ud.height_tex = height_tex
            ud.height_map_type = HeightMapType.TEXTURE
    else:
        ud = UserData.from_ui(
            tile_map_half_wh=(args.half, args.half),
            tile_width=args.tile_width,
            surface_type=SurfaceType[args.surface.upper()],
            height_map_wh=(10, 10),
            height_map_scale=(1.0, args.height_scale),
            lod_max_dist=args.lod_max_dist,
            lod_transition_width_ratio=0.05,
            merge_type=SelectiveMergeType[args.merge.upper()],
            merge_dot_threshold=0.2,
            merge_topk=100,
            tile_sort_type=TileSortType[args.tile_sort.upper()],
        )
        if height_tex is not None:
            ud.height_tex = height_tex
            ud.height_map_type = HeightMapType.TEXTURE
    if args.skybox_hdri:
        eng.set_skybox(load_skybox_hdri(args.skybox_hdri), equirect=True)
    elif args.skybox_faces:
        eng.set_skybox(load_skybox_faces(args.skybox_faces), equirect=False)
    if args.proxy_tex:
        eng.set_proxy(load_proxy_texture(args.proxy_tex)[0])
    eng.configure(ud)
    if not eng.wait_ready(timeout_s=600):
        eng.shutdown()
        raise RuntimeError("engine failed to start")
    return eng


def _add_scene_args(p):
    p.add_argument("--zip", help="tile-set zip (lod{L}_tile_{T}.ply entries)")
    p.add_argument("--dir", help="directory of tile files")
    p.add_argument("--synth-lods", type=int, default=3)
    p.add_argument("--synth-splats", type=int, default=512)
    p.add_argument("--size", default="1280x720")
    p.add_argument("--half", type=int, default=16, help="tile map half size")
    p.add_argument("--tile-width", type=float, default=4.0)
    p.add_argument("--surface", default="height_map",
                   choices=["none", "height_map", "sphere"])
    p.add_argument("--height-scale", type=float, default=0.3)
    p.add_argument("--lod-max-dist", type=float, default=48.0)
    p.add_argument("--merge", default="edge", choices=["none", "axis", "edge"])
    p.add_argument("--tile-sort", default="graph",
                   choices=["distance", "viewport", "object", "graph"])
    p.add_argument("--config", help="UserData JSON (checkpoint) to load")
    p.add_argument("--sync", action="store_true",
                   help="synchronous builder (no worker thread)")
    p.add_argument("--height-tex", help="height map image (png/jpg)")
    p.add_argument("--skybox-hdri", help="equirect EXR HDRI")
    p.add_argument("--skybox-faces", nargs=6, metavar="FACE",
                   help="6 cubemap face images (+x,-x,+y,-y,+z,-z)")
    p.add_argument("--proxy-tex", help="proxy ground texture (png/jpg)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch path)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="gswt-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_view = sub.add_parser("view", help="interactive HTTP viewer")
    _add_scene_args(p_view)
    p_view.add_argument("--port", type=int, default=8080)

    p_render = sub.add_parser("render", help="headless fly-path render")
    _add_scene_args(p_render)
    p_render.add_argument("--fly-path", required=True)
    p_render.add_argument("--out", default="frames")
    p_render.add_argument("--fps", type=float, default=10.0)

    p_bench = sub.add_parser("bench", help="fly-path benchmark")
    _add_scene_args(p_bench)
    p_bench.add_argument("--fly-path")

    args = ap.parse_args(argv)
    eng = _make_engine(args)
    try:
        if args.cmd == "view":
            from .server import serve

            serve(eng, port=args.port)
        elif args.cmd == "render":
            from ..engine import FlyPathControl
            from .headless import render_flypath_frames

            with open(args.fly_path) as f:
                fp = FlyPathControl.from_json(f.read())
            paths = render_flypath_frames(eng, fp, args.out, fps=args.fps)
            print(f"wrote {len(paths)} frames to {args.out}")
        elif args.cmd == "bench":
            from ..engine import Engine, FlyPathControl, FlyPathFrame

            if args.fly_path:
                with open(args.fly_path) as f:
                    fp = FlyPathControl.from_json(f.read())
            else:
                fp = FlyPathControl()
                fp.keyframes = [
                    FlyPathFrame(0.0, np.array([0, 0, 5], np.float32),
                                 np.array([0, 30, 2], np.float32)),
                    FlyPathFrame(10.0, np.array([8, 25, 5], np.float32),
                                 np.array([12, 55, 2], np.float32)),
                ]
            r = eng.run_benchmark(fp)
            print(json.dumps({k: v for k, v in r.items()}, default=float, indent=2))
            print(Engine.format_benchmark(r))
    finally:
        eng.shutdown()


if __name__ == "__main__":
    main()
