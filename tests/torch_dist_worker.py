"""One rank of the port's 4-rank gloo test (tests/test_torch_parallel.py)
and the small scene both use. Imports no jax.

    python tests/torch_dist_worker.py <init file> <rank> <world size> <out.json>

Every rank joins a gloo group through the file store, builds the same
64x64 scene on the CPU, and runs render_cameras_sharded and
render_stream_sharded on a (2, 2) ("dp", "sp") mesh; rank 0 renders the
single-device frames and writes what it found to <out.json>.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

# tests/test_parallel.py's scene: a height map with Edge merging, so segment
# boundaries land inside draws (200 splats a tile: blended draws take two
# stream blocks, filtered ones one)
UI = dict(tile_map_half_wh=(2, 2), height_map_scale=(1.0, 0.2),
          height_map_wh=(8, 8), lod_max_dist=8.0, merge_dot_threshold=0.5,
          merge_topk=20, lod_blending=True)
CAM_POS = (0.0, 0.0, 4.0)
TARGET = (0.0, 8.0, 1.0)
W = H = 64


def textures():
    """The skybox ramp and checker proxy of tests/test_parallel.py."""
    sky = np.clip(np.linspace(0, 3, 16)[:, None, None]
                  * np.ones((16, 32, 3), np.float32), 0, 3)
    c = np.kron(np.indices((8, 8)).sum(0) % 2,
                np.ones((4, 4))).astype(np.float32)
    return sky, np.stack([c, c * 0.5, c * 0.2], axis=-1)


def cameras(camera_cls, n):
    """n distinct cameras around the scene's."""
    return [
        camera_cls((W, H),
                   np.array([0.3 * i - 0.5, 0.2 * i, 4.0 + 0.1 * i],
                            np.float32),
                   (0.3 * i - 0.5, 8.0, 1.0), (0.0, 0.0, 1.0),
                   np.deg2rad(45.0), 0.1, 200.0)
        for i in range(n)
    ]


def small_scene(full: bool = False):
    """The scene on the port's own classes, an exact-profile CPU Renderer
    on it and its staged plan; with full, the skybox and proxy are set."""
    from gswt_renderer_tpu_torch.core import Camera, UserData
    from gswt_renderer_tpu_torch.core.config import (
        RenderConfig, SelectiveMergeType, SurfaceType, TileSortType)
    from gswt_renderer_tpu_torch.io.synth import synthetic_scene_vec
    from gswt_renderer_tpu_torch.render.pipeline import Renderer, RendererConfig
    from gswt_renderer_tpu_torch.render.uniforms import SceneParams
    from gswt_renderer_tpu_torch.tiles import WangTileEngine

    eng = WangTileEngine(synthetic_scene_vec(n_lod=2, splats_per_tile=200))
    ud = UserData.from_ui(surface_type=SurfaceType.HEIGHT_MAP,
                          merge_type=SelectiveMergeType.EDGE,
                          tile_sort_type=TileSortType.GRAPH, **UI)
    eng.configure(ud)
    cam_pos = np.array(CAM_POS, np.float32)
    eng.build_tiles(cam_pos)
    camera = Camera((W, H), cam_pos, TARGET, (0.0, 0.0, 1.0),
                    np.deg2rad(45.0), 0.1, 200.0)
    dt = eng.sort_tiles(cam_pos, camera.view_proj())
    r = Renderer(eng, RendererConfig(width=W, height=H, max_draws=128,
                                     max_stream=1 << 14, chunk=128,
                                     exact=True), device="cpu")
    r.configure(ud)
    if full:
        sky, checker = textures()
        r.set_skybox(sky, equirect=True)
        r.set_proxy(checker)
    rc = RenderConfig.new(eng.n_tiles[0])
    sp = SceneParams.from_data(ud, eng.center_coord, rc)
    return dict(r=r, sp=sp, rc=rc, staged=r.stage(dt), camera=camera,
                cameras=cameras(Camera, 4))


def main(argv):
    import torch.distributed as dist

    from gswt_renderer_tpu_torch.parallel import (
        make_mesh, render_cameras_sharded, render_stream_sharded)
    from gswt_renderer_tpu_torch.parallel.batched import pack_camera_batch

    init_file, rank, world, out_path = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh((2, world // 2), device_type="cpu")
        s = small_scene(full=True)
        r, sp, rc, staged = s["r"], s["sp"], s["rc"], s["staged"]
        full = dict(use_skybox=True, use_proxy=True)
        cam_batch = pack_camera_batch(r, sp, s["cameras"], rc)
        imgs = render_cameras_sharded(r, staged, sp, cam_batch, mesh, rc,
                                      **full)
        try:
            render_cameras_sharded(r, staged, sp, cam_batch[:3], mesh, rc)
            uneven = "no error"
        except ValueError as e:
            uneven = str(e)
        gs = render_stream_sharded(r, staged, sp, s["camera"], mesh, rc)
        calls = []
        for _ in range(4):  # the cut's feedback, call over call
            img = render_stream_sharded(r, staged, sp, s["camera"], mesh, rc,
                                        **full)
            calls.append(dict(bounds=r.last_sp_bounds,
                              pairs=r.last_shard_pairs_kept))
        if rank == 0:
            ref_dp = [r.render(None, c, sp, rc, staged=staged, as_numpy=False,
                               **full) for c in s["cameras"]]
            ref_gs = r.render(None, s["camera"], sp, rc, staged=staged,
                              as_numpy=False)
            ref = r.render(None, s["camera"], sp, rc, staged=staged,
                           as_numpy=False, **full)
            out = dict(
                dp_shape=list(imgs.shape),
                dp_err=[float((imgs[i] - ref_dp[i]).abs().max())
                        for i in range(len(ref_dp))],
                uneven=uneven,
                sp_gs_err=float((gs - ref_gs).abs().max()),
                sp_err=float((img - ref).abs().max()),
                kept=int(r.last_aux["n_pairs_kept"]),
                calls=calls,
            )
            with open(out_path, "w") as f:
                json.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
