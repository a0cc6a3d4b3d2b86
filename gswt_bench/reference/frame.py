"""One judged frame, worked out by the reference, and the numbers that
compare it with the program's frame."""

from __future__ import annotations

import numpy as np
import torch

from ..frozen.scene import bench_textures
from . import background, camera, composite, project
from . import store as store_mod

# stream rows projected at once (bounds the reference's memory)
PROJECT_ROWS = 1 << 21


def render(inputs, record, *, min_t=None, control=None):
    """The reference image [H, W, 4] of a judged frame, (kept pair-pixels,
    splats with one) when min_t is given, and the far-ground mask [H, W].
    `inputs`: the benchmark's store, height map, textures, scene and the
    program's presort lists (frame_inputs); `record`: the frame's pose,
    draw list and map centre. With `control` (a torch dtype) the splats are
    composited by composite_sequential in that type."""
    dev = inputs["device"]
    w, h = inputs["width"], inputs["height"]
    cam = camera.camera(record["position"], record["target"], w, h)
    scene = dict(inputs["scene"], center_coord=tuple(int(v) for v in record["center_coord"]))
    hm = torch.as_tensor(inputs["height_map"], device=dev)
    if inputs["skybox"] is not None:
        bg = background.skybox(cam, w, h, inputs["skybox"], dev)
    else:
        bg = torch.zeros((h, w, 4), dtype=torch.float32, device=dev)
    depth = None
    far = torch.zeros((h, w), dtype=torch.bool, device=dev)
    if inputs["pyramid"] is not None:
        pcol, depth, hit, far = background.proxy(cam, scene, hm, inputs["height_map_wh"],
                                                 inputs["pyramid"], w, h, dev)
        bg = torch.where(hit[..., None], pcol, bg)
    stream = project.assemble_stream(record["draw"], inputs["preload"], cam, 1.0, dev)
    n = stream["gs_index"].shape[0]
    parts = []
    for lo in range(0, n, PROJECT_ROWS):
        part = {k: v[lo:lo + PROJECT_ROWS] for k, v in stream.items()}
        parts.append(project.project(record["draw"], inputs["store"], scene, cam, hm,
                                     inputs["height_map_wh"], part))
    table = {k: torch.cat([p[k] for p in parts]) for k in parts[0]} if parts else None
    if table is None:
        return bg, 0, 0, far
    if control is not None:
        return composite.composite_sequential(table, w, h, bg, depth, dtype=control), 0, 0, far
    img, kept, rows = composite.composite(table, w, h, bg, depth, min_t=min_t)
    return img, kept, rows, far


# the numbers image_numbers gives, each the worst over a run's judged frames
IMAGE_NUMBERS = ("frame_mean_abs", "frame_bad_px_share", "far_ground_mean_abs")


def image_numbers(program, reference, far) -> dict:
    """The numbers a judged frame is compared by. Off the far ground: the
    mean over pixels and channels of the absolute difference, and the share
    of pixels whose largest channel difference is over 16/255. On the far
    ground (the rings beyond the tile map): the mean absolute difference, 0
    where there is none."""
    diff = (program.to(torch.float32) - reference.to(torch.float32)).abs()
    diff = torch.nan_to_num(diff, nan=1.0, posinf=1.0)
    near = diff[~far]
    fard = diff[far]
    return dict(frame_mean_abs=float(near.mean()),
                frame_bad_px_share=float((near.amax(dim=-1) > 16.0 / 255.0).float().mean()),
                far_ground_mean_abs=float(fard.mean()) if fard.numel() else 0.0)


def frame_inputs(cfg, raw, preload, device) -> dict:
    """The reference's inputs that do not change from frame to frame."""
    st = store_mod.build_store(raw, cfg["lod_max_dist"], cfg["tile_width"])
    hm, hm_wh = store_mod.height_map((cfg["height_map_w"], cfg["height_map_h"]),
                                     cfg["tile_width"], cfg["height_map_scale_z"])
    sky, checker = bench_textures((cfg["sky_h"], cfg["sky_w"]), cfg["checker_cells"],
                                  cfg["checker_cell"])
    half = cfg["tile_map_half"]
    return dict(
        device=device, width=cfg["width"], height=cfg["height"], store=st,
        height_map=hm, height_map_wh=hm_wh, preload=preload,
        skybox=sky if cfg["skybox"] else None,
        pyramid=background.mip_pyramid(checker) if cfg["proxy"] else None,
        scene=dict(
            map_half_wh=(half, half), tile_width=float(cfg["tile_width"]),
            # (s_xy, s_xy, s_z), the GUI's expansion (structure.rs:140-211)
            height_map_scale=np.array([cfg["height_map_scale_xy"]] * 2
                                      + [cfg["height_map_scale_z"]], np.float32),
            surface_type=1, transition_dist=st["transition_dist"],
            transition_width_ratio=float(cfg["lod_transition_width_ratio"]),
            # the shader is passed the tile count as num_lod (renderer.rs:646)
            num_lod=len(raw[0]),
        ),
    )
