#!/usr/bin/env python
"""A/B of the triangle raster's warp-block mask on the bench frame.

    python -m gswt_renderer_tpu_torch.benchmarks.trirast_mask_ab [--rounds 7]

Builds ``csrc/trirast.cu`` twice with nvcc, as it is and with the mask
taken out (every warp walks every pair of its entry; the tests and the
bits are the same), and times both on the proxy grid of the bench scene
(``headline``'s scene, textures and user data) at the fly path's first
camera, at 960x540 (the fast profile's proxy pass) and 1920x1080: the
raster (entries and fold), the entries alone, and the longest run alone.
Each figure is the median, min and max over `rounds` rounds of 200
back-to-back calls of the C entry (CUDA events), the two builds taking
turns. Both builds are held bit-equal to the plain spec first. Card only.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import numpy as np
import torch

from ..io.synth import synthetic_scene_vec
from ..ops import kernels, proxy, trirast
from ..ops.binning import fit_capacity
from ..ops.kernels import resolve_device
from . import headline
from .timing import device_label, time_ms

# the mask's one use in csrc/trirast.cu: a pair's 32 block bits
MASK_CALL = ("__ballot_sync(kFull, pair_reaches_block(s_tab, j,\n"
             "                                                               "
             "s_rect[lane]))")


def unmasked_source() -> str:
    """csrc/trirast.cu with every pair kept in every warp block."""
    with open(os.path.join(kernels.CSRC, "trirast.cu")) as f:
        src = f.read()
    if src.count(MASK_CALL) != 1:
        raise RuntimeError("trirast.cu no longer computes its mask where "
                           "this A/B expects it")
    return src.replace(MASK_CALL, "kFull")


def _build(sources: dict) -> dict:
    """{name: C entry gswt_trirast} for {name: CUDA source}, nvcc at once."""
    os.makedirs(kernels.BUILD, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = os.path.join(kernels.BUILD, f"trirast_ab_{name}.cu")
        so = os.path.join(kernels.BUILD, f"libtrirast_ab_{name}.so")
        with open(cu, "w") as f:
            f.write(src)
        cmd = kernels._compile_cmd("trirast", so)
        cmd[-1] = cu
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries = {}
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        fn = ctypes.CDLL(so).gswt_trirast
        fn.argtypes = [vp, ll, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
        entries[name] = fn
    return entries


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=7)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    print(f"[trirast_mask_ab] {device_label(dev)}")
    with open(os.path.join(kernels.CSRC, "trirast.cu")) as f:
        entries = _build({"mask": f.read(), "no_mask": unmasked_source()})

    eng = headline.make_engine(
        synthetic_scene_vec(n_lod=3, splats_per_tile=512, lod_decay=2, seed=0),
        1920, 1080, dev)
    fp = headline.fly_path()
    fp.start_path()
    fp.handle_events(eng.camera, now_ms=0.0)
    r = eng.renderer
    scene_d, cam_d = r.frame_uniforms(eng.camera, eng.scene_params,
                                      eng.render_config)[:2]
    ptile = (r.cfg.proxy_tile_w, r.cfg.proxy_tile_h)
    try:
        for wh in ((960, 540), (1920, 1080)):
            planes, ok, bbox = proxy.map_grid_planes(
                cam_d, scene_d, wh, r.hm4, r.height_map_wh, r.proxy_verts,
                r.proxy_tris, surface_type=int(eng.scene_params.surface_type),
                height_offset=float(eng.render_config.proxy_height))
            # the table of the demand itself (a first call reads it)
            kw = dict(image_wh=wh, tile_wh=ptile)
            n = trirast.bin_triangles(planes, bbox, ok, capacity=128,
                                      **kw)[3]
            rows, rs, re_, _ = trirast.bin_triangles(
                planes, bbox, ok, capacity=fit_capacity(n, 128), **kw)
            want = trirast.rasterize_triangles_plain(
                rows, rs, re_, image_wh=wh, tile_wh=ptile, chunk=128)
            scratch = trirast.fold_scratch(rows.shape[1], ptile, 128, dev)
            out = torch.empty_like(want)
            top = torch.arange(rs.shape[0], device=dev) == torch.argmax(re_ - rs)
            alone = (torch.where(top, rs, 0).int().contiguous(),
                     torch.where(top, re_, 0).int().contiguous())
            ntx = -(-wh[0] // ptile[0])

            def call(name, mode, ranges=(rs, re_)):
                rc = entries[name](
                    rows.data_ptr(), rows.shape[1], ranges[0].data_ptr(),
                    ranges[1].data_ptr(), out.data_ptr(), scratch.data_ptr(),
                    rs.shape[0], ntx, ptile[0], ptile[1], 128, mode,
                    kernels.stream_ptr(out))
                kernels.check(rc, f"trirast {name}")

            for name in entries:
                call(name, 3)
                if not torch.equal(out, want):
                    raise RuntimeError(f"trirast {name} is not the plain spec")
            cases = {"raster": lambda n: call(n, 3),
                     "entries": lambda n: call(n, 1),
                     "longest run alone": lambda n: call(n, 3, alone)}
            ms = {(n, c): [] for n in entries for c in cases}
            for k in range(args.rounds):
                for n in (sorted(entries) if k % 2 == 0
                          else sorted(entries, reverse=True)):
                    for c, fn in cases.items():
                        ms[(n, c)].append(time_ms(lambda: fn(n), 200, dev))
            print(f"[trirast_mask_ab] {wh[0]}x{wh[1]}: {rows.shape[1]} pairs "
                  f"on {rs.shape[0]} tiles; both builds bit-equal to the "
                  f"plain spec")
            for c in cases:
                for n in entries:
                    x = np.array(ms[(n, c)])
                    print(f"[trirast_mask_ab] {wh[0]}x{wh[1]} {c}, {n}: "
                          f"median {np.median(x):.5f} ms (min {x.min():.5f}, "
                          f"max {x.max():.5f})")
    finally:
        eng.shutdown()


if __name__ == "__main__":
    main()
