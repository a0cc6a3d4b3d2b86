"""Multi-device rendering over torch.distributed.

The reference has no multi-device story (its parallelism is a host worker
thread and the GPU itself); as in the JAX package, two modes compose on a
2D ("dp", "sp") DeviceMesh over the initialised process group:

- **Camera parallel (dp)**: a batch of cameras split over the dp ranks;
  each rank renders its cameras in turn with the full resident scene
  (dataset generation). One all_gather of the images at the end.

- **Stream parallel (sp)**: ONE camera whose front-to-back splat stream is
  cut into contiguous segments, one per sp rank. Ordered alpha compositing
  factors through the associative operator
      (c1, T1) o (c2, T2) = (c1 + T1 * c2, T1 * T2)
  so each rank composites its segment over a zero background (still
  depth-tested against the proxy), the segment images are all-gathered and
  folded in stream order, and the background lands once on the result.

The cut is demand-weighted and lane-granular: the previous call's exact
per-block pair demand (ops/binning.py emit_block_demand) weights the next
call's boundaries, so the pairs per segment balance within a few calls even
when one 256-lane block has to be split (row 5 of the block plan, the first
live lane; ops/project.py). `render_stream_segments` renders the same
segments in turn on one device, with the same cut, feedback and fold and no
collective.

Every rank runs the port's kernels on its own device: NCCL on "cuda", gloo
on the CPU (device="cpu" renderers). Both modes render at depth 0: each
camera's, background's and segment's counts are read at its end, and one
that overflowed a pair budget is rendered again with the grown budget
(Renderer.exactly), so every image is exact.
"""

from __future__ import annotations

import contextlib
import socket

import numpy as np
import torch
import torch.distributed as dist

from ..core.camera import CameraUniforms
from ..core.config import RenderConfig
from ..ops.kernels import resolve_device
from ..render.pipeline import STREAM_BLOCK, upload_parts

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(shape=None, axis_names=("dp", "sp"), device_type="cuda"):
    """A DeviceMesh over the initialised process group; shape defaults to
    (world size, 1). On "cuda" the group must be NCCL's, on the CPU gloo's:
    a mesh never falls back to another device than the one asked for."""
    dev = resolve_device(device_type)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed."
                           "init_process_group to have run")
    backend = dist.get_backend()
    if backend != _BACKEND[dev.type]:
        raise RuntimeError(f"a {dev.type} mesh needs the "
                           f"{_BACKEND[dev.type]} backend, not {backend}")
    n = dist.get_world_size()
    if shape is None:
        shape = (n, 1)
    if len(shape) != len(axis_names) or int(np.prod(shape)) != n:
        raise ValueError(f"mesh {tuple(shape)} over axes {axis_names} does "
                         f"not hold {n} ranks")
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(dev.type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


@contextlib.contextmanager
def group_of_one(device_type="cuda"):
    """A process group of this process alone (NCCL on "cuda", gloo on the
    CPU) through a TCP store on a free localhost port, and its (1, 1) mesh;
    the group is destroyed on exit. dp = sp = 1 with a real collective."""
    dev = resolve_device(device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group(_BACKEND[dev.type],
                            init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        yield make_mesh((1, 1), device_type=dev.type)
    finally:
        dist.destroy_process_group()


def _axis(mesh, name):
    """(size, this rank's index, process group) of mesh axis `name`."""
    dim = mesh.mesh_dim_names.index(name)
    return mesh.size(dim), mesh.get_local_rank(name), mesh.get_group(name)


def composite_over(front, back):
    """Premultiplied front-over-back for (rgb, alpha) images [..., 4]:
    out = front + (1 - front_alpha) * back."""
    return front + (1.0 - front[..., 3:4]) * back


def pack_camera_batch(renderer, scene_params, cameras, render_config=None):
    """Stacked per-camera packed uniforms [B, UNIFORMS_LEN] f32 on the
    renderer's device."""
    rc = render_config or RenderConfig.new(renderer.engine.n_tiles[0])
    lod_enable = list(rc.lod_enable or [True] * 16)
    vecs = [
        renderer.pack_frame_uniforms(scene_params, CameraUniforms(c),
                                     lod_enable, rc.culling_dist)
        for c in cameras
    ]
    return upload_parts([np.stack(vecs)], renderer.device)[0]


def _layers(renderer, use_skybox, use_proxy):
    """The skybox and proxy flags as Renderer.render resolves them: drawn
    only when asked for and their texture is set."""
    return (bool(use_skybox and renderer.skybox_tex is not None),
            bool(use_proxy and renderer.proxy_tex is not None))


def render_cameras_sharded(renderer, staged, scene_params, cam_batch, mesh,
                           render_config=None, *, use_skybox=False,
                           use_proxy=False):
    """Render a batch of cameras split over the mesh's "dp" axis.

    cam_batch: [B, UNIFORMS_LEN] packed uniforms (pack_camera_batch); B must
    divide by the dp size. Each dp rank renders its B / dp cameras in turn
    from the staged plan (Renderer.stage). The images are all-gathered over
    dp, so every rank returns all of them: [B, H, W, 4] on its device.
    use_skybox/use_proxy render the full frame per camera with the
    renderer's textures. No saturation cull (it carries one camera's state
    from frame to frame)."""
    resolve_device(renderer.device)
    rc = render_config or RenderConfig.new(renderer.engine.n_tiles[0])
    cam_batch = torch.as_tensor(cam_batch, dtype=torch.float32).to(
        renderer.device)
    n_dp, i_dp, group = _axis(mesh, "dp")
    b = cam_batch.shape[0]
    if b % n_dp:
        raise ValueError(f"a camera batch of {b} does not divide over "
                         f"dp = {n_dp} ranks")
    use_skybox, use_proxy = _layers(renderer, use_skybox, use_proxy)
    plan = renderer.upload_plan(staged)
    per = b // n_dp
    imgs = []
    for k in range(i_dp * per, (i_dp + 1) * per):
        def attempt(k=k):
            binned, bg, depth_tiles, aux = renderer.front_packed(
                plan, cam_batch[k], scene_params, rc, use_skybox=use_skybox,
                use_proxy=use_proxy)
            return renderer.back(binned, bg, depth_tiles,
                                 use_proxy=use_proxy), aux

        imgs.append(renderer.exactly(attempt))
    local = torch.stack(imgs)
    out = [torch.empty_like(local) for _ in range(n_dp)]
    dist.all_gather(out, local, group=group)
    return torch.cat(out)


# ---------------------------------------------------------------------- #
# stream parallel


def stream_cut(renderer, blocks_host, n_seg: int):
    """Cut the staged stream into n_seg contiguous segments of about equal
    pair demand. blocks_host: the staged plan's blocks [5, NB] (numpy).

    Boundaries are lanes, at equal quantiles of the demand: the previous
    call's observed pair demand per window entry (renderer._sp_feedback,
    recorded by the stream renderers for the same n_seg and stream length),
    else the live lanes per block. Returns (lane_bounds [n_seg + 1],
    entries): entries[i] is segment i's window entries [n_i, 3] i64 (block,
    lo, nvalid), whole blocks with a boundary block's live lanes narrowed to
    [lo, nvalid)."""
    blk = STREAM_BLOCK
    bh = np.asarray(blocks_host)
    nb = bh.shape[1]
    n_lanes = nb * blk
    if nb == 0:
        return [0] * (n_seg + 1), [np.zeros((0, 3), np.int64)] * n_seg
    nvalid = bh[3].astype(np.int64)
    fb = getattr(renderer, "_sp_feedback", None)
    segs = None
    if fb and fb.get("n_sp") == n_seg and fb.get("n_lanes") == n_lanes:
        segs = fb["segs"]
    if segs is None:
        g0 = np.arange(nb, dtype=np.int64) * blk
        segs = (g0, g0 + blk, np.maximum(bh[3].astype(np.float64), 0.0))
    s0, s1, dm = segs
    ln = np.maximum(s1 - s0, 1).astype(np.float64)
    w = np.maximum(dm, 0.0) + 1e-9 * ln  # eps: dead spans stay cuttable
    cum = np.concatenate([[0.0], np.cumsum(w)])
    tot = float(cum[-1])
    lane_bounds = [0]
    for i in range(1, n_seg):
        t = tot * i / n_seg
        j = int(np.searchsorted(cum, t, side="right")) - 1
        j = min(max(j, 0), len(s0) - 1)
        frac = (t - cum[j]) / max(float(w[j]), 1e-12)
        lane = int(round(s0[j] + frac * (s1[j] - s0[j])))
        lane_bounds.append(min(max(lane, lane_bounds[-1]), n_lanes))
    lane_bounds.append(n_lanes)
    entries = []
    for i in range(n_seg):
        l0, l1 = lane_bounds[i], lane_bounds[i + 1]
        b = np.arange(l0 // blk, -(-l1 // blk), dtype=np.int64)
        lo = np.maximum(0, l0 - b * blk)
        nv = np.minimum(nvalid[b], l1 - b * blk)
        keep = nv > lo
        entries.append(np.stack([b[keep], lo[keep], nv[keep]], 1))
    return lane_bounds, entries


def segment_blocks(blocks_host, entries):
    """The 6-row block plan [6, max(len(entries), 1)] i32 of one segment:
    the staged rows of each entry's block with nvalid narrowed and row 5
    the first live lane. A segment without entries gets one padding entry
    (panel 0, nvalid 0: every lane dead)."""
    bh = np.asarray(blocks_host)
    e = np.asarray(entries, np.int64).reshape(-1, 3)
    out = np.zeros((6, max(len(e), 1)), np.int32)
    if len(e):
        out[0:5, : len(e)] = bh[:, e[:, 0]]
        out[3, : len(e)] = e[:, 2]
        out[5, : len(e)] = e[:, 1]
    return out


def _frame_setup(renderer, staged, scene_params, camera, rc, use_skybox,
                 use_proxy):
    """What every segment of one frame shares: the uploaded plan, the
    packed uniforms and their unpacked form, the background and the proxy
    depth."""
    use_skybox, use_proxy = _layers(renderer, use_skybox, use_proxy)
    uniforms = renderer.pack_uniforms(camera, scene_params, rc)
    unpacked = renderer.unpack_frame_uniforms(uniforms)

    def attempt():
        bg, depth_tiles, aux = renderer.background(
            unpacked, scene_params, rc, use_skybox=use_skybox,
            use_proxy=use_proxy)
        return (bg, depth_tiles), aux

    bg, depth_tiles = renderer.exactly(attempt)
    return dict(plan=renderer.upload_plan(staged),
                blocks_host=staged["blocks"], uniforms=uniforms,
                unpacked=unpacked, bg=bg,
                depth_tiles=depth_tiles, use_proxy=use_proxy, scene=scene_params,
                rc=rc)


def render_segment(renderer, frame, entries):
    """Render one stream segment from its window entries (stream_cut) over a
    zero background, depth-tested against the frame's proxy depth. Returns
    (premultiplied image [H, W, 4], pairs kept (0-d tensor), pair demand
    of each window entry [max(len(entries), 1)])."""
    plan = dict(frame["plan"], blocks=torch.as_tensor(
        segment_blocks(frame["blocks_host"], entries)).to(renderer.device))
    p = renderer._project(plan, frame["uniforms"], frame["unpacked"],
                          frame["scene"], frame["rc"])

    def attempt():
        binned, aux = renderer.bin_pairs(p, frame["depth_tiles"],
                                         use_proxy=frame["use_proxy"],
                                         emit_block_demand=True,
                                         budget=renderer.segment_budget)
        img = renderer.back(binned, torch.zeros_like(frame["bg"]),
                            frame["depth_tiles"], use_proxy=frame["use_proxy"])
        return (img, aux["n_pairs_kept"], aux["block_demand"]), aux

    return renderer.exactly(attempt, renderer.segment_budget)


def _fold(imgs, bg):
    """Fold segment images front to back and land them on the background."""
    out = imgs[0]
    for nxt in imgs[1:]:
        out = composite_over(out, nxt)
    return out + (1.0 - out[..., 3:4]) * bg


def _record(renderer, lane_bounds, entries, kept, demand):
    """Keep the cut, the pairs per segment and, with more than one segment,
    the observed demand per window entry for the next call's cut (a block
    split between two segments reports each side apart, so the density
    inside it refines call over call)."""
    blk = STREAM_BLOCK
    n_seg = len(entries)
    renderer.last_sp_bounds = list(lane_bounds)
    renderer.last_shard_pairs_kept = [int(k) for k in kept]
    if n_seg == 1:
        return
    e = np.concatenate(entries)
    d = np.concatenate([
        np.asarray(x.cpu() if torch.is_tensor(x) else x, np.float64)[:len(ents)]
        for ents, x in zip(entries, demand)])
    renderer._sp_feedback = dict(
        n_sp=n_seg, n_lanes=int(lane_bounds[-1]),
        segs=(e[:, 0] * blk + e[:, 1], e[:, 0] * blk + e[:, 2], d))


def render_stream_segments(renderer, staged, scene_params, camera, n_seg,
                           render_config=None, *, use_skybox=False,
                           use_proxy=False):
    """Render ONE camera as n_seg stream segments in turn on the renderer's
    device and fold them: render_stream_sharded's cut, feedback and fold
    without a collective. Returns [H, W, 4]; leaves last_sp_bounds and
    last_shard_pairs_kept (pairs per segment) on the renderer."""
    resolve_device(renderer.device)
    rc = render_config or RenderConfig.new(renderer.engine.n_tiles[0])
    frame = _frame_setup(renderer, staged, scene_params, camera, rc,
                         use_skybox, use_proxy)
    bounds, entries = stream_cut(renderer, staged["blocks"], int(n_seg))
    imgs, kept, demand = [], [], []
    for ents in entries:
        img, k, d = render_segment(renderer, frame, ents)
        imgs.append(img)
        kept.append(k)
        demand.append(d)
    out = _fold(imgs, frame["bg"])
    _record(renderer, bounds, entries, kept, demand)
    return out


def render_stream_sharded(renderer, staged, scene_params, camera, mesh,
                          render_config=None, *, use_skybox=False,
                          use_proxy=False):
    """Render ONE camera with its splat stream cut over the mesh's "sp"
    axis. Every sp rank computes the same background and proxy depth, and
    renders its segment (stream_cut, the same on every rank) over a zero
    background; the segment images are all-gathered over sp and folded
    front to back, and the background lands once:
      final = fold(gs_0 ... gs_{n-1}) + T_total * bg
    which is algebraically the single-device gs + T * bg. Returns the final
    [H, W, 4] on every rank. At sp = 1 this is the plain frame."""
    resolve_device(renderer.device)
    rc = render_config or RenderConfig.new(renderer.engine.n_tiles[0])
    n_sp, i_sp, group = _axis(mesh, "sp")
    frame = _frame_setup(renderer, staged, scene_params, camera, rc,
                         use_skybox, use_proxy)
    bounds, entries = stream_cut(renderer, staged["blocks"], n_sp)
    img, k, d = render_segment(renderer, frame, entries[i_sp])
    imgs = [torch.empty_like(img) for _ in range(n_sp)]
    dist.all_gather(imgs, img, group=group)
    # pairs kept and the per-entry demand of every segment, in one vector
    # padded to the longest segment's entries
    width = 1 + max(max(len(e) for e in entries), 1)
    vec = torch.zeros(width, dtype=torch.int64, device=img.device)
    vec[0] = k
    vec[1 : 1 + d.shape[0]] = d
    vecs = [torch.empty_like(vec) for _ in range(n_sp)]
    dist.all_gather(vecs, vec, group=group)
    out = _fold(imgs, frame["bg"])
    _record(renderer, bounds, entries, [v[0] for v in vecs],
            [v[1:] for v in vecs])
    return out
