"""The port's temporal saturation cull (RendererConfig.sat_cull): the
counterparts of every test in tests/test_sat_cull.py, through the port on the
CPU, and the port against the JAX package where both can be given the same
inputs (the splat-level cull in bin_pairs, the carried cut image through
state_from_numpy).

The compositor records, per band of a tile, the STREAM SLOT beyond which
nothing contributed this frame because the band was already opaque
(ops/raster.py emit_zcut); the next frame's binning drops the splats behind
that cut (ops/binning.py sat_simg). Image tolerances are that file's:
MIN_T * 1.1 frame to frame, MIN_T * 1.5 after a jump (the culled pairs
composite behind a transmittance < MIN_T = 0.5/255)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswt_renderer_tpu.core import Camera, UserData
from gswt_renderer_tpu.core.config import (
    RenderConfig, SelectiveMergeType, SurfaceType, TileSortType)
from gswt_renderer_tpu.io.synth import synthetic_scene_vec
from gswt_renderer_tpu.ops import binning as jbin
from gswt_renderer_tpu.render.pipeline import Renderer as JaxRenderer
from gswt_renderer_tpu.render.pipeline import RendererConfig as JaxConfig
from gswt_renderer_tpu.render.uniforms import SceneParams
from gswt_renderer_tpu.tiles import WangTileEngine
from gswt_renderer_tpu_torch.ops import binning, raster
from gswt_renderer_tpu_torch.render.pipeline import (
    Renderer, RendererConfig, state_from_numpy)
from test_torch_raster import _proj_opaque
from torch_tables import fitted

IMAGE_WH, TILE_WH, CHUNK = (256, 128), (64, 32), 128
NTX, NTY = 4, 4


def _torch_tree(p):
    return jax.tree_util.tree_map(torch.from_numpy, p)


def _to_bands(zc):
    """[T, B] -> band-major rows [nty * B, ntx] (Renderer.back)."""
    b = zc.shape[1]
    return zc.reshape(NTY, NTX, b).permute(0, 2, 1).reshape(NTY * b, NTX)


def _run(p, cut, exact=True):
    binned = fitted(lambda cap: binning.bin_pairs(
        _torch_tree(p), image_wh=IMAGE_WH, tile_wh=TILE_WH, chunk=CHUNK,
        exact=exact, cull_exact=False, sat_simg=cut, capacity=cap),
        lambda b: b["n_pairs"], CHUNK)
    color, zcut = raster.rasterize(
        binned, torch.ones((NTX * NTY, 64 * 32)), image_wh=IMAGE_WH,
        tile_wh=TILE_WH, chunk=CHUNK, use_depth=False, exact=exact,
        emit_zcut=True)
    return color.numpy(), zcut, binned


@pytest.mark.parametrize("exact", [True, False])
def test_zcut_cull_reproduces_kernel_image(exact):
    """Culling the splats behind a tile's recorded cut reproduces the SAME
    image: the culled pairs are the ones the early exit skipped when the
    record was taken. Tolerance MIN_T: culling shifts every tile run's
    global chunk phase, which moves the entry where the early exit fires;
    pairs near that boundary flip between composited-at-T~MIN_T and skipped,
    the same error class as the early exit itself."""
    p = _proj_opaque(1024, seed=3)
    img0, zcut0, b0 = _run(p, None, exact)
    img1, zcut1, b1 = _run(p, _to_bands(zcut0), exact)
    assert int(b1["n_pairs_kept"]) < int(b0["n_pairs_kept"])
    np.testing.assert_allclose(img1, img0, atol=raster.MIN_T * 1.1)
    assert torch.equal(zcut1 == raster.SAT_NOCUT, zcut0 == raster.SAT_NOCUT)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("seed", [3, 4])
def test_sat_simg_cull_keeps_the_pairs_jax_keeps(seed, exact):
    """bin_pairs(sat_simg=...) against the JAX package's on the same cut
    image (the port's own record of the scene, and a random one with
    SAT_NOCUT holes): every tile's run of stream slots is identical."""
    p = _proj_opaque(1024, seed=seed)
    _, zcut0, _ = _run(p, None, exact)
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, 1024, (NTY * raster.SAT_BANDS, NTX)) + 0.5
    rand[rng.random(rand.shape) < 0.3] = raster.SAT_NOCUT
    for cut in (_to_bands(zcut0).numpy(), rand.astype(np.float32)):
        jb = jbin.bin_pairs(
            jax.tree_util.tree_map(jnp.asarray, p), image_wh=IMAGE_WH,
            tile_wh=TILE_WH, max_pairs=8192, chunk=CHUNK, exact=exact,
            elem_paths=2, sat_simg=jnp.asarray(cut))
        tb = binning.bin_pairs(
            _torch_tree(p), image_wh=IMAGE_WH, tile_wh=TILE_WH, chunk=CHUNK,
            exact=exact, cull_exact=False, sat_simg=torch.from_numpy(cut),
            capacity=binning.fit_capacity(jb["n_pairs"], CHUNK))
        rs, re_ = np.asarray(jb["range_start"]), np.asarray(jb["range_end"])
        np.testing.assert_array_equal(tb["range_start"].numpy(), rs)
        np.testing.assert_array_equal(tb["range_end"].numpy(), re_)
        jt, tt = np.asarray(jb["table"]), tb["table"].numpy()
        n = int(jb["n_pairs_kept"])
        np.testing.assert_array_equal(tt[12, :n], jt[12, :n])
        assert int(tb["n_live"]) == int(jb["n_live"]) < 1024


def _config(exact=False, sat=True):
    return dict(width=128, height=128, max_draws=64, max_stream=1 << 14,
                chunk=128, tile_w=32, tile_h=32, exact=exact, sat_cull=sat)


def _mk_renderer(exact=False, sat=True, **cfg):
    eng = WangTileEngine(synthetic_scene_vec(n_lod=2, splats_per_tile=256))
    ud = UserData.from_ui(
        tile_map_half_wh=(2, 2), height_map_scale=(1.0, 0.0),
        lod_max_dist=8.0, surface_type=SurfaceType.NONE,
        merge_type=SelectiveMergeType.NONE,
        tile_sort_type=TileSortType.DISTANCE, lod_blending=False)
    eng.configure(ud)
    r = Renderer(eng, RendererConfig(**dict(_config(exact, sat), **cfg)),
                 device="cpu")
    r.configure(ud)
    return eng, ud, r


def _pose(eng, ud, cam_pos, target):
    cam_pos = np.asarray(cam_pos, np.float32)
    eng.build_tiles(cam_pos)
    camera = Camera((128, 128), cam_pos, np.asarray(target, np.float32),
                    (0.0, 0.0, 1.0), np.deg2rad(45.0), 0.1, 200.0)
    dt = eng.sort_tiles(cam_pos, camera.view_proj())
    rc = RenderConfig.new(eng.n_tiles[0])
    return dt, camera, SceneParams.from_data(ud, eng.center_coord, rc), rc


def _frame(eng, r, ud, cam_pos, target):
    img = r.render(*_pose(eng, ud, cam_pos, target))
    return np.asarray(img), dict(r.last_aux)


POS, TGT = (0.0, -4.0, 2.5), (0.0, 2.0, 0.0)


def test_sat_cull_static_camera_image_stable():
    """Three frames at a fixed camera: frame 1 records, frames 2-3 cull; the
    image stays put and no pair mass is added."""
    eng, ud, r = _mk_renderer(sat=True)
    img1, aux1 = _frame(eng, r, ud, POS, TGT)
    assert r.sat_zimg is not None
    assert tuple(r.sat_zimg.shape) == (4 * raster.SAT_BANDS, 4)
    assert int((r.sat_zimg < raster.SAT_NOCUT).sum()) > 0, "real cuts"
    img2, aux2 = _frame(eng, r, ud, POS, TGT)
    img3, _ = _frame(eng, r, ud, POS, TGT)
    assert img1[..., 3].max() > 0.5
    assert int(aux2["n_pairs_kept"]) <= int(aux1["n_pairs_kept"])
    np.testing.assert_allclose(img2, img1, atol=raster.MIN_T * 1.1)
    np.testing.assert_allclose(img3, img1, atol=raster.MIN_T * 1.1)


def test_sat_cull_heals_after_camera_jump():
    """A teleport mispredicts for at most ONE frame: the jump frame's own
    (culled) run records a certificate that is sound for the new pose, so
    the frame after it matches the cull-off render from the same engine."""
    eng, ud, r = _mk_renderer(sat=True)
    _frame(eng, r, ud, POS, TGT)
    _frame(eng, r, ud, POS, TGT)
    jmp_pos, jmp_tgt = (0.0, 6.0, 2.5), (0.0, -2.0, 0.0)
    _frame(eng, r, ud, jmp_pos, jmp_tgt)  # may under-composite (one frame)
    img5, aux5 = _frame(eng, r, ud, jmp_pos, jmp_tgt)
    r.cfg = dataclasses.replace(r.cfg, sat_cull=False)
    ref, aux_ref = _frame(eng, r, ud, jmp_pos, jmp_tgt)
    assert np.isfinite(img5).all()
    assert int(aux5["n_pairs_kept"]) <= int(aux_ref["n_pairs_kept"])
    np.testing.assert_allclose(img5, ref, atol=raster.MIN_T * 1.5)


def test_sat_cull_off_in_exact_profile():
    eng, ud, r = _mk_renderer(exact=True, sat=True)
    _frame(eng, r, ud, POS, TGT)
    assert r.sat_zimg is None and r.sat_vp is None


@pytest.mark.parametrize("case", ["tile_h", "point_cloud", "no_gs"])
def test_sat_cull_off_where_the_record_means_nothing(case):
    """Tile heights that do not split into SAT_BANDS uniform bands, point
    clouds and frames without splats take no part in the cull."""
    eng, ud, r = _mk_renderer(
        sat=True, **(dict(tile_h=30) if case == "tile_h" else {}))
    dt, camera, sp, rc = _pose(eng, ud, POS, TGT)
    if case == "point_cloud":
        rc.draw_point_cloud = True
    img = r.render(dt, camera, sp, rc, render_gs=case != "no_gs")
    assert r.sat_zimg is None and np.isfinite(img).all()


def test_sat_motion_gate_disables_cull_under_sustained_motion():
    """Under SUSTAINED camera motion beyond the dilation margin the cull
    must not run off stale cuts frame after frame. The motion gate drops the
    cut for every moving frame, then re-certifies once the camera is still."""
    eng, ud, r = _mk_renderer(sat=True)
    pos, tgt = np.array(POS), np.array(TGT)
    _frame(eng, r, ud, pos, tgt)
    assert r.sat_zimg is not None  # static: recorded
    step = np.array([1.0, 0.0, 0.0])  # ~30-77 px/frame at scene depths
    for _ in range(3):
        pos, tgt = pos + step, tgt + step
        _frame(eng, r, ud, pos, tgt)
        assert r.sat_zimg is None  # every moving frame: cut dropped
    _frame(eng, r, ud, pos, tgt)
    assert r.sat_zimg is not None  # the first static frame re-certifies
    img, aux = _frame(eng, r, ud, pos, tgt)
    r.cfg = dataclasses.replace(r.cfg, sat_cull=False)
    ref, aux_ref = _frame(eng, r, ud, pos, tgt)
    assert int(aux["n_pairs_kept"]) <= int(aux_ref["n_pairs_kept"])
    np.testing.assert_allclose(img, ref, atol=raster.MIN_T * 1.5)


def test_sat_motion_exceeds_thresholds():
    """The gate's probe math against the JAX package's on the same cameras:
    sub-margin jitter passes, a real pan or strafe exceeds. Margins at this
    config (tile 32x32, SAT_BANDS=4, dilate=1): 32 px across, 8 px down."""
    eng, ud, r = _mk_renderer(sat=True)
    jr = JaxRenderer(eng, JaxConfig(min_stream=1 << 12, **_config()))

    def vp(pos, tgt):
        cam = Camera((128, 128), np.asarray(pos, np.float32),
                     np.asarray(tgt, np.float32), (0.0, 0.0, 1.0),
                     np.deg2rad(45.0), 0.1, 200.0)
        return cam, np.asarray(cam.view_proj(), np.float32)

    _, vp0 = vp(POS, TGT)
    cases = [
        (POS, TGT, False),                                  # the same camera
        ((0.004, -4.0, 2.5), (0.004, 2.0, 0.0), False),     # ~0.3 px strafe
        ((1.0, -4.0, 2.5), (1.0, 2.0, 0.0), True),          # ~77 px strafe
        ((0.0, -4.0, 2.5), (1.5, 2.0, 0.0), True),          # pure rotation
        ((0.0, -4.0, 2.5), (0.0, 2.0, 0.6), True),          # ~15 px tilt
        ((0.0, 4.0, 2.5), (0.0, 12.0, 0.0), True),          # probes behind
    ]
    for pos, tgt, want in cases:
        cam, vp1 = vp(pos, tgt)
        assert r._sat_motion_exceeds(cam, vp0, vp1) is want, (pos, tgt)
        assert jr._sat_motion_exceeds(cam, vp0, vp1) is want, (pos, tgt)


def test_second_frame_culls_what_the_jax_renderer_culls():
    """Two frames at a fixed camera through the JAX Renderer (fast profile,
    sat_cull) and the port: after frame 1 the port's carried cut image
    equals the JAX Renderer's _sat_zimg; given that image through
    state_from_numpy, the port's frame 2 keeps the same pairs and renders
    the same image within the fast profile's budget against JAX
    (tests/test_torch_fastmode.py) plus the cull's own MIN_T."""
    eng, ud, r = _mk_renderer(sat=True)
    jr = JaxRenderer(eng, JaxConfig(min_stream=1 << 12, **_config()))
    jr.configure(ud)
    pose = _pose(eng, ud, POS, TGT)
    jr.render(*pose)
    r.render(*pose)
    jz = np.asarray(jr._sat_zimg)
    np.testing.assert_array_equal(r.sat_zimg.numpy(), jz)
    kept1 = int(jr.last_aux["n_pairs_kept"])
    assert int(r.last_aux["n_pairs_kept"]) == kept1

    fed = Renderer(eng, RendererConfig(**_config()), device="cpu")
    fed.configure(ud)
    fed.set_state(state_from_numpy(dict(sat_zimg=jz), "cpu"))
    jimg = np.asarray(jr.render(*pose))
    img = fed.render(*pose)
    assert int(fed.last_aux["n_pairs_kept"]) == int(
        jr.last_aux["n_pairs_kept"]) <= kept1
    d = np.abs(img - jimg)
    assert d.max() <= 0.03 + raster.MIN_T and d.mean() <= 2e-4
    np.testing.assert_array_equal(fed.sat_zimg.numpy(),
                                  np.asarray(jr._sat_zimg))
