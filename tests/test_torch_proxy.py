"""The port's proxy ground pass (ops/proxy.py on the CPU) against the JAX
package's (Pallas kernels in interpret mode), on the same cameras, height
maps and seeded numpy textures.

Tolerances. Host-built data (map grid, mip atlas) is equal. Per pixel the
two passes agree except on silhouette and triangle-edge pixels, where a one
ulp difference in a projected vertex moves the pixel to the neighbouring
triangle, the far plane or the other side of a checker edge: at most 0.5%
of the pixels may differ by more than 1e-4 in depth or 2e-3 in colour (one
mip-weight ulp times a texel step of 1/255 stays far below that), and
`hit` may differ on at most 0.2% of them. The JAX package's grid also
hits a band of pixels just beyond the far plane (its triangle planes' c
term sums products of absolute pixel coordinates, and its float32 rounding
over thin far triangles puts a depth past 1 below it: the float64 solve of
the same vertices reads at least 1.0000077 on every such pixel), which the
port's planes, solved from the differences to a vertex, leave out; each
comparison with the JAX grid counts those pixels apart (a pinned number
per frame, `jax_far`) and holds the rest as above."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswt_renderer_tpu.core import Camera
from gswt_renderer_tpu.core.camera import CameraUniforms
from gswt_renderer_tpu.io.textures import build_mip_chain
from gswt_renderer_tpu.ops import proxy as jprox
from gswt_renderer_tpu.ops import texsample as jtex
from gswt_renderer_tpu.ops.project import pack_tex4
from gswt_renderer_tpu.render.pipeline import Renderer as JaxRenderer
from gswt_renderer_tpu_torch.ops import proxy as tprox
from gswt_renderer_tpu_torch.ops import texsample as ttex
from torch_tables import fitted

W, H = 96, 64
TILE = (32, 16)


def _t(a):
    return torch.from_numpy(np.array(a))


def _scene(half=(4, 4), hms=(1.0, 1.0, 0.8), cc=(0, 0)):
    vals = dict(map_half_wh=np.array(half, np.int32),
                tile_width=np.float32(4.0),
                height_map_scale=np.array(hms, np.float32),
                center_coord=np.array(cc, np.int32),
                sphere_radius=np.float32(0.0))
    return ({k: jnp.asarray(v) for k, v in vals.items()},
            {k: _t(v) for k, v in vals.items()})


def _cams(pos=(0, -10, 6), tgt=(0, 10, 0)):
    cam = Camera((W, H), pos, tgt, (0, 0, 1), np.deg2rad(60.0), 0.1, 2400.0)
    jcam = JaxRenderer.cam_dict(CameraUniforms(cam))
    return jcam, {k: _t(v) for k, v in jcam.items()}


def _height_map(n=16, seed=0):
    rng = np.random.default_rng(seed)
    hm = rng.uniform(-1.0, 1.0, (n, n)).astype(np.float32)
    return pack_tex4(hm.reshape(-1), n, n), (n, n)


def _texture(seed=1, size=32):
    rng = np.random.default_rng(seed)
    return build_mip_chain(rng.uniform(size=(size, size, 3)).astype(np.float32))


@pytest.mark.parametrize("args", [((9, 9), (4, 4), 4.0), ((5, 7), (2, 3), 2.5),
                                  ((97, 97), (48, 48), 4.0)])
def test_make_map_grid_equal(args):
    jv, jt = jprox.make_map_grid(*args)
    tv, tt = tprox.make_map_grid(*args)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tt, jt)
    assert tt.dtype == np.int32 and tv.dtype == np.float32


def test_pack_mip_atlas_equal_and_words_survive_the_move():
    mips = _texture()
    ja, jmeta = jprox.pack_mip_atlas(mips)
    ta, tmeta = tprox.pack_mip_atlas(mips)
    assert tmeta == jmeta
    np.testing.assert_array_equal(ta.view(np.uint32), ja.view(np.uint32))
    words = tprox.atlas_words(ta)
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  ja.view(np.uint32))


def test_sample_mip_trilinear_matches_jax():
    mips = _texture()
    atlas, meta = jprox.pack_mip_atlas(mips)
    rng = np.random.default_rng(2)
    n = 800
    u = rng.uniform(-2.0, 3.0, n).astype(np.float32)
    v = rng.uniform(-2.0, 3.0, n).astype(np.float32)
    rho = (2.0 ** rng.uniform(-2.0, len(mips) + 2.0, n)).astype(np.float32)
    ref = np.asarray(jprox.sample_mip_trilinear(
        jnp.asarray(atlas), meta, jnp.asarray(u), jnp.asarray(v),
        jnp.asarray(rho)))
    got = tprox.sample_mip_trilinear(
        tprox.atlas_words(atlas), tprox.mip_table(meta, "cpu"), _t(u), _t(v),
        _t(rho)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


def test_uv_footprint_and_march_steps_match_jax():
    rng = np.random.default_rng(3)
    u = rng.uniform(-2, 2, (20, 30)).astype(np.float32)
    v = rng.uniform(-2, 2, (20, 30)).astype(np.float32)
    ref = np.asarray(jprox._uv_footprint(jnp.asarray(u), jnp.asarray(v),
                                         32.0, 16.0))
    got = tprox._uv_footprint(_t(u), _t(v), 32.0, 16.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    for n, dist in ((96, 2400.0), (64, 200.0)):
        np.testing.assert_array_equal(
            tprox.march_steps(n, dist),
            np.asarray(jnp.linspace(0.0, 1.0, n) ** 2 * dist))


def _render_both(*, use_grid, surface_type, black=False, use_clip=False,
                 with_pyr=False, height_offset=-0.5, clip_height=0.0):
    jscene, tscene = _scene()
    jcam, tcam = _cams()
    hm4, hm_wh = _height_map()
    mips = _texture()
    atlas, meta = jprox.pack_mip_atlas(mips)
    verts, tris = jprox.make_map_grid((9, 9), (4, 4), 4.0)
    kw = dict(surface_type=surface_type, height_offset=height_offset,
              brightness=0.9, black_background=black, use_clip=use_clip,
              clip_height=clip_height, mip_meta=meta, tile_wh=TILE, chunk=128,
              use_grid=use_grid, n_steps=48, max_dist=300.0)
    jproxy = dict(atlas=jnp.asarray(atlas), verts=jnp.asarray(verts),
                  tris=jnp.asarray(tris))
    tproxy = dict(atlas=tprox.atlas_words(atlas),
                  mip_tab=tprox.mip_table(meta, "cpu"), verts=_t(verts),
                  tris=_t(tris))
    if with_pyr:
        jp, jmeta, jl = jtex.pack_pyramid(mips)
        jproxy["pyr"] = jp
        tp, tmeta, tl = ttex.pack_pyramid(mips)
        tproxy["pyr"] = _t(tp).to(torch.bfloat16)
        assert (tmeta, tl) == (jmeta, jl)
        kw["mip_pyr"] = (tmeta, tl)
    ref = jprox.render_proxy(jcam, jscene, (W, H), jnp.asarray(hm4), hm_wh,
                             jproxy, (32, 32), interpret=True, **kw)
    got = fitted(lambda cap: tprox.render_proxy(
        tcam, tscene, (W, H), _t(hm4), hm_wh, tproxy, (32, 32),
        proxy_pairs=cap, **kw), lambda out: out[3]["proxy_pairs"])
    return ref, got


def _assert_pass_close(ref, got, *, min_hit=0.2, jax_far=0):
    """`jax_far`: the pixels the JAX grid alone hits beyond the far plane
    (module docstring), pinned per frame; the rest are held to the
    tolerances."""
    jcol, jdepth, jhit, jaux = (np.asarray(x) if not isinstance(x, dict) else x
                                for x in ref)
    col, depth, hit, aux = (x.numpy() if not isinstance(x, dict) else x
                            for x in got)
    assert col.shape == (H, W, 4) and depth.shape == (H, W)
    assert np.isfinite(col).all() and np.isfinite(depth).all()
    assert hit.mean() > min_hit, "camera should see the ground"
    far = jhit & ~hit
    assert far.sum() == jax_far, far.sum()
    rest = ~far
    assert (hit & ~jhit).mean() <= 2e-3, (hit & ~jhit).mean()
    assert (np.abs(depth - jdepth)[rest] > 1e-4).mean() <= 5e-3
    assert (np.abs(col - jcol).max(axis=-1)[rest] > 2e-3).mean() <= 5e-3
    both = hit & jhit
    assert np.median(np.abs(depth - jdepth)[both]) < 1e-6
    assert int(aux["proxy_pairs"]) == int(jaux["proxy_pairs"])
    return col, depth, hit


# the pixels the JAX grid alone hits beyond the far plane on these frames
JAX_FAR = {0: 49, 1: 19}


@pytest.mark.parametrize("surface_type", [0, 1], ids=["flat", "heightmap"])
def test_render_proxy_grid_matches_jax(surface_type):
    ref, got = _render_both(use_grid=True, surface_type=surface_type)
    col, depth, hit = _assert_pass_close(ref, got,
                                         jax_far=JAX_FAR[surface_type])
    assert got[3]["proxy_pairs"] > 0
    assert (col[..., 3][hit] == 1.0).all() and (col[~hit] == 0.0).all()
    assert (depth[~hit] == 1.0).all()


@pytest.mark.parametrize("surface_type", [0, 1], ids=["flat", "heightmap"])
def test_render_proxy_march_matches_jax(surface_type):
    ref, got = _render_both(use_grid=False, surface_type=surface_type)
    _assert_pass_close(ref, got)
    assert got[3]["proxy_pairs"] == 0


def test_render_proxy_clip_and_black_background_match_jax():
    ref, got = _render_both(use_grid=True, surface_type=1, use_clip=True,
                            clip_height=0.1)
    _, _, hit = _assert_pass_close(ref, got, min_hit=0.05)
    ref_all, got_all = _render_both(use_grid=True, surface_type=1)
    assert hit.sum() < got_all[2].numpy().sum(), "the clip removes fragments"
    ref, got = _render_both(use_grid=True, surface_type=1, black=True)
    col, _, hit = _assert_pass_close(ref, got, jax_far=JAX_FAR[1])
    assert (col[..., :3] == 0.0).all() and (col[..., 3][hit] == 1.0).all()


def test_render_proxy_mip_pyramid_matches_jax():
    """mip_pyr routes the colour through factored_mip_trilinear (the JAX
    Pallas kernel in interpret mode, the port's plain version here)."""
    ref, got = _render_both(use_grid=True, surface_type=1, with_pyr=True)
    col, _, hit = _assert_pass_close(ref, got, jax_far=JAX_FAR[1])
    ref_atlas, got_atlas = _render_both(use_grid=True, surface_type=1)
    # the pyramid sampler rounds its column weights to bf16: it differs
    # from the atlas sampler, within the bound of tests/test_passes.py::
    # test_factored_mip_pyramid_matches_atlas_sampler
    d = np.abs(col - got_atlas[0].numpy())
    assert 0.0 < d.max() < 0.02 and d.mean() < 0.004


# the far-plane ties of the witness below: a hit within this distance below
# the far plane (the JAX package's float32 grid depths there are
# 0.9999986-0.9999993)
FAR_TIE = 2e-5


@pytest.mark.parametrize("surface_type", [0, 1], ids=["flat", "heightmap"])
def test_jax_proxy_eager_and_jitted_differ_at_far_plane_ties(surface_type):
    """The reference's own float32 spread, which the port cannot match on
    both sides. On the grid frames above, the JAX render_proxy run eagerly
    and the same call under jax.jit (XLA may fuse and reorder the plane
    set-up's float32 arithmetic) disagree on the hit mask; every pixel where
    they do is a far-plane tie (the hit side's float32 depth within FAR_TIE
    below 1), and there is at least one. The port's hit mask is the eager
    one's but for the JAX grid's hits beyond the far plane (module
    docstring): the port hits no pixel that either JAX path misses, and the
    eager path alone hits JAX_FAR pixels."""
    import jax

    jscene, tscene = _scene()
    jcam, tcam = _cams()
    hm4, hm_wh = _height_map()
    atlas, meta = jprox.pack_mip_atlas(_texture())
    verts, tris = jprox.make_map_grid((9, 9), (4, 4), 4.0)
    kw = dict(surface_type=surface_type, height_offset=-0.5, brightness=0.9,
              black_background=False, use_clip=False, clip_height=0.0,
              mip_meta=meta, tile_wh=TILE, chunk=128, use_grid=True,
              n_steps=48, max_dist=300.0)
    jproxy = dict(atlas=jnp.asarray(atlas), verts=jnp.asarray(verts),
                  tris=jnp.asarray(tris))

    def run(cam, scene, hm, proxy):
        return jprox.render_proxy(cam, scene, (W, H), hm, hm_wh, proxy,
                                  (32, 32), interpret=True, **kw)[1:3]

    eager = [np.asarray(x) for x in run(jcam, jscene, jnp.asarray(hm4), jproxy)]
    jitted = [np.asarray(x) for x in jax.jit(run)(jcam, jscene,
                                                  jnp.asarray(hm4), jproxy)]
    (ez, ehit), (jz, jhit) = eager, jitted
    flips = ehit != jhit
    assert flips.sum() >= 1, "the two JAX paths should disagree somewhere"
    hit_z = np.where(ehit, ez, jz)[flips]
    assert ((hit_z < 1.0) & (hit_z >= 1.0 - FAR_TIE)).all(), hit_z
    assert ehit.mean() > 0.2, "camera should see the ground"

    tproxy = dict(atlas=tprox.atlas_words(atlas),
                  mip_tab=tprox.mip_table(meta, "cpu"), verts=_t(verts),
                  tris=_t(tris))
    got = fitted(lambda cap: tprox.render_proxy(
        tcam, tscene, (W, H), _t(hm4), hm_wh, tproxy, (32, 32),
        proxy_pairs=cap, **kw), lambda out: out[3]["proxy_pairs"])
    hit = got[2].numpy()
    assert not (hit & ~ehit).any() and not (hit & ~jhit).any()
    assert (ehit & ~hit).sum() == JAX_FAR[surface_type]
