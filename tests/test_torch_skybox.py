"""The port's skybox pass (ops/skybox.py on the CPU) against the JAX
package's, on the same cameras and seeded numpy textures. The JAX equirect
path reaches the Pallas bilinear kernel, which runs in interpret mode here.

Tolerances: rays 1e-6 (one small matmul); sampled colours 2e-5: atan2 and
asin differ in the last ulp between the two libraries, the texel coordinate
is that times the texture width, and the tone curve x^(1/2.2) steepens
small values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswt_renderer_tpu.core import Camera
from gswt_renderer_tpu.core.camera import CameraUniforms
from gswt_renderer_tpu.ops import skybox as jsky
from gswt_renderer_tpu.render.pipeline import Renderer as JaxRenderer
from gswt_renderer_tpu_torch.ops import skybox as tsky
from gswt_renderer_tpu_torch.ops.texsample import factored_fits

TOL = 2e-5
CAMS = {
    "forward": ((0, 0, 0), (0, 1, 0), (0, 0, 1), 90.0),
    "up": ((0, 0, 0), (0, 0.05, 1), (0, 1, 0), 60.0),
    "oblique": ((3, -2, 5), (10, 30, 1), (0, 0, 1), 45.0),
}


def _cams(name, wh):
    pos, tgt, up, fov = CAMS[name]
    cam = Camera(wh, pos, tgt, up, np.deg2rad(fov), 0.1, 100.0)
    jcam = JaxRenderer.cam_dict(CameraUniforms(cam))
    tcam = {k: torch.from_numpy(np.array(v)) for k, v in jcam.items()}
    return jcam, tcam


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", sorted(CAMS))
def test_pixel_rays_match_jax(name):
    jcam, tcam = _cams(name, (48, 32))
    ref = np.asarray(jsky.pixel_rays(jcam, (48, 32)))
    got = tsky.pixel_rays(tcam, (48, 32)).numpy()
    assert got.shape == (32, 48, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CAMS))
@pytest.mark.parametrize("shape", [(16, 32), (180, 513)],
                         ids=["kernel_path", "gather_path"])
def test_render_skybox_equirect_matches_jax(name, shape):
    """(16, 32) is a small texture (factored_fits: the JAX package's
    bilinear kernel path); (180, 513) is over that limit, where the JAX
    package takes a 4-tap gather. The port sends both through its bilinear
    sampler, whose association differs from the gather's in the last ulp."""
    rng = np.random.default_rng(0)
    tex = rng.uniform(0.0, 4.0, shape + (3,)).astype(np.float32)
    assert factored_fits((3,) + shape) == (shape == (16, 32))
    jcam, tcam = _cams(name, (40, 24))
    ref = np.asarray(jsky.render_skybox(jcam, (40, 24), jnp.asarray(tex),
                                        equirect=True))
    got = tsky.render_skybox(tcam, (40, 24), _t(tex), equirect=True).numpy()
    assert got.shape == (24, 40, 4)
    assert (got[..., 3] == 1.0).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("name", sorted(CAMS))
def test_render_skybox_cubemap_matches_jax(name):
    rng = np.random.default_rng(1)
    faces = rng.uniform(0.0, 1.0, (6, 8, 8, 3)).astype(np.float32)
    jcam, tcam = _cams(name, (40, 24))
    ref = np.asarray(jsky.render_skybox(jcam, (40, 24), jnp.asarray(faces),
                                        equirect=False))
    got = tsky.render_skybox(tcam, (40, 24), _t(faces), equirect=False).numpy()
    # a ray within an ulp of a face boundary may pick the neighbouring face
    # in one library: at most one pixel in a thousand
    bad = np.abs(got - ref).max(axis=-1) > TOL
    assert bad.mean() <= 1e-3, bad.mean()


def test_bake_matches_jax_and_round_trips():
    """Sampling the baked cubemap reproduces direct equirect sampling up to
    the cubemap's own bilinear resample (the bound of
    tests/test_passes.py::test_hdri_cubemap_bake_roundtrip), and the baked
    faces equal the JAX package's."""
    th = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    ph = np.linspace(0, np.pi, 32)
    hdri = (
        1.5
        + np.sin(th)[None, :, None] * np.cos(2 * ph)[:, None, None]
        + 0.3 * np.cos(2 * th)[None, :, None]
    ).astype(np.float32) * np.array([1.0, 0.8, 0.6], np.float32)
    faces = tsky.bake_hdri_to_cubemap(_t(hdri), resolution=64)
    assert faces.shape == (6, 64, 64, 3)
    ref = np.asarray(jsky.bake_hdri_to_cubemap(hdri, resolution=64))
    np.testing.assert_allclose(faces.numpy(), ref, rtol=0, atol=TOL)
    rng = np.random.default_rng(2)
    d = rng.normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    via_cube = tsky._sample_cubemap(faces, _t(d)).numpy()
    direct = tsky._sample_equirect(_t(hdri), _t(d)).numpy()
    err = np.abs(via_cube - direct)
    assert np.quantile(err, 0.95) < 0.04 and err.mean() < 0.02
