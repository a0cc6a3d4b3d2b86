"""The frame's uniform block (ops/project.py UNIFORMS): the one table of its
word offsets, the port's pack and unpack against the JAX package's, and the
upload helper that sends a frame's inputs to the device (CPU, small)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswt_renderer_tpu.core import Camera as JaxCamera
from gswt_renderer_tpu.core import CameraUniforms as JaxCameraUniforms
from gswt_renderer_tpu.render.pipeline import Renderer as JaxRenderer
from gswt_renderer_tpu.render.uniforms import SceneParams as JaxSceneParams
from gswt_renderer_tpu_torch.core import Camera, CameraUniforms
from gswt_renderer_tpu_torch.ops import project
from gswt_renderer_tpu_torch.render.pipeline import Renderer, upload_parts
from gswt_renderer_tpu_torch.render.uniforms import SceneParams

# (scene fields, camera (position, target, up), lod_enable, culling_dist,
# render_gs): negative and positive integral fields, a short and a full
# lod_enable, the splats on and off
CASES = {
    "flat": (dict(splat_scale=1.0, tile_width=4.0, num_lod=3,
                  map_half_wh=(2, 2), center_coord=(0, 0)),
             ((0.5, -3.0, 2.5), (0.5, 2.0, 0.0), (0.0, 1.0, 0.0)),
             [True] * 16, 1.0, True),
    "clip_negative_centre": (
        dict(splat_scale=0.75, tile_width=2.5, use_clip=1, clip_height=-0.4,
             surface_type=1, sphere_radius=0.0, point_cloud_radius=0.02,
             transition_width_ratio=0.3, num_lod=5, map_half_wh=(6, 3),
             center_coord=(-7, 11),
             transition_dist_vec=np.arange(1, 17, dtype=np.float32) * 1.5,
             height_map_scale=np.float32([1.0, 0.3, 2.0]),
             scene_scale=np.float32([1.0, 1.0, 0.5])),
        ((1.0, -5.0, 3.0), (1.0, 0.0, 0.5), (0.0, 0.0, 1.0)),
        [True, False, True], 0.8, False),
    "sphere": (dict(surface_type=2, sphere_radius=15.0, tile_width=4.0,
                    num_lod=16, map_half_wh=(5, 2), center_coord=(3, -2)),
               ((30.0, 0.0, 8.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0)),
               [False] * 4 + [True] * 12, 2.5, True),
}


def _packed(case, jax_side=False):
    """The case's uniform block packed by the port, or by the JAX package."""
    scene, (pos, target, up), lod_enable, culling_dist, render_gs = CASES[case]
    cam_cls, uni_cls, sp_cls, r_cls = (
        (JaxCamera, JaxCameraUniforms, JaxSceneParams, JaxRenderer) if jax_side
        else (Camera, CameraUniforms, SceneParams, Renderer))
    cam = cam_cls((96, 64), np.float32(pos), np.float32(target),
                  np.float32(up), np.deg2rad(60.0), 0.1, 200.0)
    return r_cls.pack_frame_uniforms(sp_cls(**scene), uni_cls(cam),
                                     lod_enable, culling_dist,
                                     render_gs=render_gs)


def test_table_fields_are_disjoint_and_inside_the_block():
    owner = {}
    for f in project.UNIFORMS:
        assert f.words == int(np.prod(f.shape)) >= 1, f
        for k in range(f.word, f.word + f.words):
            assert 0 <= k < project.UNIFORMS_LEN, f
            assert k not in owner, (f.name, owner.get(k))
            owner[k] = f.name
    assert len({f.name for f in project.UNIFORMS}) == len(project.UNIFORMS)
    assert {f.group for f in project.UNIFORMS} == {"cam", "scene", "frame"}
    assert Renderer.UNIFORMS_LEN == project.UNIFORMS_LEN == 112


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_writes_each_field_once_and_nothing_else(case, monkeypatch):
    """Every write pack_frame_uniforms makes into the block is exactly one
    table field's words, each field is written once, and no word outside
    the table is written (it stays 0)."""
    writes = []

    class Recorder(np.ndarray):
        def __setitem__(self, key, value):
            writes.append(tuple(np.arange(len(self))[key].reshape(-1)))
            super().__setitem__(key, value)

    class Numpy:
        """numpy, but its zeros record every write into the array."""
        def __getattr__(self, name):
            return getattr(np, name)

        @staticmethod
        def zeros(n, dtype):
            return np.zeros(n, dtype).view(Recorder)

    monkeypatch.setattr(project, "np", Numpy())
    v = _packed(case)
    monkeypatch.undo()
    fields = {tuple(range(f.word, f.word + f.words)): f.name
              for f in project.UNIFORMS}
    assert sorted(writes) == sorted(fields), sorted(set(writes) ^ set(fields))
    inside = {k for ws in fields for k in ws}
    outside = [k for k in range(project.UNIFORMS_LEN) if k not in inside]
    assert outside and not np.asarray(v)[outside].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_equals_the_jax_package_word_for_word(case):
    got = np.asarray(_packed(case))
    want = np.asarray(_packed(case, jax_side=True))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_unpack_of_a_jax_packed_block_equals_the_jax_unpack(case):
    """The port's unpack of the JAX package's block equals the JAX unpack
    field by field: values, shapes and dtypes."""
    v = _packed(case, jax_side=True)
    got = Renderer.unpack_frame_uniforms(torch.from_numpy(v))
    want = JaxRenderer.unpack_frame_uniforms(jnp.asarray(v))
    assert len(got) == len(want) == 5
    for g, w in zip(got[:2], want[:2]):
        assert list(g) == list(w)
    pairs = [(f"{d}.{k}", got[i][k], want[i][k])
             for i, d in enumerate(("scene", "cam")) for k in want[i]]
    pairs += [(k, got[i], want[i]) for i, k in
              ((2, "lod_enable"), (3, "culling_dist"), (4, "gs_enable"))]
    assert len(pairs) == len(project.UNIFORMS)
    for name, g, w in pairs:
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_unpack_gives_each_table_field_its_shape_and_dtype():
    v = torch.from_numpy(_packed("clip_negative_centre"))
    scene, cam, lod_enable, culling_dist, gs_enable = (
        project.unpack_uniform_block(v))
    out = dict(scene=scene, cam=cam, frame=dict(
        lod_enable=lod_enable, culling_dist=culling_dist,
        gs_enable=gs_enable))
    for f in project.UNIFORMS:
        t = out[f.group][f.name]
        assert tuple(t.shape) == f.shape and t.dtype == f.dtype, f
        word = v[f.word:f.word + f.words].reshape(f.shape)
        assert torch.equal(t, word.to(f.dtype)), f
    assert scene["center_coord"].tolist() == [-7, 11]
    assert lod_enable.tolist() == [1, 0, 1] + [0] * 13
    assert int(gs_enable) == 0


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_upload_parts_on_the_cpu_are_the_parts(dtype):
    rng = np.random.default_rng(0)
    parts = [rng.integers(-9, 9, (5, 7)).astype(dtype),
             rng.integers(-9, 9, 3).astype(dtype),
             np.zeros((0,), dtype), rng.integers(-9, 9, (2, 4, 3)).astype(dtype)]
    got = upload_parts(parts, torch.device("cpu"))
    assert len(got) == len(parts)
    for g, a in zip(got, parts):
        assert g.device.type == "cpu"
        assert g.numpy().dtype == a.dtype and tuple(g.shape) == a.shape
        np.testing.assert_array_equal(g.numpy(), a)
