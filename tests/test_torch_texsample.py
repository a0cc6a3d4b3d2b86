"""The port's texture samplers (ops/texsample.py, plain PyTorch versions on
the CPU) against the JAX package's Pallas kernels in interpret mode, on the
same seeded numpy inputs.

Tolerances. Bilinear: the JAX kernel sums one-hot weights and contracts with
a matmul, the port reads four taps and associates A0(1-ty) + A1 ty; both are
f32, so they differ by a few ulp of the texture's range (1e-6 absolute for
values up to 4). Mip pyramid: both round the summed column weights to bf16
at the same place, so they differ only by f32 summation order (2e-6
absolute on values in [0, 1])."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswt_renderer_tpu.io.textures import build_mip_chain
from gswt_renderer_tpu.ops import texsample as jtex
from gswt_renderer_tpu_torch.ops import texsample as ttex

BIL_TOL = 1e-6
MIP_TOL = 2e-6


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("wrap_x", [False, True])
@pytest.mark.parametrize("wrap_y", [False, True])
def test_factored_bilinear_matches_jax(wrap_x, wrap_y):
    rng = np.random.default_rng(0)
    tex = rng.uniform(0.0, 4.0, (3, 12, 20)).astype(np.float32)
    n = 700
    # negative coordinates, far outside, and the last texel's edge
    x = rng.uniform(-45.0, 65.0, n).astype(np.float32)
    y = rng.uniform(-30.0, 40.0, n).astype(np.float32)
    x[:8] = [0.0, -0.5, 19.0, 19.5, 20.0, -20.0, 18.999, -1e-4]
    y[:8] = [0.0, -0.5, 11.0, 11.5, 12.0, -12.0, 10.999, -1e-4]
    ref = np.asarray(jtex.factored_bilinear(
        jnp.asarray(tex), jnp.asarray(x), jnp.asarray(y), wrap_x=wrap_x,
        wrap_y=wrap_y, interpret=True))
    got = ttex.factored_bilinear(_t(tex), _t(x), _t(y), wrap_x=wrap_x,
                                 wrap_y=wrap_y).numpy()
    assert got.shape == ref.shape == (3, n)
    np.testing.assert_allclose(got, ref, rtol=0, atol=BIL_TOL)


def test_factored_bilinear_edge_clamp_and_shape():
    """Clamping makes x0 == x1 beyond the last texel: the JAX kernel's
    weight there is (1-tx) + tx summed first, the port's i (1-tx) + i tx;
    they agree within BIL_TOL. A 2-d coordinate array keeps its shape."""
    rng = np.random.default_rng(1)
    tex = rng.uniform(0.0, 4.0, (2, 6, 9)).astype(np.float32)
    x = rng.uniform(8.0, 12.0, (5, 40)).astype(np.float32)   # all past x = 8
    y = rng.uniform(-3.0, 0.0, (5, 40)).astype(np.float32)   # all before y = 0
    ref = np.asarray(jtex.factored_bilinear(
        jnp.asarray(tex), jnp.asarray(x), jnp.asarray(y), wrap_x=False,
        wrap_y=False, interpret=True))
    got = ttex.factored_bilinear(_t(tex), _t(x), _t(y), wrap_x=False,
                                 wrap_y=False).numpy()
    assert got.shape == (2, 5, 40)
    np.testing.assert_allclose(got, ref, rtol=0, atol=BIL_TOL)
    # the corner texel itself, up to the weight rounding
    np.testing.assert_allclose(got, np.broadcast_to(
        tex[:, 0, 8][:, None, None], got.shape), rtol=0, atol=BIL_TOL)


def test_factored_fits_and_l_min_match_jax():
    for shape in ((3, 64, 128), (3, 171, 512), (3, 170, 512), (3, 64, 513),
                  (4, 128, 512)):
        assert ttex.factored_fits(shape) == jtex.factored_fits(shape), shape
    for w0 in (1, 64, 128, 129, 256, 512, 2048):
        assert ttex.pyramid_l_min(w0) == jtex.pyramid_l_min(w0)


def _chain(size, seed):
    rng = np.random.default_rng(seed)
    return build_mip_chain(rng.uniform(size=(size, size, 3)).astype(np.float32))


@pytest.mark.parametrize("size", [64, 256])
def test_pack_pyramid_matches_jax(size):
    mips = _chain(size, 2)
    jp, jmeta, jl = jtex.pack_pyramid(mips)
    tp, tmeta, tl = ttex.pack_pyramid(mips)
    assert tmeta == jmeta and tl == jl
    np.testing.assert_array_equal(tp, np.asarray(jp).astype(np.float32))
    # integers 0..255 survive the bf16 store exactly
    bf = _t(tp).to(torch.bfloat16)
    np.testing.assert_array_equal(bf.to(torch.float32).numpy(), tp)


def _mip_inputs(mips, n, seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(-1.0, 3.0, n).astype(np.float32)
    v = rng.uniform(-1.0, 3.0, n).astype(np.float32)
    # footprints below level 0 (clamp), through every transition band, and
    # far beyond the coarsest level (l0 == l1: the duplicate-row case)
    rho = (2.0 ** rng.uniform(-2.0, len(mips) + 2.0, n)).astype(np.float32)
    return u, v, rho


def _both_mip(mips, u, v, rho):
    jp, jmeta, jl = jtex.pack_pyramid(mips)
    ref = np.asarray(jtex.factored_mip_trilinear(
        jp, jmeta, jl, jnp.asarray(u), jnp.asarray(v), jnp.asarray(rho),
        interpret=True))
    tp, tmeta, tl = ttex.pack_pyramid(mips)
    got = ttex.factored_mip_trilinear(
        _t(tp).to(torch.bfloat16), tmeta, tl, _t(u), _t(v), _t(rho)).numpy()
    return ref, got


def test_factored_mip_trilinear_matches_jax():
    mips = _chain(64, 3)
    u, v, rho = _mip_inputs(mips, 900, 4)
    ref, got = _both_mip(mips, u, v, rho)
    assert got.shape == ref.shape == (3, 900)
    np.testing.assert_allclose(got, ref, rtol=0, atol=MIP_TOL)


def test_factored_mip_trilinear_coarsest_level_not_doubled():
    """l0 == l1 at the coarsest level, which is 1x1 (x0 == x1, y0 == y1):
    every tap coincides. The output is that texel, not twice it."""
    mips = _chain(64, 5)
    assert mips[-1].shape[:2] == (1, 1)
    n = 64
    rng = np.random.default_rng(6)
    u = rng.uniform(-2.0, 2.0, n).astype(np.float32)
    v = rng.uniform(-2.0, 2.0, n).astype(np.float32)
    rho = np.full(n, 1e6, np.float32)
    ref, got = _both_mip(mips, u, v, rho)
    np.testing.assert_allclose(got, ref, rtol=0, atol=MIP_TOL)
    texel = np.round(mips[-1][0, 0] * 255.0) / 255.0
    np.testing.assert_allclose(got, np.broadcast_to(texel[:, None], got.shape),
                               rtol=0, atol=1e-6)


def test_factored_mip_trilinear_l_min_clamp_of_a_512_chain():
    """A 512-wide chain drops levels 0..1; sampling at rho <= 4 clamps to
    the kept level-2 bilinear."""
    mips = _chain(512, 7)
    tp, tmeta, tl = ttex.pack_pyramid(mips)
    assert tl == 2 and len(tmeta) == 8 and tp.shape == (3, 256, 256)
    u, v, rho = _mip_inputs(mips, 500, 8)
    rho[:100] = np.linspace(0.1, 4.0, 100, dtype=np.float32)
    ref, got = _both_mip(mips, u, v, rho)
    np.testing.assert_allclose(got, ref, rtol=0, atol=MIP_TOL)
    # below l_min the footprint does not matter
    lo = ttex.factored_mip_trilinear(
        _t(tp).to(torch.bfloat16), tmeta, tl, _t(u[:100]), _t(v[:100]),
        _t(np.full(100, 0.25, np.float32))).numpy()
    np.testing.assert_array_equal(lo, got[:, :100])


def test_mip_sampler_keeps_2d_shape_and_range():
    mips = _chain(32, 9)
    tp, tmeta, tl = ttex.pack_pyramid(mips)
    u = torch.rand((7, 11), generator=torch.Generator().manual_seed(0))
    out = ttex.factored_mip_trilinear(_t(tp).to(torch.bfloat16), tmeta, tl,
                                      u, u * 0.5, torch.full((7, 11), 3.0))
    assert out.shape == (3, 7, 11) and bool(torch.isfinite(out).all())
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
