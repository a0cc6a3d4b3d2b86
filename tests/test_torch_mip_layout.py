"""The mip-pyramid sampler's layout for the card in its plain forms
(ops/texsample.py): the texel-interleaved copy of the pyramid
(interleave_pyramid) and the integer Repeat wrap (_wrap), which the CUDA
kernel uses. factored_mip_trilinear_texels_plain reads the interleaved copy
and wraps in integers; it must equal the plain spec
factored_mip_trilinear_plain to the BIT, and the JAX package's
factored_mip_trilinear (interpret mode) within tests/test_torch_texsample.py's
MIP_TOL (2e-6: f32 summation order) on all but 1% of the samples, where the
two packages' log2 may put the level an ulp apart (see the test)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswt_renderer_tpu.io.textures import build_mip_chain
from gswt_renderer_tpu.ops import texsample as jtex
from gswt_renderer_tpu_torch.ops import texsample as ttex

MIP_TOL = 2e-6


def _chain(wh, seed):
    rng = np.random.default_rng(seed)
    return build_mip_chain(
        rng.uniform(size=(wh[1], wh[0], 3)).astype(np.float32))


def _pyr(mips):
    planes, meta, l_min = ttex.pack_pyramid(mips)
    bf = torch.from_numpy(planes).to(torch.bfloat16)
    return bf, ttex.interleave_pyramid(bf), meta, l_min


def _inputs(n, n_lv, seed, span=(-3.0, 4.0), scale=1.0):
    rng = np.random.default_rng(seed)
    u = (rng.uniform(*span, n) * scale).astype(np.float32)
    v = (rng.uniform(*span, n) * scale).astype(np.float32)
    rho = (2.0 ** rng.uniform(-3.0, n_lv + 2.0, n)).astype(np.float32)
    return u, v, rho


def _t(a):
    return torch.from_numpy(np.array(a))


def test_interleave_pyramid_layout():
    bf, tex, _, _ = _pyr(_chain((64, 64), 0))
    assert tex.shape == bf.shape[1:] + (4,) and tex.dtype == torch.bfloat16
    assert tex.is_contiguous()
    assert torch.equal(tex[..., :3].permute(2, 0, 1), bf)
    assert not tex[..., 3].any()
    with pytest.raises(ValueError):
        ttex.interleave_pyramid(torch.zeros((5, 4, 4), dtype=torch.bfloat16))


@pytest.mark.parametrize("span,scale", [
    ((-3.0, 4.0), 1.0),            # several repeats either side of 0
    ((-1.0, 0.0), 1e3),            # negative, far
    ((-1.0, 1.0), 1e5),            # the integer wrap near its 2^24 limit
    ((-1.0, 1.0), 3e7),            # beyond it: the float wrap
])
@pytest.mark.parametrize("wh", [(64, 64), (128, 8), (8, 128), (512, 512)])
def test_texel_form_bit_equal_to_the_spec(wh, span, scale):
    """Square, wide and tall chains (the last two end in 1-wide levels),
    a 512 chain clamped to l_min 2; rho from below the finest kept level to
    past the coarsest (l0 == l1)."""
    mips = _chain(wh, 1)
    bf, tex, meta, l_min = _pyr(mips)
    u, v, rho = _inputs(4000, len(mips), 2, span, scale)
    rho[:200] = 1e7                     # l0 == l1
    rho[200:400] = 0.25                 # below l_min: clamps
    args = (meta, l_min, _t(u), _t(v), _t(rho))
    want = ttex.factored_mip_trilinear_plain(bf, *args)
    got = ttex.factored_mip_trilinear_texels_plain(tex, 3, *args)
    assert torch.equal(got, want)
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("wh,scale", [((64, 64), 1.0), ((8, 128), 1.0),
                                      ((512, 512), 1.0), ((128, 8), 50.0)])
def test_texel_form_matches_jax(wh, scale):
    mips = _chain(wh, 3)
    bf, tex, meta, l_min = _pyr(mips)
    u, v, rho = _inputs(900, len(mips), 4, scale=scale)
    rho[:50] = 1e7
    jp, jmeta, jl = jtex.pack_pyramid(mips)
    assert tuple(jmeta) == meta and jl == l_min
    ref = np.asarray(jtex.factored_mip_trilinear(
        jp, jmeta, jl, jnp.asarray(u), jnp.asarray(v), jnp.asarray(rho),
        interpret=True))
    got = ttex.factored_mip_trilinear_texels_plain(
        tex, 3, meta, l_min, _t(u), _t(v), _t(rho)).numpy()
    spec = ttex.factored_mip_trilinear_plain(
        bf, meta, l_min, _t(u), _t(v), _t(rho)).numpy()
    np.testing.assert_array_equal(got, spec)
    # jnp.log2 and torch.log2 may put a level one ulp apart; where a small
    # level weight then rounds to the neighbouring bf16 value, a sample
    # moves by about 2^-9 of that weight (1e-5 seen): at most 1% of the
    # samples may pass MIP_TOL, none 1e-4
    d = np.abs(got - ref).max(axis=0)
    assert (d > MIP_TOL).mean() <= 0.01, (d > MIP_TOL).mean()
    assert d.max() <= 1e-4


def test_integer_wrap_is_the_float_wrap():
    """The integer modulo equals x0f - floor(x0f / n) n wherever the kernel
    takes it (|x0f| < 2^24, n <= 2^12), around every multiple of n and at
    the limits; beyond them the float wrap is used as it is."""
    n = torch.tensor([1.0, 2.0, 3.0, 7.0, 128.0, 1000.0, 4096.0, 8192.0])
    ks = torch.arange(-3, 4, dtype=torch.float32)
    base = torch.cat([
        (ks[:, None] * n[None, :]).flatten(),
        torch.tensor([16777215.0, -16777215.0, 16777216.0, -16777216.0,
                      3.0e7, -3.0e7, 8388607.0, -8388609.0])])
    x0f = (base[:, None] + torch.arange(-2, 3, dtype=torch.float32)).flatten()
    x0f = torch.cat([x0f, torch.floor(torch.from_numpy(
        np.random.default_rng(6).uniform(-2e7, 2e7, 20000)
        .astype(np.float32)))])
    xs, ns = torch.meshgrid(x0f, n, indexing="ij")
    exact = ttex._wrap(xs, ns, True)
    flt = ttex._wrap(xs, ns, False)
    assert torch.equal(exact, flt)
    small = (xs.abs() < 2.0 ** 24) & (ns <= 4096)
    assert bool(((exact >= 0) & (exact < ns))[small].all())
