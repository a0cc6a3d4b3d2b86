"""The port's oracle against the oracle-independent golden vectors of
tests/test_wgsl_goldens.py: that file's own cases, checks and tolerances
(rtol 3e-5 on the EWA projection, 1e-9 on the fragment blend), run with
the port's ewa_project_cov and blend_fragments in place of the NumPy
oracle's. Nothing is copied out of that file."""

import numpy as np
import pytest
import torch

import test_wgsl_goldens as goldens
from gswt_renderer_tpu.refrender import oracle as jo
from gswt_renderer_tpu_torch.refrender import oracle as to


def _port_ewa(Vrk, center, view3, cam_pos, focal, htan_fov):
    """The port's EWA projection on CPU tensors of the float64 inputs the
    golden checks pass, with numpy outputs for their assertions."""
    out = to.ewa_project_cov(torch.from_numpy(np.asarray(Vrk)),
                             torch.from_numpy(np.asarray(center)),
                             torch.from_numpy(np.asarray(view3)),
                             np.asarray(cam_pos), focal, htan_fov)
    return tuple(x.numpy() for x in out)


def _port_blend(frags):
    return to.blend_fragments(frags, device="cpu").numpy()


@pytest.mark.parametrize("case", ["CASE1", "CASE2", "CASE3"])
def test_port_ewa_meets_the_golden_case(case, monkeypatch):
    monkeypatch.setattr(goldens, "ewa_project_cov_np", _port_ewa)
    goldens._check(getattr(goldens, case))


@pytest.mark.parametrize("case", ["CASE1", "CASE2", "CASE3"])
def test_port_ewa_keeps_float64_inputs(case):
    """The golden inputs are float64: the port computes in them, with J in
    float32 as the NumPy form builds it, and so gives the NumPy oracle's
    numbers on them (rtol 1e-12: float64 summation order)."""
    c = getattr(goldens, case)
    args = (np.asarray(c["Vrk"], np.float64)[None],
            np.asarray(c["center"], np.float64)[None],
            np.asarray(c["view3"], np.float64),
            np.asarray(c["cam_pos"], np.float64), c["focal"], c["htan"])
    got = _port_ewa(*args)
    assert {x.dtype for x in got} == {np.dtype(np.float64)}
    for g, r in zip(got, jo.ewa_project_cov_np(*args)):
        np.testing.assert_allclose(g, r, rtol=1e-12, atol=1e-12)


def test_port_blend_meets_the_golden_case(monkeypatch):
    monkeypatch.setattr(goldens, "blend_fragments_np", _port_blend)
    goldens.test_fragment_blend_golden()
