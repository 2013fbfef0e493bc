"""PyTorch port, the scalar numpy oracle (``owlexabrick_tpu_torch.oracle.
reference``) against the JAX package's oracle on the EX2-EX4 fixtures,
ray by ray and point by point: ``trace_dvr_ray`` (with and without space
skipping, CD and analytic shading, nearest mode), ``trace_iso_ray``,
``sample_point``, ``sample_point_with_derivative``, ``gradient_cd`` and
``region_active`` are equal exactly.  Both are numpy over the same
tables (the port's Scene holds the JAX scene's arrays bit for bit), so
equality is the fair test."""

import dataclasses

import numpy as np
import pytest

from owlexabrick_tpu.core.types import ScalarField as RefField
from owlexabrick_tpu.oracle import reference as J
from owlexabrick_tpu.pipeline import scene_from_cells as ref_scene_from_cells
from owlexabrick_tpu.render.camera import Camera
from owlexabrick_tpu.render.frame import make_frame_state
from owlexabrick_tpu.render.scene import build_scene as ref_build_scene
from owlexabrick_tpu_torch import interop
from owlexabrick_tpu_torch.oracle import reference as P

from conftest import EX2, EX3, EX4
from torch_threads import one_torch_thread  # noqa: F401

TEXTS = {"EX2": (EX2, 7.0, 3.5), "EX3": (EX3, 7.0, 2.5),
         "EX4": (EX4, 2.0, 1.5)}
SIZE = 12


def _case(amr_fixture, name, basis=True):
    """The JAX host scene and frame state (an iso surface at a value
    off the cell values), their port, and the rays."""
    text, vmax, iso = TEXTS[name]
    lower, level, scal = amr_fixture(text)
    ref, bricks, ids, *_ = ref_scene_from_cells(lower, level, [scal])
    if not basis:
        ref, *_ = ref_build_scene(bricks, ids, [RefField.from_values(
            "f", np.asarray(scal, np.float32))], basis_method=False)
    cam = Camera.look_at(from_=[12.0, 10.0, 14.0], at=[4.0, 2.0, 2.0],
                         up=[0, 1, 0], fovy_degrees=50.0, width=SIZE,
                         height=SIZE)
    fs = make_frame_state(cam, 1, [[0.0, vmax]], dt=0.7)
    fs = dataclasses.replace(
        fs, iso_enabled=np.array([True, False]),
        iso_value=np.array([iso, 0.0], np.float32),
        iso_channel=np.zeros(2, np.int32))
    o, d = cam.rays(SIZE, SIZE)
    return (ref, fs, interop.scene_from_reference(ref, "cpu"),
            interop.frame_state_from_reference(fs), o, d)


def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


DVR_KW = {
    "default": {},
    "no_skip": dict(space_skipping=False),
    "analytic": dict(gradient_shading=True),
    "cd": dict(gradient_shading=True, analytic_gradients=False),
    "offset": dict(offset=0.37),
}


@pytest.mark.parametrize("name", list(TEXTS))
@pytest.mark.parametrize("kw", list(DVR_KW))
def test_trace_dvr_ray_equal(amr_fixture, name, kw):
    ref, fs, port, pfs, o, d = _case(amr_fixture, name)
    lit = 0
    for i in range(o.shape[0]):
        want = J.trace_dvr_ray(ref, fs, o[i], d[i], **DVR_KW[kw])
        _equal(P.trace_dvr_ray(port, pfs, o[i], d[i], **DVR_KW[kw]), want)
        lit += want[3] > 0.05
    assert lit > 4


def test_trace_dvr_ray_nearest_equal(amr_fixture):
    ref, fs, port, pfs, o, d = _case(amr_fixture, "EX3", basis=False)
    for i in range(o.shape[0]):
        _equal(P.trace_dvr_ray(port, pfs, o[i], d[i], basis_method=False),
               J.trace_dvr_ray(ref, fs, o[i], d[i], basis_method=False))


@pytest.mark.parametrize("name", list(TEXTS))
@pytest.mark.parametrize("analytic", [True, False], ids=["analytic", "cd"])
def test_trace_iso_ray_equal(amr_fixture, name, analytic):
    ref, fs, port, pfs, o, d = _case(amr_fixture, name)
    hits = 0
    for i in range(o.shape[0]):
        want = J.trace_iso_ray(ref, fs, o[i], d[i],
                               analytic_gradients=analytic)
        _equal(P.trace_iso_ray(port, pfs, o[i], d[i],
                               analytic_gradients=analytic), want)
        hits += bool(np.isfinite(want[0]))
    assert hits > 4


@pytest.mark.parametrize("name", list(TEXTS))
def test_samplers_and_regions_equal(amr_fixture, name):
    """sample_point, sample_point_with_derivative and gradient_cd at
    seeded points in (and past) the bounds, in the region holding each
    point; region_active for every region under the fixture's TF and
    under a TF that keeps only the top of the range."""
    ref, fs, port, pfs, _, _ = _case(amr_fixture, name)
    hi = np.asarray(ref.voxel_bounds_hi, np.float64)
    pts = np.random.default_rng(3).uniform(-0.5, hi + 0.5, (120, 3))
    inside = 0
    for p in pts:
        rid = J.locate_region_point(ref, p)
        assert P.locate_region_point(port, p) == rid
        _equal(P.gradient_cd(port, p, 0, 0.5), J.gradient_cd(ref, p, 0, 0.5))
        if rid < 0:
            continue
        inside += 1
        _equal(P.sample_point(port, rid, p, 0), J.sample_point(ref, rid, p, 0))
        _equal(P.sample_point_with_derivative(port, rid, p, 0),
               J.sample_point_with_derivative(ref, rid, p, 0))
        _equal(P.gradient_cd(port, p, 0, 0.25, fixed_region=rid),
               J.gradient_cd(ref, p, 0, 0.25, fixed_region=rid))
    assert inside > 60
    lut = np.asarray(fs.xf_lut).copy()
    lut[0, :124, 3] = 0.0
    fs_top = dataclasses.replace(fs, xf_lut=lut)
    pfs_top = interop.frame_state_from_reference(fs_top)
    states = []
    for rid in range(np.asarray(ref.region_lo).shape[0]):
        for jf, pf in ((fs, pfs), (fs_top, pfs_top)):
            want = J.region_active(ref, jf, rid, 1)
            assert P.region_active(port, pf, rid, 1) == want
            states.append(want)
    assert any(states) and not all(states)
