"""PyTorch port, the ``SlabConfig`` fields that change the image or the
lane: ``xf_knots`` (the LUT resampled to 32 texels and classified dense,
on the megakernel lane and on a gradient-shaded einsum-lane frame, K4),
``xf_fit_quantum`` (the knot fit's tolerance), ``space_skipping`` off,
``megakernel`` off (the one-channel einsum lane, K6 then K3 from the
mids with an open interval) and ``tile_rows`` / ``tile_cols`` with the
adaptive stride on, each frame of the port against the JAX package's
``render_slabs_camera`` on the two-wing exajet scene at 32^3 (48x40,
40 slabs, chunk 4) under the slab tests' gate; and the port's fields'
defaults against the JAX package's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from owlexabrick_tpu.bench_scene import exajet_pattern_volume
from owlexabrick_tpu.pipeline import scene_from_cells
from owlexabrick_tpu.render import slabs as R
from owlexabrick_tpu.render.camera import Camera
from owlexabrick_tpu.render.frame import make_frame_state
from owlexabrick_tpu.tools.raw2cells import volume_to_cells
from owlexabrick_tpu_torch import interop
from owlexabrick_tpu_torch.render import slabs as P

from test_torch_slabs import _gate

N, W, H = 32, 48, 40
FIELDS = ("space_skipping", "xf_knots", "xf_fit_quantum", "megakernel",
          "tile_rows", "tile_cols")


@pytest.fixture(scope="module")
def scene():
    lower, level, scal = volume_to_cells(exajet_pattern_volume(N, wings=2),
                                         0.004, 3)
    sc, bricks, *_ = scene_from_cells(lower, level, [scal])
    g = R.build_level_grids(bricks, sc.scalars, axis=2, device=False)
    cam = Camera.look_at([N / 2, N / 2, 2.2 * N], [N / 2, N / 2, N / 2],
                         [0, 1, 0], 45.0, W, H)
    fs = make_frame_state(cam, 1, [[0.0, float(scal.max())]], dt=1.0,
                          opacity_scale=0.7)
    # a transfer function transparent over its lowest third, so space
    # skipping culls the background's slabs and tiles
    lut = np.asarray(fs.xf_lut).copy()
    lut[:, :42, 3] = 0.0
    fs = dataclasses.replace(fs, xf_lut=lut)
    return (jax.tree.map(jnp.asarray, g),
            interop.level_grids_from_reference(g, device="cpu"), cam, fs)


CASES = {
    "xf_knots_32": dict(xf_knots=32),
    "xf_fit_quantum_2": dict(xf_fit_quantum=2.0),
    "space_skipping_off": dict(space_skipping=False),
    "megakernel_off": dict(megakernel=False),
    "tiles_8x16_stride": dict(tile_rows=8, tile_cols=16,
                              adaptive_stride=True),
    "xf_knots_32_gradient": dict(xf_knots=32, gradient_shading_dvr=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_field_frame_matches_reference(scene, case):
    """Each field's frame against the JAX package's: 1e-4 on 99.5% of
    pixels, 2e-2 on every pixel (``_gate``), and different from the
    default frame where the field changes the image."""
    g_ref, g_port, cam, fs_r = scene
    extent = float(np.asarray(g_ref.bounds_hi[0] - g_ref.bounds_lo[0]))
    base = dict(num_channels=1, nslabs=40, chunk=4)
    kw = CASES[case]
    rcfg = R.SlabConfig(dot_precision="highest", extent_z=extent, **base,
                        **kw)
    pcfg = P.SlabConfig(**base, **kw)
    ref = np.asarray(R.render_slabs_camera(g_ref, fs_r, rcfg, cam, W, H))
    fs = interop.frame_state_from_reference(fs_r)
    got = P.render_slabs_camera(g_port, fs, pcfg, cam, W, H).numpy()
    assert ref[:, 3].max() > 0.5 and (ref[:, 3] > 0.01).mean() > 0.2
    _gate(got, ref, 1e-4)
    if "xf_knots" in kw:
        # 32 texels: a resampled LUT, not the 128-texel one
        plain = dict(kw, xf_knots=128)
        dflt = P.render_slabs_camera(g_port, fs, P.SlabConfig(**base,
                                                              **plain),
                                     cam, W, H).numpy()
        assert np.abs(dflt - got).max() > 1e-4


def test_space_skipping_and_lane_switches_take_effect(scene):
    """``space_skipping=False`` marks every slab in front of the eye live
    (the TF cull would drop some at this TF), and ``megakernel=False``
    takes the einsum lane, whose frame needs no camera products."""
    g_ref, g_port, cam, fs_r = scene
    fs = interop.frame_state_from_reference(fs_r)
    cfg = P.SlabConfig(nslabs=40, chunk=4)
    calls = []
    real = P.active_for_volume_sampling

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    P.active_for_volume_sampling = spy
    try:
        P.render_slabs_camera(g_port, fs, cfg, cam, W, H)
        assert calls
        calls.clear()
        P.render_slabs_camera(g_port, fs, dataclasses.replace(
            cfg, space_skipping=False), cam, W, H)
        assert not calls
    finally:
        P.active_for_volume_sampling = real
    assert not P.megakernel_lane(dataclasses.replace(cfg, megakernel=False))
    cache = {}
    P.render_slabs_camera(g_port, fs, dataclasses.replace(
        cfg, megakernel=False), cam, W, H, camera_cache=cache)
    assert "products" not in cache


@pytest.mark.parametrize("field", FIELDS)
def test_fields_default_as_in_reference(field):
    """The port's SlabConfig has each field under the JAX package's name
    with its default."""
    ref = {f.name: f.default for f in dataclasses.fields(R.SlabConfig)}
    got = {f.name: f.default for f in dataclasses.fields(P.SlabConfig)}
    assert got[field] == ref[field]
    assert type(got[field]) is type(ref[field])


def test_frame_luts_resample_as_reference(scene):
    """``frame_luts`` at 32 texels: the JAX package's linear resample of
    the opacity-scaled LUT (within float rounding of its linspace)."""
    _, _, _, fs_r = scene
    fs = interop.frame_state_from_reference(fs_r)
    got = P.frame_luts(fs, P.SlabConfig(xf_knots=32))[0]
    lut = np.asarray(fs_r.xf_lut[0], np.float32)
    lut = np.concatenate([lut[:, :3], lut[:, 3:4] * np.float32(0.7)], 1)
    uu = np.linspace(0.0, 127.0, 32)
    want = np.stack([np.interp(uu, np.arange(128), lut[:, k])
                     for k in range(4)], 1)
    assert got.shape == (32, 4) and got.dtype == np.float32
    assert np.abs(got - want).max() < 1e-6
    assert P.frame_luts(fs, P.SlabConfig())[0].shape == (128, 4)
