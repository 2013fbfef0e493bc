"""PyTorch port, the exact iso march (``render/iso.py``) against the JAX
package's ``trace_iso_rays`` on the CPU: on the 32^3 golden scene at
48x32, the iso golden's 0.55 (off the cell values, where one ulp would
flip a hit), analytic and CD shading, unshaded, two surfaces on two
channels with a colormap channel, and a short [tmin, tmax] window.

Hits are equal; t within 8 ulps of its value (the two packages sum a
sample's basis terms in different orders, and the hit t is a weighted
average of two sample positions); unit normals within 4e-5 and shaded
colors within 2e-5 absolute (with CD gradients, differences of samples
half a cell apart, 2e-4 and 1e-4)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owlexabrick_tpu.bench_scene import synthetic_volume as ref_volume
from owlexabrick_tpu.pipeline import scene_from_cells as ref_scene_from_cells
from owlexabrick_tpu.render import dvr as R
from owlexabrick_tpu.render import iso as RI
from owlexabrick_tpu.render.camera import Camera
from owlexabrick_tpu.render.frame import make_frame_state
from owlexabrick_tpu.render.scene import to_device
from owlexabrick_tpu.tools.raw2cells import volume_to_cells as ref_cells
from owlexabrick_tpu_torch import interop
from owlexabrick_tpu_torch.render import dvr as P
from owlexabrick_tpu_torch.render import iso as PI
from torch_threads import one_torch_thread  # noqa: F401

W, H, N = 48, 32, 32


@pytest.fixture(scope="module")
def scenes():
    lower, level, scal = ref_cells(ref_volume(N), 0.004, 3)
    ref, *_ = ref_scene_from_cells(lower, level, [scal, 1.05 - scal],
                                   num_range_channels=2)
    return ref, interop.scene_from_reference(ref, "cpu")


def _frame(n_ch, isos):
    cam = Camera.look_at([N * 0.9, N * 0.8, N * 2.1], [N / 2] * 3,
                         [0, 1, 0], 45.0, W, H)
    fs = make_frame_state(cam, n_ch, [[0.0, 1.05]] * n_ch, dt=1.0,
                          opacity_scale=0.7)
    vals, chans, on = zip(*isos)
    return cam, dataclasses.replace(
        fs, iso_value=np.asarray(vals, np.float32),
        iso_channel=np.asarray(chans, np.int32),
        iso_enabled=np.asarray(on, bool))


CASES = {
    "analytic": (1, [(0.55, 0, True), (0.0, 0, False)], {}),
    "cd": (1, [(0.55, 0, True), (0.0, 0, False)],
           dict(analytic_gradients=False)),
    "cd_fast": (1, [(0.55, 0, True), (0.0, 0, False)],
                dict(analytic_gradients=False,
                     fast_central_differences=True)),
    "unshaded": (1, [(0.55, 0, True), (0.0, 0, False)],
                 dict(gradient_shading_iso=False)),
    "two_channels_colormap": (2, [(0.55, 0, True), (0.7, 1, True)],
                              dict(colormap_channel=1)),
}


@pytest.mark.parametrize("window", [False, True], ids=["full", "window"])
@pytest.mark.parametrize("case", list(CASES))
def test_trace_iso_rays_matches_reference(scenes, case, window):
    ref, port = scenes
    n_ch, isos, kw = CASES[case]
    cam, fs = _frame(n_ch, isos)
    o, d = cam.rays(W, H)
    p = o.shape[0]
    tmin = np.full(p, 40.0 if window else 1e-6, np.float32)
    tmax = np.full(p, 60.0 if window else 2e10, np.float32)
    cfg = R.RenderConfig(num_channels=n_ch, iso_surfaces=True, **kw)
    want = jax.tree.map(np.asarray, jax.jit(
        RI.trace_iso_rays, static_argnames="cfg")(
        to_device(ref), fs, cfg, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tmin), jnp.asarray(tmax)))
    got = [x.numpy() for x in PI.trace_iso_rays(
        port, interop.frame_state_from_reference(fs),
        P.RenderConfig(**dataclasses.asdict(cfg)), torch.from_numpy(o),
        torch.from_numpy(d), torch.from_numpy(tmin), torch.from_numpy(tmax))]
    hit = np.isfinite(want[0])
    assert np.array_equal(hit, np.isfinite(got[0]))
    assert 0.05 < hit.mean() < 0.95
    assert (np.abs(got[0][hit] - want[0][hit])
            <= 8 * np.spacing(want[0][hit])).all()
    cd = case.startswith("cd")
    assert np.abs(got[1] - want[1]).max() <= (2e-4 if cd else 4e-5)
    assert np.abs(got[2] - want[2]).max() <= (1e-4 if cd else 2e-5)
    assert (got[1][~hit] == 0).all() and (got[2][~hit] == 0).all()


def test_iso_region_mask_matches_reference(scenes):
    ref, port = scenes
    _, fs = _frame(2, [(0.95, 0, True), (0.7, 1, False)])
    want = np.asarray(RI.iso_region_mask(to_device(ref), fs))
    got = PI.iso_region_mask(port, interop.frame_state_from_reference(fs))
    assert np.array_equal(want, got.numpy()) and 0 < want.mean() < 1


@pytest.mark.parametrize("case", ["analytic", "cd", "two_channels_colormap"])
def test_batched_iso_march_equals_one_batch(scenes, case):
    """The iso march in batches of 97 rays gives the one-batch march's
    t, normals and colors bit for bit (no ray's arithmetic depends on
    its batch), on the full window and the short one in one call."""
    _, port = scenes
    n_ch, isos, kw = CASES[case]
    cam, fs = _frame(n_ch, isos)
    o, d = (torch.from_numpy(x) for x in cam.rays(W, H))
    p = o.shape[0]
    tmin = torch.where(torch.arange(p) % 2 == 0, 1e-6, 40.0)
    tmax = torch.where(torch.arange(p) % 2 == 0, 2e10, 60.0)
    cfg = P.RenderConfig(num_channels=n_ch, iso_surfaces=True, **kw)
    pfs = interop.frame_state_from_reference(fs)
    one = PI.trace_iso_rays(port, pfs, cfg, o, d, tmin, tmax)
    assert P.ray_batch(port) >= p and bool(torch.isfinite(one[0]).any())
    got = PI.trace_iso_rays(port, pfs, cfg, o, d, tmin, tmax, batch=97)
    assert all(torch.equal(a, b) for a, b in zip(one, got))
