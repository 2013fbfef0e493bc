"""PyTorch port, the RK4 particle tracer (``render/tracer.py``) against the
JAX package's on the CPU: the seed stream equal to
tests/test_tracer_seed.py's g++ goldens bit for bit; ``rk4_step`` and
``Tracer.advance`` on a 3-channel velocity field over the 32^3 golden
scene's cells (the same particles alive and dead, positions within 2e-5
of the scene's edge: sampled velocities differ in their last bits and
RK4 sums four of them per step); the segment tables; and the
tracer_segments golden's recipe with the port Tracer's own segments in
the exact frame against the JAX Renderer's under the golden gate."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owlexabrick_tpu.pipeline import scene_from_cells as ref_scene_from_cells
from owlexabrick_tpu.render import tracer as RT
from owlexabrick_tpu.render.dvr import RenderConfig as RefRenderConfig
from owlexabrick_tpu.render.frame import make_frame_state
from owlexabrick_tpu.render.renderer import Renderer as RefRenderer
from owlexabrick_tpu.render.scene import to_device
from owlexabrick_tpu_torch import interop
from owlexabrick_tpu_torch.bench_scene import synthetic_volume
from owlexabrick_tpu_torch.core.constants import TRACE_DEAD
from owlexabrick_tpu_torch.render import tracer as PT
from owlexabrick_tpu_torch.render.renderer import RenderConfig, Renderer
from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

from test_golden_images import H, N, W, _cam
from test_torch_renderer_surfaces import _gate
from test_tracer_seed import GOLDEN
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def scenes():
    """The golden scene's cells carrying a swirling velocity field
    (three channels)."""
    lower, level, scal = volume_to_cells(synthetic_volume(N), 0.004, 3)
    c = lower.astype(np.float32) + 0.5 * (1 << level.astype(np.int64))[
        :, None].astype(np.float32) - N / 2
    vel = [(-c[:, 1] + 0.2 * c[:, 2]) / N, (c[:, 0] + 0.1 * scal) / N,
           (0.3 - scal) * np.float32(0.5)]
    vel = [np.asarray(v, np.float32) for v in vel]
    ref, *_ = ref_scene_from_cells(lower, level, vel)
    return ref, interop.scene_from_reference(ref, "cpu")


def test_seeds_match_gpp_golden():
    got = PT.seed_traces(8, (0, 0, 0), (64, 32, 16), (0.25, 0.0, 0.5),
                         (0.75, 1.0, 1.0))
    np.testing.assert_array_equal(got, GOLDEN)
    np.testing.assert_array_equal(PT.minstd0_uniform_f32(5, 3),
                                  RT.minstd0_uniform_f32(5, 3))
    np.testing.assert_array_equal(PT.morton_order(GOLDEN),
                                  RT.morton_order(GOLDEN))


def test_rk4_step_matches_reference(scenes):
    """One step from seeds over the whole volume, some dead already and
    some leaving it."""
    ref, port = scenes
    pos = RT.seed_traces(400, np.asarray(ref.voxel_bounds_lo),
                         np.asarray(ref.voxel_bounds_hi))
    pos[::37] = TRACE_DEAD
    dref = to_device(ref)
    for steplen in (1.0, 4.0):
        want = np.asarray(RT.rk4_step(
            dref, jnp.asarray(pos), steplen, (0, 1, 2),
            dref.voxel_bounds_lo, dref.voxel_bounds_hi))
        got = PT.rk4_step(port, torch.from_numpy(pos), steplen, (0, 1, 2),
                          port.voxel_bounds_lo, port.voxel_bounds_hi).numpy()
        dead = want == np.float32(TRACE_DEAD)
        assert np.array_equal(dead, got == np.float32(TRACE_DEAD))
        assert 0 < dead.all(-1).mean() < 0.5
        assert np.abs(got[~dead] - want[~dead]).max() <= 2e-5 * N


def test_tracer_advance_matches_reference(scenes):
    ref, port = scenes
    kw = dict(num_traces=200, num_timesteps=8, steplen=2.0,
              channels=(0, 1, 2), seed_region_lo=(0.2, 0.2, 0.2),
              seed_region_hi=(0.8, 0.8, 0.8), radius=0.6)
    a, b = RT.Tracer(to_device(ref), **kw), PT.Tracer(port, **kw)
    np.testing.assert_array_equal(a.traces, b.traces)
    assert b.surface_data().num_segments == 0
    while a.advance():
        assert b.advance()
    assert not b.advance() and b.timestep == a.timestep == 7
    dead = a.traces == np.float32(TRACE_DEAD)
    assert np.array_equal(dead, b.traces == np.float32(TRACE_DEAD))
    assert np.abs(a.traces[~dead] - b.traces[~dead]).max() <= 2e-5 * N
    for fa, fb in ((a.surface_data(), b.surface_data()),
                   (a.surface_data_full(), b.surface_data_full())):
        assert fb.num_segments == fa.num_segments == 200 * 7
        np.testing.assert_array_equal(fb.seg_t.numpy(), fa.seg_t)
        np.testing.assert_allclose(fb.seg_a.numpy(), fa.seg_a, atol=2e-5 * N)
        assert fb.seg_radius == fa.seg_radius


def test_tracer_frame_matches_jax(scenes):
    """The tracer_segments golden's frame (timestep cull included) with
    each package's own traced segments, in the exact frame."""
    ref, port = scenes
    kw = dict(num_traces=24, num_timesteps=12, steplen=3.0,
              channels=(0, 1, 2), seed_region_lo=(0.2, 0.2, 0.6),
              seed_region_hi=(0.8, 0.8, 0.9), radius=1.2)
    a, b = RT.Tracer(to_device(ref), **kw), PT.Tracer(port, **kw)
    for _ in range(11):
        a.advance()
        b.advance()
    fs = dataclasses.replace(
        make_frame_state(_cam(), 3, [[-1.0, 1.0]] * 3, dt=1.0,
                         opacity_scale=0.3),
        tracer_timestep=np.int32(8))
    want = RefRenderer(ref, W, H, cfg=RefRenderConfig(num_channels=3),
                       frame_state=fs, surfaces=a.surface_data_full())
    got = Renderer(port, W, H, cfg=RenderConfig(num_channels=3),
                   frame_state=interop.frame_state_from_reference(fs),
                   surfaces=b.surface_data_full(), device="cpu")
    _gate(want, got)
