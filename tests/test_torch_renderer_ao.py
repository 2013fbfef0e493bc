"""PyTorch port, the Renderer's lattice AO against the JAX Renderer's fast
path: mesh AO with iso occluders (``ao_combined``) on the 32^3 golden
scene at 96x64 over 2 frames under the golden gate (every pixel within
1/255, >= 99% bit-exact), and the port's ``ao_sweep`` render (iso AO on
the lattice, ``ao_fast``, 6 frames) against
``tests/golden/ao_sweep.png``."""

import dataclasses

import numpy as np
import pytest

from owlexabrick_tpu.render.frame import make_frame_state
from owlexabrick_tpu_torch import interop
from owlexabrick_tpu_torch.bench_scene import synthetic_volume
from owlexabrick_tpu_torch.render.renderer import RenderConfig, Renderer
from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

from test_golden_images import H, N, W, _cam, _check
from test_torch_renderer_surfaces import AO, ISO, _gate, _pair, _quad_and_wall


@pytest.fixture(scope="module")
def cells():
    return volume_to_cells(synthetic_volume(N), 0.004, 3)


def test_ao_combined_matches_jax(cells):
    """Mesh AO with iso occluders: the lattice shadow volumes OR the
    traced geometry under one pooled-direction estimator."""
    ref, port = _pair(cells, _quad_and_wall(), fs_patch={**ISO, **AO},
                      ao_samples=2, iso_surfaces=True)
    assert port._ao_modes() == (True, False)
    _gate(ref, port)


def test_ao_sweep_golden(cells):
    """The port's ao_sweep render (tests/test_golden_images.py::
    test_golden_ao_sweep: iso AO on the lattice, 6 frames) passes the
    golden's gate."""
    lower, level, scal = cells
    fs = make_frame_state(_cam(), 1, [[0.0, 1.05]], dt=1.0,
                          opacity_scale=0.7)
    fs = dataclasses.replace(fs, **ISO, **AO)
    r = Renderer((lower, level, scal[None]), W, H,
                 cfg=RenderConfig(num_channels=1, iso_surfaces=True,
                                  ao_samples=2),
                 frame_state=interop.frame_state_from_reference(fs),
                 device="cpu")
    assert r.enable_fast_path() and r._ao_modes() == (False, True)
    img = r.image_uint8(r.render_frames(6))
    assert (img[..., :3] > 16).any(), "blank render"
    _check(np.ascontiguousarray(img), "ao_sweep")
