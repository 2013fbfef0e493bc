"""PyTorch port, ``render_slabs_shearwarp``'s surface stop and warp
filter against the JAX package's: a seeded per-intermediate-pixel
``t_stop`` and each ``filter`` ("auto", "bicubic", "bilinear") on one
small tilted view of the EX3 fixture, under
``test_render_slabs_shearwarp_matches_reference``'s gate (2e-4 on 99.5%
of pixels, 2e-2 on all)."""

import numpy as np
import pytest
import torch

from owlexabrick_tpu.render import shearwarp as RS
from owlexabrick_tpu.render import slabs as R
from owlexabrick_tpu_torch import interop
from owlexabrick_tpu_torch.render import shearwarp as PS
from owlexabrick_tpu_torch.render import slabs as P

from test_torch_shearwarp import (  # noqa: F401 (the scenes fixture)
    SIZE, _axis, _cam, _fs, _ref_cam, scenes)
from test_torch_slabs import _gate


@pytest.mark.parametrize("filt", ["auto", "bicubic", "bilinear"])
def test_render_slabs_shearwarp_stop_and_filter(scenes, filt):  # noqa: F811
    cam = _cam("tilted")
    axis = _axis(cam, SIZE, SIZE)
    g_ref, g_port = scenes["EX3", axis]
    sw = PS.setup_shearwarp(cam, axis, SIZE, SIZE,
                            *PS.inter_dims(SIZE, SIZE))
    fs = _fs(cam, dt=0.25)
    extent = float(np.asarray(g_ref.bounds_hi[0] - g_ref.bounds_lo[0]))
    base = dict(num_channels=1, nslabs=int(np.ceil(extent / 0.25)), chunk=12)
    # stops spread over the volume's depth, per lattice pixel
    rng = np.random.default_rng(11)
    eye_d = float(np.linalg.norm(np.asarray(cam.pos) - 4.0))
    t_stop = rng.uniform(0.7, 1.3, sw.width * sw.height).astype(
        np.float32) * np.float32(
        eye_d / abs(float(np.asarray(sw.camera.dir00)[axis])))
    ref = np.asarray(RS.render_slabs_shearwarp(
        g_ref, fs, R.SlabConfig(extent_z=extent, **base), _ref_cam(cam),
        SIZE, SIZE, t_stop=t_stop, filter=filt))
    pfs = interop.frame_state_from_reference(fs)
    pcfg = P.SlabConfig(**base)
    got = PS.render_slabs_shearwarp(g_port, pfs, pcfg, cam, SIZE, SIZE,
                                    t_stop=torch.from_numpy(t_stop),
                                    filter=filt).numpy()
    assert ref[:, 3].max() > 0.3
    _gate(got, ref, 2e-4)
    full = PS.render_slabs_shearwarp(g_port, pfs, pcfg, cam, SIZE, SIZE,
                                     filter=filt).numpy()
    assert float((full[:, 3] - got[:, 3]).max()) > 0.05
    if filt != "auto":
        other = "bilinear" if filt == "bicubic" else "bicubic"
        alt = PS.render_slabs_shearwarp(g_port, pfs, pcfg, cam, SIZE, SIZE,
                                        t_stop=torch.from_numpy(t_stop),
                                        filter=other).numpy()
        assert float(np.abs(alt - got).max()) > 1e-3
