"""PyTorch port, scenes with more than 8 levels: K1's and K3's level tables
hold every level a scene can have (``kernels.MAX_LEVELS``), as the JAX
package's kernels unroll any count.  Seeded scenes of 9 and 12 levels
(one 2^3-cell brick per level, side by side along x, built with
``tools.artificial.parse_grids_text`` and the port's builder) render
through the port's ``render_slabs_camera`` on the megakernel lane (K1's
twin) and on the clip box's lane (K3's twin) against the JAX package's
``render_slabs_camera`` on the same grids at its highest dot precision,
under ``tests/test_torch_slabs.py::_gate`` at that precision's tolerance
(1e-4 on 99.5% of pixels, 2e-2 on every pixel).  The reference's default
bf16 hi/lo tent products drift up to 7.8e-4 from it on these lattices,
whose coordinates reach 8,190 voxels, so the default-precision frame is
no fair yardstick here.  The launchers' level check takes 1-32 levels,
and K1's integer arguments carry every level's lattice height."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owlexabrick_tpu.core.types import Bricks as RefBricks
from owlexabrick_tpu.render import slabs as R
from owlexabrick_tpu.render.camera import Camera as RefCamera
from owlexabrick_tpu.render.frame import make_frame_state
from owlexabrick_tpu_torch import interop, kernels
from owlexabrick_tpu_torch.pipeline import scene_from_cells
from owlexabrick_tpu_torch.render import slabs as P
from owlexabrick_tpu_torch.render import sweep as PS
from owlexabrick_tpu_torch.render.camera import Camera
from owlexabrick_tpu_torch.render.renderer import clip_interval
from owlexabrick_tpu_torch.tools.artificial import parse_grids_text

from test_torch_slabs import _gate
from torch_threads import one_torch_thread  # noqa: F401

W, H = 64, 16


def level_text(n_levels: int, seed: int) -> str:
    """One 2x2x2-cell brick per level 0..n-1 along x, coarsest first (so
    every brick's corner lies on its level's lattice), seeded corner
    values in [0.5, 7]."""
    rng = np.random.default_rng(seed)
    lines, x = [], 0
    for lv in reversed(range(n_levels)):
        vals = " ".join(f"{v:.4f}" for v in rng.uniform(0.5, 7.0, 8))
        lines.append(f"{x} 0 0 2 2 2 {lv} {vals}")
        x += 2 << lv
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for n in (9, 12):
        lower, level, scal = parse_grids_text(level_text(n, 90 + n))
        scene, bricks, *_ = scene_from_cells(lower, level, [scal],
                                             device="cpu")
        scalars = scene.scalars.numpy()
        port = P.build_level_grids(bricks, scalars, axis=2, device="cpu")
        assert len(port.levels) == n
        ref = R.build_level_grids(RefBricks(
            lower=bricks.lower, size=bricks.size, level=bricks.level,
            begin=bricks.begin), scalars, axis=2, device=False)
        ref = jax.tree.map(jnp.asarray, ref)
        extent = float(2 << (n - 1))
        cam = Camera.look_at([extent, extent / 2, 2.2 * extent],
                             [extent, extent / 2, extent / 2], [0, 1, 0],
                             50.0, W, H)
        out[n] = (ref, port, cam)
    return out


def _frame_state(cam):
    fs = make_frame_state(RefCamera(pos=cam.pos, dir00=cam.dir00,
                                    dir_du=cam.dir_du, dir_dv=cam.dir_dv),
                          1, [[0.0, 7.0]], dt=1.0, opacity_scale=0.8)
    return fs, interop.frame_state_from_reference(fs)


@pytest.mark.parametrize("clip", [False, True], ids=["megakernel", "clip"])
@pytest.mark.parametrize("n", [9, 12])
def test_many_levels_match_reference(scenes, n, clip):
    ref_g, port_g, cam = scenes[n]
    fs_r, fs = _frame_state(cam)
    extent = float(np.asarray(ref_g.bounds_hi[0] - ref_g.bounds_lo[0]))
    kw = dict(num_channels=1, nslabs=48, chunk=8)
    rcfg = R.SlabConfig(extent_z=extent, dot_precision="highest", **kw)
    pcfg = P.SlabConfig(**kw)
    interval = {}
    if clip:
        lo = np.asarray(port_g.bounds_lo)[::-1] + 0.0
        hi = np.asarray(port_g.bounds_hi)[::-1] + 0.0
        t0, t1 = clip_interval(2, cam, None, W, H, np.eye(3, 4), cam.pos,
                               [lo[0] + 0.3 * (hi[0] - lo[0]), lo[1], lo[2]],
                               [hi[0], hi[1], lo[2] + 0.8 * (hi[2] - lo[2])],
                               device="cpu")
        interval = dict(t_start=t0, t_stop=t1)
    assert P.megakernel_lane(pcfg, interval.get("t_start")) != clip
    got = P.render_slabs_camera(port_g, fs, pcfg, cam, W, H, **interval)
    ref = np.asarray(R.render_slabs_camera(
        ref_g, fs_r, rcfg, RefCamera(pos=cam.pos, dir00=cam.dir00,
                                     dir_du=cam.dir_du, dir_dv=cam.dir_dv),
        W, H, **{k: jnp.asarray(v.numpy()) for k, v in interval.items()}))
    assert ref[:, 3].max() > 0.3
    _gate(got.numpy(), ref, 1e-4)


@pytest.mark.parametrize("n", [1, 8, 9, 12, 16, 31, 32])
def test_launchers_take_many_levels(n):
    """The level check both launchers run: K1 takes 1..32 levels, K3
    0..32; past the table it names the cap."""
    kernels.check_levels("K1", n)
    kernels.check_levels("K3", n, least=0)
    with pytest.raises(ValueError, match="MAX_LEVELS"):
        kernels.check_levels("K1", kernels.MAX_LEVELS + 1)
    with pytest.raises(ValueError, match="MAX_LEVELS"):
        kernels.check_levels("K1", 0)


def test_k1_ints_carry_every_level(scenes):
    """K1's integer arguments for a 12-level chunk: the header, then one
    lattice height per level (sweep.cu's unpack reads 13 + L ints)."""
    _, port_g, cam = scenes[12]
    mids = [torch.zeros((2, 3, int(m.shape[1]), W)) for m in port_g.masks]
    y_pos = torch.linspace(0.0, 4000.0, H).repeat(3, 1)
    prep = PS.prepare_chunk(mids, [float(o[1]) for o in port_g.origins],
                            [float(1 << lv) for lv in port_g.levels], y_pos,
                            H, W)
    tables = PS.pack_luts([torch.zeros((128, 4))],
                          torch.tensor([[0.0, 1.0]]), None, "cpu")
    ints = PS._k1_ints(prep, tables, H, W, (0, 0), False, False, False)
    assert ints[0] == 12 and len(ints) == 13 + 12
    assert list(ints[13:]) == [int(m.shape[1]) for m in port_g.masks]
