"""PyTorch port, the exajet-pattern bench scene against the JAX
package's ``bench_scene``: the dense volume bit for bit for one and two
wings, the streamed cells bit for bit against the JAX package's and
equal (as a set) to the dense volume's collapse, and the scene's level
grids with two wings equal to the reference route, at n = 32."""

import numpy as np
import pytest

from owlexabrick_tpu import bench_scene as RB
from owlexabrick_tpu.pipeline import scene_from_cells
from owlexabrick_tpu.render import slabs as R
from owlexabrick_tpu.tools.raw2cells import volume_to_cells as ref_v2c
from owlexabrick_tpu_torch import bench_scene as PB
from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

from test_torch_host import _assert_grids_equal

N = 32


def _sorted(lo, lv, sc):
    key = np.lexsort((lo[:, 0], lo[:, 1], lo[:, 2], lv))
    return lo[key], lv[key], sc[key]


@pytest.mark.parametrize("wings", [1, 2])
def test_exajet_pattern_volume_bit_equal(wings):
    got = PB.exajet_pattern_volume(N, wings=wings)
    want = RB.exajet_pattern_volume(N, wings=wings)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("wings", [1, 2])
def test_exajet_pattern_cells_bit_equal(wings):
    got = PB.exajet_pattern_cells(N, wings=wings)
    want = RB.exajet_pattern_cells(N, wings=wings)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    dense = volume_to_cells(PB.exajet_pattern_volume(N, wings=wings), 0.004,
                            3)
    for a, b in zip(_sorted(*got), _sorted(*dense)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        PB.exajet_pattern_cells(N + 4)


def test_slab_scene_grids_two_wings():
    vol = RB.exajet_pattern_volume(N, wings=2)
    lower, level, scal = ref_v2c(vol, 0.004, 3)
    scene, bricks, *_ = scene_from_cells(lower, level, [scal])
    ref = R.build_level_grids(bricks, scene.scalars, axis=2, device=False)
    got, meta = PB.slab_scene_grids("exajet", N, device="cpu", wings=2)
    _assert_grids_equal(ref, got)
    assert meta["n_cells"] == lower.shape[0]
