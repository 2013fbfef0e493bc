"""PyTorch port, the exact scene build against the JAX package's: the
brick builder (numpy and native), the region build (native and numpy),
``gather_scalars``, ``build_brick_regions`` and ``build_scene``, bit for
bit on the EX0-EX4 fixtures and the 32^3 golden scene; the native core's
build raises when it cannot compile; ``interop.scene_from_reference``
carries the JAX Scene over unchanged."""

import dataclasses

import numpy as np
import pytest
import torch

from owlexabrick_tpu.builder.bricker import Bricker as RefBricker
from owlexabrick_tpu.pipeline import bricks_from_build as ref_bricks_from_build
from owlexabrick_tpu.pipeline import scene_from_cells as ref_scene_from_cells
from owlexabrick_tpu.regions.build import build_regions_py as ref_regions_py
from owlexabrick_tpu.render.scene import (
    build_brick_regions as ref_brick_regions,
    build_scene as ref_build_scene,
    gather_scalars as ref_gather,
)
from owlexabrick_tpu.core.types import ScalarField as RefField
from owlexabrick_tpu.tools.artificial import parse_grids_text
from owlexabrick_tpu_torch import interop, native
from owlexabrick_tpu_torch.bench_scene import synthetic_volume
from owlexabrick_tpu_torch.builder.bricker import (
    SAH_ALIKE, SMALL_BRICK_COUNT, SPATIAL_MEDIAN, Bricker, build_bricks)
from owlexabrick_tpu_torch.core.types import ScalarField, Scene
from owlexabrick_tpu_torch.pipeline import bricks_from_build, scene_from_cells
from owlexabrick_tpu_torch.regions.build import build_regions
from owlexabrick_tpu_torch.render.scene import (
    build_brick_regions, build_scene, gather_scalars)
from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

from conftest import EX0, EX1, EX2, EX3, EX4
from torch_threads import one_torch_thread  # noqa: F401

FIXTURES = {"EX0": EX0, "EX1": EX1, "EX2": EX2, "EX3": EX3, "EX4": EX4}


@pytest.fixture(scope="module")
def golden_cells():
    return volume_to_cells(synthetic_volume(32), 0.004, 3)


def _cells(name, golden_cells):
    if name == "golden32":
        return golden_cells
    return parse_grids_text(FIXTURES[name])


def _assert_same(a, b, what=""):
    """Dataclasses (or arrays) equal field by field, dtype included."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{what}.{f.name}")
        return
    if isinstance(a, (int, float, str)):
        assert a == b, what
        return
    if isinstance(a, tuple):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                        b.dtype)
    assert np.array_equal(a, b), what


def _same_build(ref, got):
    assert len(ref.bricks) == len(got.bricks)
    for a, b in zip(ref.bricks, got.bricks):
        _assert_same(a, b, "brick")
    assert [dataclasses.astuple(k) for k in ref.kd] == [
        dataclasses.astuple(k) for k in got.kd]


@pytest.mark.parametrize("name", [*FIXTURES, "golden32"])
@pytest.mark.parametrize("strategy",
                         [SPATIAL_MEDIAN, SAH_ALIKE, SMALL_BRICK_COUNT])
def test_bricker_matches_reference(name, strategy, golden_cells):
    """The numpy Bricker (and ``build_bricks``) gives the JAX package's
    numpy Bricker's bricks and kd-tree, and the native core its flat
    bricks and cell IDs, bit for bit."""
    lower, level, _ = _cells(name, golden_cells)
    ref = RefBricker(lower, level, strategy).build()
    _same_build(ref, Bricker(lower, level, strategy).build())
    _same_build(ref, build_bricks(lower, level, strategy))
    flat = native.native_build_bricks_flat(lower, level, strategy)
    _assert_same(ref_bricks_from_build(ref), flat)
    _assert_same(bricks_from_build(ref), flat)


@pytest.mark.parametrize("name", [*FIXTURES, "golden32"])
def test_region_builds_match_reference(name, golden_cells):
    """The native and the numpy region builds give the JAX package's
    numpy regions and tree, bit for bit (the numpy builds at 32^3 take
    ~13 s each, so there the port's numpy build is held to the JAX
    package's native one, which tests/test_native.py holds to its
    numpy build)."""
    lower, level, scal = _cells(name, golden_cells)
    bricks, ids = native.native_build_bricks_flat(lower, level)
    scalars = np.asarray(scal, np.float32)[ids][None]
    nat = build_regions(bricks, scalars)
    if name == "golden32":
        from owlexabrick_tpu.regions.build import build_regions as ref_build

        ref = ref_build(bricks, scalars)
    else:
        ref = ref_regions_py(bricks, scalars)
    _assert_same(ref, nat)
    # backend="python" is build_regions_py
    _assert_same(ref, build_regions(bricks, scalars, backend="python"))


@pytest.mark.parametrize("name", [*FIXTURES, "golden32"])
def test_build_scene_matches_reference(name, golden_cells):
    """gather_scalars, build_brick_regions and build_scene (basis and
    non-basis, an affine voxel_from_world) against the JAX package's;
    the port's Scene tensors hold the JAX Scene's arrays."""
    lower, level, scal = _cells(name, golden_cells)
    bricks, ids = native.native_build_bricks_flat(lower, level)
    vals = np.asarray(scal, np.float32)
    fields = [ScalarField.from_values("a", vals),
              ScalarField.from_values("b", 2.0 - vals)]
    ref_fields = [RefField.from_values("a", vals),
                  RefField.from_values("b", 2.0 - vals)]
    _assert_same(ref_gather(ids, ref_fields), gather_scalars(ids, fields))
    sc = gather_scalars(ids, fields)
    _assert_same(ref_brick_regions(bricks, sc), build_brick_regions(bricks,
                                                                     sc))
    m = np.asarray([[0.5, 0, 0, 1.0], [0, 0.5, 0, -2.0], [0, 0, 0.5, 0.25]],
                   np.float32)
    for kw in (dict(), dict(basis_method=False),
               dict(voxel_from_world=m, num_range_channels=2)):
        ref, ref_r, ref_t = ref_build_scene(bricks, ids, ref_fields, **kw)
        got, got_r, got_t = build_scene(bricks, ids, fields, device="cpu",
                                        **kw)
        _assert_same(ref_r, got_r)
        _assert_same(ref_t, got_t)
        host = got.host_arrays()
        for f in dataclasses.fields(ref):
            _assert_same(getattr(ref, f.name), host[f.name], f.name)


def test_scene_from_cells_and_interop(golden_cells):
    """The port's pipeline (native core) builds the JAX pipeline's Scene
    at 32^3 with two channels; scene_from_reference gives the same
    tensors, and Scene.to keeps them."""
    lower, level, scal = golden_cells
    ref, *_ = ref_scene_from_cells(lower, level, [scal, 1.05 - scal],
                                   num_range_channels=2)
    got, *_ = scene_from_cells(lower, level, [scal, 1.05 - scal],
                               num_range_channels=2, device="cpu")
    moved = interop.scene_from_reference(ref, device="cpu")
    assert isinstance(moved, Scene)
    for s in (got, moved, moved.to("cpu")):
        host = s.host_arrays()
        for f in dataclasses.fields(ref):
            _assert_same(getattr(ref, f.name), host[f.name], f.name)
    assert got.nbytes() == sum(np.asarray(getattr(ref, f.name)).nbytes
                               for f in dataclasses.fields(ref)
                               if f.name not in ("num_channels",
                                                 "max_bricks_per_region",
                                                 "tree_depth"))
    assert got.scalars.dtype == torch.float32
    assert got.tree_depth == ref.tree_depth
    # the default device is the card: without one it raises
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            interop.scene_from_reference(ref)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile, or no g++, raises: nothing falls
    back to the numpy builders."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()
    with pytest.raises(ValueError):
        build_regions(None, None, backend="auto")
