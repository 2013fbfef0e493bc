"""PyTorch port, the reference-scale scene against the JAX package's
``bench_scene`` at small n: ``load_or_build_scale_scene`` (its bricks,
scalars, level grids and counts, built and then loaded from its disk
cache), its grids equal to the per-brick scatter, the cells built in a
process pool equal to the serial build, ``build_bench_scene``, and a
frame of the bench's scale configuration (adaptive stride on, chunk 12,
budget 7) against JAX ``render_slabs_camera``, equal bit for bit through
a partial camera cache."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owlexabrick_tpu import bench_scene as RB
from owlexabrick_tpu.pipeline import scene_from_cells
from owlexabrick_tpu.render import slabs as R
from owlexabrick_tpu.render.camera import Camera
from owlexabrick_tpu.render.frame import make_frame_state
from owlexabrick_tpu_torch import bench_scene as PB
from owlexabrick_tpu_torch import interop
from owlexabrick_tpu_torch.render import slabs as P

from test_torch_host import _assert_grids_equal
from test_torch_scene import _assert_same
from test_torch_slabs import _gate

COUNTS = ("n_cells", "n_bricks", "finest_lattice", "grid_bytes",
          "value_max")


@pytest.fixture(scope="module")
def scale32(tmp_path_factory):
    ref_dir = tmp_path_factory.mktemp("ref")
    port_dir = tmp_path_factory.mktemp("port")
    ref = RB.load_or_build_scale_scene(32, 2, cache_dir=str(ref_dir),
                                       verbose=False)
    got = PB.load_or_build_scale_scene(32, 2, cache_dir=str(port_dir),
                                       verbose=False, device="cpu")
    return ref, got, port_dir


def _assert_scale_equal(ref, got):
    r_bricks, r_scal, r_grids, r_meta = ref
    bricks, scal, grids, meta = got
    for f in ("lower", "size", "level", "begin"):
        assert np.array_equal(getattr(r_bricks, f), getattr(bricks, f)), f
    assert scal.dtype == r_scal.dtype and np.array_equal(scal, r_scal)
    _assert_grids_equal(r_grids, grids)
    for k in COUNTS:
        assert meta[k] == r_meta[k], k


def test_scale_scene_matches_reference(scale32):
    ref, got, _ = scale32
    _assert_scale_equal(ref, got)
    assert got[3]["n_cells"] > 10_000 and len(got[2].levels) >= 2
    assert "cache_load_s" not in got[3]


def test_scale_scene_loads_from_cache(scale32):
    """A second call reads the pickle the first wrote: the same arrays,
    and its load time in meta."""
    ref, got, port_dir = scale32
    again = PB.load_or_build_scale_scene(32, 2, cache_dir=str(port_dir),
                                         verbose=False, device="cpu")
    _assert_scale_equal(ref, again)
    assert "cache_load_s" in again[3]
    assert sorted(p.name for p in port_dir.iterdir()) == [
        "torch_scale_32_2.pkl", "torch_scale_32_2_bricks.npz",
        "torch_scale_32_2_cells.npz"]


def test_scale_grids_from_cells_equal_brick_scatter(scale32):
    """The scale scene's cell-scatter grids equal the per-brick scatter
    (``build_level_grids``) on its bricks and brick-order scalars."""
    _, (bricks, scal, grids, _), _ = scale32
    _assert_grids_equal(P.build_level_grids(bricks, scal, axis=2,
                                            device="cpu"), grids)


def test_parallel_cells_equal_serial(monkeypatch):
    """Cells built in two spawned processes (the pool forced from n = 64
    on) equal the serial build, bit for bit, at n = 64 with two
    wings."""
    serial = PB.exajet_pattern_cells(64, wings=2)
    assert PB.default_workers() >= 1
    monkeypatch.setattr(PB, "POOL_MIN_N", 64)
    monkeypatch.setattr(PB, "default_workers", lambda: 2)
    pooled = PB.exajet_pattern_cells(64, wings=2)
    for a, b in zip(serial, pooled):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_build_bench_scene_matches_reference():
    ref, ref_stats = RB.build_bench_scene(32)
    got, stats = PB.build_bench_scene(32, device="cpu")
    assert stats == ref_stats
    host = got.host_arrays()
    for f in dataclasses.fields(ref):
        _assert_same(getattr(ref, f.name), host[f.name], f.name)


def test_scale_config_frame_matches_reference():
    """The bench's scale row at n = 64, two wings, 64x48: camera from
    (n/2, n/2, 2.2n), nslabs = ceil(extent), chunk 12, budget 7,
    adaptive stride on.  The port's frame meets the gate against JAX
    ``render_slabs_camera``, and is equal bit for bit to itself through
    a camera cache forced into its partial tier and through a full
    one."""
    n, w, h = 64, 64, 48
    lower, level, scal = RB.exajet_pattern_cells(n, wings=2)
    sc, bricks, *_ = scene_from_cells(lower, level, [scal])
    g_ref = R.build_level_grids(bricks, sc.scalars, axis=2, device=False)
    g_port = PB.level_grids_from_cells(lower, level, scal[None], axis=2,
                                       device="cpu")
    _assert_grids_equal(g_ref, g_port)
    cam = Camera.look_at([n / 2, n / 2, 2.2 * n], [n / 2, n / 2, n / 2],
                         [0, 1, 0], 45.0, w, h)
    fs_r = make_frame_state(cam, 1, [[0.0, float(scal.max())]], dt=1.0,
                            opacity_scale=0.7)
    extent = float(g_port.bounds_hi[0] - g_port.bounds_lo[0])
    base = dict(num_channels=1, nslabs=int(np.ceil(extent)), chunk=12,
                chunk_budget_mb=7, adaptive_stride=True)
    ref = np.asarray(R.render_slabs_camera(
        jax.tree.map(jnp.asarray, g_ref), fs_r,
        R.SlabConfig(dot_precision="highest", extent_z=extent, **base),
        cam, w, h))
    fs = interop.frame_state_from_reference(fs_r)
    cfg = P.SlabConfig(**base)
    live = P.render_slabs_camera(g_port, fs, cfg, cam, w, h)
    assert ref[:, 3].max() > 0.5
    _gate(live.numpy(), ref, 1e-4)

    full = {}
    out = P.render_slabs_camera(g_port, fs, cfg, cam, w, h,
                                camera_cache=full)
    assert "products" in full and "tier" not in full
    assert torch.equal(out, live)
    # the largest gate under the products' size: a partial tier
    for gate_mb in (3.0, 2.0, 1.5, 1.0):
        tiny = dataclasses.replace(cfg, camera_cache_max_mb=gate_mb)
        part = {}
        out = P.render_slabs_camera(g_port, fs, tiny, cam, w, h,
                                    camera_cache=part)
        if "tier" in part:
            break
    assert part["tier"].startswith("partial")
    assert torch.equal(out, live)
    again = P.render_slabs_camera(g_port, fs, tiny, cam, w, h,
                                  camera_cache=part)
    assert torch.equal(again, live)
