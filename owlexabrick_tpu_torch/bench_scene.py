"""Benchmark scenes (the port of ``owlexabrick_tpu/bench_scene.py``): a
synthetic multi-level AMR volume -> raw2cells threshold collapse -> level
grids; the exajet pattern also as streamed cells (in a process pool from
512^3 on); the reference-scale scene (``load_or_build_scale_scene``: the
two-wing exajet pattern on a 1024^3 finest lattice, 63.5 M cells); the
exact path's bench scene (``build_bench_scene``); and seeded surfaces to
place in them (a bumpy-sphere mesh, a bundle of streamline helices).

``slab_scene_grids`` and ``load_or_build_scale_scene`` build the level
grids straight from the cells (``level_grids_from_cells``): the bricks
only partition the cells and the basis lives on the cells, so the grids
need no per-brick scatter.  Only ``load_or_build_scale_scene`` caches on
disk (cells, then bricks, then the whole scene), as the JAX package's
does; the other scenes are made anew in every run.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np

from .core.types import TriangleMesh
from .render.slabs import level_grids_from_cells, nbytes_grids
from .render.tracer import morton_order
from .tools.raw2cells import volume_to_cells


def synthetic_volume(n: int = 64) -> np.ndarray:
    """Smooth multi-scale field: blobs + a shell, gives a real AMR level
    mix under threshold collapse."""
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    z = ax[:, None, None]
    y = ax[None, :, None]
    x = ax[None, None, :]
    r = np.sqrt(x * x + y * y + z * z)
    v = np.exp(-18 * ((x - 0.3) ** 2 + (y - 0.2) ** 2 + z ** 2))
    v = v + 0.8 * np.exp(-24 * ((x + 0.4) ** 2 + y ** 2 + (z - 0.3) ** 2))
    v += 0.6 * np.exp(-60 * (r - 0.7) ** 2)
    return np.asarray(v, np.float32)


def _exajet_field(z, y, x, n: int, wings: int = 1) -> np.ndarray:
    """The exajet-pattern analytic field on broadcastable (z, y, x) grids
    in [-1, 1] units: ``wings`` thin wavy sheets with a sharp gradient
    across each, in a smooth background whose per-coarse-cell variation
    stays below the raw2cells collapse threshold (0.004), so only the
    sheets force refinement (geometry-fitted AMR)."""
    w = np.float32(6.0 / n)  # a few finest cells thick
    sheet = 0.25 * np.sin(2.4 * x) * np.cos(1.7 * z) - 0.15 * x
    d = y - sheet
    v = 1.0 / (1.0 + np.exp(np.clip(-d / w, -60.0, 60.0)))
    if wings >= 2:
        # a second wing, phase-shifted so the sheets stay apart in y
        sheet2 = (0.2 * np.sin(2.4 * x + 2.0) * np.cos(1.7 * z + 1.1)
                  + 0.45 - 0.1 * x)
        d2 = y - sheet2
        v += 1.0 / (1.0 + np.exp(np.clip(-d2 / w, -60.0, 60.0)))
    v += 0.04 * np.exp(-2.0 * (x * x + z * z))
    v += 0.02 * np.exp(-8.0 * ((x - 0.5) ** 2 + (y - 0.5) ** 2 + z * z))
    return np.asarray(v, np.float32)


def exajet_pattern_volume(n: int = 256, wings: int = 1) -> np.ndarray:
    """Exajet-pattern field as a dense (n, n, n) volume: under threshold
    collapse the finest level hugs the wing sheets (fine cells on
    geometry, coarse everywhere else)."""
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    return _exajet_field(ax[:, None, None], ax[None, :, None],
                         ax[None, None, :], n, wings)


def _exajet_slices(n: int, z0s, threshold: float, max_level: int,
                   wings: int):
    """The cells of the z slices of 2^max_level planes starting at
    ``z0s``, in that order, each collapsed on its own with its cells' z
    offset (a process pool's task in ``exajet_pattern_cells``)."""
    w = 1 << max_level
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    y = ax[None, :, None]
    x = ax[None, None, :]
    lowers, levels, scals = [], [], []
    for z0 in z0s:
        v = _exajet_field(ax[z0:z0 + w][:, None, None], y, x, n, wings)
        lo, lv, sc = volume_to_cells(v, threshold, max_level)
        lo[:, 2] += z0
        lowers.append(lo)
        levels.append(lv)
        scals.append(sc)
    return lowers, levels, scals


# the pool pays for its spawned processes (each imports torch) from
# 512^3 on: a 256^3 build takes ~2.5 s on one core
POOL_MIN_N = 512


def exajet_pattern_cells(n: int, threshold: float = 0.004,
                         max_level: int = 3, wings: int = 1):
    """The cells of ``exajet_pattern_volume(n, wings)`` without the dense
    volume (4 GB at 1024^3): the raw2cells collapse is local to
    2^max_level-aligned root blocks, so the field streams in z slices of
    2^max_level planes, each collapsed on its own with its cells' z
    offset.  Equal to ``volume_to_cells(exajet_pattern_volume(n, wings),
    threshold, max_level)``.  From n = ``POOL_MIN_N`` on, runs of slices
    are collapsed in ``default_workers()`` spawned processes and
    concatenated in z order: the same arrays, bit for bit (a spawned
    process imports the caller's main module, so a script guards its
    work with ``if __name__ == "__main__":``).  Returns (lower (N, 3)
    int32, level, scalars)."""
    w = 1 << max_level
    if n % w:
        raise ValueError(f"n={n} must be a multiple of 2^max_level={w}")
    z0s = list(range(0, n, w))
    workers = default_workers() if n >= POOL_MIN_N else 1
    if workers <= 1 or len(z0s) < 2:
        parts = [_exajet_slices(n, z0s, threshold, max_level, wings)]
    else:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        # about four runs per worker, so a slow run delays the rest little
        per = max(1, -(-len(z0s) // (4 * workers)))
        runs = [z0s[i:i + per] for i in range(0, len(z0s), per)]
        # spawned, not forked: the caller may hold a CUDA context and
        # threads, which a forked child must not inherit
        with ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context(
                    "spawn")) as pool:
            parts = list(pool.map(
                _exajet_slices, [n] * len(runs), runs,
                [threshold] * len(runs), [max_level] * len(runs),
                [wings] * len(runs)))
    lowers, levels, scals = ([a for p in parts for a in p[k]]
                             for k in range(3))
    return (np.concatenate(lowers), np.concatenate(levels),
            np.concatenate(scals))


def default_workers() -> int:
    """Processes for the parallel cell build: the cores this process may
    run on, at most 16."""
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:  # not Linux
        cores = os.cpu_count() or 1
    return max(1, min(cores, 16))


def scale_scene_grids(n: int = 1024, wings: int = 2, device="cuda",
                      cells=None):
    """The cells-and-grids stage of the reference-scale scene: its cells
    (``exajet_pattern_cells(n, wings=wings)``, unless ``cells`` = (lower,
    level, scalars) is given) and their level grids (sweep axis z) on
    ``device``.  Returns (grids, cells, meta) with n_cells, gen_s (when
    the cells were built here), grids_s (the device's work included),
    grid_bytes and value_max."""
    import torch

    meta = {}
    if cells is None:
        t0 = time.time()
        cells = exajet_pattern_cells(n, wings=wings)
        meta["gen_s"] = time.time() - t0
    lower, level, scal = cells
    t0 = time.time()
    grids = level_grids_from_cells(lower, level, scal[None], axis=2,
                                   device=device)
    if grids.masks[0].is_cuda:
        torch.cuda.synchronize()
    meta.update(n_cells=int(lower.shape[0]), grids_s=time.time() - t0,
                grid_bytes=int(nbytes_grids(grids)),
                value_max=float(scal.max()))
    return grids, cells, meta


def load_or_build_scale_scene(n: int = 1024, wings: int = 2,
                              cache_dir: str = ".bench_cache",
                              verbose: bool = True, device="cuda"):
    """The reference-scale bench scene (the JAX package's
    ``load_or_build_scale_scene``): the ``wings``-sheet exajet pattern
    on an ``n``^3 finest lattice (63,544,167 cells and 369,716 bricks at
    n = 1024, two wings), bricked by the native core, its cells and
    level grids from ``scale_scene_grids`` on ``device`` (the card
    unless the caller asks for the CPU).

    Each stage is cached in ``cache_dir``: the cells, then the bricks,
    then the whole scene (host grids), so an interrupted build resumes
    and a later call loads.  Returns (bricks, scalars (C, cells) float32
    in brick order, grids, meta) with meta's n_cells, n_bricks,
    finest_lattice, gen_s, build_s, grids_s, grid_bytes and value_max,
    and cache_load_s when the scene came from the cache."""
    from .core.types import Bricks
    from .native import native_build_bricks_flat

    os.makedirs(cache_dir, exist_ok=True)
    tag = f"torch_scale_{n}_{wings}"
    path = os.path.join(cache_dir, tag + ".pkl")
    if os.path.exists(path):
        t0 = time.time()
        with open(path, "rb") as f:
            bricks, scalars, grids, meta = pickle.load(f)
        grids = grids.to(device)
        meta = dict(meta, cache_load_s=round(time.time() - t0, 1))
        return bricks, scalars, grids, meta

    cpath = os.path.join(cache_dir, tag + "_cells.npz")
    cells = None
    if os.path.exists(cpath):
        z = np.load(cpath)
        cells = (z["lower"], z["level"], z["scal"])
        t_gen = float(z["t_gen"])
    grids, (lower, level, scal), g_meta = scale_scene_grids(
        n, wings, device, cells)
    if cells is None:
        t_gen = g_meta["gen_s"]
        np.savez(cpath, lower=lower, level=level, scal=scal, t_gen=t_gen)
    n_cells = g_meta["n_cells"]
    if verbose:
        print(f"# scale scene: {n_cells / 1e6:.1f}M cells generated in "
              f"{t_gen:.0f}s", flush=True)
    bpath = os.path.join(cache_dir, tag + "_bricks.npz")
    if os.path.exists(bpath):
        z = np.load(bpath)
        bricks = Bricks(lower=z["b_lower"], size=z["b_size"],
                        level=z["b_level"], begin=z["b_begin"])
        cell_ids = z["cell_ids"]
        t_build = float(z["t_build"])
    else:
        t0 = time.time()
        bricks, cell_ids = native_build_bricks_flat(lower, level)
        t_build = time.time() - t0
        np.savez(bpath, b_lower=bricks.lower, b_size=bricks.size,
                 b_level=bricks.level, b_begin=bricks.begin,
                 cell_ids=cell_ids, t_build=t_build)
    if verbose:
        print(f"# scale scene: {bricks.num_bricks} bricks built in "
              f"{t_build:.0f}s", flush=True)
    scalars = scal[np.asarray(cell_ids, np.int64)][None].astype(np.float32)
    del cell_ids, lower, level, scal
    meta = dict(n_cells=n_cells, n_bricks=int(bricks.num_bricks),
                finest_lattice=n, gen_s=round(t_gen, 1),
                build_s=round(t_build, 1),
                grids_s=round(g_meta["grids_s"], 1),
                grid_bytes=g_meta["grid_bytes"],
                value_max=g_meta["value_max"])
    with open(path, "wb") as f:
        pickle.dump((bricks, scalars, grids.to("cpu"), meta), f,
                    protocol=4)
    return bricks, scalars, grids, meta


def slab_scene_grids(kind: str, n: int, threshold: float = 0.004,
                     max_level: int = 3, device="cuda", wings: int = 1):
    """Level grids (sweep axis z) of the ``kind`` ("blobs" or "exajet",
    with ``wings`` sheets) bench scene at ``n``^3, on ``device`` (the
    card unless the caller asks for the CPU).  Returns (grids, meta) with
    n_cells, build_s and value_max."""
    t0 = time.time()
    vol = (exajet_pattern_volume(n, wings) if kind == "exajet"
           else synthetic_volume(n))
    lower, level, scal = volume_to_cells(vol, threshold, max_level)
    grids = level_grids_from_cells(lower, level, scal[None], axis=2,
                                   device=device)
    meta = dict(n_cells=int(lower.shape[0]),
                build_s=round(time.time() - t0, 1),
                value_max=float(scal.max()))
    return grids, meta


def bumpy_sphere(radius: float = 14.0, center=(0.0, 0.0, 0.0), nu: int = 72,
                 nv: int = 72, seed: int = 0) -> TriangleMesh:
    """A bumpy sphere of 2 nu (nv - 1) triangles (the JAX package's
    tiled-trace test mesh, tests/test_streamline_tiled.py::_big_mesh:
    radius 14 +- 2, vertices jittered by a seeded N(0, 0.05)), scaled by
    ``radius`` / 14 about its center and moved to ``center``."""
    rng = np.random.default_rng(seed)
    u = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    v = np.linspace(1e-3, np.pi - 1e-3, nv)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    r = 14.0 + 2.0 * np.sin(3 * uu) * np.sin(4 * vv)
    verts = np.stack([r * np.sin(vv) * np.cos(uu), r * np.cos(vv),
                      r * np.sin(vv) * np.sin(uu)], -1).reshape(-1, 3)
    verts = verts.astype(np.float32)
    verts += rng.normal(0, 0.05, verts.shape).astype(np.float32)
    verts = (verts * np.float32(radius / 14.0)
             + np.asarray(center, np.float32))
    i = np.arange(nu)[:, None]
    j = np.arange(nv - 1)[None]
    a = i * nv + j
    b = (i + 1) % nu * nv + j
    idx = np.stack([np.stack([a, b, a + 1], -1),
                    np.stack([b, b + 1, a + 1], -1)], 2).reshape(-1, 3)
    return TriangleMesh(vertices=verts.astype(np.float32),
                        indices=idx.astype(np.int32))


def helix_bundle(n: int, count: int = 64, segments: int = 64,
                 turns: float = 2.0):
    """``count`` streamline helices on a square grid over an n^3 volume,
    each ``segments`` segments climbing z from 0.1n to 0.9n at radius
    0.04n, in the tracer's emission order (helices by the Morton code of
    their first point, seed-major).  Returns (seg_a (S, 3), seg_b (S, 3),
    seg_t (S,) int32: the timestep of each segment's head, 1..segments
    along a helix)."""
    side = int(np.ceil(np.sqrt(count)))
    cx = n * (0.1 + 0.8 * (np.arange(count) % side + 0.5) / side)
    cy = n * (0.1 + 0.8 * (np.arange(count) // side + 0.5) / side)
    s = np.linspace(0.0, 1.0, segments + 1)
    ang = 2 * np.pi * turns * s[None] + np.arange(count)[:, None]
    pts = np.stack([cx[:, None] + 0.04 * n * np.cos(ang),
                    cy[:, None] + 0.04 * n * np.sin(ang),
                    np.broadcast_to(n * (0.1 + 0.8 * s), ang.shape)],
                   -1).astype(np.float32)
    pts = pts[morton_order(pts[:, 0])]
    seg_t = np.tile(np.arange(1, segments + 1, dtype=np.int32), count)
    return (pts[:, :-1].reshape(-1, 3), pts[:, 1:].reshape(-1, 3), seg_t)


def build_bench_scene(n: int = 64, threshold: float = 0.004,
                      max_level: int = 3, device="cuda"):
    """The exact path's bench scene (the JAX package's
    ``build_bench_scene``): ``synthetic_volume(n)`` -> threshold collapse
    -> the port's pipeline (native core), on ``device``.  Returns (scene,
    stats) with n_cells, n_bricks, n_regions, max_bricks_per_region,
    tree_depth, the cells per level and value_max."""
    from .pipeline import scene_from_cells

    lower, level, scal = volume_to_cells(synthetic_volume(n), threshold,
                                         max_level)
    scene, bricks, _, regions, tree = scene_from_cells(
        lower, level, [scal], device=device)
    return scene, dict(
        n_cells=int(lower.shape[0]),
        n_bricks=int(bricks.num_bricks),
        n_regions=int(regions.num_regions),
        max_bricks_per_region=int(regions.max_bricks_per_region),
        tree_depth=int(tree.depth),
        levels=np.bincount(level).tolist(),
        value_max=float(scal.max()),
    )
