"""The benchmark's scenes: a configuration's cells, made by the generator
its ``scene.pattern`` names (``scenes/<pattern>.py``) from the
configuration alone in every run, or loaded from a file under
``portbench/.cache/`` that the first run of a checkout writes where the
configuration asks for it.  Here too the exajet pattern's frozen
generator (a copy of
``owlexabrick_tpu_torch.bench_scene.exajet_pattern_cells`` and of the
raw2cells threshold collapse it runs), which ``scenes/exajet.py`` calls.

This module imports numpy only: the spawned processes of the parallel
build import it, and none of them touches the card."""

from __future__ import annotations

import importlib.util
import os
import pathlib

import numpy as np

CACHE_DIR = pathlib.Path(__file__).resolve().parent / ".cache"
SCENES = pathlib.Path(__file__).resolve().parent / "scenes"


def volume_to_cells(vol: np.ndarray, threshold: float, max_level: int):
    """raw2cells: a 2x2x2 block of level-L cells collapses to one
    level-(L+1) cell when its value range is within ``threshold``; the
    collapsed scalar is the average of the covered voxels.  vol (nz, ny,
    nx) -> (lower (N, 3) int32 x, y, z; level (N,) int32; scalars (N,)
    float32)."""
    vol = np.asarray(vol, np.float64)
    w = 1 << max_level

    def pad_to(a, fill):
        pz = (-a.shape[0]) % w
        py = (-a.shape[1]) % w
        px = (-a.shape[2]) % w
        return np.pad(a, ((0, pz), (0, py), (0, px)), constant_values=fill)

    mins = [pad_to(vol, np.inf)]
    maxs = [pad_to(vol, -np.inf)]
    sums = [pad_to(vol, 0.0)]
    cnts = [pad_to(np.ones_like(vol), 0.0)]

    def red(a, op):
        s = a.shape
        r = a.reshape(s[0] // 2, 2, s[1] // 2, 2, s[2] // 2, 2)
        return op(r, axis=(1, 3, 5))

    for _ in range(max_level):
        mins.append(red(mins[-1], np.min))
        maxs.append(red(maxs[-1], np.max))
        sums.append(red(sums[-1], np.sum))
        cnts.append(red(cnts[-1], np.sum))

    lowers, levels, scalars = [], [], []
    covered = np.zeros_like(mins[max_level], dtype=bool)
    for L in range(max_level, -1, -1):
        rng = maxs[L] - mins[L]
        occupied = cnts[L] > 0
        collapsible = (rng <= threshold) | (L == 0)
        leaf = occupied & collapsible & ~covered
        iz, iy, ix = np.nonzero(leaf)
        if iz.size:
            cw = 1 << L
            lowers.append(
                np.stack([ix * cw, iy * cw, iz * cw], axis=1).astype(np.int32)
            )
            levels.append(np.full(iz.size, L, np.int32))
            scalars.append(
                (sums[L][iz, iy, ix] / cnts[L][iz, iy, ix]).astype(np.float32)
            )
        if L > 0:
            nxt = covered | leaf
            covered = np.repeat(np.repeat(np.repeat(nxt, 2, 0), 2, 1), 2, 2)
    return (np.concatenate(lowers), np.concatenate(levels),
            np.concatenate(scalars))


def exajet_field(z, y, x, n: int, wings: int = 1) -> np.ndarray:
    """The exajet pattern on broadcastable (z, y, x) grids in [-1, 1]:
    ``wings`` thin wavy sheets with a sharp gradient across each, in a
    smooth background that stays below the collapse threshold, so only
    the sheets force refinement."""
    w = np.float32(6.0 / n)
    sheet = 0.25 * np.sin(2.4 * x) * np.cos(1.7 * z) - 0.15 * x
    d = y - sheet
    v = 1.0 / (1.0 + np.exp(np.clip(-d / w, -60.0, 60.0)))
    if wings >= 2:
        sheet2 = (0.2 * np.sin(2.4 * x + 2.0) * np.cos(1.7 * z + 1.1)
                  + 0.45 - 0.1 * x)
        d2 = y - sheet2
        v += 1.0 / (1.0 + np.exp(np.clip(-d2 / w, -60.0, 60.0)))
    v += 0.04 * np.exp(-2.0 * (x * x + z * z))
    v += 0.02 * np.exp(-8.0 * ((x - 0.5) ** 2 + (y - 0.5) ** 2 + z * z))
    return np.asarray(v, np.float32)


def exajet_slices(n: int, z0s, threshold: float, max_level: int,
                  wings: int):
    """The cells of the z slices of 2^max_level planes starting at
    ``z0s``, each collapsed on its own with its cells' z offset."""
    w = 1 << max_level
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    y = ax[None, :, None]
    x = ax[None, None, :]
    lowers, levels, scals = [], [], []
    for z0 in z0s:
        v = exajet_field(ax[z0:z0 + w][:, None, None], y, x, n, wings)
        lo, lv, sc = volume_to_cells(v, threshold, max_level)
        lo[:, 2] += z0
        lowers.append(lo)
        levels.append(lv)
        scals.append(sc)
    return lowers, levels, scals


# from this lattice edge on, the slices are collapsed in a pool of
# spawned processes; below it the spawn does not pay
POOL_MIN_N = 512


def default_workers() -> int:
    """The cores this process may run on, at most 16."""
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:
        cores = os.cpu_count() or 1
    return max(1, min(cores, 16))


def exajet_pattern_cells(n: int, threshold: float = 0.004,
                         max_level: int = 3, wings: int = 1):
    """The cells of the exajet pattern at ``n``^3 without the dense
    volume: the collapse is local to 2^max_level-aligned blocks, so the
    field streams in z slices.  From n = ``POOL_MIN_N`` on, runs of slices
    are collapsed in ``default_workers()`` spawned processes and
    concatenated in z order (the same arrays, bit for bit).  Returns
    (lower, level, scalars)."""
    w = 1 << max_level
    if n % w:
        raise ValueError(f"n={n} must be a multiple of 2^max_level={w}")
    z0s = list(range(0, n, w))
    workers = default_workers() if n >= POOL_MIN_N else 1
    if workers <= 1 or len(z0s) < 2:
        parts = [exajet_slices(n, z0s, threshold, max_level, wings)]
    else:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        per = max(1, -(-len(z0s) // (4 * workers)))
        runs = [z0s[i:i + per] for i in range(0, len(z0s), per)]
        with ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context(
                    "spawn")) as pool:
            parts = list(pool.map(
                exajet_slices, [n] * len(runs), runs,
                [threshold] * len(runs), [max_level] * len(runs),
                [wings] * len(runs)))
        _stop_resource_tracker()
    lowers, levels, scals = ([a for p in parts for a in p[k]]
                             for k in range(3))
    return (np.concatenate(lowers), np.concatenate(levels),
            np.concatenate(scals))


def _stop_resource_tracker():
    """Stop multiprocessing's resource tracker, which the spawned pool
    started and which would otherwise outlive the pool until this process
    exits (a later pool starts it again)."""
    from multiprocessing import resource_tracker

    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        try:
            stop()
        except ChildProcessError:  # already reaped
            pass


def scene_module(pattern: str):
    """The generator module of scene ``pattern``: ``SCENES/<pattern>.py``."""
    path = SCENES / f"{pattern}.py"
    if not path.is_file():
        raise ValueError(f"unknown scene pattern {pattern!r}: no generator "
                         f"{path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.scenes.{pattern}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_cells(cells):
    """Refuse cells that are not (lower (N, 3) int32, level (N,) int32,
    scalars (N,) or (C, N) float32) with 1 <= C <= the port's channel
    cap."""
    from owlexabrick_tpu_torch.core.constants import MAX_CHANNELS

    lower, level, scalars = cells
    n = lower.shape[0]
    fields = 1 if scalars.ndim == 1 else scalars.shape[0]
    if (lower.shape != (n, 3) or level.shape != (n,)
            or scalars.shape[-1:] != (n,) or scalars.ndim > 2
            or lower.dtype != np.int32 or level.dtype != np.int32
            or scalars.dtype != np.float32):
        raise ValueError(
            f"scene cells must be lower (N, 3) int32, level (N,) int32, "
            f"scalars (N,) or (C, N) float32; got {lower.shape} "
            f"{lower.dtype}, {level.shape} {level.dtype}, {scalars.shape} "
            f"{scalars.dtype}")
    if not 1 <= fields <= MAX_CHANNELS:
        raise ValueError(f"a scene of {fields} fields: the port draws 1 to "
                         f"{MAX_CHANNELS}")
    return cells


def scene_cells(config: dict, cache_dir=CACHE_DIR):
    """The cells of a configuration's ``scene`` section, made by the
    generator its ``pattern`` names.  With ``"cache": true`` the first
    call in a checkout builds them and writes them to ``cache_dir``
    (atomically, scalars as the generator returned them); later calls
    load that file.  Returns ((lower, level, scalars), how: "built" |
    "built_and_cached" | "loaded")."""
    sc = config["scene"]
    gen = scene_module(sc["pattern"])
    if not sc.get("cache", False):
        return check_cells(gen.cells(sc)), "built"
    cache_dir = pathlib.Path(cache_dir)
    path = cache_dir / f"cells_{config['name']}.npz"
    if path.exists():
        with np.load(path) as z:
            return check_cells(
                (z["lower"], z["level"], z["scalars"])), "loaded"
    cells = check_cells(gen.cells(sc))
    cache_dir.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.stem + ".partial.npz")
    np.savez(tmp, lower=cells[0], level=cells[1], scalars=cells[2])
    os.replace(tmp, path)
    return cells, "built_and_cached"
