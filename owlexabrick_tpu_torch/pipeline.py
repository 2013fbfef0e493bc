"""End-to-end pipeline: cells -> bricks -> regions -> scene (the port of
``owlexabrick_tpu/pipeline.py``; the offline builder and scene assembly
in memory, what running exaBuilder and then the viewer does)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .builder.bricker import SAH_ALIKE, build_bricks
from .core.types import Bricks, ScalarField
from .native import native_build_bricks_flat
from .render.scene import build_scene


def bricks_from_build(result) -> Tuple[Bricks, np.ndarray]:
    """A BuildResult as the SoA Bricks table + flattened cellIDs."""
    lowers, sizes, levels, begins, chunks = [], [], [], [], []
    begin = 0
    for b in result.bricks:
        lowers.append(b.lower)
        sizes.append(b.size)
        levels.append(b.level)
        begins.append(begin)
        chunks.append(b.cell_ids.reshape(-1))  # z-major -> x fastest
        begin += b.cell_ids.size
    bricks = Bricks(
        lower=np.stack(lowers).astype(np.int32),
        size=np.stack(sizes).astype(np.int32),
        level=np.asarray(levels, np.int32),
        begin=np.asarray(begins, np.int32),
    )
    return bricks, np.concatenate(chunks).astype(np.int32)


def scene_from_cells(
    lower: np.ndarray,
    level: np.ndarray,
    scalars: Sequence[np.ndarray],
    strategy: str = SAH_ALIKE,
    max_leaf_width: int = 127,
    field_names: Optional[Sequence[str]] = None,
    num_range_channels: Optional[int] = None,
    voxel_from_world: Optional[np.ndarray] = None,
    device="cuda",
    backend: str = "native",
):
    """cells + per-cell scalar arrays -> (scene on ``device``, bricks,
    cell_ids, regions, tree).  ``backend="native"`` builds bricks and
    regions with the C++ core (raises if it cannot be built);
    ``"python"`` with the numpy builders.  ``voxel_from_world``: the
    world -> voxel affine (3, 4) (identity when None)."""
    if backend == "native":
        bricks, cell_ids = native_build_bricks_flat(lower, level, strategy,
                                                    max_leaf_width)
    else:
        bricks, cell_ids = bricks_from_build(build_bricks(
            lower, level, strategy, max_leaf_width))
    if field_names is None:
        field_names = [f"field{i}" for i in range(len(scalars))]
    fields = [ScalarField.from_values(n, v)
              for n, v in zip(field_names, scalars)]
    scene, regions, tree = build_scene(
        bricks, cell_ids, fields, voxel_from_world=voxel_from_world,
        num_range_channels=num_range_channels, device=device,
        backend=backend)
    return scene, bricks, cell_ids, regions, tree
