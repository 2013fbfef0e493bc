"""Scene assembly (the port of ``owlexabrick_tpu/render/scene.py``): bricks,
cell IDs and scalar fields become the exact renderer's ``Scene`` (the
analog of OptixRenderer's buffer setup, exa/OptixRenderer.cpp:38-210).
The region build is host work (the native core by default); the Scene's
tensors land on the render device.  ``Scene.to(device)`` moves a built
scene.  ``scene_from_config`` builds one from a parsed ``.exa`` config."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from ..core.constants import EMPTY_CELL_POISON_VALUE
from ..core.types import Bricks, Regions, RegionTree, ScalarField, Scene
from ..regions.build import build_regions, build_regions_py
from .slabs import render_device


def build_brick_regions(bricks: Bricks, scalars: np.ndarray,
                        num_channels: int = 1):
    """Non-basis traversal structure: a BSP over brick *bounds*.

    Brick bounds tile space without overlap, so each BSP leaf holds
    exactly one brick; per-leaf value ranges cover only that brick's
    cells and ``finest_cw`` is the brick's own cell width — the structure
    the reference's EXPLICIT_BASIS_METHOD=OFF BVH provides
    (programs/exabrick.cu:226-330)."""
    bb = Bricks(lower=bricks.lower, size=bricks.size, level=bricks.level,
                begin=bricks.begin)
    # the BSP machinery with brick *bounds* standing in as domains
    bb.domains = bb.bounds  # type: ignore[method-assign]
    regions, tree = build_regions_py(bb, scalars, num_channels=num_channels)
    cw = (1 << bricks.level.astype(np.int64)).astype(np.float32)
    fin = np.where(
        regions.brick_ids[:, 0] >= 0,
        cw[np.clip(regions.brick_ids[:, 0], 0, None)],
        regions.finest_cw,
    ).astype(np.float32)
    return dataclasses.replace(regions, finest_cw=fin), tree


def gather_scalars(cell_ids: np.ndarray,
                   fields: Sequence[ScalarField]) -> np.ndarray:
    """Per-input-cell field values through the brick cellID indirection
    into the flattened per-brick layout -> (C, total_cells)
    (exa/OptixRenderer.cpp:103-143).  A cell ID of -1 (ALLOW_EMPTY_CELLS,
    exa/ExaBricks.cpp:46) gets the poison value."""
    cell_ids = np.asarray(cell_ids, np.int64)
    if cell_ids.size and cell_ids.min() < -1:
        raise ValueError("negative cell ID")
    empty = cell_ids < 0
    ids = np.where(empty, 0, cell_ids)
    out = np.zeros((len(fields), cell_ids.size), np.float32)
    for c, f in enumerate(fields):
        if cell_ids.size and cell_ids.max() >= f.values.size:
            raise ValueError(f"invalid cell ID for field '{f.name}'")
        out[c] = np.where(empty, np.float32(EMPTY_CELL_POISON_VALUE),
                          f.values[ids])
    return out


def build_scene(
    bricks: Bricks,
    cell_ids: np.ndarray,
    fields: Sequence[ScalarField],
    voxel_from_world: Optional[np.ndarray] = None,
    num_range_channels: Optional[int] = None,
    basis_method: bool = True,
    device="cuda",
    backend: str = "native",
) -> Tuple[Scene, Regions, RegionTree]:
    """Build the Scene on ``device`` (and return the host regions and
    tree beside it).

    ``num_range_channels``: how many channels enter the region value
    ranges (all in multi-field DVR, else channel 0,
    OptixRenderer.cpp:151-157).  ``basis_method=False`` builds the
    reference's non-basis mode: traversal over brick bounds, one brick
    per leaf (OptixRenderer.cpp:176-202).  ``backend``: the region
    build's ("native" or "python")."""
    scalars = gather_scalars(cell_ids, fields)
    if basis_method:
        regions, tree = build_regions(bricks, scalars,
                                      num_channels=num_range_channels,
                                      backend=backend)
    else:
        regions, tree = build_brick_regions(bricks, scalars, num_channels=1)

    b_lo, b_hi = bricks.bounds()
    v_lo = b_lo.min(axis=0)
    v_hi = b_hi.max(axis=0)
    if voxel_from_world is None:
        voxel_from_world = np.zeros((3, 4), np.float32)
        voxel_from_world[:, :3] = np.eye(3)
    m = np.asarray(voxel_from_world, np.float64)
    inv_a = np.linalg.inv(m[:, :3])
    w_lo = inv_a @ (v_lo - m[:, 3])
    w_hi = inv_a @ (v_hi - m[:, 3])

    scene = Scene.from_arrays(
        render_device(device),
        brick_lower=bricks.lower.astype(np.float32),
        brick_size=bricks.size,
        brick_cell_width=(1 << bricks.level.astype(np.int64)).astype(
            np.float32),
        brick_begin=bricks.begin,
        scalars=scalars,
        region_lo=regions.domain_lo,
        region_hi=regions.domain_hi,
        region_value_range=regions.value_range,
        region_finest_cw=regions.finest_cw,
        region_bricks=regions.brick_ids,
        tree_axis=tree.axis,
        tree_split=tree.split,
        tree_child=tree.child,
        tree_leaf=tree.leaf,
        tree_lo=tree.node_lo,
        tree_hi=tree.node_hi,
        voxel_bounds_lo=v_lo,
        voxel_bounds_hi=v_hi,
        world_bounds_lo=w_lo,
        world_bounds_hi=w_hi,
        voxel_from_world=voxel_from_world,
        num_channels=len(fields),
        max_bricks_per_region=regions.max_bricks_per_region,
        tree_depth=tree.depth,
    )
    return scene, regions, tree


def scene_bricks(scene: Scene) -> Tuple[Bricks, np.ndarray]:
    """The scene's brick table as host ``Bricks`` and its (C, cells)
    scalars (host numpy), as ``slabs.build_level_grids`` takes them (the
    JAX package's ``grids_from_scene``)."""
    cw = scene.brick_cell_width.cpu().numpy()
    bricks = Bricks(
        lower=scene.brick_lower.cpu().numpy().astype(np.int32),
        size=scene.brick_size.cpu().numpy(),
        level=np.round(np.log2(cw)).astype(np.int32),
        begin=scene.brick_begin.cpu().numpy())
    return bricks, scene.scalars.cpu().numpy()


def scene_from_config(cfg, multi_field_dvr: bool = False, device="cuda",
                      backend: str = "native"
                      ) -> Tuple[Scene, Regions, RegionTree]:
    """A parsed ``.exa`` config (``io.config.Config``) -> the Scene on
    ``device``.  ``multi_field_dvr``: every field enters the region value
    ranges (multi-field DVR), else channel 0 alone."""
    if cfg.bricks is None:
        raise ValueError("config has no bricks")
    n_range = len(cfg.scalar_fields) if multi_field_dvr else 1
    return build_scene(
        cfg.bricks,
        cfg.cell_ids,
        cfg.scalar_fields,
        voxel_from_world=cfg.voxel_from_world(),
        num_range_channels=n_range,
        device=device,
        backend=backend,
    )
