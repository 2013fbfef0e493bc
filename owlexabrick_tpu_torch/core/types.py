"""Data model of the exa-brick scene (the jax-free copies of
``owlexabrick_tpu/core/types.py``'s classes that the port needs).

Host preprocessing (builder, region build) produces ``Bricks``,
``Regions`` and ``RegionTree`` as numpy arrays; ``Scene`` holds what the
exact renderer consumes as torch tensors on one device:

  * a *brick* is a regular grid of ``size`` cells of width ``2**level``
    anchored at integer ``lower`` (exa/ExaBricks.h:26-60); its *domain*
    is its bounds padded by half a cell, the support of its tent basis;
  * a *region* is a box in which a fixed set of brick basis functions
    overlap; regions tile the union of the brick domains
    (exa/Regions.h:28-66);
  * the *region tree* is the BSP recorded while building the regions:
    inner nodes (axis, split), leaves a region id or -1 for a hole.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


@dataclass
class Bricks:
    """SoA brick table (host numpy).  ``begin[i]`` is the offset of
    brick i's cells in the flattened cell array (x fastest,
    programs/Brick.h:61-64)."""

    lower: np.ndarray  # (M, 3) int32 — integer anchor in voxel space
    size: np.ndarray  # (M, 3) int32 — cells per axis
    level: np.ndarray  # (M,) int32 — cell width = 2**level
    begin: np.ndarray  # (M,) int32 — offset into the flattened cells

    @property
    def num_bricks(self) -> int:
        return int(self.lower.shape[0])

    @property
    def cell_width(self) -> np.ndarray:
        return 2 ** self.level.astype(np.int64)

    def bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-brick [lower, upper) bounds (float32)."""
        cw = (1 << self.level.astype(np.int64)).astype(np.float32)
        lo = self.lower.astype(np.float32)
        hi = lo + self.size.astype(np.float32) * cw[:, None]
        return lo, hi

    def domains(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-brick basis support: bounds padded by half a cell width."""
        cw = (1 << self.level.astype(np.int64)).astype(np.float32)
        lo = self.lower.astype(np.float32) - 0.5 * cw[:, None]
        hi = (self.lower.astype(np.float32)
              + (self.size.astype(np.float32) + 0.5) * cw[:, None])
        return lo, hi


@dataclass
class Regions:
    """Same-bricks regions (host numpy): boxes and brick lists padded to
    K = max bricks per region with -1; ``leaf_list`` keeps the packed
    lists."""

    domain_lo: np.ndarray  # (N, 3) float32
    domain_hi: np.ndarray  # (N, 3) float32
    value_range: np.ndarray  # (N, 2) float32 over the range channels
    finest_cw: np.ndarray  # (N,) float32 — finest cell width in region
    brick_ids: np.ndarray  # (N, K) int32, padded with -1
    leaf_list: np.ndarray  # (L,) int32 packed lists
    leaf_begin: np.ndarray  # (N,) int32
    leaf_size: np.ndarray  # (N,) int32

    @property
    def num_regions(self) -> int:
        return int(self.domain_lo.shape[0])

    @property
    def max_bricks_per_region(self) -> int:
        return int(self.brick_ids.shape[1])


@dataclass
class RegionTree:
    """Stackless BSP point-location tree over the regions (host numpy):
    ``axis`` 0-2 for inner nodes, 3 for leaves; ``child`` the left child
    (the right is child + 1); ``leaf`` a region id or -1; ``node_lo`` /
    ``node_hi`` each node's box.  ``depth`` bounds the descent."""

    axis: np.ndarray  # (T,) int32
    split: np.ndarray  # (T,) float32
    child: np.ndarray  # (T,) int32
    leaf: np.ndarray  # (T,) int32
    node_lo: np.ndarray  # (T, 3) float32
    node_hi: np.ndarray  # (T, 3) float32
    depth: int = 0


@dataclass
class ScalarField:
    """A named per-cell scalar field (host): ``values[i]`` is input cell
    i's value (exa/ScalarField.h:24-44)."""

    name: str
    values: np.ndarray  # (num_input_cells,) float32
    value_range: Tuple[float, float] = (0.0, 0.0)

    @staticmethod
    def from_values(name: str, values: np.ndarray) -> "ScalarField":
        values = np.asarray(values, dtype=np.float32)
        if values.size:
            rng = (float(values.min()), float(values.max()))
        else:
            rng = (np.inf, -np.inf)
        return ScalarField(name=name, values=values, value_range=rng)


# the Scene's integer tables (every other array field is float32)
_INT_FIELDS = ("brick_size", "brick_begin", "region_bricks", "tree_axis",
               "tree_child", "tree_leaf")
_META = ("num_channels", "max_bricks_per_region", "tree_depth")


@dataclass
class Scene:
    """What the exact renderer consumes (the reference's LaunchParams
    buffers, programs/LaunchParams.h:26-80): torch tensors on one device,
    the ints ``num_channels``, ``max_bricks_per_region`` and
    ``tree_depth`` as Python ints."""

    # bricks
    brick_lower: torch.Tensor  # (M, 3) float32 (voxel space)
    brick_size: torch.Tensor  # (M, 3) int32
    brick_cell_width: torch.Tensor  # (M,) float32 = 2**level
    brick_begin: torch.Tensor  # (M,) int32

    # per-channel cell scalars in the flattened brick layout: (C, cells)
    scalars: torch.Tensor

    # regions
    region_lo: torch.Tensor  # (N, 3) float32
    region_hi: torch.Tensor  # (N, 3) float32
    region_value_range: torch.Tensor  # (N, 2) float32
    region_finest_cw: torch.Tensor  # (N,) float32
    region_bricks: torch.Tensor  # (N, K) int32 padded with -1

    # BSP tree
    tree_axis: torch.Tensor  # (T,) int32
    tree_split: torch.Tensor  # (T,) float32
    tree_child: torch.Tensor  # (T,) int32
    tree_leaf: torch.Tensor  # (T,) int32
    tree_lo: torch.Tensor  # (T, 3) float32
    tree_hi: torch.Tensor  # (T, 3) float32

    # bounds: union of brick bounds, and the same through the inverse remap
    voxel_bounds_lo: torch.Tensor  # (3,) float32
    voxel_bounds_hi: torch.Tensor  # (3,) float32
    world_bounds_lo: torch.Tensor  # (3,) float32
    world_bounds_hi: torch.Tensor  # (3,) float32

    # world -> voxel affine (row-major 3x4 [A | b], p_v = A p_w + b)
    voxel_from_world: torch.Tensor  # (3, 4) float32

    num_channels: int = 1
    max_bricks_per_region: int = 1
    tree_depth: int = 1

    @staticmethod
    def from_arrays(device: torch.device, **arrays) -> "Scene":
        """A Scene from host arrays (numpy or array-likes, one per array
        field; the ints as keywords too) on ``device`` (the caller
        resolves it: the render layer's ``render_device``)."""
        kw = {}
        for f in dataclasses.fields(Scene):
            v = arrays[f.name]
            if f.name in _META:
                kw[f.name] = int(v)
            else:
                dt = np.int32 if f.name in _INT_FIELDS else np.float32
                kw[f.name] = torch.from_numpy(np.ascontiguousarray(
                    np.asarray(v, dt))).to(device)
        return Scene(**kw)

    @property
    def device(self) -> torch.device:
        return self.scalars.device

    def to(self, device) -> "Scene":
        """The same scene with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name not in _META})

    def host_arrays(self) -> dict:
        """Every field as host numpy (the ints as ints)."""
        return {f.name: (getattr(self, f.name) if f.name in _META
                         else getattr(self, f.name).cpu().numpy())
                for f in dataclasses.fields(self)}

    def nbytes(self) -> int:
        """Bytes of the scene's tensors."""
        return sum(getattr(self, f.name).numel()
                   * getattr(self, f.name).element_size()
                   for f in dataclasses.fields(self)
                   if f.name not in _META)


@dataclass
class TriangleMesh:
    """A triangle surface mesh (exa/TriangleMesh.h:23-38)."""

    vertices: np.ndarray  # (V, 3) float32
    indices: np.ndarray  # (T, 3) int32
