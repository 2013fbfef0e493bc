"""Offline builder: partition AMR cells into "exa bricks" (the port's
copy of ``owlexabrick_tpu/builder/bricker.py``, host numpy).

Re-implements the reference ``exaBuilder`` (builder/builder.cpp:406-917)
with numpy-vectorized per-node work:

  * duplicate removal (same-position cells collapse to the finest level,
    builder.cpp:301-351)
  * recursive partition; a node becomes a leaf (brick) when it holds a
    single refinement level, is at most ``max_leaf_width`` coarse cells in
    any dimension, and is fully populated (builder.cpp:447-530)
  * split-plane search over coarse-cell-aligned boundary planes with three
    strategies (builder.cpp:538-811):
      - ``spatial-median``: always split the widest axis in the middle
      - ``sah-alike`` (default): cost = area * volume * level-span per side
      - ``small-brick-count``: cost = #distinct levels per side, ties
        broken toward the spatial median (Kaehler-style)
  * a kd-tree over the recursion recorded in the reference's 12-byte node
    format (exa/KdTree.h), written with ``-kd``

This numpy implementation is the reference path; ``native/`` holds the
C++ builder the pipeline uses by default (identical output).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

SPATIAL_MEDIAN = "spatial-median"
SAH_ALIKE = "sah-alike"
SMALL_BRICK_COUNT = "small-brick-count"

_BIG = np.int64(1) << 40


@dataclass
class BuiltBrick:
    lower: np.ndarray  # (3,) int32
    level: int
    size: np.ndarray  # (3,) int32
    cell_ids: np.ndarray  # (size.z, size.y, size.x) int32 (z-major)


@dataclass
class KdNodeRec:
    axis: int = 3  # 0..2 inner, 3 leaf
    split: int = 0
    max_level: int = 0
    first_child: int = 0
    first_prim: int = 0
    num_prims: int = 0


@dataclass
class BuildResult:
    bricks: List[BuiltBrick]
    kd: List[KdNodeRec]

    def stats(self) -> dict:
        sizes = np.array([b.size for b in self.bricks])
        return {
            "num_bricks": len(self.bricks),
            "avg_cells_per_brick": sizes.mean(axis=0).tolist() if len(self.bricks) else [0, 0, 0],
            "num_single_cell_bricks": int((sizes == 1).all(axis=1).sum()) if len(self.bricks) else 0,
        }


def deduplicate_cells(lower: np.ndarray, level: np.ndarray) -> np.ndarray:
    """Return indices of the surviving cells: unique positions, finest level
    wins among same-position duplicates."""
    lower = np.asarray(lower, np.int64)
    level = np.asarray(level, np.int64)
    # sort by (x, y, z, level): same-position entries adjacent, finest first
    order = np.lexsort((level, lower[:, 2], lower[:, 1], lower[:, 0]))
    sl = lower[order]
    same_pos = np.concatenate(
        [[False], (sl[1:] == sl[:-1]).all(axis=1)]
    )
    return order[~same_pos]


def _signed_div_round_down(a, b):
    return np.floor_divide(a, b)


def _signed_div_round_up(a, b):
    return -np.floor_divide(-a, b)


class Bricker:
    def __init__(
        self,
        lower: np.ndarray,
        level: np.ndarray,
        strategy: str = SAH_ALIKE,
        max_leaf_width: int = 127,
        verbose: bool = False,
    ):
        self.cell_lower = np.asarray(lower, np.int64).reshape(-1, 3)
        self.cell_level = np.asarray(level, np.int64).reshape(-1)
        if (self.cell_level < 0).any() or (self.cell_level > 30).any():
            raise ValueError("cell level out of range [0, 30]")
        self.strategy = strategy
        self.max_leaf_width = max_leaf_width
        self.verbose = verbose
        self.bricks: List[BuiltBrick] = []
        self.kd: List[KdNodeRec] = []

    def build(self) -> BuildResult:
        ids = deduplicate_cells(self.cell_lower, self.cell_level)
        self.kd.append(KdNodeRec())
        self._build_rec(ids, 0)
        return BuildResult(bricks=self.bricks, kd=self.kd)

    # ------------------------------------------------------------------
    def _bounds4(self, ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """4D cell bounds: xyz = [lower, lower+2^level], w = [level, level+1]."""
        lo3 = self.cell_lower[ids]
        lev = self.cell_level[ids]
        hi3 = lo3 + (1 << lev)[:, None]
        lo = np.concatenate([lo3.min(axis=0), [lev.min()]])
        hi = np.concatenate([hi3.max(axis=0), [lev.max() + 1]])
        return lo, hi

    def _build_rec(self, ids: np.ndarray, node_id: int) -> None:
        lo4, hi4 = self._bounds4(ids)
        coarse_w = np.int64(1) << (hi4[3] - 1)
        # align xyz to the coarsest level present (builder.cpp:201-225)
        lo4 = lo4.copy()
        hi4 = hi4.copy()
        lo4[:3] = coarse_w * _signed_div_round_down(lo4[:3], coarse_w)
        hi4[:3] = coarse_w * _signed_div_round_up(hi4[:3], coarse_w)

        if self._try_make_leaf(lo4, hi4, ids, node_id):
            return

        grid_dims = (hi4[:3] - lo4[:3]) // coarse_w
        if (grid_dims == 1).all():
            raise RuntimeError("coarse size 1 that's not a leaf!?")

        lev = self.cell_level[ids]
        max_level = int(lev.max())

        split_dim, split_pos = self._find_split(ids, lo4, hi4, coarse_w, grid_dims)

        # partition (straddling a chosen boundary plane is impossible by
        # construction; guard anyway, builder.cpp:753-769)
        clo = self.cell_lower[ids][:, split_dim]
        chi = clo + (1 << lev)
        right = clo >= split_pos
        left = chi <= split_pos
        if not (right | left).all():
            raise RuntimeError("cell straddles split plane!?")
        l_ids = ids[left]
        r_ids = ids[right]
        if l_ids.size == 0 or r_ids.size == 0:
            raise RuntimeError("invalid split...")

        first_child = len(self.kd)
        self.kd.append(KdNodeRec())
        self.kd.append(KdNodeRec())
        node = self.kd[node_id]
        node.axis = int(split_dim)
        node.split = int(split_pos)
        node.max_level = max_level
        node.first_child = first_child

        self._build_rec(l_ids, first_child)
        self._build_rec(r_ids, first_child + 1)

    # ------------------------------------------------------------------
    def _try_make_leaf(self, lo4, hi4, ids, node_id) -> bool:
        if ids.size == 0:
            raise RuntimeError("empty ID vector in tryMakeLeaf!?")
        if hi4[3] - lo4[3] > 1:
            return False
        cw = np.int64(1) << (hi4[3] - 1)
        size3 = (hi4[:3] - lo4[:3]) // cw
        if (size3 > self.max_leaf_width).any():
            return False
        # fully populated? (3D volume in unit cells == n cells * cell volume)
        vol_units = int(np.prod(hi4[:3] - lo4[:3]))
        if vol_units != ids.size * int(cw) ** 3:
            return False

        idx = (self.cell_lower[ids] - lo4[:3]) // cw  # (n,3)
        grid = np.full(size3[::-1], -1, dtype=np.int32)  # z,y,x
        grid[idx[:, 2], idx[:, 1], idx[:, 0]] = ids.astype(np.int32)
        if (grid < 0).any():
            return False

        node = self.kd[node_id]
        node.axis = 3
        node.first_prim = len(self.bricks)
        node.num_prims = 1
        self.bricks.append(
            BuiltBrick(
                lower=lo4[:3].astype(np.int32),
                level=int(lo4[3]),
                size=size3.astype(np.int32),
                cell_ids=grid,
            )
        )
        return True

    # ------------------------------------------------------------------
    def _find_split(self, ids, lo4, hi4, coarse_w, grid_dims):
        best_dim, best_pos, best_cost = -1, -1, np.inf
        if self.strategy in (SAH_ALIKE, SMALL_BRICK_COUNT):
            clo = self.cell_lower[ids]
            lev = self.cell_level[ids]
            cell_w = (np.int64(1) << lev)
            chi = clo + cell_w[:, None]
            cell_vol = cell_w ** 3

            for d in range(3):
                nd = int(grid_dims[d])
                if nd <= 1:
                    continue
                bins = (clo[:, d] - lo4[d]) // coarse_w
                # per-slice: volume used, level range, 4D bounds
                vol_used = np.zeros(nd, np.int64)
                np.add.at(vol_used, bins, cell_vol)
                s_lo = np.full((nd, 4), _BIG, np.int64)
                s_hi = np.full((nd, 4), -_BIG, np.int64)
                for a in range(3):
                    np.minimum.at(s_lo[:, a], bins, clo[:, a])
                    np.maximum.at(s_hi[:, a], bins, chi[:, a])
                np.minimum.at(s_lo[:, 3], bins, lev)
                np.maximum.at(s_hi[:, 3], bins, lev + 1)

                expected_slice_vol = int(np.prod(hi4[:3] - lo4[:3])) // nd
                full = vol_used == expected_slice_vol

                # prefix/suffix unions for candidate-plane costs
                pre_lo = np.minimum.accumulate(s_lo, axis=0)
                pre_hi = np.maximum.accumulate(s_hi, axis=0)
                suf_lo = np.minimum.accumulate(s_lo[::-1], axis=0)[::-1]
                suf_hi = np.maximum.accumulate(s_hi[::-1], axis=0)[::-1]

                # distinct level sets per side (for small-brick-count)
                if self.strategy == SMALL_BRICK_COUNT:
                    levels_present = np.zeros((nd, 32), bool)
                    levels_present[bins, lev] = True
                    pre_levels = np.logical_or.accumulate(levels_present, axis=0)
                    suf_levels = np.logical_or.accumulate(
                        levels_present[::-1], axis=0
                    )[::-1]

                for plane in range(1, nd):
                    ls, rs = plane - 1, plane
                    # boundary test (builder.cpp:635-658): differs in level
                    # range or fullness across the plane
                    llo, lsz = s_lo[ls, 3], s_hi[ls, 3] - s_lo[ls, 3]
                    rlo, rsz = s_lo[rs, 3], s_hi[rs, 3] - s_lo[rs, 3]
                    if llo == rlo and lsz == rsz and full[ls] and full[rs]:
                        continue

                    lb_lo, lb_hi = pre_lo[ls], pre_hi[ls]
                    rb_lo, rb_hi = suf_lo[rs], suf_hi[rs]
                    if self.strategy == SAH_ALIKE:
                        lsize = np.maximum(lb_hi - lb_lo, 0)
                        rsize = np.maximum(rb_hi - rb_lo, 0)

                        def area(s):
                            return float(s[0]) * s[1] + float(s[1]) * s[2] + float(s[2]) * s[0]

                        def vol(s):
                            return float(s[0]) * s[1] * s[2]

                        cost = (
                            area(lsize) * vol(lsize) * float(lsize[3])
                            + area(rsize) * vol(rsize) * float(rsize[3])
                        )
                    else:
                        cost = float(pre_levels[ls].sum() + suf_levels[rs].sum())

                    pos = int(lo4[d] + plane * coarse_w)
                    if cost < best_cost:
                        best_cost, best_dim, best_pos = cost, d, pos
                    elif (
                        self.strategy == SMALL_BRICK_COUNT
                        and cost == best_cost
                        and best_dim >= 0
                    ):
                        # tie-break toward the spatial median (builder.cpp:709-719)
                        middle = int(grid_dims[best_dim]) // 2
                        if abs(pos - middle) < abs(best_pos - middle):
                            best_dim, best_pos = d, pos

        if best_dim == -1:
            # spatial-median fallback (builder.cpp:728-734)
            best_dim = int(np.argmax(grid_dims))
            plane = int(grid_dims[best_dim]) // 2
            best_pos = int(lo4[best_dim] + plane * coarse_w)
        return best_dim, best_pos


def build_bricks(
    lower: np.ndarray,
    level: np.ndarray,
    strategy: str = SAH_ALIKE,
    max_leaf_width: int = 127,
) -> BuildResult:
    """cells -> bricks with the numpy builder (``native`` holds the C++
    core with identical output, as flat arrays)."""
    return Bricker(lower, level, strategy, max_leaf_width).build()


def kd_to_arrays(kd: List[KdNodeRec]):
    """SoA arrays in the reference's packed semantics (exa/KdTree.h)."""
    axis = np.array([n.axis for n in kd], np.int32)
    word0 = np.array(
        [n.split if n.axis != 3 else n.first_prim for n in kd], np.int32
    )
    lo30 = np.array(
        [n.first_child if n.axis != 3 else n.num_prims for n in kd], np.int32
    )
    max_level = np.array([n.max_level for n in kd], np.int32)
    return axis, word0, lo30, max_level
