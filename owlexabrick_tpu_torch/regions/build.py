"""Build "same-bricks regions": spatial regions in which a fixed set of
brick basis functions overlap (the port's copy of
``owlexabrick_tpu/regions/build.py``, host numpy).

Algorithm (reference exa/Regions.cpp:32-320): recursively BSP-split the
union of all brick *domains* (bounds padded by half a cell width).  The
split candidate for each dimension is the brick-domain face closest to the
domain center; dims are tried widest-first.  When no face lies strictly
inside the current domain, the domain becomes a region whose brick list is
the exact set of bricks whose domain overlaps it.  Per region we record
the finest (minimum) cell width and the value range over every cell of
every channel whose basis support touches the region.

The BSP recursion itself is recorded as a stackless point-location tree
(`RegionTree`): inner nodes (axis, split), leaves a region id or -1 for
spatial holes.  The renderer locates the region containing any point in
`depth` gathers, in place of the reference's BVH traversal
(exabrick.cu:213-238).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core.types import Bricks, Regions, RegionTree


def build_regions(
    bricks: Bricks,
    scalars: Optional[np.ndarray] = None,
    num_channels: Optional[int] = None,
    backend: str = "native",
) -> Tuple[Regions, RegionTree]:
    """Build regions + BSP tree from a brick table.

    ``scalars``: (C, total_cells) flattened per-brick cell values used for
    per-region value ranges (may be None -> ranges left [inf,-inf]).
    ``backend``: "native" uses the threaded C++ core (native/, built at
    first use; identical output; raises if it cannot be built),
    "python" the numpy implementation (minutes at 64^3).
    """
    if backend == "native":
        from ..native import native_build_regions

        return native_build_regions(bricks, scalars, num_channels)
    if backend != "python":
        raise ValueError(f"unknown backend {backend!r}")
    return build_regions_py(bricks, scalars, num_channels)


def build_regions_py(
    bricks: Bricks,
    scalars: Optional[np.ndarray] = None,
    num_channels: Optional[int] = None,
) -> Tuple[Regions, RegionTree]:
    """Pure-numpy region build (the reference/spec implementation)."""
    dom_lo, dom_hi = bricks.domains()
    n_bricks = bricks.num_bricks

    bounds_lo = dom_lo.min(axis=0)
    bounds_hi = dom_hi.max(axis=0)

    # -- BSP over (clipped brick domain, brick id) build prims ----------
    regions_lo: List[np.ndarray] = []
    regions_hi: List[np.ndarray] = []
    leaf_lists: List[np.ndarray] = []

    axis_l: List[int] = []
    split_l: List[float] = []
    child_l: List[int] = []
    leaf_l: List[int] = []
    node_lo_l: List[np.ndarray] = []
    node_hi_l: List[np.ndarray] = []

    def new_node() -> int:
        axis_l.append(3)
        split_l.append(0.0)
        child_l.append(-1)
        leaf_l.append(-1)
        node_lo_l.append(np.zeros(3, np.float32))
        node_hi_l.append(np.zeros(3, np.float32))
        return len(axis_l) - 1

    def make_leaf(node: int, prim_lo, prim_hi, prim_id, dlo, dhi) -> None:
        # addLeaf (Regions.cpp:32-71): degenerate domains and empty prim
        # sets become holes
        if (dlo >= dhi).any() or prim_id.size == 0:
            return
        ids = np.unique(prim_id)
        leaf_l[node] = len(regions_lo)
        regions_lo.append(dlo.copy())
        regions_hi.append(dhi.copy())
        leaf_lists.append(ids.astype(np.int32))

    root = new_node()
    max_depth = 1
    # explicit stack instead of recursion: (node, prim arrays, domain, depth)
    stack = [
        (
            root,
            dom_lo.copy(),
            dom_hi.copy(),
            np.arange(n_bricks, dtype=np.int32),
            bounds_lo.copy(),
            bounds_hi.copy(),
            1,
        )
    ]
    while stack:
        node, plo, phi, pid, dlo, dhi, depth = stack.pop()
        max_depth = max(max_depth, depth)
        node_lo_l[node] = np.asarray(dlo, np.float32)
        node_hi_l[node] = np.asarray(dhi, np.float32)
        if pid.size == 0:
            continue  # hole: leaf stays -1
        if (dhi <= dlo).any():
            continue

        # candidate split per dim: prim face strictly inside the domain,
        # closest to the center (Regions.cpp:84-123)
        center = 0.5 * (dlo + dhi)
        span = dhi - dlo
        best_pos = dlo.copy()
        best_dist = span.copy()
        for dim in range(3):
            # per prim: upper face first, then lower (Regions.cpp:91-92);
            # argmin keeps the first of equal minima, matching the
            # sequential strict-< scan of the reference/native builder
            faces = np.stack([phi[:, dim], plo[:, dim]], axis=1).ravel()
            inside = (faces > dlo[dim]) & (faces < dhi[dim])
            faces = faces[inside]
            if faces.size == 0:
                continue
            dist = np.abs(center[dim] - faces)
            k = int(np.argmin(dist))
            if dist[k] < best_dist[dim]:
                best_dist[dim] = dist[k]
                best_pos[dim] = faces[k]

        widest = int(np.argmax(span))
        split_dim = -1
        split_pos = 0.0
        for i in range(3):
            dim = (widest + i) % 3
            if best_pos[dim] <= dlo[dim] or best_pos[dim] >= dhi[dim]:
                continue
            split_dim = dim
            split_pos = float(best_pos[dim])
            break

        if split_dim < 0:
            make_leaf(node, plo, phi, pid, dlo, dhi)
            continue

        # clip prims into halves
        dlo_l, dhi_l = dlo.copy(), dhi.copy()
        dhi_l[split_dim] = split_pos
        dlo_r, dhi_r = dlo.copy(), dhi.copy()
        dlo_r[split_dim] = split_pos

        def clip(lo_, hi_):
            clo = np.maximum(plo, lo_)
            chi = np.minimum(phi, hi_)
            keep = (clo < chi).all(axis=1)
            return clo[keep], chi[keep], pid[keep]

        l = clip(dlo_l, dhi_l)
        r = clip(dlo_r, dhi_r)

        first = new_node()
        new_node()
        axis_l[node] = split_dim
        split_l[node] = split_pos
        child_l[node] = first
        # left child processed first (LIFO stack) so region ids match the
        # native builder's depth-first left-to-right order
        stack.append((first + 1, *r, dlo_r, dhi_r, depth + 1))
        stack.append((first, *l, dlo_l, dhi_l, depth + 1))

    n_regions = len(regions_lo)
    if n_regions == 0:
        raise ValueError("no regions built (no bricks?)")

    leaf_begin = np.zeros(n_regions, np.int32)
    leaf_size = np.zeros(n_regions, np.int32)
    off = 0
    for i, ll in enumerate(leaf_lists):
        leaf_begin[i] = off
        leaf_size[i] = ll.size
        off += ll.size
    leaf_list = (
        np.concatenate(leaf_lists) if leaf_lists else np.zeros(0, np.int32)
    )
    max_k = int(leaf_size.max())
    brick_ids = np.full((n_regions, max_k), -1, np.int32)
    for i, ll in enumerate(leaf_lists):
        brick_ids[i, : ll.size] = ll

    r_lo = np.stack(regions_lo).astype(np.float32)
    r_hi = np.stack(regions_hi).astype(np.float32)

    # finest level cell width per region (Regions.cpp:289-299)
    cw = (1 << bricks.level.astype(np.int64)).astype(np.float32)
    padded_cw = np.where(brick_ids >= 0, cw[np.clip(brick_ids, 0, None)], np.inf)
    finest_cw = padded_cw.min(axis=1).astype(np.float32)

    # value ranges (Regions.cpp:182-240)
    value_range = np.stack(
        [np.full(n_regions, np.inf, np.float32), np.full(n_regions, -np.inf, np.float32)],
        axis=1,
    )
    if scalars is not None:
        scalars = np.asarray(scalars, np.float32)
        if scalars.ndim == 1:
            scalars = scalars[None]
        if num_channels is not None:
            scalars = scalars[:num_channels]
        value_range = compute_value_ranges(
            bricks, r_lo, r_hi, leaf_lists, scalars
        )

    regions = Regions(
        domain_lo=r_lo,
        domain_hi=r_hi,
        value_range=value_range,
        finest_cw=finest_cw,
        brick_ids=brick_ids,
        leaf_list=leaf_list,
        leaf_begin=leaf_begin,
        leaf_size=leaf_size,
    )
    tree = RegionTree(
        axis=np.asarray(axis_l, np.int32),
        split=np.asarray(split_l, np.float32),
        child=np.asarray(child_l, np.int32),
        leaf=np.asarray(leaf_l, np.int32),
        node_lo=np.stack(node_lo_l).astype(np.float32),
        node_hi=np.stack(node_hi_l).astype(np.float32),
        depth=max_depth,
    )
    return regions, tree


def compute_value_ranges(
    bricks: Bricks,
    region_lo: np.ndarray,
    region_hi: np.ndarray,
    leaf_lists: List[np.ndarray],
    scalars: np.ndarray,
) -> np.ndarray:
    """Per-region [min,max] over all channels of every cell whose basis
    support (center +- cell width per axis) overlaps the region."""
    n_regions = region_lo.shape[0]
    out = np.stack(
        [np.full(n_regions, np.inf, np.float32), np.full(n_regions, -np.inf, np.float32)],
        axis=1,
    )
    lower = bricks.lower
    size = bricks.size
    level = bricks.level
    begin = bricks.begin
    for rid in range(n_regions):
        rlo = region_lo[rid]
        rhi = region_hi[rid]
        vmin, vmax = np.inf, -np.inf
        for b in leaf_lists[rid]:
            cw = float(1 << int(level[b]))
            sx, sy, sz = (int(size[b][0]), int(size[b][1]), int(size[b][2]))
            valid = []
            for a, sa in zip(range(3), (sx, sy, sz)):
                pos = lower[b][a] + (np.arange(sa) + 0.5) * cw
                valid.append((pos - cw <= rhi[a]) & (pos + cw >= rlo[a]))
            m = (
                valid[2][:, None, None]
                & valid[1][None, :, None]
                & valid[0][None, None, :]
            )
            if not m.any():
                continue
            vals = scalars[:, int(begin[b]) : int(begin[b]) + sx * sy * sz]
            vals = vals.reshape(scalars.shape[0], sz, sy, sx)[:, m]
            vmin = min(vmin, float(vals.min()))
            vmax = max(vmax, float(vals.max()))
        out[rid] = (vmin, vmax)
    return out
