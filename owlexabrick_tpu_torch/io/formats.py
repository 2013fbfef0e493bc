"""Readers/writers for the exa file formats (the port's copy of
``owlexabrick_tpu/io/formats.py``, host numpy), bit-compatible with the
reference so its converters and datasets work unchanged: the port writes
the files the JAX package writes, byte for byte.

Formats:
  * ``.cells``   — stream of int32[4] records (x, y, z, level) per cell
                   (reference builder/builder.cpp:813-834 SingleCell)
  * ``.scalars`` — raw float32 stream, one value per cell in .cells order
                   (exa/ScalarField.cpp:22-55)
  * ``.bricks``  — stream of records: int32[3] size, int32[3] lower,
                   int32 level, int32 cellIDs[size.x*size.y*size.z]
                   (exa/ExaBricks.cpp:21-55, builder/builder.cpp:895-902)
  * ``.tris``    — multi-mesh: repeat [int32 numVerts, float32[3]*numVerts,
                   int32 numTris, int32[3]*numTris] (exa/TriangleMesh.cpp:21-69)
  * ``.kd``      — stream of 12-byte KdTreeNode records (exa/KdTree.h:25-137)
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..core.types import Bricks, ScalarField, TriangleMesh


# ----------------------------------------------------------------------------
# .cells / .scalars
# ----------------------------------------------------------------------------

def read_cells(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a .cells file -> (lower (N,3) int32, level (N,) int32)."""
    raw = np.fromfile(path, dtype=np.int32)
    if raw.size % 4 != 0:
        raise ValueError(f"{path}: size {raw.size} not a multiple of 4 int32")
    recs = raw.reshape(-1, 4)
    return np.ascontiguousarray(recs[:, :3]), np.ascontiguousarray(recs[:, 3])


def write_cells(path: str, lower: np.ndarray, level: np.ndarray) -> None:
    lower = np.asarray(lower, dtype=np.int32).reshape(-1, 3)
    level = np.asarray(level, dtype=np.int32).reshape(-1)
    if lower.shape[0] != level.shape[0]:
        raise ValueError("lower/level length mismatch")
    recs = np.concatenate([lower, level[:, None]], axis=1).astype(np.int32)
    recs.tofile(path)


def read_scalars(path: str) -> np.ndarray:
    return np.fromfile(path, dtype=np.float32)


def write_scalars(path: str, values: np.ndarray) -> None:
    np.asarray(values, dtype=np.float32).tofile(path)


# ----------------------------------------------------------------------------
# .bricks
# ----------------------------------------------------------------------------

def read_bricks(path: str) -> Tuple[Bricks, np.ndarray]:
    """Read a .bricks file.

    Returns (Bricks SoA, cell_ids) where cell_ids is the flattened
    concatenation of every brick's cellID array (x fastest), and
    ``bricks.begin[i]`` indexes into it.  Performs the same sanity checks
    as the reference loader (exa/ExaBricks.cpp:43-52).
    """
    raw = np.fromfile(path, dtype=np.int32)
    lowers: List[np.ndarray] = []
    sizes: List[np.ndarray] = []
    levels: List[int] = []
    begins: List[int] = []
    id_chunks: List[np.ndarray] = []
    pos = 0
    begin = 0
    n = raw.size
    while pos + 7 <= n:
        size = raw[pos : pos + 3]
        lower = raw[pos + 3 : pos + 6]
        level = int(raw[pos + 6])
        pos += 7
        vol = int(size[0]) * int(size[1]) * int(size[2])
        if vol <= 0 or pos + vol > n:
            raise ValueError(f"{path}: corrupt brick record at offset {pos*4}")
        id_chunks.append(raw[pos : pos + vol])
        pos += vol
        sizes.append(size)
        lowers.append(lower)
        levels.append(level)
        begins.append(begin)
        begin += vol
    if pos != n:
        raise ValueError(f"{path}: trailing bytes ({(n-pos)*4})")
    if not lowers:
        raise ValueError(f"{path}: empty bricks file")
    cell_ids = np.concatenate(id_chunks) if id_chunks else np.zeros(0, np.int32)
    total = cell_ids.size
    # reference sanity asserts (exa/ExaBricks.cpp:43-52): IDs must be
    # non-negative (-1 is the ALLOW_EMPTY_CELLS empty-cell sentinel, cpp:46)
    if cell_ids.size and cell_ids.min() < -1:
        raise ValueError(f"{path}: cellID out of range [0, {total})")
    if cell_ids.size and cell_ids.max() >= total:
        # legitimate after the builder's duplicate removal (finer level
        # wins, builder.cpp:301-351): surviving IDs still index the
        # ORIGINAL .cells/.scalars order, which is larger than the
        # deduped brick total.  The reference's assert is debug-only and
        # would trip here too; the real bound is the scalar file length,
        # checked at gather time (gather_scalars).
        print(f"#exa: note: {path} max cellID {cell_ids.max()} >= "
              f"brick total {total} (deduplicated scene)")
    bricks = Bricks(
        lower=np.stack(lowers).astype(np.int32),
        size=np.stack(sizes).astype(np.int32),
        level=np.asarray(levels, dtype=np.int32),
        begin=np.asarray(begins, dtype=np.int32),
    )
    if begin > 2**31 - 1:
        raise ValueError("32-bit brick offset overflow")
    return bricks, cell_ids


def write_bricks(
    path: str, lower: np.ndarray, size: np.ndarray, level: np.ndarray,
    cell_ids_per_brick: List[np.ndarray],
) -> None:
    """Write a .bricks file (record layout of builder/builder.cpp:895-902)."""
    with open(path, "wb") as f:
        for i in range(len(level)):
            sz = np.asarray(size[i], dtype=np.int32)
            rec = np.concatenate(
                [
                    sz,
                    np.asarray(lower[i], dtype=np.int32),
                    np.asarray([level[i]], dtype=np.int32),
                    np.asarray(cell_ids_per_brick[i], dtype=np.int32).reshape(-1),
                ]
            )
            vol = int(sz[0]) * int(sz[1]) * int(sz[2])
            if rec.size != 7 + vol:
                raise ValueError("cellIDs length != brick volume")
            rec.tofile(f)


# ----------------------------------------------------------------------------
# .tris
# ----------------------------------------------------------------------------

def read_tris(path: str) -> List[TriangleMesh]:
    data = open(path, "rb").read()
    meshes: List[TriangleMesh] = []
    pos = 0
    n = len(data)
    while pos + 4 <= n:
        num_verts = int(np.frombuffer(data, np.int32, 1, pos)[0])
        pos += 4
        verts = np.frombuffer(data, np.float32, num_verts * 3, pos).reshape(-1, 3)
        pos += num_verts * 12
        num_tris = int(np.frombuffer(data, np.int32, 1, pos)[0])
        pos += 4
        idx = np.frombuffer(data, np.int32, num_tris * 3, pos).reshape(-1, 3)
        pos += num_tris * 12
        if idx.size and (idx.min() < 0 or idx.max() >= num_verts):
            raise ValueError(f"{path}: broken triangle model")
        meshes.append(TriangleMesh(vertices=verts.copy(), indices=idx.copy()))
    return meshes


def write_tris(path: str, meshes: List[TriangleMesh]) -> None:
    with open(path, "wb") as f:
        for m in meshes:
            v = np.asarray(m.vertices, np.float32).reshape(-1, 3)
            t = np.asarray(m.indices, np.int32).reshape(-1, 3)
            np.asarray([v.shape[0]], np.int32).tofile(f)
            v.tofile(f)
            np.asarray([t.shape[0]], np.int32).tofile(f)
            t.tofile(f)


# ----------------------------------------------------------------------------
# .kd (12-byte packed nodes)
# ----------------------------------------------------------------------------

KD_LEAF_AXIS = 3


def pack_kd_nodes(axis: np.ndarray, split_or_first: np.ndarray,
                  child_or_count: np.ndarray, max_level: np.ndarray) -> np.ndarray:
    """Pack to the reference's 12-byte node records (exa/KdTree.h:93-113).

    word0: split position (inner) / first primitive (leaf)
    word1: top 2 bits = axis (3 == leaf); low 30 bits = first child (inner)
           or primitive count (leaf)
    word2: max_level
    """
    n = len(axis)
    out = np.zeros((n, 3), dtype=np.uint32)
    out[:, 0] = split_or_first.astype(np.int64).astype(np.uint32)
    out[:, 1] = (axis.astype(np.uint32) << 30) | (
        child_or_count.astype(np.int64).astype(np.uint32) & 0x3FFFFFFF
    )
    out[:, 2] = max_level.astype(np.int64).astype(np.uint32)
    return out


def write_kd(path: str, packed: np.ndarray) -> None:
    np.asarray(packed, dtype=np.uint32).tofile(path)


def read_kd(path: str):
    """Read .kd -> dict of SoA arrays (axis, split/first, child/count, max_level)."""
    raw = np.fromfile(path, dtype=np.uint32)
    if raw.size % 3 != 0:
        raise ValueError(f"{path}: size not a multiple of 12 bytes")
    recs = raw.reshape(-1, 3)
    axis = (recs[:, 1] >> 30).astype(np.int32)
    lo30 = (recs[:, 1] & 0x3FFFFFFF).astype(np.int32)
    return {
        "axis": axis,
        "word0": recs[:, 0].view(np.int32),
        "lo30": lo30,
        "max_level": recs[:, 2].view(np.int32),
    }
