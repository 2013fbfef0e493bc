"""ctypes bindings of the native preprocessing core (``exabrick_native.cpp``:
the cells -> bricks builder and the threaded region build).

The shared library is compiled from this directory's source with ``g++``
(the host compiler ``nvcc`` uses too) into ``build/torch_native/`` at the
repository root at first use, and loaded with ``ctypes``; nothing is
built when this module is imported.  A failed build raises: nothing falls
back to the numpy builders (ask for those with ``backend="python"``).
Both entry points have a numpy twin (``builder/bricker.py`` with
``pipeline.bricks_from_build``, ``regions/build.py``) with identical
output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parent / "exabrick_native.cpp"
BUILD_DIR = (pathlib.Path(__file__).resolve().parent.parent.parent
             / "build" / "torch_native")
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
            "-shared"]

_lib = None


def _host_cpu() -> str:
    """The host's CPU identity for ``-march=native``: its architecture
    and instruction-set flags (the first ``flags`` line of
    /proc/cpuinfo where there is one)."""
    ident = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            ident += next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        ident += platform.processor()
    return ident


def library_path() -> pathlib.Path:
    """The library built from this source with these flags for this
    host's CPU (a library built with ``-march=native`` elsewhere may
    hold instructions this CPU lacks)."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    h.update(_host_cpu().encode())
    return BUILD_DIR / f"libexabrick_native_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the core unless this source's library exists; returns its
    path.  Raises RuntimeError when there is no g++ or it fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native scene builder needs "
                           "a C++ compiler (or pass backend='python')")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        tmp = os.path.join(tmpdir, out.name)
        proc = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, str(SOURCE),
                               "-lpthread"], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return out


def load() -> ctypes.CDLL:
    """The native library (built on first use), with argtypes set."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    i64 = ctypes.c_int64
    p = ctypes.c_void_p
    lib.exa_build_bricks.restype = p
    lib.exa_build_bricks.argtypes = [p, p, i64, ctypes.c_int, ctypes.c_int]
    for fn in ("exa_build_num_bricks", "exa_build_num_cells",
               "exa_build_num_kd", "exa_regions_num",
               "exa_regions_leaf_list_len", "exa_regions_num_nodes"):
        getattr(lib, fn).restype = i64
        getattr(lib, fn).argtypes = [p]
    lib.exa_build_copy.restype = None
    lib.exa_build_copy.argtypes = [p] + [p] * 9
    lib.exa_build_free.restype = None
    lib.exa_build_free.argtypes = [p]
    lib.exa_build_regions.restype = p
    lib.exa_build_regions.argtypes = [p, p, p, p, i64, p, i64, ctypes.c_int]
    lib.exa_regions_depth.restype = ctypes.c_int32
    lib.exa_regions_depth.argtypes = [p]
    lib.exa_regions_copy.restype = None
    lib.exa_regions_copy.argtypes = [p] + [p] * 13
    lib.exa_regions_free.restype = None
    lib.exa_regions_free.argtypes = [p]
    _lib = lib
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


_STRATEGIES = {"spatial-median": 0, "sah-alike": 1, "small-brick-count": 2}


def native_build_bricks_flat(lower, level, strategy: str = "sah-alike",
                             max_leaf_width: int = 127,
                             with_kd: bool = False):
    """Native cells -> (Bricks, cell_ids) as ``pipeline.bricks_from_build``
    makes them from the numpy builder's result (the core lays cells out x
    fastest in brick order with running begin offsets).  ``with_kd``
    adds a third item: the kd-tree as ``bricker.kd_to_arrays`` gives it
    (axis, word0, lo30, max_level)."""
    from ..core.types import Bricks

    lib = load()
    lower = np.ascontiguousarray(lower, np.int32).reshape(-1, 3)
    level = np.ascontiguousarray(level, np.int32).reshape(-1)
    if lower.shape[0] != level.shape[0]:
        raise ValueError("lower and level hold different cell counts")
    h = lib.exa_build_bricks(_ptr(lower), _ptr(level), lower.shape[0],
                             _STRATEGIES[strategy], int(max_leaf_width))
    try:
        m = lib.exa_build_num_bricks(h)
        nc = lib.exa_build_num_cells(h)
        nk = lib.exa_build_num_kd(h)
        b_lower = np.empty((m, 3), np.int32)
        b_size = np.empty((m, 3), np.int32)
        b_level = np.empty(m, np.int32)
        b_begin = np.empty(m, np.int64)
        cell_ids = np.empty(nc, np.int32)
        kd = [np.empty(nk, np.int32) for _ in range(4)]
        lib.exa_build_copy(h, _ptr(b_lower), _ptr(b_size), _ptr(b_level),
                           _ptr(b_begin), _ptr(cell_ids),
                           *(_ptr(a) for a in kd))
    finally:
        lib.exa_build_free(h)
    bricks = Bricks(lower=b_lower, size=b_size, level=b_level,
                    begin=b_begin.astype(np.int32))
    return (bricks, cell_ids, tuple(kd)) if with_kd else (bricks, cell_ids)


def native_build_regions(bricks, scalars: Optional[np.ndarray],
                         num_channels: Optional[int] = None):
    """Native region build; returns (Regions, RegionTree) like
    ``regions.build.build_regions_py``."""
    from ..core.types import Regions, RegionTree

    lib = load()
    b_lower = np.ascontiguousarray(bricks.lower, np.int32)
    b_size = np.ascontiguousarray(bricks.size, np.int32)
    b_level = np.ascontiguousarray(bricks.level, np.int32)
    b_begin = np.ascontiguousarray(bricks.begin, np.int64)
    if scalars is None:
        sc = np.zeros((0, 0), np.float32)
    else:
        sc = np.ascontiguousarray(scalars, np.float32)
        if sc.ndim == 1:
            sc = sc[None]
        if num_channels is not None:
            sc = np.ascontiguousarray(sc[:num_channels])
    nchan, total = sc.shape

    h = lib.exa_build_regions(_ptr(b_lower), _ptr(b_size), _ptr(b_level),
                              _ptr(b_begin), b_lower.shape[0], _ptr(sc),
                              total, nchan)
    try:
        nr = lib.exa_regions_num(h)
        ll = lib.exa_regions_leaf_list_len(h)
        nt = lib.exa_regions_num_nodes(h)
        depth = lib.exa_regions_depth(h)
        region_lo = np.empty((nr, 3), np.float32)
        region_hi = np.empty((nr, 3), np.float32)
        vrange = np.empty((nr, 2), np.float32)
        finest = np.empty(nr, np.float32)
        leaf_list = np.empty(ll, np.int32)
        leaf_begin = np.empty(nr, np.int64)
        leaf_size = np.empty(nr, np.int64)
        axis = np.empty(nt, np.int32)
        split = np.empty(nt, np.float32)
        child = np.empty(nt, np.int32)
        leaf = np.empty(nt, np.int32)
        node_lo = np.empty((nt, 3), np.float32)
        node_hi = np.empty((nt, 3), np.float32)
        lib.exa_regions_copy(
            h, _ptr(region_lo), _ptr(region_hi), _ptr(vrange), _ptr(finest),
            _ptr(leaf_list), _ptr(leaf_begin), _ptr(leaf_size), _ptr(axis),
            _ptr(split), _ptr(child), _ptr(leaf), _ptr(node_lo),
            _ptr(node_hi))
    finally:
        lib.exa_regions_free(h)
    if nchan == 0:
        vrange[:, 0] = np.inf
        vrange[:, 1] = -np.inf

    # the padded brick lists, vectorized (no per-region Python loop)
    max_k = int(leaf_size.max()) if nr else 1
    idx = np.arange(max_k, dtype=np.int64)[None, :]
    valid = idx < leaf_size[:, None]
    pos = np.minimum(leaf_begin[:, None] + idx, max(ll - 1, 0))
    brick_ids = np.where(valid, leaf_list[pos], -1).astype(np.int32)

    regions = Regions(
        domain_lo=region_lo, domain_hi=region_hi, value_range=vrange,
        finest_cw=finest, brick_ids=brick_ids, leaf_list=leaf_list,
        leaf_begin=leaf_begin.astype(np.int32),
        leaf_size=leaf_size.astype(np.int32))
    tree = RegionTree(axis=axis, split=split, child=child, leaf=leaf,
                      node_lo=node_lo, node_hi=node_hi, depth=int(depth))
    return regions, tree
