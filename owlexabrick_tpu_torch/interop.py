"""Carry state over from the JAX package.

The reference's ``Scene``, ``LevelGrids``, ``FrameState``, ``ShearWarp``,
``SurfaceData`` and ``WavefrontPack`` fields, read as numpy arrays, become
the port's objects,
so tests can run both packages from the same state (the renderer's
analog of loading a reference model's weights).  Works on the
reference objects without importing ``jax``: every field is read
through ``numpy.asarray``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.types import Scene
from .render.camera import Camera
from .render.frame import FrameState
from .render.shearwarp import ShearWarp
from .render.slabs import LevelGrids, render_device
from .render.surfaces import SurfaceData
from .render.wavefront import WavefrontPack, pack_from_tables


def level_grids_from_reference(ref, device="cuda") -> LevelGrids:
    """The reference's ``LevelGrids`` (numpy or device arrays) as the
    port's, on ``device`` (the card unless the caller asks for the
    CPU)."""
    device = render_device(device)

    def t(a):
        return torch.from_numpy(
            np.ascontiguousarray(np.asarray(a, np.float32))).to(device)

    return LevelGrids(
        vals=tuple(t(v) for v in ref.vals),
        masks=tuple(t(m) for m in ref.masks),
        origins=tuple(np.asarray(o, np.float32) for o in ref.origins),
        zranges=t(ref.zranges),
        bounds_lo=np.asarray(ref.bounds_lo, np.float32),
        bounds_hi=np.asarray(ref.bounds_hi, np.float32),
        vrange_zy=tuple(t(v) for v in ref.vrange_zy),
        levels=tuple(int(l) for l in ref.levels),
        num_channels=int(ref.num_channels),
        axis=int(ref.axis),
        y_bin=tuple(int(b) for b in ref.y_bin),
    )


def frame_state_from_reference(ref) -> FrameState:
    """The reference's ``FrameState`` as the port's (host numpy)."""
    kw = {}
    for f in dataclasses.fields(FrameState):
        v = np.asarray(getattr(ref, f.name))
        kw[f.name] = v if v.ndim else v[()]
    return FrameState(**kw)


def shearwarp_from_reference(ref) -> ShearWarp:
    """The reference's ``ShearWarp`` factorization as the port's (host
    numpy and floats), so both packages' warps can take one
    factorization."""
    cam = ref.camera
    return ShearWarp(
        camera=Camera(*(np.asarray(v, np.float32) for v in (
            cam.pos, cam.dir00, cam.dir_du, cam.dir_dv))),
        width=int(ref.width), height=int(ref.height),
        hom=np.asarray(ref.hom, np.float64), axis=int(ref.axis),
        sign=float(ref.sign), u_lo=float(ref.u_lo),
        u_step=float(ref.u_step),
        coef_u=tuple(float(c) for c in ref.coef_u), v_lo=float(ref.v_lo),
        v_step=float(ref.v_step),
        coef_v=tuple(float(c) for c in ref.coef_v),
        screen=tuple(int(s) for s in ref.screen),
    )


def surface_data_from_reference(ref, device="cuda") -> SurfaceData:
    """The reference's ``SurfaceData`` (meshes and streamline segments)
    as the port's, on ``device`` (the card unless the caller asks for
    the CPU)."""
    return SurfaceData.from_arrays(
        *(np.asarray(getattr(ref, k)) for k in (
            "tri_v0", "tri_e1", "tri_e2", "tri_n", "seg_a", "seg_b",
            "seg_t", "seg_radius")), device=device)


def scene_from_reference(ref, device="cuda") -> Scene:
    """The reference's exact ``Scene`` (bricks, scalars, regions, BSP
    tree, bounds) as the port's, on ``device`` (the card unless the
    caller asks for the CPU)."""
    return Scene.from_arrays(render_device(device), **{
        f.name: getattr(ref, f.name) if f.name in (
            "num_channels", "max_bricks_per_region", "tree_depth")
        else np.asarray(getattr(ref, f.name))
        for f in dataclasses.fields(Scene)})


def pack_from_reference(ref, grids, device="cuda") -> WavefrontPack:
    """The reference's ``WavefrontPack`` as the port's, on ``device`` (the
    card unless the caller asks for the CPU): its node table, start grid
    and their geometry as they are, and the sampling data from the
    reference's axis-2 ``LevelGrids`` ``grids`` (the port's pack holds
    grids where the reference's holds its row tables)."""
    if (tuple(ref.level_cw) != tuple(float(1 << l) for l in grids.levels)
            or ref.num_channels != grids.num_channels):
        raise ValueError("the grids are not the ones the pack was built on")
    return pack_from_tables(
        np.asarray(ref.node_pack), np.asarray(ref.start_grid), ref.grid_org,
        ref.grid_cw, ref.grid_dims, ref.descent,
        level_grids_from_reference(grids, device))
