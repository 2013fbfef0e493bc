"""One frame of the Renderer's fast path, as the port's
``Renderer.enable_fast_path()`` then ``Renderer.render()`` compute it for
a volume without surfaces, clip box or iso surfaces (frozen copy of
``render/renderer.py``'s route choice, jitter, background composite,
accumulation and packing), on top of the frozen sweep."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .camera import Camera, camera_to_voxel, principal_axis, separable_mapping
from .grids import level_grids_from_cells, reorient_grids, rnd
from .shearwarp import inter_dims, setup_shearwarp, warp_image
from .slabs import SlabConfig, render_slabs_camera

JITTER_SEED = 0x51AB
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on Python ints."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _fold_in(key, data: int):
    return _threefry(key[0], key[1], 0, int(data) & _M32)


def _uniform(key) -> float:
    b0, b1 = _threefry(key[0], key[1], 0, 0)
    bits = np.uint32(((b0 ^ b1) >> 9) | 0x3F800000)
    return float(np.float32(bits.view(np.float32) - np.float32(1.0)))


def default_jitter(frame_id: int):
    """The fast path's sub-pixel jitter of a frame, in [-0.5, 0.5)^2 (the
    ``jax.random`` draws of ``fold_in(fold_in(PRNGKey(0x51AB), frame_id),
    0 | 1)``)."""
    key = _fold_in((0, JITTER_SEED), frame_id)
    return (_uniform(_fold_in(key, 0)) - 0.5,
            _uniform(_fold_in(key, 1)) - 0.5)


@dataclass
class FrameInputs:
    """What one frame depends on: the camera (world = voxel space) and
    the transfer function of channel 0."""

    cam_pos: np.ndarray
    cam_dir00: np.ndarray
    cam_du: np.ndarray
    cam_dv: np.ndarray
    xf_lut: np.ndarray  # (1, 128, 4)
    xf_domain: np.ndarray  # (1, 2)
    xf_opacity_scale: np.float32
    dt: np.float32
    frame_id: int = 0


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    return torch.where(
        x <= 0.0031308, 12.92 * x,
        1.055 * torch.pow(torch.clamp(x, min=1e-20), 1 / 2.4) - 0.055)


def pack_rgba8(color_srgb: torch.Tensor) -> torch.Tensor:
    """(P, 3) float -> (P,) RGBA8 words."""
    c = torch.clamp((color_srgb * 256.0).to(torch.int32), 0, 255).to(
        torch.int64)
    return c[:, 0] | (c[:, 1] << 8) | (c[:, 2] << 16) | 0xFF000000


class ReferenceRenderer:
    """The reference's frames of one scene: level grids built from the
    cells per sweep axis at first need, then the route the fast path
    takes (aligned, shear-warp or the reorientation preview)."""

    # the RenderConfig fields this reference computes, at the only values
    # it models; a configuration that sets another needs a reference
    # module of its own (``render.reference``)
    MODELS = {"num_channels": 1, "adaptive_stride": True}

    def __init__(self, cells, width: int, height: int, device,
                 bf16: bool = False, render_config=None):
        for k, v in (render_config or {}).items():
            if self.MODELS.get(k, object()) != v:
                raise ValueError(f"the fast-path reference does not model "
                                 f"RenderConfig {k}={v!r}")
        self.lower, self.level, scal = cells
        self.scalars = np.asarray(scal, np.float32).reshape(
            -1, self.lower.shape[0])
        self.width, self.height = width, height
        self.device = torch.device(device)
        self.bf16 = bf16
        self.voxel_from_world = np.zeros((3, 4), np.float32)
        self.voxel_from_world[:, :3] = np.eye(3)
        self._grids = {}

    def grids(self, axis: int):
        if axis not in self._grids:
            self._grids[axis] = level_grids_from_cells(
                self.lower, self.level, self.scalars, axis, self.device,
                bf16=self.bf16)
        return self._grids[axis]

    def _slab_config(self, grids, fi: FrameInputs) -> SlabConfig:
        extent = float(grids.bounds_hi[0] - grids.bounds_lo[0])
        finest = float(min(1 << l for l in grids.levels))
        nslabs = int(np.ceil(extent / (float(fi.dt) * finest)))
        return SlabConfig(num_channels=1, nslabs=nslabs,
                          adaptive_stride=True)

    def _pick_shearwarp(self, cam_v):
        d00 = np.asarray(cam_v.dir00, np.float64)
        du = np.asarray(cam_v.dir_du, np.float64)
        dv = np.asarray(cam_v.dir_dv, np.float64)
        corners = np.stack([
            d00 + u * du + v * dv
            for u, v in ((0.0, 0.0), (self.width, 0.0),
                         (0.0, self.height), (self.width, self.height))
        ])
        rn = np.linalg.norm(corners, axis=1)
        scores = np.empty(3)
        for axis in range(3):
            ra = corners[:, axis]
            if np.any(ra > 0) and np.any(ra < 0):
                scores[axis] = -np.inf
            else:
                scores[axis] = float(np.min(np.abs(ra) / rn))
        iw, ih = inter_dims(self.width, self.height)
        for axis in np.argsort(-scores):
            if not np.isfinite(scores[axis]):
                break
            sw = setup_shearwarp(cam_v, int(axis), self.width, self.height,
                                 iw, ih)
            if sw is not None:
                return int(axis), sw
        return None

    def route(self, fi: FrameInputs):
        """("aligned", axis), ("shearwarp", axis) or ("reorient", 2)."""
        cam = camera_to_voxel(Camera(fi.cam_pos, fi.cam_dir00, fi.cam_du,
                                     fi.cam_dv), self.voxel_from_world)
        view = np.asarray(cam.dir00) + 0.5 * (
            self.width * np.asarray(cam.dir_du)
            + self.height * np.asarray(cam.dir_dv))
        axis = principal_axis(view)
        if separable_mapping(cam, axis) is not None:
            return ("aligned", axis), cam, None
        pick = self._pick_shearwarp(cam)
        if pick is not None:
            return ("shearwarp", pick[0]), cam, pick[1]
        return ("reorient", 2), cam, None

    def color(self, fi: FrameInputs) -> torch.Tensor:
        """The frame's linear color (P, 3) before accumulation."""
        (kind, axis), cam_v, shear = self.route(fi)
        jx, jy = default_jitter(int(fi.frame_id))
        w, h = self.width, self.height
        if kind == "reorient":
            grids, cam = reorient_grids(self.grids(2), cam_v, bf16=self.bf16)
        else:
            grids, cam = self.grids(axis), cam_v
        scfg = self._slab_config(grids, fi)
        lattice = None
        if shear is not None:
            lattice = shear.lattice(jx, jy)
            cam = shear.camera
            w, h = shear.width, shear.height
        else:
            cam = Camera(pos=cam.pos,
                         dir00=cam.dir00 + jx * cam.dir_du + jy * cam.dir_dv,
                         dir_du=cam.dir_du, dir_dv=cam.dir_dv)
        rgba = render_slabs_camera(grids, fi, scfg, cam, w, h,
                                   lattice=lattice, bf16=self.bf16)
        # the background is black: composite_background(rgba, 0)
        wgt = rgba[:, 3:4]
        color = wgt * rgba[:, :3] + (1.0 - wgt) * torch.zeros(
            3, dtype=torch.float32, device=rgba.device)
        if shear is not None:
            color = rnd(warp_image(color, shear, self.width, self.height,
                                   jx=0.5 + jx, jy=0.5 + jy, shift_i=jx,
                                   shift_j=jy), self.bf16)
        return color

    def frame_words(self, fi: FrameInputs) -> np.ndarray:
        """The frame's (H, W) uint32 RGBA8 words at accumulation frame 0,
        as ``Renderer.render()`` returns them."""
        if int(fi.frame_id) != 0:
            raise ValueError("the reference renders accumulation frame 0")
        shown = linear_to_srgb(self.color(fi) / 1.0)
        words = pack_rgba8(shown).cpu().numpy().astype(np.uint32)
        return words.reshape(self.height, self.width)
