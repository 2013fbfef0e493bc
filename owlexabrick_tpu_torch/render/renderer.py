"""High-level renderer (the port of ``owlexabrick_tpu/render/renderer.py``):
owns the exact scene or the cells, the level grids, the surfaces, the
frame state and the accumulation buffer, and renders progressive frames.

Without ``enable_fast_path()`` a frame is the exact one: jittered
per-pixel rays, the surface pass (meshes, streamlines, contour planes,
the exact iso march and their AO, ``surfaces.trace_surface_pass``), the
clip box, the region march and accumulation.  The march takes the JAX
Renderer's route (its ``render``, renderer.py:934-960): the packed march
(``wavefront.trace_dvr_packed_compacted``, or ``render_step_packed``
with ``RenderConfig.wavefront_compaction`` off) whenever the config
samples the basis without gradient shading and the scene's pack builds
(``wavefront.build_pack`` refuses past 2^24 node or region ids), else
``render_step`` (``dvr.trace_dvr``).  ``exact_route`` names the route of
the last exact frame.

``enable_fast_path()`` switches to the slab sweep (``render_slabs_camera``):
an axis-aligned camera directly, any other through shear-warp (an
axis-aligned lattice camera plus the two-pass warp), and a frustum no
axis can factorize through the ``reorient_grids`` preview.  The clip box
(``set_clip_box``) and DVR gradient shading
(``RenderConfig.gradient_shading_dvr``) take the sweep's einsum lane;
the clip box becomes a per-pixel sweep interval (``clip_interval``).
Iso surfaces (``RenderConfig.iso_surfaces``, ``update_iso_values``)
take the iso sweep (``render_slabs_iso_camera``): its shaded hits are
the background and its hit depth stops the volume (K1's surface stop).
Meshes, streamline segments (``surfaces=``) and contour planes
(``update_contour_planes``) are traced on the sweep's own rays
(``surfaces.trace_surface_pass``, with its dense geometric AO): the
nearest of them and the iso hits is the background and stops the
volume.  AO over gradient-shaded iso hits takes the lattice estimator
(``ao_sweep.ao_shadow_fast``), alone (``ao_fast``) or OR-ed with the
geometric occluders (``ao_combined``), or with ``ao_exact`` hemisphere
rays against the exact surfaces (``_ao_shadow_exact``).

A Renderer is made from a ``Scene`` (the JAX signature) or from cells;
a cells-built one builds its scene at first need (the exact frame, a
contour plane, ``ao_exact``) through ``pipeline.scene_from_cells``, and
its fast-path grids straight from the cells.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..core.types import Scene
from ..pipeline import scene_from_cells
from ..utils import profiling
from . import prng, wavefront
from .ao_sweep import ao_shadow_fast, build_ao_lattice, lattice_to
from .camera import Camera
from .dvr import (RenderConfig, _dot3, accumulate, composite_background,
                  generate_rays, pack_rgba8, ray_box, trace_dvr)
from .frame import FrameState, make_frame_state, with_camera
from .shearwarp import inter_dims, setup_shearwarp, warp_image
from .slabs import (
    SlabConfig,
    _sqrt_rn,
    build_level_grids,
    camera_to_voxel,
    check_separable,
    level_grids_from_cells,
    permute_camera,
    principal_axis,
    render_device,
    render_slabs_camera,
    render_slabs_iso_camera,
    reorient_grids,
)
from .scene import scene_bricks
from .surfaces import SurfaceData, _nearest_surface, _onb, trace_surface_pass


JITTER_SEED = 0x51AB
# the exact frame's seed (the JAX package's render_step)
EXACT_SEED = 0x9E3779B9


def default_jitter(frame_id: int) -> Tuple[float, float]:
    """Per-frame sub-pixel jitter in [-0.5, 0.5)^2, the JAX Renderer's
    bit for bit (renderer.py:453-458): two ``uniform`` draws from
    ``fold_in(fold_in(PRNGKey(0x51AB), frame_id), 0 | 1)``."""
    key = prng.fold_in(prng.prng_key(JITTER_SEED), frame_id)
    return (float(prng.uniform_f32(prng.fold_in(key, 0))) - 0.5,
            float(prng.uniform_f32(prng.fold_in(key, 1))) - 0.5)


def _f32s(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-20)


def _full(p: int, v, dev) -> torch.Tensor:
    return torch.full((p,), float(np.float32(v)), dtype=torch.float32,
                      device=dev)


def sweep_rays_world(axis: int, cam: Camera, lattice, width: int,
                     height: int, voxel_from_world, device="cuda"):
    """Per-pixel world ray directions matching the sweep's
    parameterization (the JAX Renderer's ``_sweep_rays_world``), built on
    ``device`` in the reference's float32 operations.  The sweep advances
    p = o + s r along the voxel-frame ray r of ``cam`` (or of the
    shear-warp ``lattice`` ((W,), (H,)) with ``cam``'s sweep component); a
    world hit at t along the unit direction is the sweep parameter
    s = t / |r_w|.  Returns (d_unit (P, 3), rnorm (P,)) float32."""
    dev = render_device(device)
    if lattice is not None:
        _, dir00, _, _ = permute_camera(cam, axis)
        # grid-frame components (sweep, y, x) back to voxel (x, y, z)
        perm = (axis, *[a for a in (2, 1, 0) if a != axis])
        comps = (_f32s(dir00[0], dev).expand(height, width),
                 _f32s(lattice[1], dev)[:, None].expand(height, width),
                 _f32s(lattice[0], dev)[None, :].expand(height, width))
        rv = torch.stack([comps[perm.index(a)] for a in range(3)], -1)
    else:
        i = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
        j = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
        rv = (_f32s(cam.dir00, dev)[None, None]
              + i[None, :, None] * _f32s(cam.dir_du, dev)[None, None]
              + j[:, None, None] * _f32s(cam.dir_dv, dev)[None, None])
    r = np.asarray(voxel_from_world)[:, :3]
    dw = rv.reshape(-1, 3) @ _f32s(np.linalg.inv(r).T, dev)
    sq = dw * dw
    # the square root in double, rounded once: correctly rounded like
    # numpy's float32 sqrt, which torch's float32 sqrt on the CPU is not
    rnorm = torch.sqrt((sq[:, 0] + sq[:, 1] + sq[:, 2]).double()).float()
    return dw / rnorm[:, None], rnorm


def clip_interval(axis: int, cam: Camera, lattice, width: int, height: int,
                  voxel_from_world, eye_world, clip_lo, clip_hi,
                  device="cuda", t_stop=None):
    """The clip box's sweep interval per pixel of a render (the JAX
    Renderer's clip, renderer.py:801-817; clipRay, exabrick.cu:
    1258-1264): the world rays of ``sweep_rays_world`` from
    ``eye_world`` against the world-space box [clip_lo, clip_hi] over
    [0, 2e10], or over [0, t_stop * |r_w|] where a surface's (P,) sweep
    parameter ``t_stop`` already ends the volume, as sweep parameters.
    Returns (t_start, t_stop), each (P,) float32 on ``device``: inf and
    0 where a ray misses the box."""
    dev = render_device(device)
    d_unit, rnorm = sweep_rays_world(axis, cam, lattice, width, height,
                                     voxel_from_world, dev)
    p = rnorm.shape[0]
    t_end = (torch.full((p,), 2e10, dtype=torch.float32, device=dev)
             if t_stop is None else torch.as_tensor(t_stop).to(dev) * rnorm)
    hit, c0, c1 = ray_box(_f32s(eye_world, dev), d_unit,
                          _f32s(clip_lo, dev), _f32s(clip_hi, dev),
                          torch.zeros(p, dtype=torch.float32, device=dev),
                          t_end)
    t_start = torch.where(hit, c0, float("inf")) / rnorm
    t_stop = torch.where(hit, c1, 0.0) / rnorm
    return t_start, t_stop


def render_step(scene, fs: FrameState, surf: SurfaceData, accum, *,
                cfg: RenderConfig, width: int, height: int):
    """One progressive exact frame (the JAX package's ``render_step``):
    jittered rays -> surfaces -> clip box -> DVR -> background composite
    -> accumulation, on the scene's device.  Returns (new_accum (P, 4),
    RGBA8 words (P,) int64, display color (P, 3))."""
    return _exact_frame(scene, fs, surf, accum, cfg, width, height,
                        trace_dvr)


def render_step_packed(pack, scene, fs: FrameState, surf: SurfaceData,
                       accum, *, cfg: RenderConfig, width: int,
                       height: int):
    """``render_step`` with the packed march (``wavefront.trace_dvr_packed``
    over ``pack``, a ``wavefront.build_pack`` of the scene): the same
    rays, surfaces, clip box and accumulation."""
    def trace(*args, **kw):
        return wavefront.trace_dvr_packed(pack, *args, **kw)

    return _exact_frame(scene, fs, surf, accum, cfg, width, height, trace)


def _exact_frame(scene, fs, surf, accum, cfg, width, height, trace):
    """An exact frame whose DVR is ``trace(scene, fs, cfg, o, d, offset,
    t_end_world=, t_start_world=)``."""
    dev = scene.device
    p = width * height
    key = prng.fold_in(prng.prng_key(EXACT_SEED), int(fs.frame_id))
    jitter = prng.uniform(prng.fold_in(key, 1), (p, 2), dev)
    offset = prng.uniform(prng.fold_in(key, 2), (p,), dev)
    o, d = generate_rays(fs, width, height, jitter, dev)
    # surface pass: meshes, contour planes, iso surfaces
    # (exabrick.cu:1475-1529)
    t_hit, bg = trace_surface_pass(scene, fs, surf, cfg, o, d,
                                   prng.fold_in(key, 3),
                                   screen=(width, height))
    # the clip box shrinks the volume interval (clipRay,
    # exabrick.cu:1258-1264)
    if bool(fs.clip_enabled):
        chit, c0, c1 = ray_box(o, d, _f32s(fs.clip_lo, dev),
                               _f32s(fs.clip_hi, dev),
                               torch.zeros(p, dtype=torch.float32,
                                           device=dev), t_hit)
        t_start = torch.where(chit, c0, float("inf"))
        t_end = torch.where(chit, c1, 0.0)
    else:
        t_start, t_end = torch.zeros_like(t_hit), t_hit
    rgba = trace(scene, fs, cfg, o, d, offset, t_end_world=t_end,
                 t_start_world=t_start)
    color = composite_background(rgba, bg)
    new_accum, shown = accumulate(color, accum, int(fs.frame_id))
    return new_accum, pack_rgba8(shown), shown


class Renderer:
    """Progressive renderer on one device.

    ``source``: an exact ``Scene`` (any device; the Renderer keeps a copy
    on ``device``), or cells: (lower (N, 3) int, level (N,), scalars
    (C, N) or [(N,)] * C), with their ``voxel_from_world`` (identity when
    None; a Scene carries its own).  jitter: ``frame_id -> (jx, jy)``, the
    fast path's per-frame sub-pixel shift (default: ``default_jitter``).
    surfaces: meshes and streamline segments (``SurfaceData`` on
    ``device``), or None for none."""

    # exact AO: over iso hits on the fast path, hemisphere rays against
    # the exact surfaces (_ao_shadow_exact) instead of the lattice
    # estimator
    ao_exact = False
    # run the plain-torch twins of every kernel on the card (the
    # comparison lane, SlabConfig.plain_sweep); read where the slab
    # config is built (enable_fast_path, and each shear-warp frame)
    plain_kernels = False

    def __init__(self, source, width: int = 1024, height: int = 1024,
                 cfg: Optional[RenderConfig] = None,
                 frame_state: Optional[FrameState] = None,
                 voxel_from_world=None, device="cuda",
                 jitter: Optional[Callable[[int], Tuple[float, float]]] = None,
                 surfaces: Optional[SurfaceData] = None):
        self.device = render_device(device)
        self.surf = (surfaces if surfaces is not None
                     else SurfaceData.empty(self.device))
        if isinstance(source, Scene):
            self._lower = None  # no cells: grids come from the scene
            self._scene = source.to(self.device)
            self.voxel_from_world = source.voxel_from_world.cpu().numpy()
            self.world_bounds_lo = source.world_bounds_lo.cpu().numpy()
            self.world_bounds_hi = source.world_bounds_hi.cpu().numpy()
        else:
            self._scene = None
            lower, level, scalars = source
            self._lower = np.asarray(lower)
            self._level = np.asarray(level)
            self._scalars = np.asarray(scalars, np.float32).reshape(
                -1, self._lower.shape[0])
            if voxel_from_world is None:
                voxel_from_world = np.zeros((3, 4), np.float32)
                voxel_from_world[:, :3] = np.eye(3)
            self.voxel_from_world = np.asarray(voxel_from_world, np.float32)
            cw = (1 << self._level.astype(np.int64)).astype(np.float32)
            v_lo = self._lower.astype(np.float32).min(0)
            v_hi = (self._lower.astype(np.float32) + cw[:, None]).max(0)
            m = np.asarray(voxel_from_world, np.float64)
            inv_a = np.linalg.inv(m[:, :3])
            self.world_bounds_lo = (inv_a @ (v_lo - m[:, 3])).astype(
                np.float32)
            self.world_bounds_hi = (inv_a @ (v_hi - m[:, 3])).astype(
                np.float32)
        self.width = width
        self.height = height
        self.cfg = cfg or RenderConfig(num_channels=1)
        self._jitter = jitter or default_jitter
        if frame_state is None:
            cam = Camera.look_at(
                from_=self.world_bounds_hi * 2.0,
                at=0.5 * (self.world_bounds_lo + self.world_bounds_hi),
                up=[0, 1, 0], fovy_degrees=60.0, width=width,
                height=height)
            frame_state = make_frame_state(cam, self.cfg.num_channels)
            frame_state = dataclasses.replace(
                frame_state, clip_lo=self.world_bounds_lo.copy(),
                clip_hi=self.world_bounds_hi.copy())
        self.fs = frame_state
        self._grids_cache = {}
        self._pack = None
        self.exact_route = None
        self._ao_lat = None
        self._fast = None
        self._cam_cache = None
        self._last_pose = None
        self._last_pose_grids = None
        self.frames_rendered = 0  # render() calls, the frame spans' id
        self.reset_accumulation()

    @property
    def scene(self) -> Scene:
        """The exact scene on the render device: the one given, or (a
        cells-built Renderer) built at first use through
        ``pipeline.scene_from_cells`` with the native core."""
        if self._scene is None:
            self._scene = scene_from_cells(
                self._lower, self._level, list(self._scalars),
                voxel_from_world=self.voxel_from_world,
                device=self.device)[0]
        return self._scene

    # -- state updates (each resets accumulation, exa/viewer.cpp:257-260)
    def reset_accumulation(self):
        self.accum = torch.zeros((self.width * self.height, 4),
                                 dtype=torch.float32, device=self.device)
        self.fs = dataclasses.replace(self.fs, frame_id=np.int32(0))

    def update_camera(self, camera: Camera):
        self.fs = with_camera(self.fs, camera)
        self.reset_accumulation()

    def update_xf(self, channel: int, colors, opacities, domain,
                  opacity_scale: float = 1.0):
        lut = np.asarray(self.fs.xf_lut).copy()
        lut[channel, :, :3] = colors
        lut[channel, :, 3] = opacities
        dom = np.asarray(self.fs.xf_domain).copy()
        dom[channel] = domain
        self.fs = dataclasses.replace(
            self.fs, xf_lut=lut, xf_domain=dom,
            xf_opacity_scale=np.float32(opacity_scale))
        self.reset_accumulation()

    def update_dt(self, dt: float):
        self.fs = dataclasses.replace(self.fs, dt=np.float32(dt))
        self.reset_accumulation()

    def update_iso_values(self, values, channels, enabled):
        self.fs = dataclasses.replace(
            self.fs, iso_value=np.asarray(values, np.float32),
            iso_channel=np.asarray(channels, np.int32),
            iso_enabled=np.asarray(enabled, bool))
        self.reset_accumulation()

    def update_contour_planes(self, normals, offsets, channels, enabled):
        """Contour planes: unit ``normals`` (3, 3) (normalized here),
        ``offsets`` fractional in the world bounds box, the ``channels``
        that color them, and which are ``enabled``."""
        n = np.asarray(normals, np.float32)
        n = n / np.linalg.norm(n, axis=-1, keepdims=True)
        self.fs = dataclasses.replace(
            self.fs, contour_normal=n,
            contour_offset=np.asarray(offsets, np.float32),
            contour_channel=np.asarray(channels, np.int32),
            contour_enabled=np.asarray(enabled, bool))
        self.reset_accumulation()

    def set_clip_box(self, enabled: bool, lo=None, hi=None):
        """Enable or disable the world-space clip box [lo, hi] (each
        kept when None)."""
        self.fs = dataclasses.replace(
            self.fs, clip_enabled=np.bool_(enabled),
            clip_lo=(np.asarray(lo, np.float32) if lo is not None
                     else self.fs.clip_lo),
            clip_hi=(np.asarray(hi, np.float32) if hi is not None
                     else self.fs.clip_hi))
        self.reset_accumulation()

    def resize(self, width: int, height: int):
        """A new image size; the camera products cached for the old size
        go with it."""
        self.width = width
        self.height = height
        self._cam_cache = None
        self._last_pose = None
        self._last_pose_grids = None
        self.reset_accumulation()

    # -- fast (slab-sweep) path ------------------------------------------
    def _camera_from_fs(self) -> Camera:
        return Camera(pos=np.asarray(self.fs.cam_pos),
                      dir00=np.asarray(self.fs.cam_dir00),
                      dir_du=np.asarray(self.fs.cam_du),
                      dir_dv=np.asarray(self.fs.cam_dv))

    def _grids_for(self, axis: int):
        """Level grids for a sweep axis, built once per axis: from the
        scene's bricks (the JAX package's ``grids_from_scene``) or from
        the cells."""
        if axis not in self._grids_cache:
            if self._lower is not None:
                grids = level_grids_from_cells(
                    self._lower, self._level, self._scalars, axis=axis,
                    device=self.device)
            else:
                grids = build_level_grids(*scene_bricks(self._scene),
                                          axis=axis, device=self.device)
            self._grids_cache[axis] = grids
        return self._grids_cache[axis]

    def _ao_modes(self):
        """(ao_combined, ao_fast): AO over meshes or streamlines with iso
        occluders under one pooled-direction estimator, or the lattice
        estimator alone over gradient-shaded iso hits (the JAX
        Renderer's, renderer.py:547-554).  Geometric AO without iso
        surfaces runs inside the surface pass."""
        cfg, surf = self.cfg, self.surf
        combined = (cfg.ao_samples > 0 and cfg.iso_surfaces
                    and (surf.num_tris > 0 or surf.num_segments > 0))
        fast = (cfg.ao_samples > 0 and cfg.iso_surfaces
                and cfg.gradient_shading_iso and not combined)
        return combined, fast

    def _ao_lattice_dev(self):
        """The finest-lattice AO field of the axis-2 level grids, built
        once on the host (``build_ao_lattice``) and kept on the
        device."""
        if self._ao_lat is None:
            self._ao_lat = lattice_to(build_ao_lattice(self._grids_for(2)),
                                      self.device)
        return self._ao_lat

    def _slab_config(self, grids) -> SlabConfig:
        """Slab spacing = dt * finest cell width over the sweep extent
        (integrateBrick's dt, exabrick.cu:1129)."""
        extent = float(grids.bounds_hi[0] - grids.bounds_lo[0])
        finest = float(min(1 << l for l in grids.levels))
        nslabs = int(np.ceil(extent / (float(self.fs.dt) * finest)))
        return SlabConfig(num_channels=self.cfg.num_channels, nslabs=nslabs,
                          gradient_shading_dvr=self.cfg.gradient_shading_dvr,
                          gradient_shading_iso=self.cfg.gradient_shading_iso,
                          colormap_channel=self.cfg.colormap_channel,
                          adaptive_stride=self.cfg.adaptive_stride,
                          plain_sweep=self.plain_kernels)

    @staticmethod
    def _grid_to_voxel_normals(n_grid: torch.Tensor, axis: int):
        """(P, 3) grid-frame (z, y, x) normals -> voxel (x, y, z)."""
        perm = (axis, *[a for a in (2, 1, 0) if a != axis])
        return torch.stack([n_grid[:, perm.index(a)] for a in range(3)], 1)

    def enable_fast_path(self) -> bool:
        """Switch to the slab-sweep path: an axis-aligned camera sweeps
        directly, any other through shear-warp, and a frustum that no
        axis can factorize through the reorientation preview.  Returns
        True when active."""
        cam = camera_to_voxel(self._camera_from_fs(), self.voxel_from_world)
        view = np.asarray(cam.dir00) + 0.5 * (
            self.width * np.asarray(cam.dir_du)
            + self.height * np.asarray(cam.dir_dv))
        axis = principal_axis(view)
        if check_separable(cam, axis):
            grids = self._grids_for(axis)
            cam_r = None  # the plain voxel-space camera sweeps directly
        else:
            pick = self._pick_shearwarp(cam)
            if pick is not None:
                grids = self._grids_for(pick[0])
                cam_r = "shearwarp"
            else:
                grids, cam_r = reorient_grids(self._grids_for(2), cam)
        self._fast = (grids, self._slab_config(grids), cam_r)
        return True

    def _pick_shearwarp(self, cam_v):
        """Least-oblique shear-warp factorization of a voxel-frame camera:
        axes scored by the worst corner-ray alignment min |r_axis| / |r|
        (a sign change scores -inf) and tried best-first.  Returns
        (axis, ShearWarp), or None when every axis fails."""
        d00 = np.asarray(cam_v.dir00, np.float64)
        du = np.asarray(cam_v.dir_du, np.float64)
        dv = np.asarray(cam_v.dir_dv, np.float64)
        corners = np.stack([
            d00 + u * du + v * dv
            for u, v in ((0.0, 0.0), (self.width, 0.0),
                         (0.0, self.height), (self.width, self.height))
        ])  # (4, 3) voxel (x, y, z)
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

    def _surfaces_and_iso(self, grids, scfg, cam, lattice, rw: int,
                          rh: int):
        """The frame's surfaces on the sweep's own rays (the JAX
        Renderer's _render_fast, renderer.py:532-817): meshes,
        streamlines and contour planes (traceSurfaces,
        exabrick.cu:1475-1529), the iso sweep, AO, and the clip box.  Returns (bg (3,) or (P, 3), t_start,
        t_stop): the shaded background and the volume's sweep interval
        (None: unbounded)."""
        fs, cfg, surf, dev = self.fs, self.cfg, self.surf, self.device
        p = rw * rh
        key = prng.fold_in(prng.prng_key(JITTER_SEED), int(fs.frame_id))
        bg = torch.zeros(3, dtype=torch.float32, device=dev)
        t_start = t_stop = t_surf = geom = None
        contours = bool(np.any(fs.contour_enabled))
        need_surf = surf.num_tris > 0 or surf.num_segments > 0 or contours
        # the exact scene colors the contour planes (and marches the iso
        # surfaces for their AO rays)
        scene = self.scene if contours else None
        clip = bool(fs.clip_enabled)
        ao_combined, ao_fast = self._ao_modes()
        if need_surf or clip or ao_fast or ao_combined:
            d_unit, rnorm = sweep_rays_world(grids.axis, cam, lattice, rw, rh,
                                             self.voxel_from_world, dev)
            o_w = _f32s(fs.cam_pos, dev).expand(p, 3)

        if need_surf and ao_combined:
            # shading waits for the combined AO shadow below
            t_g, n_w_g, base_g, amb_g, _ = _nearest_surface(
                scene, fs, surf, cfg, o_w, d_unit, _full(p, 1e-6, dev),
                _full(p, 2e10, dev),
                include_contours=contours, include_iso=False,
                current_timestep=fs.tracer_timestep, screen=(rw, rh))
            t_w = torch.where(torch.isfinite(t_g), t_g, 2e10)
            geom = (t_w / rnorm, n_w_g, base_g, amb_g)
            t_surf = t_stop = geom[0]
            bg = torch.zeros((p, 3), dtype=torch.float32, device=dev)
        elif need_surf:
            t_w, bg = trace_surface_pass(
                scene, fs, surf, cfg, o_w, d_unit, prng.fold_in(key, 3),
                include_iso=False, include_contours=contours,
                screen=(rw, rh))
            t_surf = t_stop = t_w / rnorm  # world t -> sweep scale

        if cfg.iso_surfaces:
            # the iso sweep: its hit depth caps the volume interval
            # (integrateVolume t1 = min(t1, surface t), exabrick.cu:
            # 1675-1680); the nearest of iso and geometry is the
            # background (traceSurfaces' comparator)
            want_n = cfg.gradient_shading_iso or ao_fast or ao_combined
            out = render_slabs_iso_camera(grids, fs, scfg, cam, rw, rh,
                                          lattice=lattice,
                                          return_normals=want_n)
            iso_rgba, t_iso = out[0], out[1]
            iso_bg = iso_rgba[:, :3] * iso_rgba[:, 3:4]
            if want_n:
                # raygen surface shading (exabrick.cu:1644-1650): the
                # shaded base color scaled by |dir . Ng| * (1 - AO shadow)
                n_vox = self._grid_to_voxel_normals(out[2], grids.axis)
                has_n = torch.linalg.norm(n_vox, dim=-1) > 0.0
                cosf = out[3]
                shadow = torch.zeros(p, dtype=torch.float32, device=dev)
                if ao_fast:
                    hit_w = o_w + (t_iso * rnorm)[:, None] * d_unit
                    if self.ao_exact:
                        # hemisphere rays against the exact surfaces
                        shadow = self._ao_shadow_exact(
                            hit_w, _unit(n_vox @ _f32s(
                                self.voxel_from_world[:, :3], dev)),
                            prng.fold_in(key, 7), rw, rh)
                    else:
                        shadow = ao_shadow_fast(
                            self._ao_lattice_dev(), fs,
                            self._to_voxel(hit_w).flip(-1), n_vox.flip(-1),
                            prng.fold_in(key, 7), ao_samples=cfg.ao_samples,
                            ao_dirs=cfg.ao_dirs)
                        if not bool(fs.ao_enabled):
                            shadow = torch.zeros_like(shadow)
                if cfg.gradient_shading_iso and not ao_combined:
                    iso_bg = torch.where(
                        has_n[:, None],
                        iso_bg * (cosf * (1.0 - shadow))[:, None], iso_bg)
            if t_surf is None:
                bg, t_stop = iso_bg, t_iso
            else:
                iso_wins = t_iso < t_surf
                bg = torch.where(iso_wins[:, None], iso_bg, bg)
                t_stop = torch.minimum(t_iso, t_surf)
            if ao_combined:
                bg = self._ao_combined(geom, t_iso, iso_wins, iso_bg, n_vox,
                                       has_n, cosf, o_w, d_unit, rnorm, key,
                                       rw, rh)

        if clip:
            # the clip box shrinks the volume interval only (clipRay,
            # exabrick.cu:1258-1264); surfaces render unclipped
            t_start, t_stop = clip_interval(
                grids.axis, cam, lattice, rw, rh, self.voxel_from_world,
                fs.cam_pos, fs.clip_lo, fs.clip_hi, dev, t_stop=t_stop)
        return bg, t_start, t_stop

    def _to_voxel(self, pts_w):
        """(P, 3) world points (row vectors) -> voxel space."""
        m = self.voxel_from_world
        return pts_w @ _f32s(m[:, :3].T, pts_w.device) + _f32s(
            m[:, 3], pts_w.device)

    def _ao_combined(self, geom, t_iso, iso_wins, iso_bg, n_vox, has_n, cosf,
                     o_w, d_unit, rnorm, key, rw: int, rh: int):
        """AO over the visible surface, iso or geometry (the JAX
        Renderer's ao_combined, renderer.py:706-799; raygen AO against
        all surfaces but contour planes, exabrick.cu:1612-1645): lattice
        shadow volumes give the iso occlusion, the traced meshes and
        streamlines along the same per-pixel pool directions the
        geometric occlusion.  Returns the shaded background (P, 3)."""
        fs, cfg, surf, dev = self.fs, self.cfg, self.surf, self.device
        p = rw * rh
        t_sw_g, n_w_g, base_g, amb_g = geom
        m3 = _f32s(self.voxel_from_world[:, :3], dev)
        minv = _f32s(np.linalg.inv(
            np.asarray(self.voxel_from_world, np.float64)[:, :3]), dev)

        pos_w = o_w + (torch.minimum(t_iso, t_sw_g) * rnorm)[:, None] * d_unit
        # winner normals, world and voxel frames (row vectors: n_vox =
        # n_w @ inv(M), n_w = n_vox @ M)
        wins = iso_wins[:, None]
        n_w_eff = torch.where(wins, _unit(n_vox @ m3), n_w_g)
        n_vox_eff = torch.where(wins, n_vox, _unit(n_w_g @ minv))
        origin = pos_w + n_w_eff * 1e-3

        def occ_geom(d_pix):
            # d_pix: (P, 3) grid zyx -> world direction
            d_w = _unit(d_pix.flip(-1) @ minv.T)
            at = _nearest_surface(
                None, fs, surf, cfg, origin, d_w, _full(p, 1e-4, dev),
                _full(p, fs.ao_length, dev),
                include_contours=False, include_iso=False,
                current_timestep=fs.tracer_timestep, screen=(rw, rh))[0]
            return torch.isfinite(at).to(torch.float32)

        if self.ao_exact:
            shadow = self._ao_shadow_exact(pos_w, n_w_eff,
                                           prng.fold_in(key, 7), rw, rh)
        else:
            shadow = ao_shadow_fast(
                self._ao_lattice_dev(), fs, self._to_voxel(pos_w).flip(-1),
                n_vox_eff.flip(-1), prng.fold_in(key, 7),
                ao_samples=cfg.ao_samples, geom_occluder=occ_geom,
                ao_dirs=cfg.ao_dirs)
            if not bool(fs.ao_enabled):
                shadow = torch.zeros_like(shadow)
        iso_shaded = iso_bg
        if cfg.gradient_shading_iso:
            iso_shaded = torch.where(
                has_n[:, None], iso_bg * (cosf * (1.0 - shadow))[:, None],
                iso_bg)
        has_n_g = torch.linalg.norm(n_w_g, dim=-1) > 0.0
        shade_g = amb_g[:, None] + base_g * (
            (d_unit * n_w_g).sum(-1).abs() * (1.0 - shadow))[:, None]
        bg_g = torch.where((t_sw_g < 1e9)[:, None],
                           torch.where(has_n_g[:, None], shade_g, base_g), 0.0)
        return torch.where(wins, iso_shaded, bg_g)

    def _ao_shadow_exact(self, pos_w, n_w, key, rw: int, rh: int):
        """Progressive exact AO (the JAX Renderer's, renderer.py:337-380):
        ``cfg.ao_samples`` cosine-hemisphere rays per pixel per frame from
        pos_w (P, 3) about the unit normals n_w, each tested against the
        exact surfaces (meshes, streamlines and, with iso surfaces on,
        the exact iso march) over [1e-4, ao_length] — the reference's
        own estimator (exabrick.cu:1612-1645), amortized into the
        progressive accumulation.  Returns the shadow (P,), 0 where
        ``fs.ao_enabled`` is off."""
        fs, cfg, dev = self.fs, self.cfg, pos_w.device
        p = pos_w.shape[0]
        u, v = _onb(n_w)
        origin = pos_w + n_w * 1e-3
        hits = torch.zeros(p, dtype=torch.float32, device=dev)
        for s in range(cfg.ao_samples):
            r = prng.uniform(prng.fold_in(key, s), (p, 2), dev)
            rr = _sqrt_rn(r[:, 0])
            theta = 2.0 * math.pi * r[:, 1]
            dir_ = ((rr * torch.cos(theta))[:, None] * u
                    + (rr * torch.sin(theta))[:, None] * v
                    + _sqrt_rn(1.0 - r[:, 0])[:, None] * n_w)
            dir_ = dir_ / torch.clamp(_sqrt_rn(_dot3(dir_, dir_)),
                                      min=1e-20)[:, None]
            at = _nearest_surface(
                self.scene, fs, self.surf, cfg, origin, dir_,
                _full(p, 1e-4, dev), _full(p, fs.ao_length, dev),
                include_contours=False, include_iso=cfg.iso_surfaces,
                current_timestep=fs.tracer_timestep, screen=(rw, rh))[0]
            hits = hits + torch.isfinite(at).to(torch.float32)
        if not bool(fs.ao_enabled):
            return torch.zeros_like(hits)
        return hits / cfg.ao_samples

    def _render_fast(self) -> np.ndarray:
        grids, scfg, cam_r = self._fast
        jx, jy = self._jitter(int(self.fs.frame_id))
        shear = None
        lattice = None
        rw, rh = self.width, self.height
        if cam_r == "shearwarp":
            # factorize per frame (host math): orbiting re-picks the axis
            # and the lattice without rebuilding grids
            cam_v = camera_to_voxel(self._camera_from_fs(),
                                    self.voxel_from_world)
            pick = self._pick_shearwarp(cam_v)
            if pick is None:
                # too oblique for every axis mid-orbit: this frame goes
                # through the reorientation preview
                grids, cam_r = reorient_grids(self._grids_for(2), cam_v)
                scfg = self._slab_config(grids)
            else:
                axis, shear = pick
                grids = self._grids_for(axis)
                scfg = self._slab_config(grids)
                # lattice-phase jitter: the intermediate rays move each
                # frame and the warp compensates (shift_i/shift_j)
                lattice = shear.lattice(jx, jy)
                cam = shear.camera
                rw, rh = shear.width, shear.height
        if shear is None:
            cam = cam_r if cam_r is not None else camera_to_voxel(
                self._camera_from_fs(), self.voxel_from_world)
            # per-frame sub-pixel jitter as a whole-grid shift
            cam = Camera(pos=cam.pos,
                         dir00=cam.dir00 + jx * cam.dir_du + jy * cam.dir_dv,
                         dir_du=cam.dir_du, dir_dv=cam.dir_dv)
        # static pose at frame 0 (a TF edit resets accumulation, the pose
        # and its frame-0 jitter stay): reuse the camera products
        pose = (np.asarray(cam.pos).tobytes(),
                np.asarray(cam.dir00).tobytes(),
                np.asarray(cam.dir_du).tobytes(),
                np.asarray(cam.dir_dv).tobytes(), rw, rh,
                None if lattice is None else tuple(
                    np.asarray(l).tobytes() for l in lattice))
        cam_cache = None
        if (int(self.fs.frame_id) == 0 and pose == self._last_pose
                and self._last_pose_grids is grids):
            if self._cam_cache is None:
                self._cam_cache = {}
            cam_cache = self._cam_cache
        self._last_pose = pose
        self._last_pose_grids = grids

        bg, t_start, t_stop = self._surfaces_and_iso(grids, scfg, cam,
                                                     lattice, rw, rh)
        rgba = render_slabs_camera(grids, self.fs, scfg, cam, rw, rh,
                                   camera_cache=cam_cache, lattice=lattice,
                                   t_start=t_start, t_stop=t_stop)
        color = composite_background(rgba, bg)
        if shear is not None:
            # one screen-space homography warp finishes the frame
            color = warp_image(color, shear, self.width, self.height,
                               jx=0.5 + jx, jy=0.5 + jy, shift_i=jx,
                               shift_j=jy, plain=scfg.plain_sweep)
        self.accum, shown = accumulate(color, self.accum,
                                       int(self.fs.frame_id))
        words = pack_rgba8(shown)
        with profiling.sync("sync.readback", words):
            words = words.cpu()
        return words.numpy().astype(np.uint32).reshape(self.height,
                                                        self.width)

    # -- exact path ------------------------------------------------------
    def _wavefront_pack(self):
        """The packed march's tables, built at first need and kept (the
        JAX Renderer's ``_wavefront_pack``): None where the config needs
        the classic sampler, or where the scene's ids exceed the packed
        range (``build_pack`` raises ``ValueError``; remembered as
        False).  The axis-2 grids become the pack's views of its flat
        buffer, so they are held once."""
        if not self.cfg.basis_method or self.cfg.gradient_shading_dvr:
            return None
        if self._pack is None:
            try:
                self._pack = wavefront.build_pack(self.scene,
                                                  self._grids_for(2))
                self._grids_cache[2] = self._pack.grids
            except ValueError:
                self._pack = False  # scene exceeds the packed id range
        return self._pack or None

    def _render_packed_compacted(self, pack):
        """The JAX Renderer's compacted packed frame
        (``wavefront.trace_dvr_packed_compacted``)."""
        def trace(*args, **kw):
            return wavefront.trace_dvr_packed_compacted(pack, *args, **kw)

        return _exact_frame(self.scene, self.fs, self.surf, self.accum,
                            self.cfg, self.width, self.height, trace)

    # -- frame ----------------------------------------------------------
    def render(self) -> np.ndarray:
        """Render one progressive frame (the fast path's once
        ``enable_fast_path()`` ran, else the exact one on the JAX
        Renderer's route); returns (H, W) uint32 RGBA8.  The frame is a
        ``frame`` span with id ``frames_rendered`` (``utils.profiling``)."""
        with profiling.frame(self.frames_rendered):
            rgba8 = self._render()
        self.frames_rendered += 1
        self.fs = dataclasses.replace(self.fs,
                                      frame_id=self.fs.frame_id + 1)
        return rgba8

    def _render(self) -> np.ndarray:
        if self._fast is not None:
            return self._render_fast()
        pack = self._wavefront_pack()
        if pack is not None and self.cfg.wavefront_compaction:
            self.exact_route = "packed_compacted"
            out = self._render_packed_compacted(pack)
        elif pack is not None:
            self.exact_route = "packed"
            out = render_step_packed(
                pack, self.scene, self.fs, self.surf, self.accum,
                cfg=self.cfg, width=self.width, height=self.height)
        else:
            self.exact_route = "classic"
            out = render_step(
                self.scene, self.fs, self.surf, self.accum, cfg=self.cfg,
                width=self.width, height=self.height)
        self.accum, words, _ = out
        with profiling.sync("sync.readback", words):
            words = words.cpu()
        return words.numpy().astype(np.uint32).reshape(self.height,
                                                       self.width)

    def render_frames(self, n: int) -> np.ndarray:
        out = None
        for _ in range(n):
            out = self.render()
        return out

    def image_uint8(self, rgba8: np.ndarray) -> np.ndarray:
        """(H, W) uint32 -> (H, W, 4) uint8, flipped top-down for PNG."""
        img = rgba8.view(np.uint8).reshape(self.height, self.width, 4)
        return img[::-1]
