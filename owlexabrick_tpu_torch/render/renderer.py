"""High-level renderer, DVR on the slab fast path (the port of the fast
path of ``owlexabrick_tpu/render/renderer.py``): owns the level grids,
the surfaces, the frame state and the accumulation buffer, and renders
progressive frames through ``render_slabs_camera``: an axis-aligned
camera directly, any other camera through shear-warp (an axis-aligned
lattice camera plus the two-pass warp), and a frustum no axis can
factorize through the ``reorient_grids`` preview.  The clip box
(``set_clip_box``) and DVR gradient shading
(``RenderConfig.gradient_shading_dvr``) take the sweep's einsum lane;
the clip box becomes a per-pixel sweep interval (``clip_interval``).
Iso surfaces (``RenderConfig.iso_surfaces``, ``update_iso_values``)
take the iso sweep (``render_slabs_iso_camera``): its shaded hits are
the background and its hit depth stops the volume (K1's surface stop).
Meshes and streamline segments (``surfaces=``) are traced on the
sweep's own rays (``surfaces.trace_surface_pass``, with its dense
geometric AO): the nearest of them and the iso hits is the background
and stops the volume.  AO over gradient-shaded iso hits takes the
lattice estimator (``ao_sweep.ao_shadow_fast``), alone (``ao_fast``) or
OR-ed with the geometric occluders (``ao_combined``).

Not ported yet (each raises NotImplementedError): contour planes and
``ao_exact``, which sample the exact scene, and the exact wavefront
path itself.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import prng
from .ao_sweep import ao_shadow_fast, build_ao_lattice, lattice_to
from .camera import Camera
from .dvr import accumulate, composite_background, pack_rgba8, ray_box
from .frame import FrameState, make_frame_state, with_camera
from .shearwarp import inter_dims, setup_shearwarp, warp_image
from .slabs import (
    SlabConfig,
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
from .surfaces import SurfaceData, _nearest_surface, trace_surface_pass


@dataclass(frozen=True)
class RenderConfig:
    """The fields of the JAX package's ``RenderConfig`` that the slab
    fast path reads (same names and defaults)."""

    num_channels: int = 1
    gradient_shading_dvr: bool = False
    gradient_shading_iso: bool = True
    iso_surfaces: bool = False
    ao_samples: int = 0
    # fast-path AO only: candidate directions per frame of the lattice
    # estimator (render/ao_sweep.py)
    ao_dirs: int = 4
    # secondary field that colormaps iso surfaces (LaunchParams.h:59-60)
    colormap_channel: int = 0
    # adaptive z-stride on the slab fast path (exabrick.cu:1129)
    adaptive_stride: bool = True


JITTER_SEED = 0x51AB


def default_jitter(frame_id: int) -> Tuple[float, float]:
    """Per-frame sub-pixel jitter in [-0.5, 0.5)^2, the JAX Renderer's
    bit for bit (renderer.py:453-458): two ``uniform`` draws from
    ``fold_in(fold_in(PRNGKey(0x51AB), frame_id), 0 | 1)``."""
    key = prng.fold_in(prng.prng_key(JITTER_SEED), frame_id)
    return (float(prng.uniform_f32(prng.fold_in(key, 0))) - 0.5,
            float(prng.uniform_f32(prng.fold_in(key, 1))) - 0.5)


def _f32s(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


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


class Renderer:
    """Progressive renderer of cell data on one device.

    cells: (lower (N, 3) int, level (N,), scalars (C, N) or [(N,)] * C).
    jitter: ``frame_id -> (jx, jy)``, the per-frame sub-pixel shift
    (default: ``default_jitter``).  surfaces: meshes and streamline
    segments (``SurfaceData`` on ``device``), or None for none."""

    # the JAX Renderer's exact AO switch; its estimator marches the exact
    # scene, which is not ported (setting it makes AO frames raise)
    ao_exact = False
    # run the plain-torch twins of every kernel on the card (the
    # comparison lane, SlabConfig.plain_sweep); read where the slab
    # config is built (enable_fast_path, and each shear-warp frame)
    plain_kernels = False

    def __init__(self, cells, width: int = 1024, height: int = 1024,
                 cfg: Optional[RenderConfig] = None,
                 frame_state: Optional[FrameState] = None,
                 voxel_from_world=None, device="cuda",
                 jitter: Optional[Callable[[int], Tuple[float, float]]] = None,
                 surfaces: Optional[SurfaceData] = None):
        self.device = render_device(device)
        self.surf = (surfaces if surfaces is not None
                     else SurfaceData.empty(self.device))
        lower, level, scalars = cells
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
        self.world_bounds_lo = (inv_a @ (v_lo - m[:, 3])).astype(np.float32)
        self.world_bounds_hi = (inv_a @ (v_hi - m[:, 3])).astype(np.float32)
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
        self._ao_lat = None
        self._fast = None
        self._cam_cache = None
        self._last_pose = None
        self._last_pose_grids = None
        self.reset_accumulation()

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
        """Level grids for a sweep axis, built once per axis."""
        if axis not in self._grids_cache:
            self._grids_cache[axis] = level_grids_from_cells(
                self._lower, self._level, self._scalars, axis=axis,
                device=self.device)
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

    def _check_supported(self):
        """Raise on what needs the exact scene, which the port does not
        have yet: an enabled contour plane (the surface pass colors it by
        sampling the scene) and ``ao_exact`` on a frame with AO (its
        hemisphere rays march the exact iso surfaces)."""
        if bool(np.any(self.fs.contour_enabled)):
            raise NotImplementedError("contour planes need the exact "
                                      "scene, which is not ported yet")
        if self.ao_exact and any(self._ao_modes()):
            raise NotImplementedError("ao_exact needs the exact iso "
                                      "march, which is not ported yet")

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
        self._check_supported()
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
        Renderer's _render_fast, renderer.py:532-817): meshes and
        streamlines (traceSurfaces, exabrick.cu:1475-1529), the iso
        sweep, AO, and the clip box.  Returns (bg (3,) or (P, 3), t_start,
        t_stop): the shaded background and the volume's sweep interval
        (None: unbounded)."""
        fs, cfg, surf, dev = self.fs, self.cfg, self.surf, self.device
        p = rw * rh
        key = prng.fold_in(prng.prng_key(JITTER_SEED), int(fs.frame_id))
        bg = torch.zeros(3, dtype=torch.float32, device=dev)
        t_start = t_stop = t_surf = geom = None
        need_surf = surf.num_tris > 0 or surf.num_segments > 0
        clip = bool(fs.clip_enabled)
        ao_combined, ao_fast = self._ao_modes()
        if need_surf or clip or ao_fast or ao_combined:
            d_unit, rnorm = sweep_rays_world(grids.axis, cam, lattice, rw, rh,
                                             self.voxel_from_world, dev)
            o_w = _f32s(fs.cam_pos, dev).expand(p, 3)

        if need_surf and ao_combined:
            # shading waits for the combined AO shadow below
            t_g, n_w_g, base_g, amb_g, _ = _nearest_surface(
                fs, surf, cfg, o_w, d_unit, _full(p, 1e-6, dev),
                _full(p, 2e10, dev),
                include_contours=False, include_iso=False,
                current_timestep=fs.tracer_timestep, screen=(rw, rh))
            t_w = torch.where(torch.isfinite(t_g), t_g, 2e10)
            geom = (t_w / rnorm, n_w_g, base_g, amb_g)
            t_surf = t_stop = geom[0]
            bg = torch.zeros((p, 3), dtype=torch.float32, device=dev)
        elif need_surf:
            t_w, bg = trace_surface_pass(
                fs, surf, cfg, o_w, d_unit, prng.fold_in(key, 3),
                include_iso=False, include_contours=False, screen=(rw, rh))
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

        def unit(v):
            return v / torch.clamp(torch.linalg.norm(v, dim=-1,
                                                     keepdim=True), min=1e-20)

        pos_w = o_w + (torch.minimum(t_iso, t_sw_g) * rnorm)[:, None] * d_unit
        # winner normals, world and voxel frames (row vectors: n_vox =
        # n_w @ inv(M), n_w = n_vox @ M)
        wins = iso_wins[:, None]
        n_w_eff = torch.where(wins, unit(n_vox @ m3), n_w_g)
        n_vox_eff = torch.where(wins, n_vox, unit(n_w_g @ minv))
        origin = pos_w + n_w_eff * 1e-3

        def occ_geom(d_pix):
            # d_pix: (P, 3) grid zyx -> world direction
            d_w = unit(d_pix.flip(-1) @ minv.T)
            at = _nearest_surface(
                fs, surf, cfg, origin, d_w, _full(p, 1e-4, dev),
                _full(p, fs.ao_length, dev),
                include_contours=False, include_iso=False,
                current_timestep=fs.tracer_timestep, screen=(rw, rh))[0]
            return torch.isfinite(at).to(torch.float32)

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

    def _render_fast(self) -> np.ndarray:
        self._check_supported()
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
        words = pack_rgba8(shown).cpu().numpy().astype(np.uint32)
        return words.reshape(self.height, self.width)

    # -- frame ----------------------------------------------------------
    def render(self) -> np.ndarray:
        """Render one progressive frame; returns (H, W) uint32 RGBA8."""
        if self._fast is None:
            raise NotImplementedError(
                "only the slab-sweep fast path is ported: call "
                "enable_fast_path() first")
        rgba8 = self._render_fast()
        self.fs = dataclasses.replace(self.fs,
                                      frame_id=self.fs.frame_id + 1)
        return rgba8

    def render_frames(self, n: int) -> np.ndarray:
        out = None
        for _ in range(n):
            out = self.render()
        return out

    def image_uint8(self, rgba8: np.ndarray) -> np.ndarray:
        """(H, W) uint32 -> (H, W, 4) uint8, flipped top-down for PNG."""
        img = rgba8.view(np.uint8).reshape(self.height, self.width, 4)
        return img[::-1]
