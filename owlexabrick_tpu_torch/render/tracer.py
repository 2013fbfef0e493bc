"""Particle tracer: RK4 advection through a 3-channel velocity field of
the exact scene (the port of ``owlexabrick_tpu/render/tracer.py``).

The reference advances one particle per pixel thread of its raygen
launch (computeTraces, exabrick.cu:1531-1574); here one RK4 step is a
batch update of every particle on the scene's device, one call per
timestep.

Lifecycle parity (exa/OptixRenderer.cpp:450-487):
  * seeds reproduce the reference's stream bit for bit (host numpy):
    libstdc++ ``std::default_random_engine(0)`` (minstd_rand0, seed 0 ->
    state 1) through ``std::uniform_real_distribution<float>``, with
    GCC's right-to-left evaluation of
    ``vec3f(x(engine),y(engine),z(engine))`` (z draws first);
  * one RK4 step per advance with step length ``steplen``; a particle
    dies (position := TRACE_DEAD) when any sub-sample is invalid, it
    leaves the bounds, or it moved less than 1e-10;
  * live segments render as rounded cones up to the current timestep
    (exabrick.cu:519-570).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.constants import TRACE_DEAD
from .dvr import _sqrt_rn, locate_leaf, sample_basis


def morton_order(points: np.ndarray) -> np.ndarray:
    """Permutation sorting (N, 3) points along a 3D Z-curve (10 bits per
    axis over the point AABB).  ``SurfaceData.from_meshes`` orders
    triangles by it, and the tracer its segments, so the tiled traces'
    chunk bounding spheres stay tight (render/surfaces.py): a pure
    reordering, render semantics (nearest hit over the set) unchanged."""
    pts = np.asarray(points, np.float64)
    lo = pts.min(0)
    ext = np.maximum(pts.max(0) - lo, 1e-30)
    q = np.minimum((pts - lo) / ext * 1023.0, 1023.0).astype(np.uint64)

    def _spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = _spread(q[:, 0]) | (_spread(q[:, 1]) << np.uint64(1)) \
        | (_spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")


def minstd0_uniform_f32(n: int, seed: int = 0) -> np.ndarray:
    """n float32 draws of libstdc++'s
    ``uniform_real_distribution<float>(0,1)(default_random_engine(seed))``.

    minstd_rand0: x' = 16807*x mod (2^31-1); seed 0 maps to state 1.
    generate_canonical<float> uses one engine call: (x - 1) / R with
    R = float(2^31 - 2), which rounds to 2^31, all in float32."""
    m = 2147483647
    x = seed % m
    if x == 0:
        x = 1
    out = np.empty(n, np.uint32)
    for i in range(n):
        x = (16807 * x) % m
        out[i] = x
    return ((out - 1).astype(np.float32)
            / np.float32(2147483648.0)).astype(np.float32)


def seed_traces(num_traces: int, bounds_lo, bounds_hi,
                seed_region_lo=(0.0, 0.0, 0.0),
                seed_region_hi=(1.0, 1.0, 1.0),
                seed: int = 0) -> np.ndarray:
    """(N, 3) seeds exactly as resetTracer draws them
    (exa/OptixRenderer.cpp:450-462): per axis
    ``uniform_real_distribution<float>(region_lo*size, region_hi*size)``,
    relative to the bounds *size* only like the reference, drawn z, then
    y, then x per point."""
    size = (np.asarray(bounds_hi, np.float32)
            - np.asarray(bounds_lo, np.float32))
    a = (np.asarray(seed_region_lo, np.float32) * size).astype(np.float32)
    b = (np.asarray(seed_region_hi, np.float32) * size).astype(np.float32)
    u = minstd0_uniform_f32(3 * num_traces, seed).reshape(num_traces, 3)
    u = u[:, ::-1]  # draw order z, y, x -> columns x, y, z
    return (u * (b - a) + a).astype(np.float32)


def _sample_velocity(scene, pos, channels: Tuple[int, int, int]):
    """(ok, velocity (N, 3)) at voxel-space positions (sampleDirection,
    exabrick.cu:945-963)."""
    rid = scene.tree_leaf[locate_leaf(scene, pos)]
    rids = torch.clamp(rid, min=0)
    oks = rid >= 0
    comps = []
    for c in channels:
        ok_c, v = sample_basis(scene, rids, pos, c)
        oks = oks & ok_c
        comps.append(v)
    return oks, torch.stack(comps, -1)


def rk4_step(scene, pos, steplen, channels: Tuple[int, int, int],
             bounds_lo, bounds_hi):
    """One RK4 advection step of particles pos (N, 3) (voxel space, on
    the scene's device).  Dead particles stay dead; an invalid step dies
    (exabrick.cu:1545-1572)."""
    steplen = float(np.float32(steplen))
    alive = pos.abs().amax(-1) < TRACE_DEAD / 2
    ok1, k1 = _sample_velocity(scene, pos, channels)
    k1 = k1 * steplen
    ok2, k2 = _sample_velocity(scene, pos + 0.5 * k1, channels)
    k2 = k2 * steplen
    ok3, k3 = _sample_velocity(scene, pos + 0.5 * k2, channels)
    k3 = k3 * steplen
    ok4, k4 = _sample_velocity(scene, pos + k3, channels)
    k4 = k4 * steplen
    new = pos + (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0
    valid = ok1 & ok2 & ok3 & ok4
    inside = ((new >= bounds_lo) & (new <= bounds_hi)).all(-1)
    step = new - pos
    moved = _sqrt_rn(step[:, 0] * step[:, 0] + step[:, 1] * step[:, 1]
                     + step[:, 2] * step[:, 2]) >= 1e-10
    live = alive & valid & inside & moved
    return torch.where(live[:, None], new, TRACE_DEAD)


class Tracer:
    """The trace table (host numpy) and its advance loop (the
    OptixRenderer's tracer state); each step runs on the scene's
    device."""

    def __init__(self, scene, num_traces: int = 1000,
                 num_timesteps: int = 100, steplen: float = 1.0,
                 channels: Tuple[int, int, int] = (0, 0, 0),
                 seed_region_lo=(0.0, 0.0, 0.0),
                 seed_region_hi=(1.0, 1.0, 1.0), radius: float = 2.0):
        self.scene = scene
        self.num_traces = num_traces
        self.num_timesteps = num_timesteps
        self.steplen = steplen
        self.channels = tuple(int(c) for c in channels)
        self.radius = radius
        self.seed_region = (seed_region_lo, seed_region_hi)
        self.reset()

    def reset(self):
        lo = self.scene.voxel_bounds_lo.cpu().numpy()
        hi = self.scene.voxel_bounds_hi.cpu().numpy()
        self.traces = np.full(
            (self.num_traces, self.num_timesteps, 3), TRACE_DEAD, np.float32)
        self.traces[:, 0] = seed_traces(self.num_traces, lo, hi,
                                        *self.seed_region)
        self.timestep = 0

    def advance(self) -> bool:
        """Advance one timestep (advanceTracer, OptixRenderer.cpp:
        476-487); False once the table is full."""
        if self.timestep + 1 >= self.num_timesteps:
            return False
        t = self.timestep
        s = self.scene
        pos = torch.from_numpy(np.ascontiguousarray(self.traces[:, t])).to(
            s.device)
        nxt = rk4_step(s, pos, self.steplen, self.channels,
                       s.voxel_bounds_lo, s.voxel_bounds_hi)
        self.traces[:, t + 1] = nxt.cpu().numpy()
        self.timestep += 1
        return True

    def _segments(self, steps: int):
        """Segments of timesteps 1..steps in the seeds' Morton order
        (spatially coherent chunks for the tiled streamline trace), as
        SurfaceData on the scene's device."""
        from .surfaces import SurfaceData

        tr = self.traces[morton_order(self.traces[:, 0])]
        z = np.zeros((0, 3), np.float32)
        seg_t = np.tile(np.arange(1, steps + 1, dtype=np.int32),
                        (self.num_traces, 1)).reshape(-1)
        return SurfaceData.from_arrays(
            z, z, z, z, tr[:, :steps].reshape(-1, 3),
            tr[:, 1:steps + 1].reshape(-1, 3), seg_t, self.radius,
            self.scene.device)

    def surface_data(self):
        """Segments up to the current timestep as renderable rounded
        cones."""
        if self.timestep == 0:
            from .surfaces import SurfaceData

            return SurfaceData.empty(self.scene.device)
        return self._segments(self.timestep)

    def surface_data_full(self):
        """Every timestep's segment, a fixed-shape table for a live view:
        segments not yet advanced hold TRACE_DEAD endpoints (the traces'
        dead mask drops them) and ``FrameState.tracer_timestep`` culls
        the display, so the table's shape never changes while particles
        advect (the reference rebuilds its streamline BVH per frame,
        exa/OptixRenderer.cpp:476-487)."""
        return self._segments(self.num_timesteps - 1)
