"""Sweep-based ambient occlusion for the slab fast path (the port of
``owlexabrick_tpu/render/ao_sweep.py``).

The reference's AO (exabrick.cu:1612-1645) shoots 2 cosine-distributed
hemisphere rays per pixel per frame against the surfaces and averages
hit counts progressively.  The fast path restates the same Monte-Carlo
integral over a per-frame direction pool:

  * per frame, ``RenderConfig.ao_dirs`` uniform-sphere directions are
    drawn and a signed shadow volume is built for each: S_d(x) = 1 iff
    the iso indicator is occupied within ao_length along d from x, a
    directional dilation of the indicator built with log2(K) shift-OR
    doubling passes over a dense finest-lattice grid (shifts with zero
    fill, no gathers); the cost scales with the pool, not the pixels;
  * each pixel draws ``ao_samples`` pool members with probability
    proportional to |cos(n, u_j)| and importance weight
    2|cos_j| / (D p_j), unbiased for the cosine-weighted hemisphere
    integral.

The occluders are the iso level sets (marked on the lattice where a
cell neighborhood's field range crosses an enabled iso); meshes and
streamlines join through ``geom_occluder`` (``ao_combined`` in the
Renderer).  The direction pool and the shadow volumes' shifts are a few
host float32 numbers per frame (``prng.normal``, bit for bit the JAX
package's); the indicator, the volumes and the per-pixel estimator are
torch ops on the lattice's device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import prng

_F32 = np.float32


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def build_ao_lattice(grids_host):
    """Host-side (once per scene): the basis field and occupancy at the
    finest-lattice cell centers over the sweep bounds, (nz, ny, nx) in
    the grid (z, y, x) frame, from level grids (numpy or torch arrays,
    read back to the host).  Returns (val, occ, lo (3,), cwf), numpy."""
    finest = min(grids_host.levels)
    cwf = float(1 << finest)
    lo = np.asarray(grids_host.bounds_lo, np.float64)
    hi = np.asarray(grids_host.bounds_hi, np.float64)
    dims = [int(np.ceil((hi[a] - lo[a]) / cwf)) for a in range(3)]

    coords = [
        (lo[a] + cwf * (0.5 + np.arange(dims[a]))).astype(np.float64)
        for a in range(3)
    ]
    sw = np.zeros(dims, np.float32)
    swv = np.zeros(dims, np.float32)
    for li, L in enumerate(grids_host.levels):
        cw = float(1 << L)
        m = _host(grids_host.masks[li])
        v = _host(grids_host.vals[li])[0]
        org = np.asarray(grids_host.origins[li], np.float64)
        mats = []
        for a, n_l in zip(range(3), m.shape):
            q = coords[a] / cw - org[a] - 0.5
            k = np.arange(n_l)
            mats.append(
                np.maximum(0.0, 1.0 - np.abs(q[:, None] - k[None]))
                .astype(np.float32)
            )

        def resample(vol):
            t = np.einsum("zi,iyx->zyx", mats[0], vol, optimize=True)
            t = np.einsum("yj,zjx->zyx", mats[1], t, optimize=True)
            return np.einsum("xk,zyk->zyx", mats[2], t, optimize=True)

        sw += resample(m)
        swv += resample(v)
    occ = sw > 1e-20
    val = np.where(occ, swv / np.where(occ, sw, 1.0), 0.0)
    return (val.astype(np.float32), occ,
            np.asarray(grids_host.bounds_lo, np.float32), cwf)


def lattice_to(lattice, device):
    """``build_ao_lattice``'s (val, occ, lo, cwf) with val and occ as
    tensors on ``device`` (lo and cwf stay host numbers)."""
    val, occ, lo, cwf = lattice
    return (torch.from_numpy(np.ascontiguousarray(val)).to(device),
            torch.from_numpy(np.ascontiguousarray(occ)).to(device),
            np.asarray(lo, np.float32), float(cwf))


def iso_indicator(val, occ, fs):
    """(nz, ny, nx) float32 0/1: an enabled iso value crosses between
    this cell's center and a face neighbor's.  Kept one cell thin: a
    thickened indicator would self-occlude every surface point (the
    dominant error mode of volumetric AO)."""
    ind = torch.zeros(val.shape, dtype=torch.bool, device=val.device)
    isos = [float(_F32(v)) for v, on in zip(
        np.asarray(fs.iso_value), np.asarray(fs.iso_enabled, bool)) if on]
    for ax in range(3):
        n = val.shape[ax]
        idx = torch.arange(n, device=val.device)
        shape = [1, 1, 1]
        shape[ax] = n
        for s in (1, -1):
            nb_v = torch.roll(val, s, ax)
            nb_o = torch.roll(occ, s, ax)
            # roll wraps: mask the pair that compared across the
            # opposite boundary
            edge_ok = (idx >= s) if s > 0 else (idx < n + s)
            pair = occ & nb_o & edge_ok.reshape(shape)
            for iso in isos:
                ind = ind | (pair & ((val - iso) * (nb_v - iso) <= 0.0))
    return ind.to(torch.float32)


def _shift_along(vol, off):
    """vol(x) -> vol(x + off) with zero fill; ``off`` a host (3,) int
    lattice offset (the JAX package's roll with the wrapped part masked,
    as a shifted copy)."""
    out = vol
    for ax in range(3):
        o = int(off[ax])
        n = out.shape[ax]
        if o == 0:
            continue
        res = torch.zeros_like(out)
        if abs(o) < n:
            if o > 0:
                res.narrow(ax, 0, n - o).copy_(out.narrow(ax, o, n - o))
            else:
                res.narrow(ax, -o, n + o).copy_(out.narrow(ax, 0, n + o))
        out = res
    return out


def shadow_offsets(d, ao_len_cells, max_len_cells: int):
    """The lattice offsets of ``shadow_volume``'s passes for the host
    float32 unit direction ``d``: the first reach, then one offset per
    doubling pass (``ceil(log2(max_len_cells))`` of them, float32
    arithmetic as the JAX package's traced one)."""
    d = np.asarray(d, _F32)
    steps = np.maximum(np.ceil(_F32(ao_len_cells)), _F32(1.0))
    offs = [np.round(d).astype(np.int32)]
    n_pass = max(int(np.ceil(np.log2(max(max_len_cells, 2)))), 1)
    span = _F32(1.0)
    for _ in range(n_pass):
        adv = np.minimum(span, np.maximum(steps - span, _F32(0.0)))
        offs.append(np.round(d * adv).astype(np.int32))
        span = _F32(span + adv)
    return offs


def shadow_volume(ind, d, ao_len_cells, max_len_cells: int):
    """S_d(x): ``ind`` occupied within ``ao_len_cells`` along the unit
    direction ``d`` from x.  Doubling construction with a pass bound of
    ceil(log2(max_len_cells)); a zero offset (a pass that advances
    nothing) is the identity and is skipped."""
    first, *passes = shadow_offsets(d, ao_len_cells, max_len_cells)
    reach = _shift_along(ind, first)
    for off in passes:
        if np.any(off):
            reach = torch.maximum(reach, _shift_along(reach, off))
    return reach


def sample_lattice(vol, lo, cwf, pts_zyx):
    """Trilinear sample of a dense (nz, ny, nx) volume at (P, 3) points
    in the grid (z, y, x) frame."""
    return sample_lattice_indexed(
        vol[None], lo, cwf, pts_zyx,
        torch.zeros(pts_zyx.shape[0], dtype=torch.int64,
                    device=pts_zyx.device))


def sample_lattice_indexed(vols, lo, cwf, pts_zyx, vidx):
    """Trilinear sample of a stacked (V, nz, ny, nx) volume at (P, 3)
    grid-frame points, volume ``vidx`` (P,) per point: one gather per
    corner per pixel.  ``lo`` (3,) and ``cwf`` host numbers."""
    _, nz, ny, nx = vols.shape
    dev = pts_zyx.device
    lo_t = torch.as_tensor(np.asarray(lo, _F32), device=dev)
    q = (pts_zyx - lo_t[None, :]) / float(cwf) - 0.5
    k0 = torch.floor(q).to(torch.int64)
    f = q - k0.to(q.dtype)
    flat = vols.reshape(vols.shape[0], -1)
    vidx = vidx.to(torch.int64)
    acc = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                kz = torch.clamp(k0[:, 0] + dz, 0, nz - 1)
                ky = torch.clamp(k0[:, 1] + dy, 0, ny - 1)
                kx = torch.clamp(k0[:, 2] + dx, 0, nx - 1)
                w = ((f[:, 0] if dz else 1 - f[:, 0])
                     * (f[:, 1] if dy else 1 - f[:, 1])
                     * (f[:, 2] if dx else 1 - f[:, 2]))
                corner = flat[vidx, (kz * ny + ky) * nx + kx]
                acc = acc + w * corner.to(torch.float32)
    return acc


def direction_pool(key, n_dirs: int) -> np.ndarray:
    """The frame's ``n_dirs`` uniform-sphere directions (host float32,
    (D, 3) in the grid (z, y, x) frame): ``normal(fold_in(key, 101))``,
    normalized."""
    u = prng.normal(prng.fold_in(key, 101), (n_dirs, 3))
    nrm = np.sqrt((u * u).sum(-1, keepdims=True, dtype=_F32))
    return (u / np.maximum(nrm, _F32(1e-9))).astype(_F32)


def ao_shadow_fast(lattice, fs, hit_zyx, normals_zyx, key,
                   ao_samples: int = 2, geom_occluder=None,
                   ao_dirs: int = 4):
    """Per-pixel AO shadow estimate at surface hits.

    lattice: (val, occ, lo, cwf), val and occ on the device
    (``lattice_to``).  hit_zyx: (P, 3) surface points, normals_zyx: (P,
    3) unit normals, both in the grid (z, y, x) frame; ``key`` the
    frame's ``prng`` key.  Returns (P,) shadow in [0, 1], the frame's
    term of the progressive average.

    Estimator: ``ao_dirs`` uniform-sphere directions are drawn per frame
    and their signed shadow volumes built once; each pixel then draws
    ``ao_samples`` directions from the pool with probability
    proportional to |cos(n, u_j)| and weights the hit by
    2|cos_j| / (D p_j).  The pool never shrinks below ``ao_samples``.

    ``geom_occluder``: optional callback ``d_pix (P, 3) zyx -> (P,)
    0/1`` reporting geometric occlusion (meshes/streamlines) along the
    per-pixel direction, OR-ed with the lattice's iso occlusion under
    the same estimator."""
    val, occ, lo, cwf = lattice
    dev = hit_zyx.device
    ind = iso_indicator(val, occ, fs)
    max_len = max(val.shape)
    ao_cells = np.clip(_F32(fs.ao_length) / _F32(cwf), _F32(1.0),
                       _F32(max_len))
    n_dirs = max(int(ao_dirs), int(ao_samples), 1)

    # the frame's direction pool + its 2*D signed shadow volumes (uint8:
    # the indicator is 0/1, and the stack stays small)
    u = direction_pool(key, n_dirs)
    stack = torch.stack([
        shadow_volume(ind, s * u[j], ao_cells, max_len)
        for j in range(n_dirs) for s in (1, -1)]).to(torch.uint8)
    u_t = torch.from_numpy(u).to(dev)

    cos = (normals_zyx[:, None, :] * u_t[None]).sum(-1)  # (P, D)
    p = cos.abs() + 1e-3  # full support keeps the estimator unbiased
    p = p / p.sum(-1, keepdim=True)
    # the running sum over the pool in order (torch's scan kernel is slow
    # over an innermost axis this short)
    cols = [p[:, 0]]
    for j in range(1, n_dirs):
        cols.append(cols[-1] + p[:, j])
    cdf = torch.stack(cols, -1)

    shadow = torch.zeros(hit_zyx.shape[0], dtype=torch.float32, device=dev)
    for s in range(ao_samples):
        r = prng.uniform(prng.fold_in(key, s), (hit_zyx.shape[0],), dev)
        j_sel = torch.clamp((r[:, None] >= cdf).sum(-1), 0, n_dirs - 1)
        cos_sel = cos.gather(1, j_sel[:, None])[:, 0]
        p_sel = p.gather(1, j_sel[:, None])[:, 0]
        d_pix = torch.sign(cos_sel)[:, None] * u_t[j_sel]
        # stand off along the normal past the indicator's own ~1.5-cell
        # shell: tangential directions then run parallel above the
        # surface slab instead of through it (self-occlusion)
        probe = (hit_zyx + normals_zyx * (1.5 * cwf)
                 + d_pix * (0.5 * cwf))
        vidx = j_sel * 2 + (cos_sel < 0.0).to(torch.int64)
        hit = sample_lattice_indexed(stack, lo, cwf, probe, vidx)
        if geom_occluder is not None:
            hit = torch.maximum(hit, geom_occluder(d_pix))
        w = 2.0 * cos_sel.abs() / (n_dirs * p_sel)
        shadow = shadow + torch.clamp(hit, 0.0, 1.0) * w
    return torch.clamp(shadow / ao_samples, 0.0, 1.0)
