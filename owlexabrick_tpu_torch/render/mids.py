"""The x stage of the megakernel lane's camera products (the port of
``owlexabrick_tpu/render/pallas_mids.py``): K6, the x-tent resample of
the z-lerped lattice blocks of every level of a chunk to screen columns.

Per level, zvs (C+1, S, ny, nx): the channel blocks, then the mask
block, z-lerped at the chunk's slab planes; qx (S, W): the slab-plane
lattice x coordinate of every screen column.  Out (C+1, S, ny, W), the
port's mids layout: per column the two lattice columns k0 = floor(qx),
k0 + 1 weighted max(0, 1 - |qx - k|), zero outside [0, nx) (the JAX
package's dense tent matrix entries, ``tent_taps``).

The plain version (``xresample_mids_reference``, per level), a launcher
of the hand-written Hopper kernel in ``csrc/mids.cu``
(``xresample_mids_levels_cuda``: one launch for up to
``K6_MAX_LEVELS`` levels, counting its launches in
``utils.profiling.counts["launch.K6"]``) and
dispatchers: CPU tensors take the plain version, CUDA tensors launch the
kernel or raise, and ``plain=True`` picks the plain version on the card.
``xresample_mids`` is the same for one level.  None of the TPU kernel's
layout stays: no 8-row pad, no -2 column pad, no bf16 hi/lo split.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import profiling


def tent_taps(q: torch.Tensor, n: int):
    """The two lattice points k0 = floor(q), k0 + 1 a tent at q reaches on
    an axis of ``n`` points: their clamped indices, their tent weights
    max(0, 1 - |q - k|) (the JAX package's ``_tent_matrix`` entries) and
    their derivative weights -1, +1 (``_dtent_matrix``, half-open
    support); a point outside [0, n-1] is absent (weights 0)."""
    kf = torch.floor(q)
    k0 = kf.to(torch.int64)
    in0 = (k0 >= 0) & (k0 < n)
    in1 = (k0 + 1 >= 0) & (k0 + 1 < n)
    w0 = torch.where(in0, torch.clamp(1.0 - torch.abs(q - kf), min=0.0), 0.0)
    w1 = torch.where(in1, torch.clamp(1.0 - torch.abs(q - (kf + 1.0)),
                                      min=0.0), 0.0)
    d0 = torch.where(in0, -1.0, 0.0)
    d1 = torch.where(in1, 1.0, 0.0)
    return ((torch.clamp(k0, 0, n - 1), torch.clamp(k0 + 1, 0, n - 1)),
            (w0, w1), (d0, d1))


def xresample_mids_reference(zvs: torch.Tensor,
                             qx: torch.Tensor) -> torch.Tensor:
    """Plain-torch K6: the same arithmetic as ``csrc/mids.cu``.
    zvs: (C+1, S, ny, nx); qx: (S, W).  Returns (C+1, S, ny, W)."""
    n_comp, s_, ny, nx = zvs.shape
    w_ = qx.shape[1]
    (i0, i1), (w0, w1), _ = tent_taps(qx, nx)

    def tap(idx, wt):
        cols = idx[None, :, None, :].expand(n_comp, s_, ny, w_)
        return wt[None, :, None, :] * torch.gather(zvs, 3, cols)

    return tap(i0, w0) + tap(i1, w1)


# levels per launch (kMaxLevels in csrc/mids.cu)
K6_MAX_LEVELS = 8


def xresample_mids_levels_reference(zvs_list, qx_list):
    """Plain-torch K6 for a chunk's levels: ``xresample_mids_reference``
    per level."""
    return [xresample_mids_reference(z, q) for z, q in zip(zvs_list, qx_list)]


def _levels_shape(zvs_list, qx_list):
    """(n_comp, S, W) the levels share; raises on anything else."""
    if len(zvs_list) != len(qx_list) or not zvs_list:
        raise ValueError(f"need as many qx as zvs (>= 1), got "
                         f"{len(zvs_list)} and {len(qx_list)}")
    for z, q in zip(zvs_list, qx_list):
        if z.dim() != 4 or q.dim() != 2:
            raise ValueError(f"zvs: need (C+1, S, ny, nx), qx: (S, W); got "
                             f"{tuple(z.shape)}, {tuple(q.shape)}")
    n_comp, s_ = zvs_list[0].shape[:2]
    w_ = qx_list[0].shape[1]
    for z, q in zip(zvs_list, qx_list):
        if tuple(z.shape[:2]) != (n_comp, s_) or tuple(q.shape) != (s_, w_):
            raise ValueError(f"levels differ in (C+1, S) or W: "
                             f"{tuple(z.shape)}, {tuple(q.shape)}")
    return n_comp, s_, w_


def xresample_mids_levels_cuda(zvs_list, qx_list):
    """Launch K6 (``csrc/mids.cu``) on the current stream, once for every
    ``K6_MAX_LEVELS`` levels.  Same arguments and result as
    ``xresample_mids_levels_reference``.  Raises on any input the kernel
    does not take; never falls back."""
    from .. import kernels

    dev = zvs_list[0].device if zvs_list else None
    if dev is None or dev.type != "cuda":
        raise ValueError(f"xresample_mids_levels_cuda needs CUDA tensors, "
                         f"got {dev}")
    n_comp, s_, w_ = _levels_shape(zvs_list, qx_list)
    for z, q in zip(zvs_list, qx_list):
        kernels.check_tensor("zvs", z, dev, tuple(z.shape))
        kernels.check_tensor("qx", q, dev, (s_, w_))
    outs = [torch.empty((n_comp, s_, z.shape[2], w_), dtype=torch.float32,
                        device=dev) for z in zvs_list]
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for i in range(0, len(zvs_list), K6_MAX_LEVELS):
        grp = range(i, min(i + K6_MAX_LEVELS, len(zvs_list)))
        n = len(grp)
        kernels.launch(
            "owx_xresample_levels", "K6",
            (vp * n)(*[zvs_list[l].data_ptr() for l in grp]),
            (vp * n)(*[qx_list[l].data_ptr() for l in grp]),
            (vp * n)(*[outs[l].data_ptr() for l in grp]),
            (ci * n)(*[zvs_list[l].shape[2] for l in grp]),
            (ci * n)(*[zvs_list[l].shape[3] for l in grp]),
            n, n_comp, s_, w_, kernels.stream_arg(dev))
        profiling.count("launch.K6")
    return outs


def xresample_mids_levels(zvs_list, qx_list, plain: bool = False):
    """K6 for a chunk's levels: the kernel for CUDA tensors, the plain
    version for CPU tensors (or anywhere when ``plain``, the explicit
    choice a kernel-vs-plain comparison makes).  Returns the per-level
    (C+1, S, ny, W) mids."""
    if plain or zvs_list[0].device.type == "cpu":
        _levels_shape(zvs_list, qx_list)
        return xresample_mids_levels_reference(zvs_list, qx_list)
    return xresample_mids_levels_cuda(zvs_list, qx_list)


def xresample_mids(zvs: torch.Tensor, qx: torch.Tensor,
                   plain: bool = False) -> torch.Tensor:
    """``xresample_mids_levels`` for one level."""
    return xresample_mids_levels([zvs], [qx], plain=plain)[0]

