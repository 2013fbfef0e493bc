"""The x stage of the megakernel lane's camera products (the port of
``owlexabrick_tpu/render/pallas_mids.py``): K6,
``xresample_mids``, the x-tent resample of one level's z-lerped lattice
blocks to screen columns.

zvs (C+1, S, ny, nx): the channel blocks, then the mask block, z-lerped
at the chunk's slab planes; qx (S, W): the slab-plane lattice x
coordinate of every screen column.  Out (C+1, S, ny, W), the port's
mids layout: per column the two lattice columns k0 = floor(qx), k0 + 1
weighted max(0, 1 - |qx - k|), zero outside [0, nx) (the JAX package's
dense tent matrix entries, ``tent_taps``).

The plain version (``xresample_mids_reference``), a launcher of the
hand-written Hopper kernel in ``csrc/mids.cu`` (``xresample_mids_cuda``,
counting its launches in ``.launches``) and a dispatcher: CPU tensors
take the plain version, CUDA tensors launch the kernel or raise, and
``plain=True`` picks the plain version on the card.  None of the TPU
kernel's layout stays: no 8-row pad, no -2 column pad, no bf16 hi/lo
split, one launch per level for every component.
"""

from __future__ import annotations

import ctypes

import torch


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


def xresample_mids_cuda(zvs: torch.Tensor, qx: torch.Tensor) -> torch.Tensor:
    """Launch K6 (``csrc/mids.cu``) on the current stream.  Same arguments
    and result as ``xresample_mids_reference``.  Raises on any input the
    kernel does not take; never falls back."""
    from .. import kernels

    dev = zvs.device
    if dev.type != "cuda":
        raise ValueError(f"xresample_mids_cuda needs CUDA tensors, got {dev}")
    if zvs.dim() != 4 or qx.dim() != 2:
        raise ValueError(f"zvs: need (C+1, S, ny, nx), qx: (S, W); got "
                         f"{tuple(zvs.shape)}, {tuple(qx.shape)}")
    n_comp, s_, ny, nx = zvs.shape
    w_ = qx.shape[1]
    kernels.check_tensor("zvs", zvs, dev, (n_comp, s_, ny, nx))
    kernels.check_tensor("qx", qx, dev, (s_, w_))
    out = torch.empty((n_comp, s_, ny, w_), dtype=torch.float32, device=dev)
    vp = ctypes.c_void_p
    kernels.launch("owx_xresample_mids", "K6", vp(zvs.data_ptr()),
                   vp(qx.data_ptr()), vp(out.data_ptr()), n_comp, s_, ny, nx,
                   w_, kernels.stream_arg(dev))
    xresample_mids_cuda.launches += 1
    return out


xresample_mids_cuda.launches = 0


def xresample_mids(zvs: torch.Tensor, qx: torch.Tensor,
                   plain: bool = False) -> torch.Tensor:
    """K6 for CUDA tensors, the plain version for CPU tensors (or
    anywhere when ``plain``, the explicit choice a kernel-vs-plain
    comparison makes)."""
    fn = (xresample_mids_reference if plain or zvs.device.type == "cpu"
          else xresample_mids_cuda)
    return fn(zvs, qx)
