"""The benchmark's yardstick for kernels: the card's published peaks, the
roofline bound of a launch, the port's hand-written kernels by profiler
name, and the bytes and operations K1 and K6 need for a launch, counted
from its arguments' shapes (frozen here; the numbers are those of the
repository's ``chip_smoke.py``)."""

from __future__ import annotations

# the H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): device
# memory bytes/s and float32 operations/s outside the tensor cores
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12
# float32 operations counted low so the bound stays a bound: K1 adds 3 per
# component and level (the y lerp) to ~30 per sample for the quotient,
# texel coordinate, LUT, opacity and composite; K6 3 per output value (two
# taps)
OPS_K1_BASE, OPS_K6 = 30, 3
# the port's kernel functions in csrc/ (substrings of their profiler
# names) by id
PORT_KERNELS = {"sweep_kernel": "K1", "warp_pass1_kernel": "K2a",
                "warp_pass2_kernel": "K2b",
                "composite_mids_kernel": "K3",
                "classify_field_kernel": "K4", "xf_classify_kernel": "K5",
                "xresample_levels_kernel": "K6"}


def port_kernel(name: str):
    """The id of the port kernel a device event's name belongs to, or
    None."""
    return next((t for f, t in PORT_KERNELS.items() if f in name), None)


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take to move ``nbytes`` (each input
    read once, each output written once) and do ``ops`` float32
    operations, at the published peaks."""
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_S)


def nbytes_of(t) -> int:
    """Bytes of a tensor, of a sequence of tensors, or 0 for None."""
    if t is None:
        return 0
    if isinstance(t, (list, tuple)):
        return sum(nbytes_of(x) for x in t)
    return t.numel() * t.element_size() if hasattr(t, "numel") else 0


def k1_bytes(prep, sec, act_f, act_all_f, tables, kwargs) -> int:
    """Bytes one K1 launch must move: its inputs (the mids, the tile
    tables, positions, secants, the carried transmittance, the
    classification tables, a surface stop) read once and its (4, H, W)
    output written once."""
    h, w = sec.shape
    inputs = (nbytes_of(prep.mids) + nbytes_of(prep.acts_l)
              + nbytes_of(prep.vmin) + nbytes_of(prep.vmax)
              + nbytes_of(prep.y_pos) + nbytes_of(sec) + nbytes_of(act_f)
              + nbytes_of(act_all_f) + nbytes_of(kwargs.get("prev_trans"))
              + nbytes_of([t for t in tables if hasattr(t, "numel")])
              + nbytes_of(kwargs.get("t_stop")))
    return inputs + 4 * h * w * 4


def k1_ops(samples: float, comps: int, levels: int) -> float:
    """Operations of K1 over ``samples`` classified samples."""
    return samples * (3 * comps * levels + OPS_K1_BASE)


def k6_counts(zvs_list, qx_list, outs):
    """(bytes, operations) of one K6 launch set: every level's z-lerped
    block and column coordinates read once, its mids written once, and
    two taps per output value."""
    nbytes = sum(nbytes_of(z) + nbytes_of(q) + nbytes_of(o)
                 for z, q, o in zip(zvs_list, qx_list, outs))
    return nbytes, OPS_K6 * sum(o.numel() for o in outs)
