"""K1's share of its roofline over the traced stretch, in %: the sum over
its launches of each launch's bound (the larger of its bytes at the
card's bandwidth and its float32 operations at its peak, counted from the
launch's arguments by ``yardstick``) over the sum of its launches' device
time.  The arguments are taken where ``render/slabs.py`` calls the
kernel, through its ``run_chunk``."""

import torch

from portbench.yardstick import bound_s, k1_bytes, k1_ops, port_kernel

TAP = ("owlexabrick_tpu_torch.render.slabs", "run_chunk")


def record(args, kwargs, out):
    """Host-side numbers of one launch (no device sync), and its tile
    weights, whose active share is reduced after the stretch."""
    prep, sec, live, tables, dz, h, w = args[:7]
    act_f = kwargs["act_f"]
    return dict(nbytes=k1_bytes(prep, sec, act_f, kwargs["act_all_f"],
                                tables, kwargs),
                slab_pixels=prep.y_pos.shape[0] * h * w, act_f=act_f,
                comps=prep.mids[0].shape[0], levels=len(prep.mids))


def read(trace):
    calls = trace.calls.get("k1_roofline_pct", [])
    dev_s = sum(e.dur_ns for e in trace.events
                if port_kernel(e.name) == "K1") / 1e9
    if not calls or dev_s <= 0:
        return None
    total = 0.0
    for c in calls:
        # the samples the tile tables leave to classify
        samples = float((c["act_f"] > 0).to(torch.float32).mean()) \
            * c["slab_pixels"]
        total += bound_s(c["nbytes"], k1_ops(samples, c["comps"],
                                             c["levels"]))
    return 100.0 * total / dev_s
