"""PyTorch port, sweep stage: the activity and stride tables equal the
JAX package's exactly, and the plain-torch K1 (sweep_chunk_reference)
agrees with pallas_sweep.sweep_chunk (Pallas in interpret mode) on one
chunk.  Inputs are made from a seed with numpy and fed to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owlexabrick_tpu.render import pallas_sweep as RS
from owlexabrick_tpu.render import slabs as R
from owlexabrick_tpu_torch.render import slabs as P
from owlexabrick_tpu_torch.render import sweep as PS

from torch_sweep_inputs import (CWS, H, ORG_Y, TILES, W, deep_levels,
                                seeded_inputs)


def _port_mids(d):
    return [torch.from_numpy(np.stack([v, m])) for v, m in d["mids"]]


# the activity tables' cases: (seed, slabs, levels, channels, TF cull);
# seeds 0 and 1 at the shared inputs' shapes, the TF drag's chunk (4
# slabs over 4 levels), 12 slabs (a ragged group of 8), two channels, and
# no TF cull
ACTIVITY_CASES = {0: (0, 6, None, 1, True), 1: (1, 6, None, 1, True),
                  "tf_drag_chunk": (2, 4, 4, 1, True),
                  "s12_ragged": (3, 12, None, 1, True),
                  "two_channels": (4, 6, None, 2, True),
                  "no_cull": (5, 6, None, 1, False)}


@pytest.mark.parametrize("stride", [False, True])
@pytest.mark.parametrize("case", list(ACTIVITY_CASES))
def test_activity_and_stride_tables_exact(stride, case):
    """The geometric tables of ``prepare_chunk`` and the plain K7
    (``combine_activity`` on CPU tensors) equal the JAX package's."""
    seed, slabs, n_levels, channels, cull = ACTIVITY_CASES[case]
    d = seeded_inputs(seed, channels=channels, slabs=slabs,
                      levels=deep_levels(n_levels) if n_levels else None)
    if n_levels:
        # every level spans the rows: level l keeps columns below 16 (l+1)
        # only, so each column tile has another finest level
        for li, (v, m) in enumerate(d["mids"][:-1]):
            v[..., 16 * (li + 1):] = 0.0
            m[..., 16 * (li + 1):] = 0.0
    n_lv = len(d["mids"])
    chans = [v.reshape(-1, *m.shape) for v, m in d["mids"]]
    luts = d.get("luts", [d["lut"]])
    ref_prep = RS.prepare_chunk(
        [([jnp.asarray(c) for c in v], jnp.asarray(m))
         for v, (_, m) in zip(chans, d["mids"])],
        list(d["org_y"]), list(d["cws"]), jnp.asarray(d["y_pos"]), H, W,
        tiles=TILES, adaptive_stride=stride, fuse_mids=False,
        concat_levels=False,
        tf_cull=([jnp.asarray(v) for v in d["vr"]], (1,) * n_lv)
        if cull else None)
    prep = PS.prepare_chunk(
        [torch.from_numpy(np.concatenate([v, m[None]]))
         for v, (_, m) in zip(chans, d["mids"])],
        d["org_y"], d["cws"], torch.from_numpy(d["y_pos"]), H, W,
        tiles=TILES, adaptive_stride=stride,
        tf_cull=([torch.from_numpy(v) for v in d["vr"]], (1,) * n_lv)
        if cull else None)
    assert prep.acts_l.shape == (n_lv, slabs, 3, 3)
    for li in range(n_lv):
        assert np.array_equal(np.asarray(ref_prep.acts_l[li]),
                              prep.acts_l[li].numpy())
    if cull:
        assert prep.vmin.shape[0] == channels
        assert np.array_equal(np.asarray(ref_prep.vmin), prep.vmin.numpy())
        assert np.array_equal(np.asarray(ref_prep.vmax), prep.vmax.numpy())
    else:
        assert prep.vmin is None and ref_prep.vmin is None
    # the tables must exercise both branches of every tile decision
    assert prep.acts_l.any() and not prep.acts_l.all()

    ref_act, ref_all = RS.combine_activity(
        ref_prep, jnp.asarray(d["live"]), [jnp.asarray(lut) for lut in luts],
        [jnp.asarray(dom) for dom in d["dom"]], list(d["cws"]),
        adaptive_stride=stride)
    act, act_all, live_f = PS.combine_activity(
        prep, torch.from_numpy(d["live"]),
        [torch.from_numpy(lut) for lut in luts], torch.from_numpy(d["dom"]),
        adaptive_stride=stride)
    assert np.array_equal(np.asarray(ref_act), act.numpy())
    assert np.array_equal(np.asarray(ref_all), act_all.numpy())
    assert np.array_equal(live_f.numpy(), d["live"].astype(np.float32))
    if stride:
        assert (act > 1).any(), "no adaptive-stride group formed"


@pytest.mark.parametrize("cull", [False, True], ids=["no_cull", "cull"])
def test_k7_argument_packs(cull):
    """K7's int and float packs (``sweep._k7_packs``) carry the shapes it
    is given, the flags, each slab's live bit and the cell widths, from a
    host mask as a bool tensor, a numpy array or a list; a mask of another
    length raises."""
    d = seeded_inputs(6, channels=2, levels=deep_levels(3), slabs=5)
    prep = PS.prepare_chunk(
        [torch.from_numpy(np.concatenate([v, m[None]]))
         for v, m in d["mids"]],
        d["org_y"], d["cws"], torch.from_numpy(d["y_pos"]), H, W,
        tiles=TILES, adaptive_stride=True,
        tf_cull=([torch.from_numpy(v) for v in d["vr"]], (1,) * 3)
        if cull else None)
    live = np.asarray([True, False, True, True, False])
    want = [3, 2 if cull else 0, 5, 3, 3, 32 if cull else 0, int(cull), 1,
            1, 0, 1, 1, 0]
    for host in (torch.from_numpy(live), live, live.tolist()):
        ints, flts = PS._k7_packs(prep, host, 32, True)
        assert ints.dtype == np.int32 and ints.tolist() == want
        assert flts.dtype == np.float32 and flts.tolist() == [1.0, 2.0, 4.0]
    ints, _ = PS._k7_packs(prep, live, 32, False)
    assert ints[7] == 0
    with pytest.raises(ValueError):
        PS._k7_packs(prep, live[:4], 32, True)


@pytest.mark.parametrize("dense", [False, True], ids=["knots", "dense"])
def test_sweep_reference_matches_pallas(dense):
    """One chunk through pallas_sweep.sweep_chunk (default dma lane,
    HIGHEST dots, interpret mode) and the port's plain-torch K1."""
    d = seeded_inputs(2)
    knots_r = knots_p = None
    if not dense:
        knots_r = R.compress_pwl([d["lut"]])
        knots_p = P.compress_pwl([d["lut"]])
        assert knots_p is not None and knots_p.tau == (True,)
    tf_cull_r = ([jnp.asarray(v) for v in d["vr"]], (1, 1))
    dz = np.float32(0.75)
    ref_rgb, ref_t = RS.sweep_chunk(
        [([jnp.asarray(v)], jnp.asarray(m)) for v, m in d["mids"]],
        list(ORG_Y), list(CWS), jnp.asarray(d["y_pos"]),
        jnp.asarray(d["sec"]), jnp.asarray(d["live"]),
        [jnp.asarray(d["lut"])], [jnp.asarray(d["dom"][0])], dz, H, W,
        knots=knots_r, tf_cull=tf_cull_r, tiles=TILES,
        dot_precision="highest", adaptive_stride=True,
        prev_trans=jnp.asarray(d["pt"]), fuse_mids=False, dma_mids=True,
        concat_levels=False)
    rgb, t = PS.sweep_chunk(
        _port_mids(d), ORG_Y, CWS, torch.from_numpy(d["y_pos"]),
        torch.from_numpy(d["sec"]), torch.from_numpy(d["live"]),
        [torch.from_numpy(d["lut"])], torch.from_numpy(d["dom"]), dz, H, W,
        knots=knots_p,
        tf_cull=([torch.from_numpy(v) for v in d["vr"]], (1, 1)),
        tiles=TILES, adaptive_stride=True,
        prev_trans=torch.from_numpy(d["pt"]))
    ref = np.concatenate([np.asarray(ref_rgb), np.asarray(ref_t)[None]])
    got = torch.cat([rgb, t[None]]).numpy()
    diff = np.abs(got - ref).max(0)
    assert (1.0 - ref[3]).max() > 0.3, "chunk composites nothing"
    # f32 sums in another order than the MXU's: ~1e-6
    assert diff.max() < 1e-4, diff.max()
    # the saturated tile did no work in both
    assert np.array_equal(got[:3, :8, :16], np.zeros((3, 8, 16)))


@pytest.mark.parametrize("dense", [False, True], ids=["knots", "dense"])
def test_sweep_reference_matches_pallas_six_channels(dense):
    """A 6-channel chunk (K1 takes 1..MAX_CHANNELS) through
    pallas_sweep.sweep_chunk in interpret mode and the port's plain-torch
    K1: per-channel values, LUTs, domains and TF-cull bounds."""
    from owlexabrick_tpu.core import constants as ref_constants
    from owlexabrick_tpu_torch.core.constants import MAX_CHANNELS

    assert MAX_CHANNELS == ref_constants.MAX_CHANNELS
    n_ch = 6
    d = seeded_inputs(3, channels=n_ch)
    knots_r = knots_p = None
    if not dense:
        knots_r = R.compress_pwl(d["luts"])
        knots_p = P.compress_pwl(d["luts"])
        assert knots_p is not None and len(knots_p.tau) == n_ch
        assert np.array_equal(knots_p.pos, np.asarray(knots_r.pos))
    dz = np.float32(0.75)
    ref_rgb, ref_t = RS.sweep_chunk(
        [([jnp.asarray(c) for c in v], jnp.asarray(m))
         for v, m in d["mids"]],
        list(ORG_Y), list(CWS), jnp.asarray(d["y_pos"]),
        jnp.asarray(d["sec"]), jnp.asarray(d["live"]),
        [jnp.asarray(lut) for lut in d["luts"]],
        [jnp.asarray(dom) for dom in d["dom"]], dz, H, W,
        knots=knots_r, tf_cull=([jnp.asarray(v) for v in d["vr"]], (1, 1)),
        tiles=TILES, dot_precision="highest", adaptive_stride=True,
        prev_trans=jnp.asarray(d["pt"]), fuse_mids=False, dma_mids=True,
        concat_levels=False)
    mids = [torch.from_numpy(np.concatenate([v, m[None]]))
            for v, m in d["mids"]]
    assert mids[0].shape[0] == n_ch + 1
    rgb, t = PS.sweep_chunk(
        mids, ORG_Y, CWS, torch.from_numpy(d["y_pos"]),
        torch.from_numpy(d["sec"]), torch.from_numpy(d["live"]),
        [torch.from_numpy(lut) for lut in d["luts"]],
        torch.from_numpy(d["dom"]), dz, H, W, knots=knots_p,
        tf_cull=([torch.from_numpy(v) for v in d["vr"]], (1, 1)),
        tiles=TILES, adaptive_stride=True,
        prev_trans=torch.from_numpy(d["pt"]))
    ref = np.concatenate([np.asarray(ref_rgb), np.asarray(ref_t)[None]])
    got = torch.cat([rgb, t[None]]).numpy()
    assert (1.0 - ref[3]).max() > 0.3, "chunk composites nothing"
    # f32 sums in another order than the MXU's
    assert np.abs(got - ref).max() < 1e-4, np.abs(got - ref).max()


def _walks(u, lo, top_of, step):
    """Float32 sums of ``step(acc, j)`` over j from the window's ``lo``:
    up to the window's top for every pixel (``top_of(None)``), and per
    pixel up to its own stop (``top_of(u)``), in the same order."""
    win, own = None, None
    hi = top_of(None)
    for j in range(lo, hi):
        win = step(win, j, np.ones_like(u, bool))
        own = step(own, j, j < top_of(u))
    return win, own


@pytest.mark.parametrize("lut_kind", ["bench_jet_tau", "seeded", "dense"])
def test_per_pixel_stop_equals_window_walk(lut_kind):
    """The premise of K1's per-pixel stop: walking a tile's whole knot
    window [lo_k, hi_k) and stopping each pixel at its first knot with
    pos >= u (dense: at floor(u)) give float32 sums that compare equal,
    because every skipped term adds an exact zero."""
    from owlexabrick_tpu_torch.render.camera import Camera
    from owlexabrick_tpu_torch.render.frame import make_frame_state

    f32 = np.float32
    if lut_kind == "bench_jet_tau":
        # the bench's TF (Jet, domain [0, value max], dt 1, opacity 0.7)
        cam = Camera.look_at([32, 32, 140.8], [32, 32, 32], [0, 1, 0],
                             45.0, 64, 36)
        fs = make_frame_state(cam, 1, [[0.0, 1.0]], dt=1.0,
                              opacity_scale=0.7)
        lut = P.scaled_luts(fs, 1)[0]
    else:
        lut = seeded_inputs(4)["lut"]
    n = lut.shape[0]
    rng = np.random.default_rng(11)
    # a tile's texel coordinates: a spread window, integer texels, knots
    u = rng.uniform(17.0, 101.0, 4096).astype(f32)
    u[:128] = np.floor(u[:128])
    if lut_kind == "dense":
        dlut = np.concatenate([lut[:1], lut[1:] - lut[:-1]]).astype(f32)
        lo = min(max(int(np.floor(u.min())), 0), n - 2)
        hi = min(max(int(np.floor(u.max())), 0), n - 2)

        def top_of(x):
            if x is None:
                return hi + 1
            return np.minimum(np.floor(x).astype(np.int64), n - 2) + 1

        def step(acc, kk, on):
            acc = np.broadcast_to(lut[lo], (u.size, 4)) if acc is None \
                else acc
            ramp = np.clip(u - f32(kk), f32(0), f32(1))
            return np.where(on[:, None], acc + ramp[:, None] * dlut[kk + 1],
                            acc)
    else:
        knots = P.compress_pwl([lut])
        assert knots is not None
        if lut_kind == "bench_jet_tau":
            assert knots.tau == (True,)
        pos, sd = knots.pos[0], knots.sd[0]
        assert np.all(np.diff(pos) >= 0), "knot positions must be sorted"
        u[128:128 + 16] = pos[(pos > 17) & (pos < 101)][:16]
        lo = int((pos <= u.min()).sum())
        hi = int((pos < u.max()).sum())
        cum = knots.cum[0, lo]
        first = np.searchsorted(pos, u, side="left")  # first pos >= u

        def top_of(x):
            return hi if x is None else first

        def step(acc, j, on):
            if acc is None:
                acc = (knots.base[0] + u[:, None] * cum[:4]) - cum[4:]
            ramp = np.maximum(u - pos[j], f32(0))
            return np.where(on[:, None], acc + ramp[:, None] * sd[j], acc)
    win, own = _walks(u, lo, top_of, step)
    assert win.dtype == np.float32 and own.dtype == np.float32
    # the per-pixel stops leave out terms (else the test shows nothing)
    assert (top_of(u) < top_of(None)).mean() > 0.5
    assert np.array_equal(win, own)
