"""PyTorch port on the card: K1 (csrc/sweep.cu, with and without its
surface stop, under a clear and a set early-exit flag, at 2 to 16
levels), K7 (csrc/sweep.cu, bit for bit),
K2a/K2b (csrc/warp.cu), K3 (from the mids, at 1 to 12 levels), K4, K5
(csrc/xf.cu) and K6 (csrc/mids.cu) against their plain-torch versions
(K1, K3 and K4 also through a 32-texel LUT, and K3 on the unclipped
chunks of ``megakernel=False``), and the port's main path (its flagged
early exit too), einsum
lane and iso path, the packed exact march (against the classic one
too), the offline CLI's ``--fast`` runs and the web
viewer's frames (``aox=1`` among them) on CUDA against the same paths on
the CPU, and a 2-rank gloo mesh whose ranks share the card against the
same work in one process.  Marked ``cuda``; each test skips where no card
is present (the check runs inside the fixture, never at import).
Imports no jax, so it also runs where only torch is installed; there,
skip the suite's conftest, which sets up jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from owlexabrick_tpu_torch.core.constants import MAX_CHANNELS
from owlexabrick_tpu_torch.render import sweep as PS
from owlexabrick_tpu_torch.utils.profiling import counts as COUNTS

from torch_sweep_inputs import (
    EXIT_H, EXIT_W, H, K3_MIDS_CASES, TILES, W, deep_levels, exit_scene,
    k3_mids_inputs, k6_level_cases, seeded_inputs)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _texels(lut, n):
    """An (128, 4) LUT resampled linearly to ``n`` texels (the
    ``xf_knots`` speed mode's LUT)."""
    uu = np.linspace(0.0, 127.0, n)
    return np.stack([np.interp(uu, np.arange(128), lut[:, k])
                     for k in range(4)], 1).astype(np.float32)


def _k1_against_plain(cuda, dense, carry, stop, channels, tiles=TILES,
                      levels=None, texels=128, flag=None):
    """K1 and its plain twin on one seeded chunk (``levels``:
    ``deep_levels``' table, else two levels; ``texels``: the dense LUT's
    texels; ``flag``: the early exit's flag, None, "clear" or "set");
    returns K1's launch shape after checking every output value within
    1e-5, and, under a set flag, that both return exactly rgb 0 and the
    carried transmittance (1 without a carry)."""
    from owlexabrick_tpu_torch.render.slabs import compress_pwl

    d = seeded_inputs(5, channels=channels, levels=levels)
    luts_np = d.get("luts", [d["lut"]])
    if texels != 128:
        luts_np = [_texels(lut, texels) for lut in luts_np]
    mids = [torch.from_numpy(np.concatenate([v.reshape(-1, *m.shape),
                                             m[None]])).to(cuda)
            for v, m in d["mids"]]
    luts = [torch.from_numpy(lut).to(cuda) for lut in luts_np]
    dom = torch.from_numpy(d["dom"]).to(cuda)
    knots = None if dense else compress_pwl(luts_np)
    assert dense or knots is not None
    prep = PS.prepare_chunk(
        mids, d["org_y"], d["cws"], torch.from_numpy(d["y_pos"]).to(cuda),
        H, W,
        tiles=tiles, adaptive_stride=True,
        tf_cull=([torch.from_numpy(v).to(cuda) for v in d["vr"]],
                 (1,) * len(d["vr"])))
    act_f, act_all_f, live = PS.combine_activity(prep, d["live"], luts, dom,
                                                 adaptive_stride=True)
    tables = PS.pack_luts(luts, dom, knots, cuda)
    args = (prep, torch.from_numpy(d["sec"]).to(cuda), live, tables,
            np.float32(0.75), H, W)
    kw = dict(act_f=act_f, act_all_f=act_all_f, tiles=tiles,
              adaptive_stride=True,
              prev_trans=(torch.from_numpy(d["pt"]).to(cuda) if carry
                          else None))
    if flag is not None:
        kw["done"] = torch.tensor([flag == "set"], device=cuda)
    if stop:
        # per-slab sweep parameters and a per-pixel stop cutting about
        # half the slabs, a quarter of the pixels exactly at a slab
        rng = np.random.default_rng(9)
        s_ = d["y_pos"].shape[0]
        t_slab = (10.0 + 0.5 * np.arange(s_)).astype(np.float32)
        t_img = rng.uniform(t_slab[0], t_slab[-1], (H, W)).astype(np.float32)
        tie = rng.uniform(size=(H, W)) < 0.25
        t_img[tie] = t_slab[rng.integers(0, s_, (H, W))][tie]
        kw["t_stop"] = (torch.from_numpy(t_slab).to(cuda),
                        torch.from_numpy(t_img).to(cuda))
    n0 = COUNTS["launch.K1"]
    rgb_k, t_k = PS.sweep_chunk_cuda(*args, **kw)
    assert COUNTS["launch.K1"] == n0 + 1
    rgb_p, t_p = PS.sweep_chunk_reference(*args, **kw)
    torch.cuda.synchronize()
    k = torch.cat([rgb_k, t_k[None]])
    p = torch.cat([rgb_p, t_p[None]])
    assert torch.isfinite(k).all()
    assert float((k - p).abs().max()) < 1e-5
    if flag == "set":
        t0 = kw["prev_trans"] if carry else torch.ones_like(t_k)
        for rgb, t in ((rgb_k, t_k), (rgb_p, t_p)):
            assert torch.equal(rgb, torch.zeros_like(rgb))
            assert torch.equal(t, t0)
    return PS.k1_launch_shape(prep, tables, H, W, tiles=tiles,
                              adaptive_stride=True, has_pt=carry,
                              has_stop=stop)


@pytest.mark.parametrize("channels", [1, 2, 6])
@pytest.mark.parametrize("stop", [False, True], ids=["free", "stop"])
@pytest.mark.parametrize("dense", [False, True], ids=["knots", "dense"])
@pytest.mark.parametrize("carry", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("flag", [None, "clear", "set"],
                         ids=["unflagged", "flag_clear", "flag_set"])
def test_k1_matches_plain_version(cuda, dense, carry, stop, channels, flag):
    shape = _k1_against_plain(cuda, dense, carry, stop, channels, flag=flag)
    assert shape["carry_on_chip"] == 1 and shape["cluster"] > 1


@pytest.mark.parametrize("channels", [1, 4, 10])
@pytest.mark.parametrize("n_levels", [9, 12, 16])
def test_k1_many_levels_match_plain_version(cuda, n_levels, channels):
    """More levels than K1's old table of 8: a seeded chunk of 9-16
    levels at 1-10 channels launches (the per-row taps grow with the
    level count; a carry that no longer fits beside them moves to the
    global scratch) and matches its twin within 1e-5."""
    shape = _k1_against_plain(cuda, False, True, True, channels,
                              levels=deep_levels(n_levels))
    assert shape["cluster"] > 1 and shape["smem_bytes"] > 0


@pytest.mark.parametrize("carry", [False, True], ids=["fresh", "carried"])
def test_k1_ragged_row_tiles_match_plain_version(cuda, carry):
    """16-row tiles over 24 rows: the second row of tiles is half past the
    image, so some of its cluster's blocks hold no pixel at all and enter
    the tile max only through their out-of-bounds lanes."""
    shape = _k1_against_plain(cuda, False, carry, True, 2, tiles=(16, 16))
    assert shape["rows_per_block"] * shape["cluster"] == 16


@pytest.mark.parametrize("dense", [False, True], ids=["knots", "dense"])
def test_k1_carry_in_global_memory_matches_plain_version(cuda, dense):
    """A tile whose carry does not fit in shared memory (64x1024 at six
    channels, most of it past the image) keeps it in the global scratch."""
    shape = _k1_against_plain(cuda, dense, True, True, 6, tiles=(64, 1024))
    assert shape["carry_on_chip"] == 0 and shape["carry_floats"] > 0


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("stop", [False, True], ids=["free", "stop"])
def test_k1_dense_32_texels_matches_plain_version(cuda, stop, channels):
    """K1's dense classification of a 32-texel LUT (``xf_knots=32``)
    against its twin within 1e-5, with the carry in."""
    shape = _k1_against_plain(cuda, True, True, stop, channels, texels=32)
    assert shape["carry_on_chip"] == 1


# K7's cases: (slabs, levels, channels, LUT texels, the channel whose TF
# domain is degenerate or None); 12 slabs leave a ragged group of 8
K7_CASES = {"s1": (1, 1, 1, 128, None), "s4": (4, 4, 1, 128, None),
            "s12": (12, 9, 2, 32, 1), "s24": (24, 4, MAX_CHANNELS, 128, None),
            "s256": (256, 4, 2, 128, None)}


def _k7_inputs(cuda, case, cull, live_kind, seed=17):
    """Seeded K7 inputs on the card at 1080p's 5 x 15 tiles: per tile a
    finest level (coarser levels active at random above it, some tiles
    with none), so stride groups of 2, 4 and 8 form; TF-cull bounds with
    empty (+inf, -inf) and inverted ranges; LUTs whose alpha is 0 over
    runs (past two channels, the last one's everywhere); a degenerate
    domain (lo = hi); live all dead, one live or mixed.
    Returns (prep, live on the host, luts, domains)."""
    s_, n_lv, n_ch, n_tex, degenerate = K7_CASES[case]
    rng = np.random.default_rng(seed + s_)
    n_rt, n_ct = 5, 15
    finest = rng.integers(0, n_lv + 1, (n_rt, n_ct))  # n_lv: no level
    lv = np.arange(n_lv)[:, None, None, None]
    acts = (lv >= finest[None, None]) & (
        rng.uniform(size=(n_lv, s_, n_rt, n_ct)) < 0.7)
    vmin = rng.uniform(-0.3, 1.2, (n_ch, s_, n_rt)).astype(np.float32)
    vmax = (vmin + rng.uniform(-0.1, 0.5, vmin.shape)).astype(np.float32)
    empty = rng.uniform(size=vmin.shape) < 0.1
    vmin[empty], vmax[empty] = np.inf, -np.inf
    luts = rng.uniform(0.0, 1.0, (n_ch, n_tex, 4)).astype(np.float32)
    luts[:, :n_tex * 2 // 5, 3] = 0.0
    luts[:, 3 * n_tex // 4::3, 3] = 0.0
    if n_ch > 2:
        luts[-1, :, 3] = 0.0
    dom = np.stack([rng.uniform(-0.2, 0.2, n_ch),
                    rng.uniform(0.8, 1.2, n_ch)], 1).astype(np.float32)
    if degenerate is not None:
        # every entry then reads texels 0 and 1: give them some alpha
        luts[degenerate, :, 3] = rng.uniform(0.1, 1.0, n_tex)
        dom[degenerate, 1] = dom[degenerate, 0]
    live = {"dead": np.zeros(s_, bool), "one": np.arange(s_) == s_ // 2,
            "mixed": rng.uniform(size=s_) < 0.8}[live_kind]
    if live_kind == "mixed":  # the first slab live, the last dead (S > 1)
        live[0] = True
        live[-1] = s_ == 1

    def dev(a):
        return torch.from_numpy(a).to(cuda)

    prep = PS.ChunkPrep(
        mids=(), origins_y=(0.0,) * n_lv,
        cell_widths=tuple(float(1 << i) for i in range(n_lv)),
        acts_l=dev(acts), vmin=dev(vmin) if cull else None,
        vmax=dev(vmax) if cull else None,
        y_pos=torch.zeros((s_, 1), device=cuda))
    return prep, live, [dev(lut) for lut in luts], dev(dom)


@pytest.mark.parametrize("live_kind", ["dead", "one", "mixed"])
@pytest.mark.parametrize("stride", [False, True], ids=["unit", "stride"])
@pytest.mark.parametrize("cull", [False, True], ids=["no_cull", "cull"])
@pytest.mark.parametrize("case", sorted(K7_CASES))
def test_k7_bit_equal_plain(cuda, case, cull, stride, live_kind):
    """K7 (``combine_activity_cuda``) against ``combine_activity_reference``
    on the card, ``torch.equal`` on every table; the dispatcher launches
    K7 once for CUDA tables and gives the same."""
    prep, live, luts, dom = _k7_inputs(cuda, case, cull, live_kind)
    live_d = torch.from_numpy(live).to(cuda)
    n0 = COUNTS["launch.K7"]
    got = PS.combine_activity_cuda(prep, live, luts, dom,
                                   adaptive_stride=stride)
    assert COUNTS["launch.K7"] == n0 + 1
    want = (*PS.combine_activity_reference(prep, live_d, luts, dom,
                                           adaptive_stride=stride),
            live_d.to(torch.float32))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    routed = PS.combine_activity(prep, torch.from_numpy(live), luts, dom,
                                 adaptive_stride=stride)
    assert COUNTS["launch.K7"] == n0 + 2
    assert all(torch.equal(g, w) for g, w in zip(routed, want))
    act = want[0]
    if live_kind == "dead":
        assert not act.any()
    else:
        assert act.any() and not act.all()
        if stride and live_kind == "mixed" and prep.acts_l.shape[1] >= 4:
            assert (act > 1).any(), "no adaptive-stride group formed"


def test_k7_refuses_what_it_does_not_take(cuda):
    """More slabs than MAX_SLABS, CPU tensors beside CUDA ones and a live
    mask on the card raise; nothing falls back."""
    from owlexabrick_tpu_torch import kernels

    prep, live, luts, dom = _k7_inputs(cuda, "s4", True, "mixed")
    s_ = kernels.MAX_SLABS + 1
    big = prep._replace(acts_l=torch.zeros((1, s_, 5, 15), dtype=torch.bool,
                                           device=cuda), vmin=None, vmax=None,
                        cell_widths=(1.0,))
    bad = [(big, np.ones(s_, bool), luts, dom),
           (prep, live, [lut.cpu() for lut in luts], dom),
           (prep, live, luts, dom.cpu()),
           (prep._replace(vmin=prep.vmin.cpu()), live, luts, dom),
           (prep, torch.from_numpy(live).to(cuda), luts, dom)]
    n0 = COUNTS["launch.K7"]
    for args in bad:
        with pytest.raises(ValueError):
            PS.combine_activity_cuda(*args, adaptive_stride=True)
    assert COUNTS["launch.K7"] == n0


def test_main_path_on_card_matches_cpu(cuda):
    """render_slabs_camera on the card (K6, K1) == on the CPU (plain)."""
    from owlexabrick_tpu_torch.bench_scene import synthetic_volume
    from owlexabrick_tpu_torch.render.camera import Camera
    from owlexabrick_tpu_torch.render.frame import make_frame_state
    from owlexabrick_tpu_torch.render.slabs import (
        SlabConfig, level_grids_from_cells, render_slabs_camera)
    from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

    lower, level, scal = volume_to_cells(synthetic_volume(16), 0.004, 3)
    g_cpu = level_grids_from_cells(lower, level, scal[None], device="cpu")
    g_gpu = g_cpu.to(cuda)
    cam = Camera.look_at([8.0, 8.0, 40.0], [8.0, 8.0, 8.0], [0, 1, 0],
                         30.0, 24, 24)
    fs = make_frame_state(cam, 1, [[0.0, 1.0]], dt=1.0, opacity_scale=0.8)
    cfg = SlabConfig(nslabs=20, chunk=4, adaptive_stride=True)
    n0 = (COUNTS["launch.K1"], COUNTS["launch.K6"], COUNTS["launch.K7"])
    got = render_slabs_camera(g_gpu, fs, cfg, cam, 24, 24).cpu()
    assert COUNTS["launch.K1"] > n0[0]
    assert COUNTS["launch.K6"] > n0[1]
    # one K7 per chunk swept
    assert COUNTS["launch.K7"] - n0[2] == COUNTS["launch.K1"] - n0[0]
    want = render_slabs_camera(g_cpu, fs, cfg, cam, 24, 24)
    assert float((got - want).abs().max()) < 1e-5
    plain = render_slabs_camera(
        g_gpu, fs, dataclasses.replace(cfg, plain_sweep=True), cam, 24,
        24).cpu()
    assert float((plain - want).abs().max()) < 1e-5
    assert float(want[:, 3].max()) > 0.3


@pytest.mark.parametrize("poll", [None, 1], ids=["poll", "poll_every"])
@pytest.mark.parametrize("carry", [None, "partial", "saturated"],
                         ids=["fresh", "partial", "saturated"])
def test_flag_exit_on_card_matches_cpu(cuda, carry, poll, monkeypatch,
                                       record_property):
    """The early exit's scene (every pixel crosses alpha 0.98 in chunk 3 of
    8; with the saturated carry, before chunk 0) on the megakernel lane:
    the card's frame, whose loop never waits and whose K1 reads the flag,
    equals the frame of the loop that waits at every chunk's top bit for
    bit, and the CPU's frame within 1e-5, with the flags copied to the
    host every ``_FlagExit.POLL`` chunks or every chunk; the flag's
    counters are reported (how many chunks run flagged depends on how far
    the host ran ahead)."""
    from owlexabrick_tpu_torch.render import slabs

    if poll is not None:
        monkeypatch.setattr(slabs._FlagExit, "POLL", poll)
    g_cpu, fs, cfg, cam, rgba0 = exit_scene("cpu", carry)
    g_gpu = g_cpu.to(cuda)
    c0 = dict(COUNTS)
    got = slabs.render_slabs_camera(g_gpu, fs, cfg, cam, EXIT_W, EXIT_H,
                                    carry=rgba0).cpu()
    flagged = COUNTS["exit.flagged"] - c0.get("exit.flagged", 0)
    late = COUNTS["exit.late_chunks"] - c0.get("exit.late_chunks", 0)
    record_property("exit.flagged", flagged)
    record_property("exit.late_chunks", late)
    print(f"exit.flagged {flagged}, exit.late_chunks {late}")
    assert flagged in (0, 1) and late >= flagged
    assert flagged or late == 0
    assert COUNTS["sync.early_exit"] == c0.get("sync.early_exit", 0)
    with monkeypatch.context() as mp:
        mp.setattr(slabs, "_FlagExit", lambda dev, n: slabs._SyncExit())
        ref = slabs.render_slabs_camera(g_gpu, fs, cfg, cam, EXIT_W, EXIT_H,
                                        carry=rgba0).cpu()
    assert torch.equal(got, ref)
    want = slabs.render_slabs_camera(g_cpu, fs, cfg, cam, EXIT_W, EXIT_H,
                                     carry=rgba0)
    assert float((got - want).abs().max()) < 1e-5
    assert bool((got[:, 3] >= 0.98).all())


@pytest.mark.parametrize("c", [3, 4])
@pytest.mark.parametrize("layout", ["pixel_major", "planar"])
def test_k2_matches_plain_version(cuda, c, layout):
    """K2a + K2b (csrc/warp.cu) against warp_two_pass_reference on the
    card, on white noise (every window clamp shows), with jitter and
    lattice shifts; the input as (P, C) rows or as a transposed planar
    (C, P) image, the sweep's layout."""
    from owlexabrick_tpu_torch.render import warp as PW
    from owlexabrick_tpu_torch.render.camera import Camera
    from owlexabrick_tpu_torch.render.shearwarp import (
        inter_dims, setup_shearwarp)

    w, h = 256, 128
    cam = Camera.look_at([57.6, 51.2, 140.8], [32.0, 32.0, 32.0], [0, 1, 0],
                         45.0, w, h)
    iw, ih = inter_dims(w, h)
    sw = setup_shearwarp(cam, 2, w, h, iw, ih)
    bi, bj = PW.warp_windows(sw, w, h)
    rng = np.random.default_rng(c)
    img = torch.from_numpy(
        rng.uniform(0, 1, (iw * ih, c)).astype(np.float32)).to(cuda)
    if layout == "planar":
        img = img.T.contiguous().T
    kw = dict(jx=0.63, jy=0.29, shift_i=0.13, shift_j=-0.21)
    n1, n2 = COUNTS["launch.K2a"], COUNTS["launch.K2b"]
    got = PW.warp_two_pass(img, sw, w, h, bi, bj, **kw)
    assert COUNTS["launch.K2a"] == n1 + 1
    assert COUNTS["launch.K2b"] == n2 + 1
    want = PW.warp_two_pass(img, sw, w, h, bi, bj, plain=True, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (w * h, c)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) < 1e-5
    cpu = PW.warp_two_pass(img.cpu(), sw, w, h, bi, bj, **kw)
    assert float((got.cpu() - cpu).abs().max()) < 1e-5


def _xf_inputs(s, h, w, seed):
    """Seeded einsum-lane fields: invalid samples (sw = 0), values beyond
    the TF domain on both sides, a dead slab, grazing rays (large sec),
    and a LUT with opacity-1 steps."""
    rng = np.random.default_rng(seed)
    sw = rng.uniform(0.0, 2.0, (s, h, w)).astype(np.float32)
    sw[rng.uniform(size=sw.shape) < 0.15] = 0.0
    value = rng.uniform(-0.4, 1.4, (s, h, w)).astype(np.float32)
    swv = (value * np.where(sw > 0, sw, 1.0)).astype(np.float32)
    sec = rng.uniform(1.0, 6.0, (h, w)).astype(np.float32)
    sec[0, :7] = 900.0
    live = np.ones(s, bool)
    live[1] = False
    lut = rng.uniform(0.0, 1.0, (128, 4)).astype(np.float32)
    lut[64:80, 3] = 1.0
    return sw, swv, sec, live, lut


@pytest.mark.parametrize("shape", [(5, 21, 200), (12, 40, 512)])
def test_k4_matches_plain_version(cuda, shape):
    """K4 (csrc/xf.cu) against classify_field_reference on the card:
    every output value within 1e-5, the launch count up by one."""
    from owlexabrick_tpu_torch.render import classify as PC

    sw, swv, sec, live, lut = (torch.from_numpy(a).to(cuda)
                               for a in _xf_inputs(*shape, seed=3))
    dom, dz = np.asarray([0.1, 0.9], np.float32), np.float32(0.75)
    n4 = COUNTS["launch.K4"]
    got4 = PC.classify_field(sw, swv, sec, lut, dom, dz)
    assert COUNTS["launch.K4"] == n4 + 1
    want4 = PC.classify_field(sw, swv, sec, lut, dom, dz, plain=True)
    torch.cuda.synchronize()
    for g, p in zip(got4, want4):
        assert g.shape == p.shape and torch.isfinite(g).all()
        assert float((g - p).abs().max()) <= 1e-5
    assert float(got4[3].max()) > 0.5


def test_k4_32_texels_matches_plain_version(cuda):
    """K4 classifying through a 32-texel LUT (``xf_knots=32`` on a
    shaded or multi-channel einsum-lane frame) against its twin within
    1e-5."""
    from owlexabrick_tpu_torch.render import classify as PC

    sw, swv, sec, _, lut = _xf_inputs(12, 40, 512, seed=4)
    sw, swv, sec, lut = (torch.from_numpy(a).to(cuda)
                         for a in (sw, swv, sec, _texels(lut, 32)))
    dom, dz = np.asarray([0.1, 0.9], np.float32), np.float32(0.75)
    n4 = COUNTS["launch.K4"]
    got = PC.classify_field(sw, swv, sec, lut, dom, dz)
    assert COUNTS["launch.K4"] == n4 + 1
    want = PC.classify_field(sw, swv, sec, lut, dom, dz, plain=True)
    torch.cuda.synchronize()
    for g, p in zip(got, want):
        assert torch.isfinite(g).all()
        assert float((g - p).abs().max()) <= 1e-5


@pytest.mark.parametrize("case", ["levels4", "no_interval"])
def test_k3_mids_32_texels_bit_equal_plain(cuda, case):
    """K3 from the mids through a 32-texel LUT against its twin, bit for
    bit, with the clip interval and without (the unclipped one-channel
    chunk ``megakernel=False`` sends)."""
    from owlexabrick_tpu_torch.render import classify as PC

    d = k3_mids_inputs(case)
    d["lut"] = _texels(d["lut"], 32)

    def dev(v):
        return None if v is None else torch.from_numpy(v).to(cuda)

    args = ([dev(m) for m in d["mids"]], [dev(tp) for tp in d["taps"]],
            dev(d["scale"]), dev(d["t_start"]), dev(d["t_stop"]),
            dev(d["sec"]), dev(d["lut"]), d["dom"], d["dz"])
    n0 = COUNTS["launch.K3"]
    got = PC.composite_mids(*args)
    assert COUNTS["launch.K3"] == n0 + 1
    want = PC.composite_mids(*args, plain=True)
    torch.cuda.synchronize()
    for g, p in zip(got, want):
        assert torch.isfinite(g).all() and torch.equal(g, p)


def test_k3_unclipped_lane_on_card_equals_plain(cuda):
    """``SlabConfig(megakernel=False)``: a one-channel frame without a
    clip box on the einsum lane, on the card (K6, then K3 from the mids
    with an open interval) equal to its plain versions on the card bit
    for bit and to the CPU frame within 1e-5; K3 launches once per
    chunk with a live slab."""
    from owlexabrick_tpu_torch.bench_scene import synthetic_volume
    from owlexabrick_tpu_torch.render import slabs as P
    from owlexabrick_tpu_torch.render.camera import Camera
    from owlexabrick_tpu_torch.render.frame import make_frame_state
    from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

    lower, level, scal = volume_to_cells(synthetic_volume(32), 0.004, 3)
    cam = Camera.look_at([16.0, 16.0, 70.0], [16.0, 16.0, 16.0], [0, 1, 0],
                         30.0, 200, 120)
    fs = make_frame_state(cam, 1, [[0.0, 1.05]], dt=1.0, opacity_scale=0.8)
    cfg = P.SlabConfig(nslabs=18, chunk=4, megakernel=False)
    frames = []
    for device, plain in ((cuda, False), (cuda, True), ("cpu", False)):
        g = P.level_grids_from_cells(lower, level, scal[None], device=device)
        n3 = COUNTS["launch.K3"]
        frames.append(P.render_slabs_camera(
            g, fs, dataclasses.replace(cfg, plain_sweep=plain), cam, 200,
            120).cpu())
        k3 = COUNTS["launch.K3"] - n3
        assert (k3 == 0) == (plain or device == "cpu")
    assert torch.equal(frames[0], frames[1])
    assert float((frames[0] - frames[2]).abs().max()) < 1e-5
    assert float(frames[0][:, 3].max()) > 0.3


@pytest.mark.parametrize("case", sorted(K3_MIDS_CASES))
def test_k3_mids_bit_equal_plain(cuda, case):
    """K3 from the mids (csrc/xf.cu) against composite_mids_reference on
    the card, bit for bit: 1, 4, 8, 9 and 12 levels (past 8, the grouped
    path), W = 1000, a 2944 x 1624
    lattice, an interval every pixel misses and none; one launch per
    call."""
    from owlexabrick_tpu_torch.render import classify as PC

    d = k3_mids_inputs(case)

    def dev(v):
        return None if v is None else torch.from_numpy(v).to(cuda)

    mids = [dev(m) for m in d["mids"]]
    taps = [dev(tp) for tp in d["taps"]]
    args = (mids, taps, dev(d["scale"]), dev(d["t_start"]), dev(d["t_stop"]),
            dev(d["sec"]), dev(d["lut"]), d["dom"], d["dz"])
    n0 = COUNTS["launch.K3"]
    got = PC.composite_mids(*args)
    assert COUNTS["launch.K3"] == n0 + 1
    want = PC.composite_mids(*args, plain=True)
    torch.cuda.synchronize()
    for g, p in zip(got, want):
        assert g.shape == p.shape and torch.isfinite(g).all()
        assert torch.equal(g, p)
    assert (case == "all_infinite") == bool((got[1] == 1.0).all())


def test_k3_route_on_card_equals_plain(cuda, monkeypatch):
    """The one-channel clip route on the card (K6, then K3) equals its
    plain versions on the card bit for bit, with dead slabs (18 slabs in
    chunks of 4) and the clip box's interval; K3 launches once per chunk
    with a live slab and K6 once per such chunk with an occupied
    level."""
    from owlexabrick_tpu_torch.bench_scene import synthetic_volume
    from owlexabrick_tpu_torch.render import slabs as P
    from owlexabrick_tpu_torch.render.camera import Camera
    from owlexabrick_tpu_torch.render.frame import make_frame_state
    from owlexabrick_tpu_torch.render.renderer import clip_interval
    from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

    lower, level, scal = volume_to_cells(synthetic_volume(32), 0.004, 3)
    g = P.level_grids_from_cells(lower, level, scal[None], device=cuda)
    cam = Camera.look_at([16.0, 16.0, 70.0], [16.0, 16.0, 16.0], [0, 1, 0],
                         30.0, 200, 120)
    fs = make_frame_state(cam, 1, [[0.0, 1.05]], dt=1.0, opacity_scale=0.8)
    t0, t1 = clip_interval(2, cam, None, 200, 120, np.eye(3, 4), cam.pos,
                           [8.0, 0.0, 0.0], [32.0, 32.0, 25.6], device=cuda)
    calls = []
    mids = P._EinsumLane.mids

    def spy(lane, z_s, occ_s, scale):
        calls.append(sum(bool(o.any()) for o in occ_s))
        return mids(lane, z_s, occ_s, scale)

    monkeypatch.setattr(P._EinsumLane, "mids", spy)
    frames = []
    for plain in (False, True):
        calls.clear()
        n3, n6 = COUNTS["launch.K3"], COUNTS["launch.K6"]
        frames.append(P.render_slabs_camera(
            g, fs, P.SlabConfig(nslabs=18, chunk=4, plain_sweep=plain), cam,
            200, 120, t_start=t0, t_stop=t1))
        k3, k6 = COUNTS["launch.K3"] - n3, COUNTS["launch.K6"] - n6
        want = (0, 0) if plain else (len(calls),
                                     sum(n > 0 for n in calls))
        assert (k3, k6) == want
    torch.cuda.synchronize()
    assert len(calls) >= 3
    assert torch.equal(frames[0], frames[1])
    assert float(frames[0][:, 3].max()) > 0.3


@pytest.mark.parametrize("channels,grad", [(1, False), (2, False), (1, True),
                                           (2, True)])
def test_einsum_lane_on_card_matches_cpu(cuda, channels, grad):
    """The einsum lane (clip box interval, gradient shading, two
    channels) on the card (K3 or K4) == on the CPU (plain versions)."""
    from owlexabrick_tpu_torch.bench_scene import synthetic_volume
    from owlexabrick_tpu_torch.render.camera import Camera
    from owlexabrick_tpu_torch.render.frame import make_frame_state
    from owlexabrick_tpu_torch.render.renderer import clip_interval
    from owlexabrick_tpu_torch.render.slabs import (
        SlabConfig, level_grids_from_cells, render_slabs_camera)
    from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

    lower, level, scal = volume_to_cells(synthetic_volume(16), 0.004, 3)
    fields = np.stack([scal, 1.05 - scal][:channels])
    g_cpu = level_grids_from_cells(lower, level, fields, device="cpu")
    g_gpu = g_cpu.to(cuda)
    cam = Camera.look_at([8.0, 8.0, 40.0], [8.0, 8.0, 8.0], [0, 1, 0],
                         30.0, 24, 24)
    fs = make_frame_state(cam, channels, [[0.0, 1.05], [0.0, 4.0]][:channels],
                          dt=1.0, opacity_scale=0.8)
    cfg = SlabConfig(num_channels=channels, nslabs=20, chunk=4,
                     gradient_shading_dvr=grad)
    box = ([4.0, 0.0, 0.0], [16.0, 16.0, 12.8])
    kernel = "launch.K4" if channels > 1 or grad else "launch.K3"
    frames = []
    for dev, g in (("cuda", g_gpu), ("cpu", g_cpu)):
        t0, t1 = clip_interval(2, cam, None, 24, 24, np.eye(3, 4), cam.pos,
                               *box, device=dev)
        n0 = COUNTS[kernel]
        frames.append(render_slabs_camera(g, fs, cfg, cam, 24, 24,
                                          t_start=t0, t_stop=t1).cpu())
        assert (COUNTS[kernel] > n0) == (dev == "cuda")
    got, want = frames
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) < 1e-5
    assert float(want[:, 3].max()) > 0.3


def test_k5_matches_plain_version(cuda):
    """K5 (csrc/xf.cu) against xf_classify_reference on the card: u over
    [0, 127] with every integer texel, a random LUT, within 1e-5."""
    from owlexabrick_tpu_torch.render import classify as PC

    rng = np.random.default_rng(4)
    u = rng.uniform(0.0, 127.0, (64, 1000)).astype(np.float32)
    u[0, :128] = np.arange(128, dtype=np.float32)
    lut = rng.uniform(0.0, 1.0, (128, 4)).astype(np.float32)
    u_d, lut_d = torch.from_numpy(u).to(cuda), torch.from_numpy(lut).to(cuda)
    n0 = COUNTS["launch.K5"]
    got = PC.xf_classify(u_d, lut_d)
    assert COUNTS["launch.K5"] == n0 + 1
    want = PC.xf_classify(u_d, lut_d, plain=True)
    torch.cuda.synchronize()
    for g, p in zip(got, want):
        assert g.shape == (64, 1000) and torch.isfinite(g).all()
        assert float((g - p).abs().max()) <= 1e-5


def test_k6_matches_plain_version(cuda):
    """K6 (csrc/mids.cu) against xresample_mids_reference on the card:
    seeded blocks, qx past both lattice ends and on lattice points, ny no
    multiple of the kernel's row split, within 1e-6."""
    from owlexabrick_tpu_torch.render import mids as PM

    rng = np.random.default_rng(8)
    c, s_, ny, nx, w = 3, 5, 37, 29, 300
    zvs = torch.from_numpy(rng.uniform(-1.0, 2.0, (c, s_, ny, nx)).astype(
        np.float32)).to(cuda)
    qx = np.sort(rng.uniform(-2.5, nx + 1.5, (s_, w)), 1).astype(np.float32)
    qx[:, 10:20] = np.arange(10, dtype=np.float32)
    qx = torch.from_numpy(qx).to(cuda)
    n0 = COUNTS["launch.K6"]
    got = PM.xresample_mids(zvs, qx)
    assert COUNTS["launch.K6"] == n0 + 1
    want = PM.xresample_mids(zvs, qx, plain=True)
    torch.cuda.synchronize()
    assert got.shape == (c, s_, ny, w) and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.parametrize("case", ["levels4", "levels9", "ragged_w",
                                  "wide_window"])
def test_k6_levels_bit_equal_plain(cuda, case):
    """The level-batched K6 against the plain version on the card, bit
    for bit, in one launch per 8 levels."""
    from owlexabrick_tpu_torch.render import mids as PM

    zvs_l, qx_l = k6_level_cases()[case]
    zt = [torch.from_numpy(z).to(cuda) for z in zvs_l]
    qt = [torch.from_numpy(q).to(cuda) for q in qx_l]
    want = PM.xresample_mids_levels(zt, qt, plain=True)
    n0 = COUNTS["launch.K6"]
    got = PM.xresample_mids_levels(zt, qt)
    assert (COUNTS["launch.K6"] - n0
            == -(-len(zt) // PM.K6_MAX_LEVELS))
    torch.cuda.synchronize()
    assert len(got) == len(want)
    assert all(torch.equal(g, p) for g, p in zip(got, want))


def test_iso_on_card_matches_cpu(cuda):
    """The iso sweep, the volume stopped at its hits (K1's stop, its
    camera products' x stage in K6) and the colormap recolor (K5) on the
    card == on the CPU (plain versions)."""
    from owlexabrick_tpu_torch.bench_scene import synthetic_volume
    from owlexabrick_tpu_torch.render.camera import Camera
    from owlexabrick_tpu_torch.render.frame import make_frame_state
    from owlexabrick_tpu_torch.render.slabs import (
        SlabConfig, level_grids_from_cells, render_slabs_camera,
        render_slabs_iso_camera)
    from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

    lower, level, scal = volume_to_cells(synthetic_volume(16), 0.004, 3)
    g_cpu = level_grids_from_cells(lower, level,
                                   np.stack([scal, 1.05 - scal]),
                                   device="cpu")
    g_gpu = g_cpu.to(cuda)
    cam = Camera.look_at([8.0, 8.0, 40.0], [8.0, 8.0, 8.0], [0, 1, 0],
                         30.0, 24, 24)
    fs = make_frame_state(cam, 2, [[0.0, 1.05], [0.0, 1.05]], dt=1.0,
                          opacity_scale=0.8)
    fs = dataclasses.replace(fs, iso_enabled=np.asarray([True, False]),
                             iso_value=np.asarray([0.55, 0.0], np.float32))
    cfg = SlabConfig(num_channels=2, nslabs=20, chunk=4, colormap_channel=1)
    counts = ("launch.K1", "launch.K5", "launch.K6")
    frames = []
    for g in (g_gpu, g_cpu):
        n0 = [COUNTS[k] for k in counts]
        rgba_i, t_iso, n, cos = render_slabs_iso_camera(
            g, fs, cfg, cam, 24, 24, return_normals=True)
        vol = render_slabs_camera(g, fs, cfg, cam, 24, 24, t_stop=t_iso)
        frames.append([x.cpu() for x in (rgba_i, t_iso, n, cos, vol)])
        ran = [COUNTS[k] > c for k, c in zip(counts, n0)]
        assert ran == [g is g_gpu] * 3
    # the fields round alike on both devices but for the order of a few
    # sums: hit masks may flip at an exact tie, so compare where both hit
    got, want = frames
    hit = (got[0][:, 3] > 0) & (want[0][:, 3] > 0)
    assert (hit == (want[0][:, 3] > 0)).float().mean() >= 0.99
    assert int(hit.sum()) > 20
    for g, w in zip(got[:4], want[:4]):
        assert float((g[hit] - w[hit]).abs().max()) < 1e-4
    assert float((got[4] - want[4]).abs().max(1).values.gt(1e-4)
                 .float().mean()) <= 0.01


@pytest.mark.parametrize("prims", ["triangles", "streamlines"])
def test_tiled_traces_on_card_equal_dense(cuda, prims):
    """The tiled triangle and streamline traces on the card (screen-tiled
    ray blocks, the candidate pairs, the per-ray sphere test) equal the
    dense traces on the card bit for bit, and hit the pixels the CPU's
    dense trace hits."""
    from owlexabrick_tpu_torch.bench_scene import bumpy_sphere, helix_bundle
    from owlexabrick_tpu_torch.render import surfaces as S

    from torch_sweep_inputs import camera_rays

    w, h = 96, 64
    if prims == "triangles":
        surf = S.SurfaceData.from_meshes([bumpy_sphere()], device="cpu")
        o, d = camera_rays(w, h, [70.0, 45.0, 80.0], [0.0, 0.0, 0.0])
        dense = S.trace_triangles
        tiled = lambda *a, **kw: S.trace_triangles_tiled(  # noqa: E731
            *a, screen=(w, h), **kw)
    else:
        surf = S.SurfaceData.from_arrays(
            np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3)),
            np.zeros((0, 3)), *helix_bundle(64), 1.2, device="cpu")
        o, d = camera_rays(w, h, [40.0, 50.0, 150.0], [32.0, 32.0, 32.0])
        dense = lambda s, *a: S.trace_streamlines(s, 49, *a)  # noqa: E731
        tiled = lambda s, *a: S.trace_streamlines_tiled(  # noqa: E731
            s, 49, *a, screen=(w, h))
    p = o.shape[0]
    args = [torch.from_numpy(o), torch.from_numpy(d),
            torch.full((p,), 1e-6), torch.full((p,), 2e10)]
    t_cpu, _ = dense(surf, *args)
    surf_g = S.SurfaceData.from_arrays(
        *(getattr(surf, k).numpy() for k in (
            "tri_v0", "tri_e1", "tri_e2", "tri_n", "seg_a", "seg_b",
            "seg_t")), surf.seg_radius, device=cuda)
    args = [a.to(cuda) for a in args]
    t_d, n_d = dense(surf_g, *args)
    t_t, n_t = tiled(surf_g, *args)
    assert torch.equal(t_t, t_d) and torch.equal(n_t, n_d)
    hit = torch.isfinite(t_cpu)
    assert int(hit.sum()) > 100
    assert torch.equal(torch.isfinite(t_d).cpu(), hit)


def test_ao_shadow_fast_on_card_matches_cpu(cuda):
    """The lattice AO estimator (iso indicator, 8 shadow volumes, the
    per-pixel pool draws, a geometric occluder OR-ed in) on the card
    against the same call on the CPU: within 1e-6 on 99.9% of 20,000
    seeded hits."""
    from owlexabrick_tpu_torch.bench_scene import synthetic_volume
    from owlexabrick_tpu_torch.render import ao_sweep as A
    from owlexabrick_tpu_torch.render import prng
    from owlexabrick_tpu_torch.render.camera import Camera
    from owlexabrick_tpu_torch.render.frame import make_frame_state
    from owlexabrick_tpu_torch.render.slabs import level_grids_from_cells
    from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

    n = 48
    lower, level, scal = volume_to_cells(synthetic_volume(n), 0.004, 3)
    lat = A.build_ao_lattice(level_grids_from_cells(lower, level, scal,
                                                    axis=2, device="cpu"))
    cam = Camera.look_at([n / 2, n / 2, 2 * n], [n / 2] * 3, [0, 1, 0],
                         45.0, 64, 64)
    fs = dataclasses.replace(
        make_frame_state(cam, 1, [[0.0, 1.05]], ao_enabled=True,
                         ao_length=n * 0.5),
        iso_enabled=np.asarray([True, False]),
        iso_value=np.asarray([0.55 * float(scal.max()), 0.0], np.float32))
    rng = np.random.default_rng(3)
    hits = rng.uniform(2.0, n - 2.0, (20000, 3)).astype(np.float32)
    nrm = rng.normal(size=(20000, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    key = prng.fold_in(prng.fold_in(prng.prng_key(0x51AB), 2), 7)
    out = []
    for dev in (cuda, torch.device("cpu")):
        out.append(A.ao_shadow_fast(
            A.lattice_to(lat, dev), fs, torch.from_numpy(hits).to(dev),
            torch.from_numpy(nrm).to(dev), key, ao_samples=2,
            geom_occluder=lambda dp: (dp[:, 0] > 0.2).to(torch.float32),
            ao_dirs=4).cpu())
    got, want = out
    assert 0.05 < float(want.mean()) < 0.95
    assert float(((got - want).abs() <= 1e-6).float().mean()) >= 0.999


def test_native_builder_loads_on_card_machine(cuda):
    """The native core builds from the checkout's source into build/
    and its scene lands on the card."""
    from owlexabrick_tpu_torch import native
    from owlexabrick_tpu_torch.bench_scene import synthetic_volume
    from owlexabrick_tpu_torch.pipeline import scene_from_cells
    from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

    assert native.build().exists()
    lower, level, scal = volume_to_cells(synthetic_volume(16), 0.004, 3)
    scene, *_ = scene_from_cells(lower, level, [scal], device=cuda)
    cpu, *_ = scene_from_cells(lower, level, [scal], device="cpu")
    assert scene.device.type == "cuda"
    for k, v in cpu.host_arrays().items():
        assert np.array_equal(scene.host_arrays()[k], v), k


@pytest.mark.parametrize("grad", [False, True], ids=["plain", "gradient"])
def test_trace_dvr_on_card_matches_cpu(cuda, grad):
    """The exact march on the card against the same code on the CPU on a
    seeded 24^3 scene (within 1e-4 on 99.9% of values, 2e-2 on all: the
    card sums a sample's basis terms in another order), and the exact
    iso march's hits."""
    from owlexabrick_tpu_torch.bench_scene import synthetic_volume
    from owlexabrick_tpu_torch.pipeline import scene_from_cells
    from owlexabrick_tpu_torch.render.camera import Camera
    from owlexabrick_tpu_torch.render.dvr import (
        RenderConfig, generate_rays, trace_dvr)
    from owlexabrick_tpu_torch.render.frame import make_frame_state
    from owlexabrick_tpu_torch.render.iso import trace_iso_rays
    from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

    n = 24
    lower, level, scal = volume_to_cells(synthetic_volume(n), 0.004, 3)
    scene, *_ = scene_from_cells(lower, level, [scal], device="cpu")
    cam = Camera.look_at([n * 0.9, n * 0.7, n * 2.2], [n / 2] * 3,
                         [0, 1, 0], 45.0, 64, 48)
    fs = dataclasses.replace(
        make_frame_state(cam, 1, [[0.0, 1.05]], dt=1.0, opacity_scale=0.7),
        iso_enabled=np.asarray([True, False]),
        iso_value=np.asarray([0.55, 0.0], np.float32))
    cfg = RenderConfig(gradient_shading_dvr=grad, iso_surfaces=True)
    rng = np.random.default_rng(11)
    jit = torch.from_numpy(rng.random((64 * 48, 2)).astype(np.float32))
    off = torch.from_numpy(rng.random(64 * 48).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda):
        s = scene.to(dev)
        o, d = generate_rays(fs, 64, 48, jit.to(dev), dev)
        rgba, iters = trace_dvr(s, fs, cfg, o, d, off.to(dev),
                                return_stats=True)
        p = o.shape[0]
        t_iso = trace_iso_rays(s, fs, cfg, o, d,
                               torch.full((p,), 1e-6, device=dev),
                               torch.full((p,), 2e10, device=dev))[0]
        out[str(dev)] = (rgba.cpu(), iters.cpu(), t_iso.cpu())
    (a, ia, ta), (b, ib, tb) = out["cpu"], out["cuda"]
    diff = (a - b).abs().amax(-1)
    assert float((diff <= 1e-4).float().mean()) >= 0.999
    assert float(diff.max()) <= 2e-2 and float(a[:, 3].max()) > 0.5
    assert float((ia == ib).float().mean()) >= 0.999
    hit = torch.isfinite(ta)
    assert float((hit == torch.isfinite(tb)).float().mean()) >= 0.999
    both = hit & torch.isfinite(tb)
    assert float((ta[both] - tb[both]).abs().max()) <= 1e-2


@pytest.mark.parametrize("channels", [1, 2])
def test_packed_march_on_card_matches_classic_and_cpu(cuda, channels):
    """The packed march (``wavefront.trace_dvr_packed``) on the card
    against the classic march on the card and against itself on the CPU
    on a seeded 24^3 scene (within 1e-4 on 99.9% of values, 2e-2 on all),
    its pack's tables built on the card equal to the CPU's, and the
    Renderer's exact frame on the card taking the packed route."""
    from owlexabrick_tpu_torch.bench_scene import synthetic_volume
    from owlexabrick_tpu_torch.pipeline import scene_from_cells
    from owlexabrick_tpu_torch.render.camera import Camera
    from owlexabrick_tpu_torch.render.dvr import (
        RenderConfig, generate_rays, trace_dvr)
    from owlexabrick_tpu_torch.render.frame import make_frame_state
    from owlexabrick_tpu_torch.render.renderer import Renderer
    from owlexabrick_tpu_torch.render.scene import scene_bricks
    from owlexabrick_tpu_torch.render.slabs import build_level_grids
    from owlexabrick_tpu_torch.render.wavefront import (
        build_pack, trace_dvr_packed)
    from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

    n = 24
    lower, level, scal = volume_to_cells(synthetic_volume(n), 0.004, 3)
    fields = [scal, 1.05 - scal][:channels]
    scene, *_ = scene_from_cells(lower, level, fields,
                                 num_range_channels=channels, device="cpu")
    cam = Camera.look_at([n * 0.9, n * 0.7, n * 2.2], [n / 2] * 3,
                         [0, 1, 0], 45.0, 64, 48)
    fs = make_frame_state(cam, channels, [[0.0, 1.05]] * channels, dt=1.0,
                          opacity_scale=0.7)
    cfg = RenderConfig(num_channels=channels)
    rng = np.random.default_rng(12)
    jit = torch.from_numpy(rng.random((64 * 48, 2)).astype(np.float32))
    off = torch.from_numpy(rng.random(64 * 48).astype(np.float32))
    out, packs = {}, {}
    for dev in ("cpu", cuda):
        s = scene.to(dev)
        pack = build_pack(s, build_level_grids(*scene_bricks(s), axis=2,
                                               device=dev))
        o, d = generate_rays(fs, 64, 48, jit.to(dev), dev)
        out[str(dev)] = [trace_dvr_packed(pack, s, fs, cfg, o, d,
                                          off.to(dev)).cpu(),
                         trace_dvr(s, fs, cfg, o, d, off.to(dev)).cpu()]
        packs[str(dev)] = pack
    a, b = packs["cpu"], packs["cuda"]
    assert torch.equal(a.node_pack, b.node_pack.cpu())
    assert torch.equal(a.start_grid, b.start_grid.cpu())
    assert torch.equal(a.flat, b.flat.cpu())
    want = out["cuda"][0]
    assert float(want[:, 3].max()) > 0.5
    for other in (out["cpu"][0], out["cuda"][1]):
        diff = (want - other).abs().amax(-1)
        assert float((diff <= 1e-4).float().mean()) >= 0.999
        assert float(diff.max()) <= 2e-2
    r = Renderer(scene, 64, 48, cfg=cfg, frame_state=fs, device=cuda)
    r.render()
    assert r.exact_route == "packed_compacted"
    assert bool(torch.isfinite(r.accum).all())


@pytest.mark.parametrize("case", ["aligned", "tilted", "bands2", "clip"])
def test_cli_fast_on_card_matches_cpu(cuda, tmp_path, case):
    """The offline CLI's --fast run with ``--device cuda`` (the kernels)
    against ``--device cpu`` (the plain twins): every pixel within
    1/255, and the path's kernel launched (K1; K3 for the clip box; at
    this size ``warp_windows`` admits no two-pass warp, so the tilted
    frame warps in torch, as the JAX package does)."""
    from owlexabrick_tpu_torch.builder.__main__ import main as build_main
    from owlexabrick_tpu_torch.tools.artificial import generate
    from owlexabrick_tpu_torch.utils.png import read_png
    from owlexabrick_tpu_torch.viewer.offline import main

    (tmp_path / "g.grids").write_text(
        "0 0 0 6 6 6 0 0 1 2 3 4 5 6 7\n6 0 0 2 2 2 1 4\n")
    generate(str(tmp_path / "g.grids"), str(tmp_path / "d"))
    assert build_main([str(tmp_path / "d.cells"), "-o",
                       str(tmp_path / "d.bricks")]) == 0
    (tmp_path / "s.exa").write_text(
        "bricks d.bricks\nscalar density d.scalars\nvalue_range 0 7\n")
    eye = ["14", "9", "20"] if case == "tilted" else ["5", "3", "30"]
    args = [str(tmp_path / "s.exa"), "--fast", "--size", "96", "64", "--dt",
            "0.7", "--frames", "2", "--camera", *eye, "5", "3", "3", "0",
            "1", "0", "--fov", "40"]
    args += {"bands2": ["--bands", "2"],
             "clip": ["--clip-box", "2", "0", "0", "10", "6", "4"]
             }.get(case, [])
    fns = {"aligned": ["launch.K1"], "bands2": ["launch.K1"],
           "tilted": ["launch.K1"], "clip": ["launch.K3"]}[case]
    n0 = {fn: COUNTS[fn] for fn in fns}
    imgs = []
    for dev in ("cuda", "cpu"):
        out = str(tmp_path / f"{dev}.png")
        assert main(args + ["--device", dev, "-o", out]) == 0
        imgs.append(read_png(out).astype(int))
        if dev == "cuda":
            assert all(COUNTS[fn] > n0[fn] for fn in fns), case
    assert np.abs(imgs[0] - imgs[1]).max() <= 1
    assert (imgs[0][..., :3] > 8).any()


def _viewer_query(**kw):
    q = dict(theta=0.5, phi=0.3, dist=1.2, frame=0, field=0,
             cmap="Paraview Cool Warm", customcm="", lo=0, hi=7, os=1,
             dt=0.5, iso=0, gsiso=1, caxis="off", coff=0.5, clip=0, cx0=0,
             cy0=0, cz0=0, cx1=1, cy1=1, cz1=1, gsdvr=0, skip=1)
    q.update(kw)
    return {k: str(v) for k, v in q.items()}


@pytest.mark.parametrize("query", ["orbit", "clip", "iso", "aox"])
def test_serve_frame_on_card_matches_cpu(cuda, tmp_path, query):
    """The web viewer with ``device="cuda"``, served through a real
    ThreadingHTTPServer on 127.0.0.1 (rendering on its handler thread),
    against ``device="cpu"`` on the same query under the golden gate:
    the tilted orbit pose, the clip box (K3), an iso value and one
    ``aox=1`` frame (exact AO over the iso hits) at 48x32."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer
    from io import BytesIO
    from urllib.parse import urlencode

    from owlexabrick_tpu_torch.utils.png import golden_gate, read_png
    from owlexabrick_tpu_torch.viewer import serve

    from test_torch_cli import make_scene_dir

    d = make_scene_dir(tmp_path)
    kw = {"orbit": {}, "clip": dict(clip=1, cx0=0.3, cz1=0.8),
          "iso": dict(iso=3.3), "aox": dict(iso=3.3, ao=1, aolen=4, aox=1)
          }[query]
    q = _viewer_query(**kw)
    card = serve.ViewerState(str(d / "one.exa"), 48, 32, device="cuda")
    handler = type("Handler", (serve._Handler,), {"state": card})
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    fn = "launch.K3" if query == "clip" else "launch.K1"
    n0 = COUNTS[fn]
    try:
        url = (f"http://127.0.0.1:{server.server_address[1]}/frame?"
               + urlencode(q))
        with urllib.request.urlopen(url, timeout=300) as r:
            assert r.status == 200
            got = read_png(BytesIO(r.read()))
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=30)
    assert COUNTS[fn] > n0
    cpu = serve.ViewerState(str(d / "one.exa"), 48, 32, device="cpu")
    want = read_png(BytesIO(cpu.render({k: [v] for k, v in q.items()})))
    ok, dmax, exact = golden_gate(got, want)
    assert ok, (query, dmax, exact)
    assert (got[..., :3] > 8).any()


def test_mesh_two_gloo_ranks_share_card(cuda, tmp_path):
    """Two gloo ranks on ``cuda:0`` (the exchanges staged through host
    memory): a 2x1 px mesh of the exact path, 2 pixel bands and 2 z
    bands of the slab path, each rank's image equal to the same work in
    one process on the card at the dry run's tolerances, and K1 and K6
    launched in the ranks."""
    import json

    import torch.multiprocessing as mp

    from torch_mesh_ranks import free_port, one_process, port_cases, run

    cases = port_cases("cuda:0")
    torch.save(cases, tmp_path / "cases.pt")
    mp.start_processes(run, args=(2, free_port(), str(tmp_path / "cases.pt"),
                                  str(tmp_path)),
                       nprocs=2, join=True, start_method="spawn")
    for name, case in cases.items():
        imgs = [np.load(tmp_path / f"{name}_r{r}.npy") for r in range(2)]
        assert np.array_equal(imgs[0], imgs[1])
        one = one_process(case).cpu().numpy()
        tol = (dict(rtol=1e-4, atol=2e-5) if case["mode"] == "z"
               else dict(rtol=1e-5, atol=1e-6))
        np.testing.assert_allclose(imgs[0], one, **tol)
    for r in range(2):
        counts = json.loads((tmp_path / f"launches_r{r}.json").read_text())
        assert counts["bands2"]["K1"] > 0 and counts["bands2"]["K6"] > 0
        assert counts["z2"]["K1"] > 0 and counts["z2"]["K6"] > 0
