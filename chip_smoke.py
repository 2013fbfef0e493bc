#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``owlexabrick_tpu_torch/csrc`` and
drives the port's two paths on the card: the axis-aligned slab-sweep DVR
and the shear-warp tilted-camera path (an axis-aligned lattice camera
swept by K1, then the two-pass warp K2a + K2b).  Phases, each of which
fails the run:

1. device: the card's name and power limit, and the kernel build
   (``nvcc -Xptxas -v``'s report);
2. K1 (``csrc/sweep.cu``) against its plain-torch version
   ``sweep_chunk_reference`` on seeded inputs at the 64^3 headline's
   1080p chunk shapes (compressed and dense classification), on one
   real chunk of the 256^3 blobs scene, and on a seeded chunk at the
   tilted camera's 2944x1624 lattice (232x128 tiles, 161 blocks), with
   times from CUDA events;
3. K2a + K2b (``csrc/warp.cu``) against ``warp_pass1_reference`` /
   ``warp_pass2_reference`` on the headline's tilted lattice image at
   1080p, as rgba (C = 4) and as the Renderer's color (C = 3);
4. the ``fast_aligned``, ``fast_stride`` and ``fast_shearwarp`` golden
   images through the port's ``Renderer`` on the card, under the golden
   gate;
5. the aligned path at 1920x1080 through ``render_slabs_camera`` on the
   bench's scenes, camera and config (``headline``: 64^3 blobs, 72
   slabs; ``blobs256``: 256^3 blobs, 264 slabs, chunk 24, budget 16),
   uncached and through the camera cache;
6. the tilted path: the same scenes and configs with the eye at
   (0.9n, 0.8n, 2.2n) (``headline_tilted``, ``blobs256_tilted``) through
   ``render_slabs_shearwarp``, uncached and cached, then a few
   progressive frames of ``headline_tilted`` through the ``Renderer``;
7. every row's kernel frame against the plain-torch frame (plain sweep,
   plain warp) on the card.

Launch counts are set to 0 just before each path and read just after;
a kernel of a path that launched no time there fails the run.

``--profile`` adds a torch.profiler trace of one uncached and one cached
frame per row: device time by kernel and the device's busy share (Chrome
traces go to chiprun_out/).

The last line of standard output is ``{"ok": true, "device": {...}}``;
the line before it is the card, and the one before that lists each
kernel with its launches on the two paths.
Exits non-zero without a CUDA card or without the port's sources.
Needs no JAX and no network.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
# bench.py:73-110: camera from (n/2, n/2, 2.2n) at the center, fovy 45,
# TF domain [0, value_max], dt 1, opacity scale 0.7
K1_REPLACES = "owlexabrick_tpu/render/pallas_sweep.py:108"
K2A_REPLACES = "owlexabrick_tpu/render/pallas_warp.py:71"
K2B_REPLACES = "owlexabrick_tpu/render/pallas_warp.py:120"
# K2 against its plain version: max abs over every output value
TOL_K2 = 1e-5
# jax.random jitter of the JAX Renderer's frames 0 and 1 (renderer.py:
# 453-458); tests/test_torch_host.py pins these to jax.random
GOLDEN_JITTER = {0: (0.11854469776153564, -0.06521260738372803),
                 1: (0.016130805015563965, 0.13509845733642578)}
# kernel vs plain: within TOL_PX on FRAC_PX of pixels, TOL_ALL on all
# (the 2e-2 admits saturation-collapse flips at alpha ~ 0.98)
TOL_PX, FRAC_PX, TOL_ALL = 1e-4, 0.999, 2e-2


def log(*a):
    print(*a, flush=True)


def agree(a, b, frac=FRAC_PX):
    """(ok, max_abs, share within TOL_PX) of two (P, k) / (k, H, W)
    results, per pixel over the leading/trailing channel axis."""
    d = (a - b).abs().float()
    per_px = d.amax(dim=-1) if d.dim() == 2 else d.amax(dim=0)
    mx = float(d.max())
    share = float((per_px <= TOL_PX).float().mean())
    return (share >= frac and mx <= TOL_ALL), mx, share


def tilted_setup(setup, n, width, height):
    """A bench row's grids and config with the tilted camera (eye
    (0.9n, 0.8n, 2.2n) at the center, fovy 45: the tilted golden's camera
    at bench distance), and its shear-warp factorization along the
    grids' sweep axis."""
    from owlexabrick_tpu_torch.render.camera import Camera
    from owlexabrick_tpu_torch.render.frame import make_frame_state
    from owlexabrick_tpu_torch.render.shearwarp import (
        inter_dims, setup_shearwarp)
    from owlexabrick_tpu_torch.render.warp import warp_windows

    grids, _, fs, cfg, meta = setup
    cam = Camera.look_at(from_=[n * 0.9, n * 0.8, n * 2.2],
                         at=[n / 2, n / 2, n / 2], up=[0, 1, 0],
                         fovy_degrees=45.0, width=width, height=height)
    fs_t = make_frame_state(cam, 1, [[0.0, meta["value_max"]]], dt=1.0,
                            opacity_scale=0.7)
    sw = setup_shearwarp(cam, grids.axis, width, height,
                         *inter_dims(width, height))
    if sw is None:
        raise SystemExit(f"n={n}: tilted camera does not factorize")
    wb = warp_windows(sw, width, height)
    if wb is None:
        raise SystemExit(f"n={n}: warp_windows admits no two-pass warp, "
                         "so K2 would not run")
    return grids, cam, fs_t, cfg, dict(meta, lattice=[sw.width, sw.height],
                                       windows=list(wb)), sw


def bench_setup(kind, n, width, height, device):
    """Grids, camera, frame state and SlabConfig of a bench row."""
    from owlexabrick_tpu_torch.bench_scene import slab_scene_grids
    from owlexabrick_tpu_torch.render.camera import Camera
    from owlexabrick_tpu_torch.render.frame import make_frame_state
    from owlexabrick_tpu_torch.render.slabs import SlabConfig

    t0 = time.perf_counter()
    grids, meta = slab_scene_grids(kind, n, device=device)
    build_s = time.perf_counter() - t0
    cam = Camera.look_at(from_=[n / 2, n / 2, n * 2.2],
                         at=[n / 2, n / 2, n / 2], up=[0, 1, 0],
                         fovy_degrees=45.0, width=width, height=height)
    fs = make_frame_state(cam, 1, [[0.0, meta["value_max"]]], dt=1.0,
                          opacity_scale=0.7)
    extent = float(grids.bounds_hi[0] - grids.bounds_lo[0])
    ns = int(np.ceil(extent / 1.0))
    chunk, budget = (24, 16) if 200 <= ns <= 600 else (12, 7)
    cfg = SlabConfig(num_channels=1, nslabs=ns, chunk=chunk,
                     chunk_budget_mb=budget)
    return grids, cam, fs, cfg, dict(meta, grids_build_s=round(build_s, 1))


def chunk_inputs(grids, cam, fs, cfg, width, height, chunk_index,
                 lattice=None):
    """One real chunk's sweep inputs on the main path (the prepared
    camera products, the frame's activity tables and LUT tables);
    ``lattice`` for a shear-warp lattice camera."""
    import dataclasses

    import torch

    from owlexabrick_tpu_torch.render import slabs
    from owlexabrick_tpu_torch.render.sweep import combine_activity, pack_luts

    pos, dir00, du, dv = slabs.permute_camera(cam, grids.axis)
    cfg = dataclasses.replace(cfg, flip=bool(dir00[0] < 0))
    hints = slabs.ky_hints_for_camera(grids, cfg, pos, dir00, dv, height,
                                      width, lattice=lattice)
    crop = slabs.y_crop_for_camera(grids, cfg, pos, dir00, dv, height,
                                   lattice=lattice)
    preps = slabs.render_slabs(grids, fs, cfg, pos, dir00, du, dv, width,
                               height, ky_hints=hints, return_products=True,
                               products_chunks=chunk_index + 1,
                               light_rest=False, y_crop=crop,
                               lattice=lattice)
    prep, scale = preps[chunk_index]
    dev = grids.device
    luts_np = slabs.scaled_luts(fs, 1)
    lut = torch.from_numpy(luts_np[0]).to(dev)
    domains = torch.from_numpy(np.asarray(fs.xf_domain, np.float32)).to(dev)
    live = (scale > 1e-6).to(dev)
    act_f, act_all_f = combine_activity(prep, live, [lut], domains)
    knots = slabs.compress_pwl(luts_np)
    _, _, sec = slabs.ray_components(dir00, du, dv, width, height, dev,
                                     lattice=lattice)
    return dict(prep=prep, live=live, act_f=act_f, act_all_f=act_all_f,
                sec=sec, dz=slabs.slab_spacing(grids, cfg.nslabs),
                tables_knots=pack_luts([lut], domains, knots, dev),
                tables_dense=pack_luts([lut], domains, None, dev))


def seeded_chunk(like, seed, device):
    """Seeded random mids and transmittance at ``like``'s shapes (the
    real geometry, tables and activity stay)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    mids = []
    for m in like["prep"].mids:
        r = torch.rand(m.shape, generator=g)
        mask = torch.where(r < 0.2, 0.0, r)
        vals = torch.rand(m.shape, generator=g) * mask
        mids.append(torch.cat([vals[:-1], mask[-1:]]).to(device))
    h, w = like["sec"].shape
    pt = 0.2 + 0.8 * torch.rand((h, w), generator=g)
    return like["prep"]._replace(mids=tuple(mids)), pt.to(device)


def time_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def k1_check(name, ci, prep, pt, tables, width, height, timing):
    """K1 vs plain on one chunk; returns a result dict (fails loudly)."""
    import torch

    from owlexabrick_tpu_torch.render.sweep import (
        sweep_chunk_cuda, sweep_chunk_reference)

    kw = dict(act_f=ci["act_f"], act_all_f=ci["act_all_f"], prev_trans=pt)
    args = (prep, ci["sec"], ci["live"], tables, ci["dz"], height, width)
    n0 = sweep_chunk_cuda.launches
    rgb_k, t_k = sweep_chunk_cuda(*args, **kw)
    rgb_p, t_p = sweep_chunk_reference(*args, **kw)
    torch.cuda.synchronize()
    ok, mx, share = agree(torch.cat([rgb_k, t_k[None]]),
                          torch.cat([rgb_p, t_p[None]]))
    res = dict(name=name, max_abs_err=mx, share_within_tol=share,
               work=float(1.0 - t_k.mean()))
    if timing:
        res["ms"] = time_ms(lambda: sweep_chunk_cuda(*args, **kw), 50)
        res["plain_ms"] = time_ms(lambda: sweep_chunk_reference(*args, **kw),
                                  3, warmup=1)
    res["k1_launches"] = sweep_chunk_cuda.launches - n0
    log("k1 check:", json.dumps(res))
    if not ok or not np.isfinite(mx):
        raise SystemExit(f"K1 disagrees with its plain version on {name}: "
                         f"max {mx}, share {share}")
    return res


def phase_k1(setups, tilted, width, height, device):
    """Phase 2: K1 against sweep_chunk_reference at the main path's
    chunk shapes, the tilted lattice's included."""
    head = setups["headline"]
    ci = chunk_inputs(*head[:4], width, height, chunk_index=2)
    results = []
    prep, pt = seeded_chunk(ci, seed=1234, device=device)
    shapes = [tuple(m.shape) for m in prep.mids]
    log("k1 headline chunk mids shapes (C+1, S, ny, W):", shapes)
    results.append(k1_check("headline_seeded_knots", ci, prep, pt,
                            ci["tables_knots"], width, height, timing=True))
    results.append(k1_check("headline_seeded_dense", ci, prep, pt,
                            ci["tables_dense"], width, height, timing=False))
    results.append(k1_check("headline_real_chunk", ci, ci["prep"],
                            None, ci["tables_knots"], width, height,
                            timing=False))
    b256 = setups["blobs256"]
    cb = chunk_inputs(*b256[:4], width, height, chunk_index=4)
    log("k1 blobs256 chunk mids shapes (C+1, S, ny, W):",
        [tuple(m.shape) for m in cb["prep"].mids])
    results.append(k1_check("blobs256_real_chunk", cb, cb["prep"], None,
                            cb["tables_knots"], width, height, timing=True))

    from owlexabrick_tpu_torch.render.sweep import tile_shape

    grids, _, fs_t, cfg, _, sw = tilted["headline_tilted"]
    iw, ih = sw.width, sw.height
    ct = chunk_inputs(grids, sw.camera, fs_t, cfg, iw, ih, chunk_index=2,
                      lattice=sw.lattice())
    prep, pt = seeded_chunk(ct, seed=4321, device=device)
    tr, tc = tile_shape(ih, iw)
    log(f"k1 tilted lattice {iw}x{ih}: tiles {tr}x{tc}, "
        f"{-(-ih // tr) * -(-iw // tc)} blocks, mids shapes",
        [tuple(m.shape) for m in prep.mids])
    results.append(k1_check("headline_tilted_lattice_seeded", ct, prep, pt,
                            ct["tables_knots"], iw, ih, timing=True))
    return results


def phase_k2(tilted, width, height, device):
    """Phase 3: K2a and K2b against their plain-torch versions on the
    headline's tilted lattice image at 1080p, as rgba (C = 4, the input
    render_slabs_shearwarp warps) and as the Renderer's composited color
    (C = 3), with a jittered lattice phase; each pass on the same input
    as its plain version, times from CUDA events."""
    import torch

    from owlexabrick_tpu_torch.render import warp as PW
    from owlexabrick_tpu_torch.render.dvr import composite_background
    from owlexabrick_tpu_torch.render.slabs import render_slabs_camera

    grids, _, fs_t, cfg, _, sw = tilted["headline_tilted"]
    bi, bj = PW.warp_windows(sw, width, height)
    kx, ky = 0.23, -0.31
    rgba_i = render_slabs_camera(grids, fs_t, cfg, sw.camera, sw.width,
                                 sw.height, lattice=sw.lattice(kx, ky))
    color_i = composite_background(
        rgba_i, torch.zeros(3, dtype=torch.float32, device=device))
    params = PW.warp_params(sw, 0.5 + kx, 0.5 + ky, kx, ky)
    wj0, wi0 = PW.window_starts(params, sw, width, height, bi, bj)
    wj0, wi0 = wj0.to(device), wi0.to(device)
    results = []
    for c, img in ((4, rgba_i), (3, color_i)):
        v_k = PW.warp_pass1_cuda(img, wj0, params, sw, height, bj)
        v_p = PW.warp_pass1_reference(img, wj0, params, sw, height, bj)
        o_k = PW.warp_pass2_cuda(v_p, wi0, params, sw, width, height, bi)
        o_p = PW.warp_pass2_reference(v_p, wi0, params, sw, width, height,
                                      bi)
        full_k = PW.warp_two_pass(img, sw, width, height, bi, bj,
                                  jx=0.5 + kx, jy=0.5 + ky, shift_i=kx,
                                  shift_j=ky)
        full_p = PW.warp_two_pass(img, sw, width, height, bi, bj,
                                  jx=0.5 + kx, jy=0.5 + ky, shift_i=kx,
                                  shift_j=ky, plain=True)
        torch.cuda.synchronize()
        res = dict(
            channels=c, windows=[bi, bj], v_shape=list(v_k.shape),
            k2a_max_abs_err=float((v_k - v_p).abs().max()),
            k2b_max_abs_err=float((o_k - o_p).abs().max()),
            two_pass_max_abs_err=float((full_k - full_p).abs().max()),
            out_mean=float(full_k.mean()),
            k2a_ms=time_ms(lambda: PW.warp_pass1_cuda(
                img, wj0, params, sw, height, bj), 50),
            k2a_plain_ms=time_ms(lambda: PW.warp_pass1_reference(
                img, wj0, params, sw, height, bj), 10),
            k2b_ms=time_ms(lambda: PW.warp_pass2_cuda(
                v_p, wi0, params, sw, width, height, bi), 50),
            k2b_plain_ms=time_ms(lambda: PW.warp_pass2_reference(
                v_p, wi0, params, sw, width, height, bi), 10),
        )
        log("k2 check:", json.dumps(res))
        errs = [res[k] for k in ("k2a_max_abs_err", "k2b_max_abs_err",
                                 "two_pass_max_abs_err")]
        if not all(np.isfinite(e) and e <= TOL_K2 for e in errs):
            raise SystemExit(f"K2 disagrees with its plain version (C={c}): "
                             f"{errs} > {TOL_K2}")
        if not bool(torch.isfinite(full_k).all()) or res["out_mean"] <= 0:
            raise SystemExit(f"K2 output not finite or blank (C={c})")
        results.append(res)
    return results


def phase_goldens(device):
    """Phase 4: the fast_aligned / fast_stride / fast_shearwarp goldens
    on the card (tests/test_golden_images.py's scene and cameras)."""
    from owlexabrick_tpu_torch.bench_scene import synthetic_volume
    from owlexabrick_tpu_torch.render.camera import Camera
    from owlexabrick_tpu_torch.render.frame import make_frame_state
    from owlexabrick_tpu_torch.render.renderer import RenderConfig, Renderer
    from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells
    from owlexabrick_tpu_torch.utils.png import golden_gate, read_png

    w, h, n = 96, 64, 32
    lower, level, scal = volume_to_cells(synthetic_volume(n), 0.004, 3)
    for name, stride, tilted in (("fast_aligned", False, False),
                                 ("fast_stride", True, False),
                                 ("fast_shearwarp", False, True)):
        eye = ([n * 0.9, n * 0.8, n * 2.1] if tilted
               else [n / 2, n / 2, n * 2.1])
        cam = Camera.look_at(eye, [n / 2, n / 2, n / 2], [0, 1, 0], 45.0,
                             w, h)
        fs = make_frame_state(cam, 1, [[0.0, 1.05]], dt=1.0,
                              opacity_scale=0.7)
        r = Renderer((lower, level, scal[None]), w, h,
                     cfg=RenderConfig(num_channels=1, adaptive_stride=stride),
                     frame_state=fs, device=device,
                     jitter=GOLDEN_JITTER.__getitem__)
        r.enable_fast_path()
        if (r._fast[2] == "shearwarp") != tilted:
            raise SystemExit(f"golden {name}: Renderer took {r._fast[2]!r}")
        img = r.image_uint8(r.render_frames(2))
        want = read_png(str(REPO / "tests" / "golden" / f"{name}.png"))
        ok, mx, exact = golden_gate(img, want)
        log(f"golden {name}: max_diff={mx} exact={exact:.4f} "
            f"{'pass' if ok else 'FAIL'}")
        if not ok or not (img[..., :3] > 16).any():
            raise SystemExit(f"golden {name} failed on the card")


def render_row(row, width, height, cfg=None, cache=None):
    """One frame of a row: an aligned row (grids, cam, fs, cfg, meta)
    through render_slabs_camera, a tilted row (which carries its
    ShearWarp sixth) through render_slabs_shearwarp."""
    from owlexabrick_tpu_torch.render.shearwarp import render_slabs_shearwarp
    from owlexabrick_tpu_torch.render.slabs import render_slabs_camera

    grids, cam, fs, row_cfg, _, *sw = row
    cfg = cfg or row_cfg
    if sw:
        return render_slabs_shearwarp(grids, fs, cfg, cam, width, height,
                                      sw=sw[0], camera_cache=cache)
    return render_slabs_camera(grids, fs, cfg, cam, width, height,
                               camera_cache=cache)


def launch_counts():
    from owlexabrick_tpu_torch.render.sweep import sweep_chunk_cuda
    from owlexabrick_tpu_torch.render.warp import (
        warp_pass1_cuda, warp_pass2_cuda)

    return dict(K1=sweep_chunk_cuda.launches, K2a=warp_pass1_cuda.launches,
                K2b=warp_pass2_cuda.launches)


def reset_launch_counts():
    from owlexabrick_tpu_torch.render.sweep import sweep_chunk_cuda
    from owlexabrick_tpu_torch.render.warp import (
        warp_pass1_cuda, warp_pass2_cuda)

    for fn in (sweep_chunk_cuda, warp_pass1_cuda, warp_pass2_cuda):
        fn.launches = 0


def phase_rows(rows, width, height, n_timed=3):
    """Phases 5 and 6: each row at full size, uncached and through the
    camera cache; returns the kernel frames for the plain comparison."""
    import torch

    frames = {}
    for name, row in rows.items():
        cfg, meta = row[3], row[4]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n0 = launch_counts()

        def frame(cache=None):
            t0 = time.perf_counter()
            out = render_row(row, width, height, cache=cache)
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        first, first_ms = frame()
        unc = [frame()[1] for _ in range(n_timed)]
        cache = {}
        cached0, prep_ms = frame(cache)
        cached = [frame(cache) for _ in range(n_timed)]
        img = cached[-1][0]
        rec = dict(
            row=name, frames_uncached_ms=[round(first_ms, 3)]
            + [round(t, 3) for t in unc],
            cache_first_frame_ms=round(prep_ms, 3),
            frames_cached_ms=[round(t, 3) for _, t in cached],
            cache_tier=cache.get("tier", "full"),
            peak_mem_mb=round(torch.cuda.max_memory_allocated() / 1e6, 1),
            nslabs=cfg.nslabs, chunk=cfg.chunk, cells=meta["n_cells"],
            grids_build_s=meta["grids_build_s"],
        )
        for k in ("lattice", "windows"):
            if k in meta:
                rec[k] = meta[k]
        rec.update({f"{k}_launches": v - n0[k]
                    for k, v in launch_counts().items()})
        rec["prepare_ms_est"] = round(
            prep_ms - float(np.median([t for _, t in cached])), 3)
        bit_same = bool(torch.equal(first, cached0))
        ok_c, mx_c, _ = agree(first, img, frac=1.0)
        rec["cached_vs_uncached_max_abs"] = mx_c
        rec["cached_bit_identical"] = bit_same
        finite = bool(torch.isfinite(first).all())
        rec["alpha_mean"] = float(first[:, 3].mean())
        log("main path:", json.dumps(rec))
        if not finite or not rec["alpha_mean"] > 1e-3:
            raise SystemExit(f"{name}: frame not finite or blank")
        if mx_c > 1e-6:
            raise SystemExit(f"{name}: cached frame differs by {mx_c}")
        frames[name] = first
    return frames


def phase_renderer(row, n, width, height, device, n_frames=3):
    """Phase 6, end: progressive frames of the tilted headline through
    the port's Renderer on the card (the user's entry point): it must
    take shear-warp and show a non-blank, finite image."""
    import torch

    from owlexabrick_tpu_torch.bench_scene import synthetic_volume
    from owlexabrick_tpu_torch.render.renderer import RenderConfig, Renderer
    from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

    lower, level, scal = volume_to_cells(synthetic_volume(n), 0.004, 3)
    r = Renderer((lower, level, scal[None]), width, height,
                 cfg=RenderConfig(num_channels=1), frame_state=row[2],
                 device=device)
    r.enable_fast_path()
    if r._fast[2] != "shearwarp":
        raise SystemExit(f"Renderer took {r._fast[2]!r}, not shear-warp")
    times = []
    for _ in range(n_frames):
        t0 = time.perf_counter()
        words = r.render()
        torch.cuda.synchronize()
        times.append(round((time.perf_counter() - t0) * 1e3, 3))
    img = r.image_uint8(words)
    lit = float((img[..., :3] > 16).any(-1).mean())
    finite = bool(torch.isfinite(r.accum).all())
    log("renderer:", json.dumps(dict(
        row="headline_tilted", sweep_axis=int(r._fast[0].axis),
        frames_ms=times, lit_pixel_share=lit, accum_finite=finite)))
    if not finite or lit < 0.05:
        raise SystemExit("Renderer frames not finite or blank")


def phase_plain(rows, frames, width, height):
    """Phase 7: each row's kernel frame against the plain-torch frame
    (plain sweep and, on tilted rows, plain warp) on the card."""
    import dataclasses

    for name, row in rows.items():
        t0 = time.perf_counter()
        plain = render_row(row, width, height,
                           cfg=dataclasses.replace(row[3], plain_sweep=True))
        ms = (time.perf_counter() - t0) * 1e3
        ok, mx, share = agree(frames[name], plain)
        log(f"main path {name}: kernel vs plain frame max_abs={mx} "
            f"share_within_1e-4={share:.6f} plain_frame_ms={ms:.1f}")
        if not ok:
            raise SystemExit(f"{name}: kernel frame disagrees with plain")


def phase_profile(setups, width, height):
    """With ``--profile``: trace one uncached and one cached frame per
    row with torch.profiler; print the device time by kernel, the
    device's busy share of the unprofiled frame time, and write the
    Chrome traces under chiprun_out/."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    for name, row in setups.items():
        cache = {}
        for mode in ("uncached", "cached"):
            c = cache if mode == "cached" else None
            for _ in range(2):  # warm up (and fill the cache)
                render_row(row, width, height, cache=c)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render_row(row, width, height, cache=c)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                render_row(row, width, height, cache=c)
                torch.cuda.synchronize()
            prof.export_chrome_trace(str(out_dir / f"trace_{name}_{mode}.json"))
            rows = []
            for e in prof.key_averages():
                # kernels only: an aten op's entry repeats the device
                # time of the kernels it launched
                if e.device_type != DeviceType.CUDA:
                    continue
                dev_us = getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0))
                if dev_us > 0:
                    rows.append((dev_us, e.count, e.key[:60]))
            rows.sort(reverse=True)
            dev_ms = sum(r[0] for r in rows) / 1e3
            log("profile:", json.dumps(dict(
                row=name, mode=mode, frame_wall_ms=round(wall_ms, 3),
                device_ms=round(dev_ms, 3),
                device_busy_share=round(dev_ms / wall_ms, 4),
                device_launches=sum(r[1] for r in rows),
                top=[dict(kernel=k, ms=round(us / 1e3, 3), n=n)
                     for us, n, k in rows[:8]])))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    try:
        from owlexabrick_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e})",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    log("card:", card)
    log("torch", torch.__version__, "cuda", torch.version.cuda)
    t0 = time.perf_counter()
    kernels.build(force=True)
    kernels.load()
    log(f"kernel build {time.perf_counter() - t0:.1f} s")
    for line in kernels.build_log().splitlines():
        if "ptxas" in line or "error" in line.lower():
            log("  " + line.strip())

    dev = torch.device("cuda")
    width, height = 1920, 1080
    setups, tilted = {}, {}
    for name, kind, n in (("headline", "blobs", 64),
                          ("blobs256", "blobs", 256)):
        setups[name] = bench_setup(kind, n, width, height, dev)
        tilted[f"{name}_tilted"] = tilted_setup(setups[name], n, width,
                                                height)
        log(f"scene {name}: {json.dumps(setups[name][4])} "
            f"nslabs={setups[name][3].nslabs}; tilted lattice "
            f"{tilted[f'{name}_tilted'][4]['lattice']}, warp windows "
            f"{tilted[f'{name}_tilted'][4]['windows']}")

    k1 = phase_k1(setups, tilted, width, height, dev)
    k2 = phase_k2(tilted, width, height, dev)
    phase_goldens(dev)

    # each path runs with the launch counts set to 0 just before it
    reset_launch_counts()
    frames = phase_rows(setups, width, height)
    aligned = launch_counts()
    log("launches on the aligned path:", json.dumps(aligned))
    if aligned["K1"] <= 0:
        raise SystemExit("the aligned path launched K1 no time")
    reset_launch_counts()
    frames.update(phase_rows(tilted, width, height))
    phase_renderer(tilted["headline_tilted"], 64, width, height, dev)
    tilt = launch_counts()
    log("launches on the tilted path:", json.dumps(tilt))
    if min(tilt.values()) <= 0:
        raise SystemExit(f"the tilted path left a kernel unlaunched: {tilt}")

    rows = {**setups, **tilted}
    phase_plain(rows, frames, width, height)
    if "--profile" in sys.argv[1:]:
        phase_profile(rows, width, height)

    timed = next(r for r in k1 if r["name"] == "headline_seeded_knots")
    k2_rows = next(r for r in k2 if r["channels"] == 4)
    src_warp = "owlexabrick_tpu_torch/csrc/warp.cu"
    log(json.dumps({"kernels": [{
        "name": "K1 slab-sweep megakernel",
        "route": "cuda",
        "source": "owlexabrick_tpu_torch/csrc/sweep.cu",
        "replaces": K1_REPLACES,
        "launches": aligned["K1"] + tilt["K1"],
        "max_abs_err": max(r["max_abs_err"] for r in k1),
        "ms": timed["ms"],
        "plain_ms": timed["plain_ms"],
    }, {
        "name": "K2a warp pass 1 (vertical Catmull-Rom)",
        "route": "cuda",
        "source": src_warp,
        "replaces": K2A_REPLACES,
        "launches": tilt["K2a"],
        "max_abs_err": max(r["k2a_max_abs_err"] for r in k2),
        "ms": k2_rows["k2a_ms"],
        "plain_ms": k2_rows["k2a_plain_ms"],
    }, {
        "name": "K2b warp pass 2 (horizontal Catmull-Rom)",
        "route": "cuda",
        "source": src_warp,
        "replaces": K2B_REPLACES,
        "launches": tilt["K2b"],
        "max_abs_err": max(r["k2b_max_abs_err"] for r in k2),
        "ms": k2_rows["k2b_ms"],
        "plain_ms": k2_rows["k2b_plain_ms"],
    }]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
