#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``owlexabrick_tpu_torch/csrc`` and
drives the port's paths on the card: the axis-aligned slab-sweep
DVR (camera products whose x stage is K6, then the sweep K1), the
shear-warp tilted-camera path (an axis-aligned lattice camera swept by
K6 + K1, then the two-pass warp K2a + K2b), the sweep's einsum lane (the
clip box: each level's mids by K6, then K3; DVR gradient shading and
multi-channel clip: fields rebuilt per slab, then K4) and the iso-surface path (the iso sweep, its
colormap recolor through K5, the volume stopped at the hits by K1's
surface stop) and the surface path (meshes, streamline segments and the
lattice AO through the ``Renderer``: the traces and the AO estimator are
torch ops, their depth K1's surface stop), and the exact path (the
scene build, the packed region march of ``render/wavefront.py`` on the
JAX Renderer's route and the classic one, the exact iso march, contour
planes, ``ao_exact``: torch ops, no port kernel).  Phases, each of which
fails the run:

1. device: the card's name and power limit, and the kernel build
   (``nvcc -Xptxas -v``'s report; K1's registers and spills per channel
   count);
2. K1 (``csrc/sweep.cu``) against its plain-torch version
   ``sweep_chunk_reference``, every value within TOL_K1, on seeded
   inputs at the 64^3 headline's 1080p chunk shapes (compressed and
   dense classification, each with and without a surface stop cutting
   about half the slabs, and at 2 and 6 channels), on one real chunk of
   the headline and of the 256^3 blobs scene, and on a seeded chunk at
   the tilted camera's 2944x1624 lattice (232x128 tiles, 161 tiles);
   each with its launch shape (cluster, grid, threads, dynamic shared
   memory, clusters resident) and times from CUDA events and CUDA-graph
   replay;
3. K2a + K2b (``csrc/warp.cu``) against ``warp_pass1_reference`` /
   ``warp_pass2_reference`` on the headline's tilted lattice image at
   1080p, as rgba (C = 4) and as the Renderer's color (C = 3);
4. the ``fast_aligned``, ``fast_stride``, ``fast_shearwarp`` and
   ``ao_sweep`` golden images through the port's ``Renderer`` on the
   card, under the golden gate;
5. the aligned path at 1920x1080 through ``render_slabs_camera`` on the
   bench's scenes, camera and config (``headline``: 64^3 blobs, 72
   slabs; ``blobs256``: 256^3 blobs, 264 slabs, chunk 24, budget 16),
   uncached (K6 and K1) and through the camera cache (K1);
6. the tilted path: the same scenes and configs with the eye at
   (0.9n, 0.8n, 2.2n) (``headline_tilted``, ``blobs256_tilted``) through
   ``render_slabs_shearwarp``, uncached and cached, then a few
   progressive frames of ``headline_tilted`` through the ``Renderer``;
7. every row's kernel frame against the plain-torch frame (plain x
   stage, plain sweep, plain warp) on the card;
8. K4 (``csrc/xf.cu``) against ``classify_field_reference`` on seeded
   1080p fields at S = 12 and S = 24 and on the fields of a real chunk
   of the ``headline_clip`` row, with times from CUDA events; K3 from
   the mids (``csrc/xf.cu``: the y lerp of each level's mids, the clip
   masks and the composite) bit for bit against
   ``composite_mids_reference`` on a real chunk of ``headline_clip``,
   ``blobs256_clip`` and ``headline_tilted_clip``, timed by CUDA events
   and graph replay;
9. the einsum lane at 1920x1080 (uncached: it has no product cache):
   the clipbox golden's box scaled to n on the headline (aligned,
   ``headline_clip``; through shear-warp, ``headline_tilted_clip``) and
   on blobs256 (``blobs256_clip``), DVR gradient shading
   (``headline_gradient``, ``blobs256_gradient``) and two channels under
   the box (``headline_2ch_clip``); then progressive ``Renderer`` frames
   with the clip box, aligned and tilted, and with gradient shading;
10. every einsum-lane row's kernel frame against its plain frame;
11. K5 (``csrc/xf.cu``) against ``xf_classify_reference`` on seeded
    texel coordinates at 1080p and on the colormap row's real hit image;
    K6 (``csrc/mids.cu``, one launch per chunk for every level) bit for
    bit against ``xresample_mids_reference`` on a seeded level block and,
    from a real uncached frame of the headline and of blobs256, on the
    largest level block, the largest chunk and the whole frame, timed
    beside ``fill_`` of its outputs (the card's store speed on them) and
    one PyTorch call that computes its function (``grid_sample``), the
    yardstick ``library_ms``;
12. the iso path at 1920x1080, one iso surface at 0.524 of the value
    maximum, gradient shading iso on: ``headline_iso``, ``blobs256_iso``
    (uncached and cached), ``headline_tilted_iso`` (shear-warp) and
    ``headline_2ch_iso_colormap`` (K5), then progressive ``Renderer``
    frames with the iso surface, aligned and tilted, and every iso row's
    kernel frame against its plain frame;
13. the surface path at 1920x1080 through the ``Renderer``
    (``surface_setups``): a 10,224-triangle bumpy sphere in the 64^3
    volume, aligned (``headline_mesh``) and through shear-warp
    (``headline_tilted_mesh``), 4,096 streamline segments over the
    256^3 volume with the last quarter hidden (``blobs256_streamlines``),
    the iso rows' iso with the lattice AO (``headline_iso_ao``,
    ``blobs256_iso_ao``) and the mesh with both (``headline_mesh_iso_ao``):
    uncached and cached frames, launches, the tiled traces' calls and
    peak memory; then per row one profiled frame (device ms, busy
    share), K1 against its plain twin on a real chunk under the row's
    surface stop, and the row's frame 0 against its plain frame
    (``Renderer.plain_kernels``).

14. the exact path (``Renderer(scene)`` without ``enable_fast_path()``;
    the scene built by the port's pipeline with the native core, built
    from ``owlexabrick_tpu_torch/native/exabrick_native.cpp`` into
    ``build/torch_native/``): the eight exact-path goldens (wavefront,
    iso, contour, clipbox, mesh_volume, tracer_segments, multichannel,
    ao_exact) at 96x64 on the card under the golden gate;
15. ``headline_exact``: the 64^3 bench scene and camera at 1920x1080,
    exact DVR, EXACT_FRAMES frames through the Renderer's route, which
    must be the packed one (``render/wavefront.py``): the scene's build
    seconds and bytes on the card, the pack's build (grids s,
    ``build_pack`` s, table MB, descent, start grid), the frame ms, one
    profiled frame (launches, busy share), the peak MB, frame 0's packed
    march at half its ray batch and at the batch in turns; frame 0's
    packed rgba against the classic ``trace_dvr`` of the same rays on
    the card (their region iterations logged) and against the packed
    march on the CPU on every EXACT_CPU_STRIDE-th pixel, the classic
    march against the CPU there, each under ``agree``'s gate (no K1-K6
    kernel may launch on this path);
16. ``headline_contour``: the headline fast path with one contour plane
    through the centre (colored from the exact scene), through the
    surface rows' phases: frames, launches, a profiled frame, K1 on a
    real chunk under the plane's stop against its plain twin, and the
    frame against its plain frame;
17. ``blobs256_scene``: the 256^3 scene (7,431,411 cells) built with the
    native core and moved to the card (build s, MB), its pack (build s,
    table MB, descent, macro-cell width), then one exact frame at
    BLOBS256_EXACT_SIZE through the packed route (ms, peak MB), its
    packed rgba against the classic march on every EXACT_CPU_STRIDE-th
    pixel's rays under ``agree``;
18. ``cli_exajet256``: the README's Quick start chain through the port's
    builder and offline CLI (``phase_cli_exajet256``);
19. ``phase_levels``: K1 and K3 past 8 levels, seeded 1080p chunks of 9
    and 12 levels (K1 at 1 and 4 channels), each against its twin;
20. ``phase_serve``: the web viewer on the ``.exa`` phase 18 wrote, at
    1920x1080 behind an HTTP server in this process, through real
    requests (orbit, axis and fly poses, the clip box, gradient shading,
    iso, the tracer, the clock overlay, ``/xf``), two frames against a
    ``plain_kernels`` viewer;
21. ``phase_mesh``: the multi-device modes on two gloo ranks sharing the
    card (spawned): px and spp meshes of the exact path, pixel bands and
    z bands of blobs256, each against the same work in this process;
22. ``phase_fields`` (after phase 10): the ``SlabConfig`` fields
    ``xf_knots=32``, ``xf_fit_quantum=2``, ``space_skipping=False``,
    ``megakernel=False`` (K3) and a 120x256 tile with the stride, one
    1080p headline frame each against its plain frame;
23. ``phase_scale``: the reference-scale scene (the JAX bench's
    scale1024 row: the two-wing exajet pattern on a 1024^3 lattice,
    63,544,167 cells, 4.46 GB of grids built on the card) at 1920x1080
    with the stride on, through the full and the partial camera cache,
    a pose switch, a TF drag and uncached frames; the tiers' frames
    equal bit for bit, the TF drag against uncached frames, a 960x540
    frame against its plain frame, K1 on a real chunk against its twin.

Launch counts are set to 0 just before each path (aligned, tilted,
einsum lane, iso, surfaces, contour, CLI, serve, fields, scale; the
mesh ranks count their own) and read just after; a kernel of a path
that launched no time there fails the run, and so does an uncached
megakernel frame whose K6 launches are not one per 8 levels of every
chunk it swept, and a one-channel clip frame that does not launch K3
once per live chunk and K6 once per 8 occupied levels of each.
Each kernel's bound is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its float32 operations
over 67 TFLOP/s (the H100 SXM's published peaks), counted from this
run's inputs.

The profiled frames of the surface, exact and scale rows record the
device's kernels alone (no host op events; a frame makes up to ~2.4e5
launches).  ``--profile`` adds a torch.profiler trace of one uncached
and one cached frame per row (one frame per einsum-lane and iso row): device
time by kernel (the top eight, and each of the port's kernels) and the
device's busy share, and Chrome traces of the aligned and tilted
megakernel rows (``phase_profile``).

The last line of standard output is ``{"ok": true, "device": {...}}``;
the line before it is the card, and the one before that lists each
kernel with its launches on every path, its error against its plain
version, its time, its plain version's time, its bound and, for K5 and
K6, the library call's time.
Exits non-zero without a CUDA card or without the port's sources.
Needs no JAX and no network.  Before it exits, pass or fail, it stops
every process it started (``stop_children``): multiprocessing's resource
tracker, which the spawned cell pool and mesh ranks start, would
otherwise outlive it for a moment.
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
K3_REPLACES = "owlexabrick_tpu/render/pallas_xf.py:178"
K4_REPLACES = "owlexabrick_tpu/render/pallas_xf.py:46"
K5_REPLACES = "owlexabrick_tpu/render/pallas_xf.py:24"
K6_REPLACES = "owlexabrick_tpu/render/pallas_mids.py:47"
# K7 replaces no TPU kernel: XLA fused the jitted function it computes
K7_REPLACES = "none (XLA fused owlexabrick_tpu/render/pallas_sweep.py:1489)"
# K1, K2, K3, K4, K5 and K6 against their plain versions: max abs over
# every output value
TOL_K1 = 1e-5
TOL_K2 = 1e-5
TOL_XF = 1e-5
# the H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): device
# memory bytes/s and float32 operations/s outside the tensor cores
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12
# float32 operations per sample, counted low so the bound stays a bound:
# K1 adds 3 per component and level (the y lerp) to ~30 for the quotient,
# texel coordinate, LUT, opacity and composite; K3 ~30 (classification,
# opacity, composite), K4 ~25 (no composite); K2a/K2b ~20 per output
# value (four Catmull-Rom taps and their weights); K5 ~8 per element (the
# texel index, fraction and four lerps); K6 3 per output value (two taps)
OPS_K1_BASE, OPS_K3, OPS_K4, OPS_K2, OPS_K5, OPS_K6 = 30, 30, 25, 20, 8, 3
# the port's kernel functions in csrc/ (profiler kernel names) by id
PORT_KERNELS = {"sweep_kernel": "K1", "warp_pass1_kernel": "K2a",
                "warp_pass2_kernel": "K2b",
                "composite_mids_kernel": "K3",
                "classify_field_kernel": "K4", "xf_classify_kernel": "K5",
                "xresample_levels_kernel": "K6", "activity_kernel": "K7"}
# the iso rows' iso value as a fraction of the scene's value maximum: the
# iso golden's 0.55 on its [0, 1.05] TF domain
ISO_FRAC = 0.524
# the clipbox golden's box (tests/test_golden_images.py:168-180) as
# fractions of the scene's edge n
CLIP_LO, CLIP_HI = (0.25, 0.0, 0.0), (1.0, 1.0, 0.8)
# jax.random jitter of the JAX Renderer's frames 0 and 1 (renderer.py:
# 453-458), which the port's default_jitter must give on the card's host
# too; tests/test_torch_host.py pins these to jax.random
GOLDEN_JITTER = {0: (0.11854469776153564, -0.06521260738372803),
                 1: (0.016130805015563965, 0.13509845733642578)}
# the surface rows: the bumpy sphere's radius and the helices' tube
# radius as fractions of the scene's edge n (the tracer_segments golden's
# 1.2 at n = 32 is 0.0375 n), the helices' segment count, and the chunk
# whose K1 is held to its plain twin under the row's surface stop
MESH_RADIUS, STREAM_RADIUS, STREAM_SEGMENTS = 0.3, 0.0375, 64
SURF_K1_CHUNK = 2
# the exact path: frames per row; every EXACT_CPU_STRIDE-th pixel of the
# headline's exact frame 0 is held to the same port code on the CPU (and
# of both rows' frame 0 to the classic march on the card); the blobs256
# exact frame's size, fixed from the headline's exact frame time in the
# chip run PERF.md records (1080p if under 15 s, else 960x540)
EXACT_FRAMES, EXACT_CPU_STRIDE = 2, 64
BLOBS256_EXACT_SIZE = (1920, 1080)
# the headline_contour row's plane: normal z through the volume's centre
# (offset 0.5 of the bounds box)
CONTOUR_NORMAL, CONTOUR_OFFSET = (0.0, 0.0, 1.0), 0.5
# kernel vs plain: within TOL_PX on FRAC_PX of pixels, TOL_ALL on all
# (the 2e-2 admits saturation-collapse flips at alpha ~ 0.98)
TOL_PX, FRAC_PX, TOL_ALL = 1e-4, 0.999, 2e-2
# the SlabConfig fields on the headline at 1920x1080: (case, fields, the
# kernels its frame must launch); the tile override leaves a ragged
# column tile (1920 = 7 x 256 + 128)
FIELD_CASES = (
    ("xf_knots_32", dict(xf_knots=32), ("K1", "K6")),
    ("xf_fit_quantum_2", dict(xf_fit_quantum=2.0), ("K1", "K6")),
    ("space_skipping_off", dict(space_skipping=False), ("K1", "K6")),
    ("megakernel_off", dict(megakernel=False), ("K3", "K6")),
    ("tiles_120x256_stride", dict(tile_rows=120, tile_cols=256,
                                  adaptive_stride=True), ("K1", "K6")),
)
# the scale phase: the JAX bench's scale1024 row (bench.py:395-615): the
# two-wing exajet pattern on a 1024^3 finest lattice, whose generator
# gives 63,544,167 cells (bench.py:411, SCALE_RUN_r03.md); the row's
# camera-cache gate (bench.py:457-459); cached, TF-drag and orbit frames
# per step (bench.py:537-545, 588-591); the size of the kernel-vs-plain
# frame (the plain K1 takes 136-394 ms per 1080p chunk, ~86 chunks a
# frame); the chunk K1 is timed on
SCALE_N, SCALE_WINGS, SCALE_CELLS = 1024, 2, 63_544_167
SCALE_GATE_MB = 5120
SCALE_CACHED, SCALE_TF, SCALE_ORBIT = 5, 8, 8
SCALE_PLAIN_SIZE = (960, 540)
SCALE_K1_CHUNK = 4
# K7's timed chunks, seeded at the benchmark cells' shapes: (name, slabs,
# levels, row tiles, column tiles); the TF drag's (exajet1024 at 1080p: 4
# slabs over 4 levels, 216 x 128 tiles) and the zoom's (exajet256 through
# shear-warp: 12 slabs over 4 levels on the 2944 x 1624 lattice's 232 x
# 128 tiles)
K7_SHAPES = (("tf_drag_chunk", 4, 4, 5, 15), ("zoom_chunk", 12, 4, 7, 23))


def log(*a):
    print(*a, flush=True)


def bound(nbytes, ops):
    """(bound_ms, bound_by): the least time the card could take to move
    ``nbytes`` (each input read once, each output written once) and do
    ``ops`` float32 operations, at the published peaks."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


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
    return grids, cam, fs, cfg, dict(meta, n=n,
                                     grids_build_s=round(build_s, 1))


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
    act_f, act_all_f, live = combine_activity(
        prep, scale > 1e-6, [lut], domains,
        adaptive_stride=cfg.adaptive_stride)
    knots = slabs.compress_pwl(luts_np)
    _, _, sec = slabs.ray_components(dir00, du, dv, width, height, dev,
                                     lattice=lattice)
    return dict(prep=prep, scale=scale, live=live, act_f=act_f,
                act_all_f=act_all_f, sec=sec, lut=lut, domains=domains,
                stride=cfg.adaptive_stride,
                dz=slabs.slab_spacing(grids, cfg.nslabs),
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


def graph_ms(fn, iters=50):
    """Device time of one ``fn()``: ``iters`` calls captured in a CUDA
    graph, replayed between CUDA events, so that the host's launch cost
    (a ctypes call is ~20-40 us) does not stand in for a kernel that
    runs shorter than that."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def seeded_channels_chunk(like, seed, device, channels):
    """A seeded chunk of ``channels`` scalar channels at ``like``'s
    shapes (its geometry, activity, sec and dz stay): per level the
    channel values under one mask, each channel its own colormap LUT,
    opacity ramp and domain.  Returns (prep, prev_t, tables)."""
    import torch

    from owlexabrick_tpu_torch.render.slabs import compress_pwl
    from owlexabrick_tpu_torch.render.sweep import pack_luts
    from owlexabrick_tpu_torch.viewer.colormaps import colormap_colors

    g = torch.Generator(device=device).manual_seed(seed)
    mids = []
    for m in like["prep"].mids:
        shape = (channels + 1,) + tuple(m.shape[1:])
        r = torch.rand(shape, generator=g, device=device)
        mask = torch.where(r[-1:] < 0.2, 0.0, r[-1:])
        vals = 1.5 * torch.rand((channels,) + shape[1:], generator=g,
                                device=device) * mask
        mids.append(torch.cat([vals, mask]).contiguous())
    h, w = like["sec"].shape
    pt = 0.2 + 0.8 * torch.rand((h, w), generator=g, device=device)
    maps = ("Jet", "Paraview Cool Warm", "Matplotlib Plasma", "Blackbody",
            "Rainbow", "Ice Fire", "Matplotlib Virdis", "Blue Gold",
            "Covise", "HSV")
    luts = []
    for c in range(channels):
        opac = np.clip(np.linspace(-0.2 + 0.05 * c, 1.0, 128), 0.0, 1.0)
        luts.append(np.concatenate(
            [colormap_colors(maps[c], 128),
             (0.05 + 0.02 * c) * opac[:, None]], 1).astype(np.float32))
    domains = torch.tensor([[0.05 * c, 1.2 + 0.03 * c]
                            for c in range(channels)], dtype=torch.float32,
                           device=device)
    tables = pack_luts([torch.from_numpy(t).to(device) for t in luts],
                       domains, compress_pwl(luts), device)
    return like["prep"]._replace(mids=tuple(mids)), pt, tables


def k1_check(name, ci, prep, pt, tables, width, height, timing=True,
             stop=None):
    """K1 vs plain on one chunk, with the surface stop ``stop`` ((t_slab
    (S,), t_stop (H, W)) or None): every output value within TOL_K1.
    Logs the launch shape; times K1 by CUDA events around eager launches
    (``ms``) and by CUDA-graph replay (``graph_ms``).  Returns a result
    dict (fails loudly)."""
    import torch

    from owlexabrick_tpu_torch.render.sweep import (
        k1_launch_shape, sweep_chunk_cuda, sweep_chunk_reference)
    from owlexabrick_tpu_torch.utils.profiling import counts

    kw = dict(act_f=ci["act_f"], act_all_f=ci["act_all_f"], prev_trans=pt,
              t_stop=stop)
    args = (prep, ci["sec"], ci["live"], tables, ci["dz"], height, width)
    n0 = counts["launch.K1"]
    rgb_k, t_k = sweep_chunk_cuda(*args, **kw)
    rgb_p, t_p = sweep_chunk_reference(*args, **kw)
    torch.cuda.synchronize()
    d = (torch.cat([rgb_k, t_k[None]]) - torch.cat([rgb_p, t_p[None]])).abs()
    mx = float(d.max())
    res = dict(name=name, channels=prep.mids[0].shape[0] - 1,
               compressed=tables.compressed, max_abs_err=mx,
               share_exact=float((d.amax(0) == 0).float().mean()),
               work=float(1.0 - t_k.mean()),
               launch=k1_launch_shape(prep, tables, height, width,
                                      has_pt=pt is not None,
                                      has_stop=stop is not None,
                                      occupancy=True))
    if timing:
        res["ms"] = time_ms(lambda: sweep_chunk_cuda(*args, **kw), 50)
        res["graph_ms"] = graph_ms(lambda: sweep_chunk_cuda(*args, **kw), 20)
        res["plain_ms"] = time_ms(lambda: sweep_chunk_reference(*args, **kw),
                                  3, warmup=1)
        # the samples this chunk's activity tables (and stop) leave to
        # classify
        samples = (float((ci["act_f"] > 0).float().mean())
                   * prep.y_pos.shape[0] * height * width)
        if stop is not None:
            res["stop_keeps_share"] = float(
                (stop[0][:, None, None] < stop[1][None]).float().mean())
            samples *= res["stop_keeps_share"]
        comps = prep.mids[0].shape[0]
        res["bound_ms"], res["bound_by"] = bound(
            nbytes(*prep.mids, prep.acts_l, prep.vmin, prep.vmax,
                   prep.y_pos, ci["sec"], ci["act_f"], ci["act_all_f"], pt,
                   *[t for t in tables if isinstance(t, torch.Tensor)],
                   *(stop or ()), rgb_k, t_k),
            samples * (3 * comps * len(prep.mids) + OPS_K1_BASE))
    res["k1_launches"] = counts["launch.K1"] - n0
    log("k1 check:", json.dumps(res))
    if not mx <= TOL_K1 or not bool(torch.isfinite(t_k).all()):
        raise SystemExit(f"K1 disagrees with its plain version on {name}: "
                         f"max {mx} > {TOL_K1}")
    return res


def phase_k1(setups, tilted, width, height, device):
    """Phase 2: K1 against sweep_chunk_reference at the main path's
    chunk shapes, the tilted lattice's included, with and without a
    surface stop, and at 2 and 6 channels."""
    import torch

    head = setups["headline"]
    ci = chunk_inputs(*head[:4], width, height, chunk_index=2)
    results = []
    prep, pt = seeded_chunk(ci, seed=1234, device=device)
    shapes = [tuple(m.shape) for m in prep.mids]
    log("k1 headline chunk mids shapes (C+1, S, ny, W):", shapes)
    results.append(k1_check("headline_seeded_knots", ci, prep, pt,
                            ci["tables_knots"], width, height))
    results.append(k1_check("headline_seeded_dense", ci, prep, pt,
                            ci["tables_dense"], width, height))
    # the surface stop: a seeded per-pixel stop between the chunk's first
    # and last slab cuts about half its slabs
    g = torch.Generator(device="cpu").manual_seed(77)
    t_slab = ci["scale"].to(device)
    lo, hi = float(t_slab.min()), float(t_slab.max())
    t_img = (lo + (hi - lo) * torch.rand((height, width), generator=g)).to(
        device)
    for name, tables in (("knots", ci["tables_knots"]),
                         ("dense", ci["tables_dense"])):
        results.append(k1_check(f"headline_seeded_{name}_stop", ci, prep,
                                pt, tables, width, height,
                                stop=(t_slab, t_img)))
    results.append(k1_check("headline_real_chunk", ci, ci["prep"],
                            None, ci["tables_knots"], width, height))
    for channels, seed in ((2, 2222), (6, 6666)):
        prep_c, pt_c, tables_c = seeded_channels_chunk(ci, seed, device,
                                                       channels)
        results.append(k1_check(f"headline_seeded_{channels}ch", ci,
                                prep_c, pt_c, tables_c, width, height))
        del prep_c
    b256 = setups["blobs256"]
    cb = chunk_inputs(*b256[:4], width, height, chunk_index=4)
    log("k1 blobs256 chunk mids shapes (C+1, S, ny, W):",
        [tuple(m.shape) for m in cb["prep"].mids])
    results.append(k1_check("blobs256_real_chunk", cb, cb["prep"], None,
                            cb["tables_knots"], width, height))

    from owlexabrick_tpu_torch.render.sweep import tile_shape

    grids, _, fs_t, cfg, _, sw = tilted["headline_tilted"]
    iw, ih = sw.width, sw.height
    ct = chunk_inputs(grids, sw.camera, fs_t, cfg, iw, ih, chunk_index=2,
                      lattice=sw.lattice())
    prep, pt = seeded_chunk(ct, seed=4321, device=device)
    tr, tc = tile_shape(ih, iw)
    log(f"k1 tilted lattice {iw}x{ih}: tiles {tr}x{tc}, "
        f"{-(-ih // tr) * -(-iw // tc)} tiles, mids shapes",
        [tuple(m.shape) for m in prep.mids])
    results.append(k1_check("headline_tilted_lattice_seeded", ct, prep, pt,
                            ct["tables_knots"], iw, ih))
    return results


def k7_check(name, prep, live, luts, domains, stride=True, timing=True):
    """K7 vs its plain twin on one chunk's tables (``live``: the host's
    (S,) bool mask): every output bit-equal.  Times K7 by CUDA events
    around 50 eager launches (``ms``, which the host's issue sets), by
    CUDA-graph replay (``graph_ms``, the device's time) and by the host's
    clock per call (``host_us``), and the twin by events.  Returns a
    result dict (fails loudly)."""
    import torch

    from owlexabrick_tpu_torch.render.sweep import (
        combine_activity_cuda, combine_activity_reference)
    from owlexabrick_tpu_torch.utils.profiling import counts

    live_d = torch.as_tensor(live).to(prep.acts_l.device)
    n0 = counts["launch.K7"]

    def k7():
        return combine_activity_cuda(prep, live, luts, domains,
                                     adaptive_stride=stride)

    def plain():
        return combine_activity_reference(prep, live_d, luts, domains,
                                          adaptive_stride=stride)

    got = k7()
    want = (*plain(), live_d.to(torch.float32))
    torch.cuda.synchronize()
    equal = [bool(torch.equal(g, w)) for g, w in zip(got, want)]
    n_lv, s_, n_rt, n_ct = prep.acts_l.shape
    res = dict(name=name, levels=n_lv, slabs=s_, tiles=[n_rt, n_ct],
               channels=0 if prep.vmin is None else prep.vmin.shape[0],
               bit_equal=equal, max_abs_err=0.0 if all(equal) else None,
               strided_tiles=int((want[0] > 1).any(0).sum()),
               k7_launches=counts["launch.K7"] - n0)
    if timing:
        res["ms"] = time_ms(k7, 50)
        res["graph_ms"] = graph_ms(k7, 50)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            k7()
        res["host_us"] = (time.perf_counter() - t0) / 200 * 1e6
        res["plain_ms"] = time_ms(plain, 20)
        res["bound_ms"], res["bound_by"] = bound(
            nbytes(prep.acts_l, prep.vmin, prep.vmax, domains,
                   *luts[:res["channels"]], *got), 0)
    log("k7 check:", json.dumps(res))
    if not all(equal):
        raise SystemExit(f"K7 differs from its plain version on {name}: "
                         f"act_f, act_all_f, live_f equal {equal}")
    return res


def k7_chunk(slabs, levels, n_rt, n_ct, device, seed):
    """Seeded K7 inputs at a chunk's shape: per tile a finest level
    (coarser ones active at random above it, some tiles with none), TF-cull
    bounds with empty ranges, the bench's Jet LUT (a ramp from 0, opacity
    scale 0.7) on the domain [0, 1], and a live mask with one dead slab.
    Returns (prep, live on the host, luts, domains)."""
    import torch

    from owlexabrick_tpu_torch.render.sweep import ChunkPrep
    from owlexabrick_tpu_torch.viewer.colormaps import colormap_colors

    rng = np.random.default_rng(seed)
    finest = rng.integers(0, levels + 1, (n_rt, n_ct))
    lv = np.arange(levels)[:, None, None, None]
    acts = (lv >= finest[None, None]) & (
        rng.uniform(size=(levels, slabs, n_rt, n_ct)) < 0.8)
    vmin = rng.uniform(0.0, 1.0, (1, slabs, n_rt)).astype(np.float32)
    vmax = (vmin + rng.uniform(0.0, 0.3, vmin.shape)).astype(np.float32)
    vmin[:, :, 0], vmax[:, :, 0] = np.inf, -np.inf
    lut = np.concatenate([colormap_colors("Jet", 128),
                          0.7 * np.linspace(0.0, 1.0, 128)[:, None]], 1)
    lut = torch.from_numpy(lut.astype(np.float32)).to(device)
    live = np.ones(slabs, bool)
    live[slabs // 2] = False

    def dev(a):
        return torch.from_numpy(a).to(device)

    prep = ChunkPrep(mids=(), origins_y=(0.0,) * levels,
                     cell_widths=tuple(float(1 << i) for i in range(levels)),
                     acts_l=dev(acts), vmin=dev(vmin), vmax=dev(vmax),
                     y_pos=torch.zeros((slabs, 1), device=device))
    return prep, live, [lut], torch.tensor([[0.0, 1.0]], device=device)


def phase_k7(device):
    """K7 against its plain twin, seeded at K7_SHAPES (timed) and at the
    card tests' extremes (256 slabs, 9 levels, no TF cull, no stride)."""
    results = []
    for i, (name, slabs, levels, n_rt, n_ct) in enumerate(K7_SHAPES):
        results.append(k7_check(name, *k7_chunk(slabs, levels, n_rt, n_ct,
                                                 device, 700 + i)))
    prep, live, luts, dom = k7_chunk(256, 9, 5, 15, device, 710)
    results.append(k7_check("s256_l9", prep, live, luts, dom, timing=False))
    results.append(k7_check("s256_l9_no_cull_unit",
                            prep._replace(vmin=None, vmax=None), live, luts,
                            dom, stride=False, timing=False))
    return results


def k1_registers(build_log):
    """Registers and spill bytes of each K1 instantiation (channel count)
    from nvcc's ``-Xptxas -v`` report."""
    import re

    out, nch = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '\S*sweep_kernelILi(\d+)E",
                      line)
        if m:
            nch = int(m.group(1))
            continue
        if nch is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(nch, {}).update(spill_stores=int(m.group(1)),
                                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(nch, {})["registers"] = int(m.group(1))
            nch = None
    return out


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
        res["k2a_bound_ms"], res["k2a_bound_by"] = bound(
            nbytes(img, wj0, v_k), OPS_K2 * v_k.numel())
        res["k2b_bound_ms"], res["k2b_bound_by"] = bound(
            nbytes(v_p, wi0, o_k), OPS_K2 * o_k.numel())
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
    """Phase 4: the fast_aligned / fast_stride / fast_shearwarp /
    ao_sweep goldens on the card (tests/test_golden_images.py's scene,
    cameras and recipes), with the Renderer's default jitter (the JAX
    Renderer's, checked against ``GOLDEN_JITTER`` first)."""
    import dataclasses

    from owlexabrick_tpu_torch.bench_scene import synthetic_volume
    from owlexabrick_tpu_torch.render.camera import Camera
    from owlexabrick_tpu_torch.render.frame import make_frame_state
    from owlexabrick_tpu_torch.render.renderer import (
        RenderConfig, Renderer, default_jitter)
    from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells
    from owlexabrick_tpu_torch.utils.png import golden_gate, read_png

    for f, want in GOLDEN_JITTER.items():
        if default_jitter(f) != want:
            raise SystemExit(f"default_jitter({f}) = {default_jitter(f)}, "
                             f"not the JAX Renderer's {want}")
    w, h, n = 96, 64, 32
    lower, level, scal = volume_to_cells(synthetic_volume(n), 0.004, 3)
    for name, stride, tilted, ao in (("fast_aligned", False, False, False),
                                     ("fast_stride", True, False, False),
                                     ("fast_shearwarp", False, True, False),
                                     ("ao_sweep", False, False, True)):
        eye = ([n * 0.9, n * 0.8, n * 2.1] if tilted
               else [n / 2, n / 2, n * 2.1])
        cam = Camera.look_at(eye, [n / 2, n / 2, n / 2], [0, 1, 0], 45.0,
                             w, h)
        fs = make_frame_state(cam, 1, [[0.0, 1.05]], dt=1.0,
                              opacity_scale=0.7)
        cfg = RenderConfig(num_channels=1, adaptive_stride=stride)
        if ao:
            # the iso surface shaded with the lattice AO, 6 frames
            fs = dataclasses.replace(
                fs, iso_enabled=np.asarray([True, False]),
                iso_value=np.asarray([0.55, 0.0], np.float32),
                ao_enabled=np.bool_(True), ao_length=np.float32(n * 0.5))
            cfg = RenderConfig(num_channels=1, iso_surfaces=True,
                               ao_samples=2)
        r = Renderer((lower, level, scal[None]), w, h, cfg=cfg,
                     frame_state=fs, device=device)
        r.enable_fast_path()
        if (r._fast[2] == "shearwarp") != tilted:
            raise SystemExit(f"golden {name}: Renderer took {r._fast[2]!r}")
        img = r.image_uint8(r.render_frames(6 if ao else 2))
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


KERNEL_IDS = ("K1", "K2a", "K2b", "K3", "K4", "K5", "K6", "K7")
# the launch counters at the last reset_launch_counts()
_launches0 = {}


def launch_counts():
    """Each kernel's launches since the last ``reset_launch_counts()``."""
    from owlexabrick_tpu_torch.utils.profiling import counts

    return {k: counts[f"launch.{k}"] - _launches0.get(k, 0)
            for k in KERNEL_IDS}


def reset_launch_counts():
    """Snapshot the launch counters; ``launch_counts()`` counts from
    here."""
    from owlexabrick_tpu_torch.utils.profiling import counts

    _launches0.update({k: counts[f"launch.{k}"] for k in KERNEL_IDS})


def phase_rows(rows, width, height, n_timed=3):
    """Phases 5 and 6: each row at full size, uncached and through the
    camera cache; returns the kernel frames for the plain comparison.
    The first uncached frame must launch K6 once per 8 levels of every
    chunk it sweeps (K1 launches once per chunk)."""
    import torch

    from owlexabrick_tpu_torch.render.mids import K6_MAX_LEVELS

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

        f0 = launch_counts()
        first, first_ms = frame()
        f1 = launch_counts()
        k6_first, chunks = (f1[k] - f0[k] for k in ("K6", "K1"))
        k6_want = chunks * -(-len(row[0].levels) // K6_MAX_LEVELS)
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
        rec["k6_launches_uncached_frame"] = k6_first
        rec["chunks_swept_uncached_frame"] = chunks
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
        if chunks <= 0 or k6_first != k6_want:
            raise SystemExit(f"{name}: an uncached frame swept {chunks} "
                             f"chunks in {k6_first} K6 launches, not "
                             f"{k6_want}")
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


def lane_setups(setups, tilted, device):
    """The einsum lane's rows at 1920x1080 on the bench's scenes and
    configs: the clipbox golden's box scaled to n (aligned, through
    shear-warp, and on blobs256), DVR gradient shading, and two channels
    under the box (the multichannel golden's recipe: scal and
    1.05 vmax - scal over [0, 1.05 vmax] and [0, 4 vmax])."""
    import dataclasses

    from owlexabrick_tpu_torch.bench_scene import synthetic_volume
    from owlexabrick_tpu_torch.render.frame import make_frame_state
    from owlexabrick_tpu_torch.render.slabs import level_grids_from_cells
    from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

    def row(setup, n, box=False, grad=False, sw=None):
        grids, cam, fs, cfg, meta = setup[:5]
        r = dict(grids=grids, cam=cam, fs=fs, meta=meta, sw=sw,
                 cfg=dataclasses.replace(cfg, gradient_shading_dvr=grad))
        if box:
            r["box"] = ([n * f for f in CLIP_LO], [n * f for f in CLIP_HI])
        return r

    head, b256 = setups["headline"], setups["blobs256"]
    ht = tilted["headline_tilted"]
    rows = dict(headline_clip=row(head, 64, box=True),
                headline_tilted_clip=row(ht, 64, box=True, sw=ht[5]),
                blobs256_clip=row(b256, 256, box=True),
                headline_gradient=row(head, 64, grad=True),
                blobs256_gradient=row(b256, 256, grad=True))
    lower, level, scal = volume_to_cells(synthetic_volume(64), 0.004, 3)
    vmax = float(scal.max())
    grids2 = level_grids_from_cells(
        lower, level, np.stack([scal, 1.05 * vmax - scal]), axis=2,
        device=device)
    fs2 = make_frame_state(head[1], 2, [[0.0, 1.05 * vmax], [0.0, 4 * vmax]],
                           dt=1.0, opacity_scale=0.5)
    rows["headline_2ch_clip"] = row(
        (grids2, head[1], fs2, dataclasses.replace(head[3], num_channels=2),
         head[4]), 64, box=True)
    return rows


def render_lane(row, width, height, plain=False):
    """One frame of an einsum-lane row: the clip box's interval from
    ``renderer.clip_interval`` (for the lattice on a shear-warp row),
    ``render_slabs_camera``, and on a shear-warp row the warp.  ``plain``
    runs the plain versions of every kernel."""
    import dataclasses

    from owlexabrick_tpu_torch.render.renderer import clip_interval
    from owlexabrick_tpu_torch.render.shearwarp import warp_image
    from owlexabrick_tpu_torch.render.slabs import render_slabs_camera

    grids, cam, sw = row["grids"], row["cam"], row["sw"]
    cfg = dataclasses.replace(row["cfg"], plain_sweep=plain)
    cam_s, w, h, lattice = ((sw.camera, sw.width, sw.height, sw.lattice())
                            if sw is not None else (cam, width, height, None))
    interval = {}
    if "box" in row:
        t0, t1 = clip_interval(grids.axis, cam_s, lattice, w, h,
                               np.eye(3, 4, dtype=np.float32), cam.pos,
                               *row["box"], device=grids.device)
        interval = dict(t_start=t0, t_stop=t1)
    rgba = render_slabs_camera(grids, row["fs"], cfg, cam_s, w, h,
                               lattice=lattice, **interval)
    if sw is None:
        return rgba
    return warp_image(rgba, sw, width, height, plain=plain)


def xf_check(name, sw, swv, sec, lut, dom, dz):
    """K4 against its plain version on one chunk's fields, with times
    from CUDA events and the bound of this chunk's work."""
    import torch

    from owlexabrick_tpu_torch.render import classify as PC

    args4 = (sw, swv, sec, lut, dom, dz)
    k4 = PC.classify_field_cuda(*args4)
    p4 = PC.classify_field_reference(*args4)
    torch.cuda.synchronize()
    e4 = max(float((a - b).abs().max()) for a, b in zip(k4, p4))
    finite = all(bool(torch.isfinite(t).all()) for t in k4)
    res = dict(name=name, shape=list(sw.shape),
               valid_share=float((sw > 1e-20).float().mean()),
               k4_max_abs_err=e4, k4_alpha_mean=float(k4[3].mean()))
    res["k4_ms"] = time_ms(lambda: PC.classify_field_cuda(*args4), 50)
    res["k4_plain_ms"] = time_ms(
        lambda: PC.classify_field_reference(*args4), 3, warmup=1)
    res["k4_bound_ms"], res["k4_bound_by"] = bound(
        nbytes(sw, swv, sec, lut, *k4), OPS_K4 * sw.numel())
    log("xf check:", json.dumps(res))
    if not finite or not e4 <= TOL_XF:
        raise SystemExit(f"K4 disagrees with its plain version on {name}: "
                         f"{e4} (finite={finite})")
    return res


def k3_check(name, args):
    """K3 from the mids against its plain version on one chunk's inputs
    (mids, y taps, scale, t_start, t_stop, sec, LUT, domain, dz), bit for
    bit; times from CUDA-graph replay (``ms``) and CUDA events
    (``ms_events``), the plain version's time and the bound of this
    chunk's work."""
    import torch

    from owlexabrick_tpu_torch.render import classify as PC

    mids, taps, scale, t_start, t_stop, sec, lut, dom, dz = args

    def kernel():
        return PC.composite_mids_cuda(*args)

    want = PC.composite_mids_reference(*args)
    got = kernel()
    torch.cuda.synchronize()
    err = max(float((g - p).abs().max()) for g, p in zip(got, want))
    exact = all(torch.equal(g, p) for g, p in zip(got, want))
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    s_ = scale.shape[0]
    h, w = sec.shape
    sw = PC.mids_fields_reference(*args[:5], h, w)[0]
    res = dict(name=name, slabs=s_, ny=[int(m.shape[2]) for m in mids],
               H=h, W=w, valid_share=float((sw > 1e-20).float().mean()),
               max_abs_err=err, bit_equal=exact,
               trans_mean=float(got[1].mean()))
    del sw
    res["ms"] = graph_ms(kernel, 50)
    res["ms_events"] = time_ms(kernel, 50)
    res["plain_ms"] = time_ms(lambda: PC.composite_mids_reference(*args), 3,
                              warmup=1)
    res["library_ms"] = None
    # each level's mids, taps and the per-pixel inputs read once, r, g,
    # b, T written once; 3 operations per level and component per sample
    # (the y lerp) and OPS_K3 for the classification and composite
    res["bound_ms"], res["bound_by"] = bound(
        nbytes(*mids, *taps, scale, t_start, t_stop, sec, lut, *got),
        (6 * len(mids) + OPS_K3) * s_ * h * w)
    log("k3 check:", json.dumps(res))
    if not finite or not exact:
        raise SystemExit(f"K3 differs from its plain version on {name}: "
                         f"{err} (finite={finite})")
    return res


def capture_chunk(row, width, height):
    """K3's inputs in one frame of ``row`` (mids, y taps, scale, t_start,
    t_stop, sec, LUT, domain, dz), cloned, of the chunk with the most
    valid samples."""
    from owlexabrick_tpu_torch.render import classify as PC
    from owlexabrick_tpu_torch.render import slabs

    calls = capture_all_calls(slabs, "composite_mids",
                              lambda: render_lane(row, width, height))

    def valid(a):
        h, w = a[5].shape
        return int((PC.mids_fields_reference(*a[:5], h, w)[0]
                    > 1e-20).sum())

    return max(calls, key=valid)


def phase_xf(lanes, width, height, device):
    """K3 and K4 against their plain versions at the lane's 1080p shapes:
    K4 on seeded fields at S = 12 and S = 24 (invalid samples, values
    beyond the TF domain) with the headline's sec, LUT and dz, and on the
    fields of a real headline_clip chunk; K3 on a real chunk of each clip
    row (``headline_clip``, ``blobs256_clip``, ``headline_tilted_clip``,
    on its 2944x1624 lattice).  Returns (K4 results, K3 results)."""
    import torch

    from owlexabrick_tpu_torch.render import classify as PC
    from owlexabrick_tpu_torch.render import slabs

    grids, cam, fs, cfg = (lanes["headline_clip"][k]
                           for k in ("grids", "cam", "fs", "cfg"))
    _, dir00, du, dv = slabs.permute_camera(cam, grids.axis)
    _, _, sec = slabs.ray_components(dir00, du, dv, width, height, device)
    lut = torch.from_numpy(slabs.scaled_luts(fs, 1)[0]).to(device)
    dom = np.asarray(fs.xf_domain[0], np.float32)
    dz = slabs.slab_spacing(grids, cfg.nslabs)
    k4 = []
    for s_ in (12, 24):
        g = torch.Generator(device=device).manual_seed(100 + s_)

        def rand():
            return torch.rand((s_, height, width), generator=g,
                              device=device)

        sw = torch.where(rand() < 0.15, 0.0, 2.0 * rand())
        value = float(dom[1]) * (1.2 * rand() - 0.1)
        swv = value * torch.where(sw > 0, sw, 1.0)
        k4.append(xf_check(f"seeded_S{s_}", sw, swv, sec, lut, dom, dz))
        del sw, swv, value
    k3 = []
    for name in ("headline_clip", "blobs256_clip", "headline_tilted_clip"):
        real = capture_chunk(lanes[name], width, height)
        k3.append(k3_check(f"{name}_real_chunk", real))
        if name == "headline_clip":
            h, w = real[5].shape
            sw, swv = PC.mids_fields_reference(*real[:5], h, w)
            k4.append(xf_check("headline_clip_real_chunk", sw, swv,
                               *real[5:]))
        del real
    return k4, k3


def phase_lane_rows(rows, width, height, n_timed=3):
    """Each einsum-lane row at full size (uncached: the lane has no
    product cache); returns the kernel frames for the plain comparison.
    A one-channel clip row's first frame must launch K3 once per chunk
    with a live slab and K6 once per 8 occupied levels of each."""
    import torch

    from owlexabrick_tpu_torch.render import slabs
    from owlexabrick_tpu_torch.render.mids import K6_MAX_LEVELS

    frames = {}
    for name, row in rows.items():
        cfg = row["cfg"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n0 = launch_counts()

        def frame():
            t0 = time.perf_counter()
            out = render_lane(row, width, height)
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        # the first frame's live chunks, by their occupied levels
        chunks = []
        mids = slabs._EinsumLane.mids

        def spy(lane, z_s, occ_s, scale):
            chunks.append(sum(bool(o.any()) for o in occ_s))
            return mids(lane, z_s, occ_s, scale)

        f0 = launch_counts()
        slabs._EinsumLane.mids = spy
        try:
            first, first_ms = frame()
        finally:
            slabs._EinsumLane.mids = mids
        f1 = launch_counts()
        times = [first_ms] + [frame()[1] for _ in range(n_timed)]
        rec = dict(
            row=name, frames_ms=[round(t, 3) for t in times],
            peak_mem_mb=round(torch.cuda.max_memory_allocated() / 1e6, 1),
            nslabs=cfg.nslabs, chunk=cfg.chunk, channels=cfg.num_channels,
            gradient_shading_dvr=cfg.gradient_shading_dvr,
            clip_box=row.get("box"), cells=row["meta"]["n_cells"])
        if row["sw"] is not None:
            rec["lattice"] = [row["sw"].width, row["sw"].height]
        rec.update({f"{k}_launches": v - n0[k]
                    for k, v in launch_counts().items()})
        rec["alpha_mean"] = float(first[:, 3].mean())
        clip = cfg.num_channels == 1 and not cfg.gradient_shading_dvr
        if clip:
            # K3 once per live chunk, K6 once per 8 occupied levels of it
            rec["live_chunks_first_frame"] = len(chunks)
            got = tuple(f1[k] - f0[k] for k in ("K3", "K6"))
            want = (len(chunks), sum(-(-n // K6_MAX_LEVELS) for n in chunks))
            rec["k3_k6_launches_first_frame"] = list(got)
        log("einsum lane:", json.dumps(rec))
        if not bool(torch.isfinite(first).all()) or rec["alpha_mean"] <= 1e-3:
            raise SystemExit(f"{name}: frame not finite or blank")
        if clip and (not chunks or got != want):
            raise SystemExit(f"{name}: {len(chunks)} live chunks took "
                             f"(K3, K6) launches {got}, not {want}")
        frames[name] = first
    return frames


def phase_lane_plain(rows, frames, width, height):
    """Each einsum-lane row's kernel frame against its plain frame (plain
    K3/K4 and, on the shear-warp row, plain K1's twin and warp)."""
    for name, row in rows.items():
        t0 = time.perf_counter()
        plain = render_lane(row, width, height, plain=True)
        ms = (time.perf_counter() - t0) * 1e3
        ok, mx, share = agree(frames[name], plain)
        log(f"einsum lane {name}: kernel vs plain frame max_abs={mx} "
            f"share_within_1e-4={share:.6f} plain_frame_ms={ms:.1f}")
        if not ok:
            raise SystemExit(f"{name}: kernel frame disagrees with plain")


def phase_renderer_lane(setups, tilted, n, width, height, device,
                        n_frames=2):
    """Progressive Renderer frames on the einsum lane: the clip box
    (aligned and through shear-warp) and DVR gradient shading, each
    finite and not blank."""
    import torch

    from owlexabrick_tpu_torch.bench_scene import synthetic_volume
    from owlexabrick_tpu_torch.render.renderer import RenderConfig, Renderer
    from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

    lower, level, scal = volume_to_cells(synthetic_volume(n), 0.004, 3)
    box = ([n * f for f in CLIP_LO], [n * f for f in CLIP_HI])
    for name, fs, grad, tilt in (
            ("renderer_clip", setups["headline"][2], False, False),
            ("renderer_tilted_clip", tilted["headline_tilted"][2], False,
             True),
            ("renderer_gradient", setups["headline"][2], True, False)):
        r = Renderer((lower, level, scal[None]), width, height,
                     cfg=RenderConfig(num_channels=1,
                                      gradient_shading_dvr=grad),
                     frame_state=fs, device=device)
        if not grad:
            r.set_clip_box(True, *box)
        r.enable_fast_path()
        if (r._fast[2] == "shearwarp") != tilt:
            raise SystemExit(f"{name}: Renderer took {r._fast[2]!r}")
        times = []
        for _ in range(n_frames):
            t0 = time.perf_counter()
            words = r.render()
            torch.cuda.synchronize()
            times.append(round((time.perf_counter() - t0) * 1e3, 3))
        img = r.image_uint8(words)
        lit = float((img[..., :3] > 16).any(-1).mean())
        finite = bool(torch.isfinite(r.accum).all())
        log("renderer:", json.dumps(dict(row=name, frames_ms=times,
                                         lit_pixel_share=lit,
                                         accum_finite=finite)))
        if not finite or lit < 0.02:
            raise SystemExit(f"{name}: Renderer frames not finite or blank")


def iso_setups(setups, tilted, lanes):
    """The iso path's rows at 1920x1080 on the bench's scenes: one iso
    surface at ISO_FRAC of the scene's value maximum, gradient shading
    iso on; the headline and blobs256 aligned (``headline_iso``,
    ``blobs256_iso``), the headline through shear-warp
    (``headline_tilted_iso``), and the two-channel headline of the
    ``headline_2ch_clip`` row with the iso on channel 0 and its hits
    recolored by channel 1 (``headline_2ch_iso_colormap``, K5)."""
    import dataclasses

    def row(setup, sw=None, cached=True, **cfg_kw):
        grids, cam, fs, cfg, meta = setup[:5]
        fs = dataclasses.replace(
            fs, iso_enabled=np.asarray([True, False]),
            iso_value=np.asarray([ISO_FRAC * meta["value_max"], 0.0],
                                 np.float32),
            iso_channel=np.zeros(2, np.int32))
        return dict(grids=grids, cam=cam, fs=fs, meta=meta, sw=sw,
                    cached=cached, cfg=dataclasses.replace(cfg, **cfg_kw))

    head, b256 = setups["headline"], setups["blobs256"]
    ht = tilted["headline_tilted"]
    two = lanes["headline_2ch_clip"]
    return dict(
        headline_iso=row(head), blobs256_iso=row(b256),
        headline_tilted_iso=row(ht, sw=ht[5], cached=False),
        headline_2ch_iso_colormap=row(
            (two["grids"], two["cam"], two["fs"], two["cfg"], head[4]),
            cached=False, colormap_channel=1))


def render_iso(row, width, height, cache=None, plain=False):
    """One frame of an iso row, as the Renderer composes it (renderer.py:
    604-707, no AO): the iso sweep (``render_slabs_iso_camera``), its
    hits shaded by |dir . N| as the background, and the volume in front
    of them (``render_slabs_camera`` with ``t_stop`` = the hit depth:
    K1's stop); on a shear-warp row on the lattice, then warped.
    Returns (P, 4): the composited color and the volume's alpha.
    ``plain`` runs the plain versions of every kernel."""
    import dataclasses

    import torch

    from owlexabrick_tpu_torch.render.dvr import composite_background
    from owlexabrick_tpu_torch.render.shearwarp import warp_image
    from owlexabrick_tpu_torch.render.slabs import (
        render_slabs_camera, render_slabs_iso_camera)

    grids, cam, sw = row["grids"], row["cam"], row["sw"]
    cfg = dataclasses.replace(row["cfg"], plain_sweep=plain)
    cam_s, w, h, lattice = ((sw.camera, sw.width, sw.height, sw.lattice())
                            if sw is not None else (cam, width, height, None))
    iso_rgba, t_iso, n, cos = render_slabs_iso_camera(
        grids, row["fs"], cfg, cam_s, w, h, lattice=lattice,
        return_normals=True)
    bg = iso_rgba[:, :3] * iso_rgba[:, 3:4]
    bg = torch.where((torch.linalg.norm(n, dim=-1) > 0.0)[:, None],
                     bg * cos[:, None], bg)
    rgba = render_slabs_camera(grids, row["fs"], cfg, cam_s, w, h,
                               lattice=lattice, t_stop=t_iso,
                               camera_cache=cache)
    out = torch.cat([composite_background(rgba, bg), rgba[:, 3:]], 1)
    if sw is None:
        return out
    return warp_image(out, sw, width, height, plain=plain)


def phase_iso_rows(rows, width, height, n_timed=2):
    """Each iso row at full size, uncached and (where ``cached``) through
    the camera cache of its volume part; returns the kernel frames."""
    import torch

    frames = {}
    for name, row in rows.items():
        cfg = row["cfg"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n0 = launch_counts()

        def frame(cache=None):
            t0 = time.perf_counter()
            out = render_iso(row, width, height, cache=cache)
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        first, first_ms = frame()
        rec = dict(row=name, frames_uncached_ms=[round(first_ms, 3)] + [
            round(frame()[1], 3) for _ in range(n_timed)])
        if row["cached"]:
            cache = {}
            cached0, prep_ms = frame(cache)
            cached = [frame(cache) for _ in range(n_timed)]
            rec["cache_first_frame_ms"] = round(prep_ms, 3)
            rec["frames_cached_ms"] = [round(t, 3) for _, t in cached]
            _, mx_c, _ = agree(first, cached[-1][0], frac=1.0)
            rec["cached_vs_uncached_max_abs"] = mx_c
            if mx_c > 1e-6:
                raise SystemExit(f"{name}: cached frame differs by {mx_c}")
        rec.update(
            peak_mem_mb=round(torch.cuda.max_memory_allocated() / 1e6, 1),
            nslabs=cfg.nslabs, chunk=cfg.chunk, channels=cfg.num_channels,
            colormap_channel=cfg.colormap_channel,
            iso_value=float(row["fs"].iso_value[0]),
            cells=row["meta"]["n_cells"])
        if row["sw"] is not None:
            rec["lattice"] = [row["sw"].width, row["sw"].height]
        rec.update({f"{k}_launches": v - n0[k]
                    for k, v in launch_counts().items()})
        rec["volume_alpha_mean"] = float(first[:, 3].mean())
        rec["lit_share"] = float((first[:, :3].amax(1) > 0.05).float().mean())
        log("iso path:", json.dumps(rec))
        if not bool(torch.isfinite(first).all()) or rec["lit_share"] < 0.02:
            raise SystemExit(f"{name}: frame not finite or blank")
        need = ["K1"] + (["K2a", "K2b"] if row["sw"] is not None else []) + (
            ["K5"] if cfg.colormap_channel else [])
        if min(rec[f"{k}_launches"] for k in need) <= 0:
            raise SystemExit(f"{name}: launched none of some of {need}")
        frames[name] = first
    return frames


def phase_iso_plain(rows, frames, width, height):
    """Each iso row's kernel frame against its plain frame (plain K1, K5
    and warp)."""
    for name, row in rows.items():
        t0 = time.perf_counter()
        plain = render_iso(row, width, height, plain=True)
        ms = (time.perf_counter() - t0) * 1e3
        ok, mx, share = agree(frames[name], plain)
        log(f"iso path {name}: kernel vs plain frame max_abs={mx} "
            f"share_within_1e-4={share:.6f} plain_frame_ms={ms:.1f}")
        if not ok:
            raise SystemExit(f"{name}: kernel frame disagrees with plain")


def phase_renderer_iso(setups, tilted, n, width, height, device,
                       n_frames=2):
    """Progressive Renderer frames with an iso surface (the user's entry
    point: ``RenderConfig(iso_surfaces=True)``, ``update_iso_values``),
    aligned and through shear-warp, each finite and not blank."""
    import torch

    from owlexabrick_tpu_torch.bench_scene import synthetic_volume
    from owlexabrick_tpu_torch.render.renderer import RenderConfig, Renderer
    from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

    lower, level, scal = volume_to_cells(synthetic_volume(n), 0.004, 3)
    iso = ISO_FRAC * setups["headline"][4]["value_max"]
    for name, fs, tilt in (
            ("renderer_iso", setups["headline"][2], False),
            ("renderer_tilted_iso", tilted["headline_tilted"][2], True)):
        r = Renderer((lower, level, scal[None]), width, height,
                     cfg=RenderConfig(num_channels=1, iso_surfaces=True),
                     frame_state=fs, device=device)
        r.update_iso_values([iso, 0.0], [0, 0], [True, False])
        r.enable_fast_path()
        if (r._fast[2] == "shearwarp") != tilt:
            raise SystemExit(f"{name}: Renderer took {r._fast[2]!r}")
        times = []
        for _ in range(n_frames):
            t0 = time.perf_counter()
            words = r.render()
            torch.cuda.synchronize()
            times.append(round((time.perf_counter() - t0) * 1e3, 3))
        img = r.image_uint8(words)
        lit = float((img[..., :3] > 16).any(-1).mean())
        finite = bool(torch.isfinite(r.accum).all())
        log("renderer:", json.dumps(dict(row=name, frames_ms=times,
                                         lit_pixel_share=lit,
                                         accum_finite=finite)))
        if not finite or lit < 0.02:
            raise SystemExit(f"{name}: Renderer frames not finite or blank")


def capture_calls(module, attr, render):
    """Run ``render()`` with ``module.attr`` wrapped; return the clones of
    the tensor arguments of the call with the most elements in its
    first argument."""
    import torch

    run = getattr(module, attr)
    best = []

    def spy(*args, **kw):
        if not best or args[0].numel() > best[0][0].numel():
            best[:] = [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                             for a in args)]
        return run(*args, **kw)

    setattr(module, attr, spy)
    try:
        render()
    finally:
        setattr(module, attr, run)
    if not best:
        raise SystemExit(f"{attr} was not called")
    return best[0]


def k5_check(name, u, lut):
    """K5 against its plain version and against the library's yardstick
    (``grid_sample`` of the LUT as a (1, 4, 1, N) image, bilinear, zero
    padding, align_corners: the same lerp), with device times from CUDA
    graph replays (``graph_ms``; ``eager_ms``: CUDA events around eager
    launches) and the bound of 20 bytes per element."""
    import torch
    import torch.nn.functional as F

    from owlexabrick_tpu_torch.render import classify as PC

    k = torch.stack(PC.xf_classify_cuda(u, lut))
    p = torch.stack(PC.xf_classify_reference(u, lut))
    n = lut.shape[0]
    img = lut.T.reshape(1, 4, 1, n).contiguous()
    grid = torch.stack([u * (2.0 / (n - 1)) - 1.0, torch.zeros_like(u)],
                       -1)[None].contiguous()

    def library():
        return F.grid_sample(img, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    lib = library()[0]
    torch.cuda.synchronize()
    res = dict(name=name, shape=list(u.shape),
               max_abs_err=float((k - p).abs().max()),
               library_max_abs_err=float((lib - k).abs().max()),
               ms=graph_ms(lambda: PC.xf_classify_cuda(u, lut)),
               eager_ms=time_ms(lambda: PC.xf_classify_cuda(u, lut), 50),
               plain_ms=time_ms(lambda: PC.xf_classify_reference(u, lut), 3,
                                warmup=1),
               library_ms=graph_ms(library),
               library_eager_ms=time_ms(library, 50))
    res["bound_ms"], res["bound_by"] = bound(nbytes(u, lut, k),
                                             OPS_K5 * u.numel())
    log("k5 check:", json.dumps(res))
    if not bool(torch.isfinite(k).all()) or not res["max_abs_err"] <= TOL_XF:
        raise SystemExit(f"K5 disagrees with its plain version on {name}: "
                         f"{res['max_abs_err']}")
    return res


def k6_check(name, calls, iters):
    """K6 against the plain version on ``calls``, a list of (zvs_list,
    qx_list) (one chunk's levels each, one launch per call), bit for bit,
    and against the library's yardstick (``grid_sample`` of (S, C+1, ny,
    nx) per level, bilinear, zero padding, align_corners, grid rows
    exactly at lattice rows: the same x tent); device times from CUDA
    graph replays of ``iters`` passes; ``fill_ms``, ``fill_`` of the same
    outputs, the card's store speed on them; the bytes bound summed over
    the levels."""
    import torch
    import torch.nn.functional as F

    from owlexabrick_tpu_torch.render import mids as PM

    levels = [(z, q) for zl, ql in calls for z, q in zip(zl, ql)]
    plain = [o for zl, ql in calls
             for o in PM.xresample_mids_levels_reference(zl, ql)]

    def run():
        return [o for zl, ql in calls
                for o in PM.xresample_mids_levels_cuda(zl, ql)]

    outs = run()
    err = max(float((a - b).abs().max()) for a, b in zip(outs, plain))
    finite = all(bool(torch.isfinite(o).all()) for o in outs)
    lib_in = []
    for z, q in levels:
        _, s_, ny, nx = z.shape
        w = q.shape[1]
        gx = q * (2.0 / max(nx - 1, 1)) - 1.0
        gy = (torch.arange(ny, dtype=torch.float32, device=q.device)
              * (2.0 / max(ny - 1, 1)) - 1.0)
        lib_in.append((z.transpose(0, 1).contiguous(), torch.stack(
            [gx[:, None, :].expand(s_, ny, w),
             gy[None, :, None].expand(s_, ny, w)], -1).contiguous()))

    def library():
        return [F.grid_sample(inp, grid, mode="bilinear",
                              padding_mode="zeros", align_corners=True)
                for inp, grid in lib_in]

    lib_err = max(float((a.transpose(0, 1) - b).abs().max())
                  for a, b in zip(library(), plain))
    res = dict(
        name=name, calls=len(calls), levels=len(levels),
        W=levels[0][1].shape[1],
        largest_zvs=list(max((z for z, _ in levels),
                             key=lambda z: z.numel()).shape),
        ny=[int(z.shape[2]) for z, _ in levels[:8]],
        max_abs_err=err, library_max_abs_err=lib_err,
        ms=graph_ms(run, iters),
        fill_ms=graph_ms(lambda: [o.fill_(0.5) for o in outs], iters),
        plain_ms=time_ms(lambda: [PM.xresample_mids_levels_reference(zl, ql)
                                  for zl, ql in calls], 3, warmup=1),
        library_ms=graph_ms(library, iters))
    res["bound_ms"], res["bound_by"] = bound(
        sum(nbytes(z, q, o) for (z, q), o in zip(levels, plain)),
        OPS_K6 * sum(o.numel() for o in plain))
    log("k6 check:", json.dumps(res))
    if not finite or err != 0.0:
        raise SystemExit(f"K6 differs from its plain version on {name}: "
                         f"{err} (finite={finite})")
    return res


def k6_check_frame(name, calls, iters):
    """``k6_check`` on every call of a frame, in runs of calls whose
    outputs stay under 4 GB (k6_check holds about five sets of a run's
    outputs at once, and a 1080p frame of the 1024^3 scene writes ~15 GB
    of mids); one record for the frame: the runs' times and bounds
    summed, their errors maxed."""
    max_mb = 4096
    runs, run, mb = [], [], 0.0
    for zl, ql in calls:
        out_mb = sum(z.shape[0] * z.shape[1] * z.shape[2] * q.shape[1] * 4
                     for z, q in zip(zl, ql)) / 2**20
        if run and mb + out_mb > max_mb:
            runs.append(run)
            run, mb = [], 0.0
        run.append((zl, ql))
        mb += out_mb
    runs.append(run)
    parts = [k6_check(f"{name}_run{i}", r, iters)
             for i, r in enumerate(runs)]
    res = dict(parts[0], name=name, runs=len(parts),
               largest_zvs=max((p["largest_zvs"] for p in parts),
                               key=lambda s: np.prod(s)))
    for k in ("calls", "levels", "ms", "fill_ms", "plain_ms", "library_ms",
              "bound_ms"):
        res[k] = sum(p[k] for p in parts)
    for k in ("max_abs_err", "library_max_abs_err"):
        res[k] = max(p[k] for p in parts)
    res["bound_by"] = ",".join(sorted({p["bound_by"] for p in parts}))
    log("k6 check:", json.dumps(res))
    return res


def capture_all_calls(module, attr, render):
    """Run ``render()`` with ``module.attr`` wrapped; return the clones of
    the positional arguments of every call (tensors and lists of
    tensors)."""
    import torch

    def clone(a):
        if isinstance(a, torch.Tensor):
            return a.clone()
        if isinstance(a, (list, tuple)):
            return [clone(x) for x in a]
        return a

    run = getattr(module, attr)
    calls = []

    def spy(*args, **kw):
        calls.append(tuple(clone(a) for a in args))
        return run(*args, **kw)

    setattr(module, attr, spy)
    try:
        render()
    finally:
        setattr(module, attr, run)
    if not calls:
        raise SystemExit(f"{attr} was not called")
    return calls


def phase_k5(iso_rows, width, height, device):
    """K5 against its plain version and the library yardstick on seeded
    texel coordinates at 1080p and on the colormap row's real hit
    image."""
    import torch

    from owlexabrick_tpu_torch.render import slabs

    g = torch.Generator(device="cpu").manual_seed(55)
    row = iso_rows["headline_2ch_iso_colormap"]
    lut = torch.from_numpy(slabs.scaled_luts(row["fs"], 1)[0]).to(device)
    u = (127.0 * torch.rand((height, width), generator=g)).to(device)
    k5 = [k5_check("seeded_1080p", u, lut)]
    u_real, lut_real = capture_calls(
        slabs, "xf_classify", lambda: render_iso(row, width, height))[:2]
    k5.append(k5_check("headline_2ch_iso_colormap_hits", u_real, lut_real))
    return k5


def phase_k6(setups, width, height, device):
    """K6 against the plain version and the library yardstick: a seeded
    level block; then, from one real uncached
    frame each of the headline and blobs256, the largest level block,
    the whole chunk with the most level elements, and every chunk of the
    frame."""
    import torch

    from owlexabrick_tpu_torch.render import slabs

    g = torch.Generator(device="cpu").manual_seed(56)
    s_, ny, nx = 12, 80, 80
    zvs = torch.rand((2, s_, ny, nx), generator=g).to(device)
    cols = torch.arange(width, dtype=torch.float32) * ((nx + 4.0) / width)
    qx = (cols[None] * (1.0 + 0.01 * torch.arange(s_)[:, None]) - 2.0).to(
        device).contiguous()
    k6 = [k6_check("seeded_level_block", [([zvs], [qx])], 50)]
    for name in ("headline", "blobs256"):
        frame = capture_all_calls(
            slabs, "xresample_mids_levels",
            lambda: render_row(setups[name], width, height))
        frame = [c[:2] for c in frame]
        chunk = max(frame, key=lambda c: sum(z.numel() for z in c[0]))
        big = max(range(len(chunk[0])), key=lambda i: chunk[0][i].numel())
        k6.append(k6_check(f"{name}_largest_level",
                           [([chunk[0][big]], [chunk[1][big]])], 50))
        k6.append(k6_check(f"{name}_chunk", [chunk], 20))
        k6.append(k6_check(f"{name}_frame", frame, 5))
    return k6


def surface_setups(setups, tilted, device, width, height, sizes=(64, 256)):
    """The surface and AO rows at ``width`` x ``height`` (1920x1080) on
    the bench scenes (edges ``sizes``: the headline's, blobs256's), each a
    port ``Renderer`` (the user's entry point) with the row's camera,
    frame state, config and surfaces, its fast path enabled:

    - ``headline_mesh``: a bumpy sphere of 10,224 triangles
      (``bench_scene.bumpy_sphere``, radius MESH_RADIUS n) at the 64^3
      volume's center: the tiled triangle trace, its depth K1's stop;
    - ``headline_tilted_mesh``: the same through shear-warp (the trace
      on the 2944x1624 lattice rays, then K2a + K2b);
    - ``blobs256_streamlines``: 64 helices of 64 segments
      (``bench_scene.helix_bundle``, radius STREAM_RADIUS n) over the
      256^3 volume, ``tracer_timestep`` hiding each helix's last
      quarter: the tiled streamline trace;
    - ``headline_iso_ao``, ``blobs256_iso_ao``: the iso rows' iso value,
      shaded, AO with 2 samples of a 4-direction pool and ao_length 0.5
      n (the ao_sweep golden's recipe at scale: ``ao_fast``);
    - ``headline_mesh_iso_ao``: the mesh, that iso and AO
      (``ao_combined``: the lattice shadow OR the traced mesh).

    The level grids come from the bench setups (the Renderer would build
    the same from the same cells)."""
    import dataclasses

    from owlexabrick_tpu_torch.bench_scene import (
        bumpy_sphere, helix_bundle, synthetic_volume)
    from owlexabrick_tpu_torch.render.renderer import RenderConfig, Renderer
    from owlexabrick_tpu_torch.render.surfaces import SurfaceData
    from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

    n_head, n_big = sizes
    mesh = bumpy_sphere(radius=MESH_RADIUS * n_head, center=[n_head / 2] * 3)
    z = np.zeros((0, 3), np.float32)
    segs = helix_bundle(n_big, segments=STREAM_SEGMENTS)
    surfs = dict(
        mesh=SurfaceData.from_meshes([mesh], device=device),
        segs=SurfaceData.from_arrays(z, z, z, z, *segs,
                                     STREAM_RADIUS * n_big, device=device))
    cells = {n: volume_to_cells(synthetic_volume(n), 0.004, 3)
             for n in sizes}
    iso_ao = dict(iso_surfaces=True, ao_samples=2, ao_dirs=4)

    def row(setup, n, surf=None, shear=False, timestep=None, **cfg_kw):
        grids, _, fs, _, meta = setup[:5]
        if cfg_kw:
            fs = dataclasses.replace(
                fs, iso_enabled=np.asarray([True, False]),
                iso_value=np.asarray([ISO_FRAC * meta["value_max"], 0.0],
                                     np.float32),
                iso_channel=np.zeros(2, np.int32), ao_enabled=np.bool_(True),
                ao_length=np.float32(0.5 * n))
        if timestep is not None:
            fs = dataclasses.replace(fs, tracer_timestep=np.int32(timestep))
        lower, level, scal = cells[n]
        r = Renderer((lower, level, scal[None]), width, height,
                     cfg=RenderConfig(num_channels=1, **cfg_kw),
                     frame_state=fs, device=device,
                     surfaces=None if surf is None else surfs[surf])
        r._grids_cache[2] = grids
        r.enable_fast_path()
        if (r._fast[2] == "shearwarp") != shear:
            raise SystemExit(f"n={n}: the Renderer took {r._fast[2]!r}")
        return dict(renderer=r, n=n, meta=meta, surf=surf)

    head, b256 = setups["headline"], setups["blobs256"]
    return dict(
        headline_mesh=row(head, n_head, "mesh"),
        headline_tilted_mesh=row(tilted["headline_tilted"], n_head, "mesh",
                                 shear=True),
        blobs256_streamlines=row(b256, n_big, "segs",
                                 timestep=STREAM_SEGMENTS * 3 // 4 + 1),
        headline_iso_ao=row(head, n_head, **iso_ao),
        blobs256_iso_ao=row(b256, n_big, **iso_ao),
        headline_mesh_iso_ao=row(head, n_head, "mesh", **iso_ao))


def _render_timed(r):
    """One Renderer frame; returns its host-clock ms (ending in a
    synchronize)."""
    import torch

    t0 = time.perf_counter()
    r.render()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_surface_rows(rows, card, n_timed=2):
    """Each surface / AO row through its Renderer: the first frame and
    ``n_timed`` more, uncached (progressive frames: the jitter moves the
    pose); then frame 0 again at its pose, with the camera products
    cached (a static pose; the surfaces and AO are traced every frame),
    which must equal the uncached frame 0.  Counts each row's launches
    and calls of the tiled traces; returns each row's uncached frame 0
    color (P, 3) for the plain comparison."""
    import torch

    from owlexabrick_tpu_torch.render import surfaces

    frames = {}
    tiled = {k: getattr(surfaces, k) for k in (
        "trace_triangles_tiled", "trace_streamlines_tiled")}
    for name, row in rows.items():
        r = row["renderer"]
        for fn in tiled.values():
            fn.work.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n0 = launch_counts()
        unc = [_render_timed(r)]
        first = r.accum[:, :3].clone()
        unc += [_render_timed(r) for _ in range(n_timed)]
        r.reset_accumulation()
        again = _render_timed(r)  # frame 0's pose, not yet cached
        r.reset_accumulation()
        fill = _render_timed(r)  # fills the camera-product cache
        cached = []
        for _ in range(n_timed):
            r.reset_accumulation()
            cached.append(_render_timed(r))
        _, mx_c, _ = agree(first, r.accum[:, :3], frac=1.0)
        surf = r.surf
        rec = dict(
            row=name, card=card, lane=r._fast[2] or "aligned",
            tris=surf.num_tris, segments=surf.num_segments,
            ao=dict(zip(("combined", "fast"), r._ao_modes())),
            frames_uncached_ms=[round(t, 3) for t in unc + [again]],
            cache_first_frame_ms=round(fill, 3),
            frames_cached_ms=[round(t, 3) for t in cached],
            cached_vs_uncached_max_abs=mx_c,
            peak_mem_mb=round(torch.cuda.max_memory_allocated() / 1e6, 1),
            tiled_trace_calls={k: fn.work.get("calls", 0)
                               for k, fn in tiled.items()})
        rec.update({f"{k}_launches": v - n0[k]
                    for k, v in launch_counts().items()})
        rec["lit_share"] = float((first > 0.05).any(-1).float().mean())
        log("surface path:", json.dumps(rec))
        if not bool(torch.isfinite(r.accum).all()) or (
                rec["lit_share"] < 0.02):
            raise SystemExit(f"{name}: frames not finite or blank")
        if mx_c > 1e-6:
            raise SystemExit(f"{name}: cached frame differs by {mx_c}")
        want_calls = ((["trace_triangles_tiled"] if surf.num_tris else [])
                      + (["trace_streamlines_tiled"]
                         if surf.num_segments else []))
        if any(not rec["tiled_trace_calls"][k] for k in want_calls):
            raise SystemExit(f"{name}: the tiled trace did not run "
                             f"({rec['tiled_trace_calls']})")
        need = ["K1", "K6"] + (["K2a", "K2b"] if r._fast[2] else [])
        if min(rec[f"{k}_launches"] for k in need) <= 0:
            raise SystemExit(f"{name}: launched none of some of {need}")
        frames[name] = first
    return frames


def surface_stages(r, grids, scfg, cam, lattice, w, h, t_stop, n=2):
    """Host-clock ms (each ending in a synchronize; mean of ``n`` after
    one warm-up) of a surface row's frame stages at its frame-0 camera:
    everything before the volume (``Renderer._surfaces_and_iso``:
    surfaces, iso sweep, AO, shading), each nearest-surface trace the
    Renderer makes there (one run: ms and the tiled traces' ``work``),
    the iso sweep alone, and the volume (``render_slabs_camera`` with the
    row's stop, uncached)."""
    import torch

    from owlexabrick_tpu_torch.render.slabs import (
        render_slabs_camera, render_slabs_iso_camera)

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return round((time.perf_counter() - t0) * 1e3 / n, 3)

    from owlexabrick_tpu_torch.render import renderer as RM
    from owlexabrick_tpu_torch.render import surfaces as S

    fs = r.fs
    out = dict(before_volume_ms=timed(
        lambda: r._surfaces_and_iso(grids, scfg, cam, lattice, w, h)))
    # each nearest-surface trace of that stage (the primary rays, then
    # per AO sample the hemisphere or occluder rays): ms and its work
    run, traces = RM._nearest_surface, []
    tiled = (S.trace_triangles_tiled, S.trace_streamlines_tiled)

    def spy(*a, **kw):
        for fn in tiled:
            fn.work.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(*a, **kw)
        torch.cuda.synchronize()
        traces.append(dict(
            ms=round((time.perf_counter() - t0) * 1e3, 3),
            **{fn.__name__: dict(fn.work) for fn in tiled if fn.work}))
        return res

    for mod in (RM, S):
        mod._nearest_surface = spy
    try:
        r._surfaces_and_iso(grids, scfg, cam, lattice, w, h)
    finally:
        for mod in (RM, S):
            mod._nearest_surface = run
    out["renderer_traces"] = traces
    if r.cfg.iso_surfaces:
        out["iso_sweep_ms"] = timed(lambda: render_slabs_iso_camera(
            grids, fs, scfg, cam, w, h, lattice=lattice,
            return_normals=True))
    out["volume_ms"] = timed(lambda: render_slabs_camera(
        grids, fs, scfg, cam, w, h, lattice=lattice, t_stop=t_stop))
    return out


def phase_surface_checks(rows, frames, card, device):
    """Per surface / AO row, after its launches were counted: one
    profiled uncached frame (device ms, busy share, launches), K1 against
    its plain twin on a real chunk of the row's frame 0 with the row's
    surface stop (``t_stop`` from its surfaces, captured from the
    Renderer's call), and the row's frame 0 with every kernel's plain
    twin (``Renderer.plain_kernels``) against its kernel frame; and the
    host-clock times of the frame's stages (``surface_stages``).
    Returns the K1 results."""
    import torch

    from owlexabrick_tpu_torch.render import renderer as RM

    k1 = []
    for name, row in rows.items():
        r = row["renderer"]
        r.reset_accumulation()
        r.render()
        wall = _render_timed(r)
        prof = profile_once(r.render)
        log("surface profile:", json.dumps(dict(
            row=name, card=card, mode="uncached",
            **profile_record(wall, prof))))

        run = RM.render_slabs_camera
        seen = []

        def spy(*a, **kw):
            if not seen:
                seen.append((a, {k: v for k, v in kw.items()
                                 if k in ("lattice", "t_stop")}))
            return run(*a, **kw)

        RM.render_slabs_camera = spy
        try:
            r.resize(r.width, r.height)  # frame 0, products not cached
            r.render()
        finally:
            RM.render_slabs_camera = run
        (grids, fs, scfg, cam, w, h), kw = seen[0]
        t_stop = kw["t_stop"]
        log("surface stages:", json.dumps(dict(
            row=name, card=card, **surface_stages(r, grids, scfg, cam,
                                                  kw.get("lattice"), w, h,
                                                  t_stop))))
        ci = chunk_inputs(grids, cam, fs, scfg, w, h, SURF_K1_CHUNK,
                          lattice=kw.get("lattice"))
        stop = (ci["scale"].to(device),
                torch.as_tensor(t_stop).to(device).reshape(h, w))
        res = k1_check(f"{name}_real_chunk_surface_stop", ci, ci["prep"],
                       None, ci["tables_knots"], w, h, stop=stop)
        res["card"] = card
        k1.append(res)
        del ci, stop

        r.plain_kernels = True
        try:
            r.enable_fast_path()
            r.resize(r.width, r.height)
            t0 = time.perf_counter()
            r.render()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            ok, mx, share = agree(frames[name], r.accum[:, :3])
        finally:
            r.plain_kernels = False
            r.enable_fast_path()
        log(f"surface path {name}: kernel vs plain frame max_abs={mx} "
            f"share_within_1e-4={share:.6f} plain_frame_ms={ms:.1f}")
        if not ok:
            raise SystemExit(f"{name}: kernel frame disagrees with plain")
    return k1


# ----------------------------------------------------------------------------
# the exact path: the scene build, the exact goldens, headline_exact,
# headline_contour, blobs256_scene
# ----------------------------------------------------------------------------

def exact_scene(n, device):
    """The bench scene of edge n (``synthetic_volume(n)`` at threshold
    0.004, 3 levels) built by the port's pipeline with the native core on
    the host, then moved to ``device``.  Returns (host scene, device
    scene, cells, build s, move s)."""
    import torch

    from owlexabrick_tpu_torch.bench_scene import synthetic_volume
    from owlexabrick_tpu_torch.pipeline import scene_from_cells
    from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

    cells = volume_to_cells(synthetic_volume(n), 0.004, 3)
    t0 = time.perf_counter()
    host = scene_from_cells(cells[0], cells[1], [cells[2]], device="cpu")[0]
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = host.to(device)
    torch.cuda.synchronize()
    return host, scene, cells, build_s, time.perf_counter() - t0


def golden_surfaces(n, device):
    """The mesh_volume golden's quad and the tracer_segments golden's
    helix (tests/test_golden_images.py) as port SurfaceData."""
    from owlexabrick_tpu_torch.render.surfaces import SurfaceData

    v = np.asarray([[2.0, 2.0, n * 0.7], [n - 2.0, 2.0, n * 0.55],
                    [n - 2.0, n - 2.0, n * 0.55], [2.0, n - 2.0, n * 0.7]],
                   np.float32)
    tris = np.asarray([[0, 1, 2], [0, 2, 3]])
    v0 = v[tris[:, 0]]
    e1, e2 = v[tris[:, 1]] - v0, v[tris[:, 2]] - v0
    nrm = np.cross(e1, e2)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    z = np.zeros((0, 3), np.float32)
    t = np.linspace(0.0, 4.0 * np.pi, 33)
    pts = np.stack([n * 0.5 + n * 0.55 * np.cos(t),
                    n * 0.5 + n * 0.55 * np.sin(t),
                    n * 0.8 + t * (n * 0.2 / (4.0 * np.pi))],
                   axis=1).astype(np.float32)
    return dict(
        quad=SurfaceData.from_arrays(v0, e1, e2, nrm, z, z,
                                     np.zeros(0, np.int32), 0.5, device),
        helix=SurfaceData.from_arrays(z, z, z, z, pts[:-1], pts[1:],
                                      np.arange(1, 33, dtype=np.int32), 1.2,
                                      device))


def phase_exact_goldens(device, card):
    """The eight exact-path goldens (tests/test_golden_images.py's
    wavefront, iso, contour, clipbox, mesh_volume, tracer_segments,
    multichannel and ao_exact) through ``Renderer(scene)`` on the card,
    the scene built by the port's pipeline, under the golden gate."""
    import dataclasses

    from owlexabrick_tpu_torch.pipeline import scene_from_cells
    from owlexabrick_tpu_torch.render.camera import Camera
    from owlexabrick_tpu_torch.render.frame import make_frame_state
    from owlexabrick_tpu_torch.render.renderer import RenderConfig, Renderer
    from owlexabrick_tpu_torch.utils.png import golden_gate, read_png

    w, h, n = 96, 64, 32
    _, scene, cells, build_s, _ = exact_scene(n, device)
    surf = golden_surfaces(n, device)
    iso = dict(iso_enabled=np.asarray([True, False]),
               iso_value=np.asarray([0.55, 0.0], np.float32),
               iso_channel=np.zeros(2, np.int32))
    normals = np.zeros((3, 3), np.float32)
    normals[0] = [0.0, 0.0, 1.0]
    recipes = dict(
        wavefront=({}, None, {}, 2),
        iso=(dict(iso_surfaces=True), None, iso, 2),
        contour=({}, None, dict(
            contour_enabled=np.asarray([True, False, False]),
            contour_normal=normals,
            contour_offset=np.asarray([0.65, 0.5, 0.5], np.float32),
            contour_channel=np.zeros(3, np.int32)), 2),
        clipbox=({}, None, dict(
            clip_enabled=np.bool_(True),
            clip_lo=np.asarray([n * 0.25, 0.0, 0.0], np.float32),
            clip_hi=np.asarray([n, n, n * 0.8], np.float32)), 2),
        mesh_volume=({}, "quad", {}, 2),
        tracer_segments=({}, "helix", dict(tracer_timestep=np.int32(25)),
                         2),
        multichannel=(dict(num_channels=2), None, {}, 2),
        ao_exact=(dict(iso_surfaces=True, ao_samples=2), None, dict(
            iso, ao_enabled=np.bool_(True), ao_length=np.float32(n * 0.5)),
                  6))
    cam = Camera.look_at([n / 2, n / 2, n * 2.1], [n / 2] * 3, [0, 1, 0],
                         45.0, w, h)
    for name, (cfg_kw, sname, patch, frames) in recipes.items():
        s = scene
        if name == "multichannel":
            lower, level, scal = cells
            s = scene_from_cells(lower, level, [scal, 1.05 - scal],
                                 num_range_channels=2, device=device)[0]
            fs = make_frame_state(cam, 2, [[0.0, 1.05], [0.0, 4.0]], dt=1.0,
                                  opacity_scale=0.5)
        else:
            fs = make_frame_state(cam, 1, [[0.0, 1.05]], dt=1.0,
                                  opacity_scale=0.7)
        r = Renderer(s, w, h, cfg=RenderConfig(**cfg_kw),
                     frame_state=dataclasses.replace(fs, **patch),
                     device=device,
                     surfaces=None if sname is None else surf[sname])
        t0 = time.perf_counter()
        img = r.image_uint8(r.render_frames(frames))
        ms = (time.perf_counter() - t0) * 1e3 / frames
        want = read_png(str(REPO / "tests" / "golden" / f"{name}.png"))
        ok, mx, exact = golden_gate(img, want)
        log(f"exact golden {name}: max_diff={mx} exact={exact:.4f} "
            f"frame_ms={ms:.1f} {'pass' if ok else 'FAIL'}")
        if not ok or not (img[..., :3] > 16).any():
            raise SystemExit(f"exact golden {name} failed on the card")
    log(f"exact goldens: 32^3 scene built in {build_s:.3f} s ({card})")


def bench_frame_state(n, value_max, width, height):
    """bench.py's camera and TF at edge n (as ``bench_setup``)."""
    from owlexabrick_tpu_torch.render.camera import Camera
    from owlexabrick_tpu_torch.render.frame import make_frame_state

    cam = Camera.look_at(from_=[n / 2, n / 2, n * 2.2],
                         at=[n / 2, n / 2, n / 2], up=[0, 1, 0],
                         fovy_degrees=45.0, width=width, height=height)
    return make_frame_state(cam, 1, [[0.0, value_max]], dt=1.0,
                            opacity_scale=0.7)


def exact_frames(r, n_frames):
    """``n_frames`` progressive exact frames of Renderer ``r`` from frame
    0; returns (host-clock ms per frame, frame 0's color (P, 3))."""
    import torch

    r.reset_accumulation()
    times, first = [], None
    for i in range(n_frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render()
        torch.cuda.synchronize()
        times.append(round((time.perf_counter() - t0) * 1e3, 3))
        if i == 0:
            first = r.accum[:, :3].clone()
    return times, first


def build_exact_pack(r, host=None):
    """Renderer ``r``'s pack for the packed route, built and timed (the
    axis-2 grids first, then ``build_pack``), and, given the host scene,
    its twin on the CPU.  Returns (record, CPU pack or None); a scene
    whose ids pass 2^24 (``build_pack``'s ValueError, the JAX package's
    rule) is named in the record and takes the classic route."""
    import torch

    from owlexabrick_tpu_torch.render import wavefront

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r._grids_for(2)
    torch.cuda.synchronize()
    grids_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pack = r._wavefront_pack()
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    if pack is None:
        return dict(route="classic", grids_s=round(grids_s, 3),
                    pack="refused: ids past 2^24 (ValueError)"), None
    rec = dict(grids_s=round(grids_s, 3), pack_s=round(pack_s, 3),
               pack_mb=round(pack.table_nbytes() / 1e6, 3),
               grids_mb=round(nbytes(pack.flat) / 1e6, 3),
               descent=pack.descent, start_grid=list(pack.grid_dims),
               macro_cell=pack.grid_cw,
               nodes=int(pack.node_pack.shape[0]),
               levels=len(pack.grids.levels))
    cpu_pack = None
    if host is not None:
        cpu_pack = wavefront.build_pack(host, pack.grids.to("cpu"))
    return rec, cpu_pack


def phase_headline_exact(device, card):
    """``headline_exact``: the 64^3 bench scene (native build, moved to
    the card) and camera at 1920x1080, exact DVR through
    ``Renderer(scene)``, which takes the JAX Renderer's default route,
    the packed march (``wavefront.trace_dvr_packed_compacted``): the
    pack's build (grids s, ``build_pack`` s, table MB, descent, start
    grid), EXACT_FRAMES frames (ms, launches and busy share from one
    profiled frame, peak MB), frame 0's packed march at half its ray
    batch and at the batch, in turns; frame 0's packed rgba against the
    classic ``trace_dvr`` rgba of the same rays on the card (with their
    region iterations) and against the packed march on the CPU on every
    EXACT_CPU_STRIDE-th pixel, both under ``agree``'s gate; the classic
    march on the card against the CPU on those pixels; one default batch
    of gradient-shaded rays (classic: analytic and central differences,
    ms and peak MB).  No K1-K6 kernel runs on this path."""
    import dataclasses

    import torch

    from owlexabrick_tpu_torch.render import prng
    from owlexabrick_tpu_torch.render.dvr import (
        generate_rays, ray_batch, trace_dvr)
    from owlexabrick_tpu_torch.render.renderer import (
        EXACT_SEED, RenderConfig, Renderer)
    from owlexabrick_tpu_torch.render.wavefront import (
        packed_batch, trace_dvr_packed, trace_dvr_packed_compacted)

    w, h, n = 1920, 1080, 64
    host, scene, cells, build_s, move_s = exact_scene(n, device)
    fs = bench_frame_state(n, float(cells[2].max()), w, h)
    r = Renderer(scene, w, h, cfg=RenderConfig(), frame_state=fs,
                 device=device)
    pack_rec, cpu_pack = build_exact_pack(r, host)
    if cpu_pack is None:
        raise SystemExit(f"headline_exact: no pack ({pack_rec})")
    pack = r._wavefront_pack()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    times, first = exact_frames(r, EXACT_FRAMES)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    counts = launch_counts()
    if any(counts.values()):
        raise SystemExit(f"the exact frame launched port kernels: {counts}")
    route = r.exact_route
    log(f"headline_exact: route {route}, pack {json.dumps(pack_rec)}")
    if route != "packed_compacted":
        raise SystemExit(f"headline_exact took the {route} route")
    prof = profile_once(r.render)

    # frame 0's rays again: packed and classic on the card, both on the
    # CPU on every EXACT_CPU_STRIDE-th pixel
    p = w * h
    key = prng.fold_in(prng.prng_key(EXACT_SEED), 0)
    rays = []
    for dev in (device, torch.device("cpu")):
        jit = prng.uniform(prng.fold_in(key, 1), (p, 2), dev)
        off = prng.uniform(prng.fold_in(key, 2), (p,), dev)
        rays.append((*generate_rays(fs, w, h, jit, dev), off))
    o, d, off = rays[0]
    packed = trace_dvr_packed_compacted(pack, scene, fs, r.cfg, o, d, off)
    t0 = time.perf_counter()
    rgba, iters = trace_dvr(scene, fs, r.cfg, o, d, off, return_stats=True)
    torch.cuda.synchronize()
    trace_ms = (time.perf_counter() - t0) * 1e3
    # the packed batch: frame 0's packed march at half the batch and at
    # the batch, in turns (ms and peak MB each)
    batch = packed_batch(pack)
    turns = []
    for b in (batch // 2, batch, batch, batch // 2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trace_dvr_packed(pack, scene, fs, r.cfg, o, d, off, batch=b)
        torch.cuda.synchronize()
        turns.append(dict(batch=b, ms=round(
            (time.perf_counter() - t0) * 1e3, 3), peak_mem_mb=round(
            torch.cuda.max_memory_allocated() / 1e6, 1)))
    # gradient shading (the classic march): one full default batch of
    # frame 0's rays (every k-th pixel) with analytic gradients and with
    # central differences (6 sample points a ray, so a sixth of the
    # batch): ms and peak MB
    grad_batches = []
    for kw, pts in ((dict(), 1), (dict(analytic_gradients=False), 6)):
        cfg_g = dataclasses.replace(r.cfg, gradient_shading_dvr=True, **kw)
        b = ray_batch(scene, pts)
        sel = torch.arange(0, p, max(1, p // b), device=device)[:b]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        g_rgba = trace_dvr(scene, fs, cfg_g, o[sel], d[sel], off[sel])
        torch.cuda.synchronize()
        grad_batches.append(dict(
            analytic=not kw, points_per_ray=pts, rays=int(sel.numel()),
            ms=round((time.perf_counter() - t0) * 1e3, 3),
            peak_mem_mb=round(torch.cuda.max_memory_allocated() / 1e6, 1),
            finite=bool(torch.isfinite(g_rgba).all())))
    idx = torch.arange(0, p, EXACT_CPU_STRIDE)
    o_c, d_c, off_c = (x[idx] for x in rays[1])
    t0 = time.perf_counter()
    want = trace_dvr_packed(cpu_pack, host, fs, r.cfg, o_c, d_c, off_c)
    cpu_s = time.perf_counter() - t0
    want_classic = trace_dvr(host, fs, r.cfg, o_c, d_c, off_c)
    checks = dict(
        packed_vs_classic=agree(packed, rgba),
        packed_card_vs_cpu=agree(packed[idx.to(device)].cpu(), want),
        classic_card_vs_cpu=agree(rgba[idx.to(device)].cpu(),
                                  want_classic))
    # frame 0 is the packed march's rgba over the black background
    same = float((packed[:, :3] * packed[:, 3:4] - first).abs().max())
    rec = dict(
        row="headline_exact", card=card, cells=int(cells[0].shape[0]),
        regions=int(scene.region_lo.shape[0]),
        bricks=int(scene.brick_lower.shape[0]),
        max_bricks_per_region=scene.max_bricks_per_region,
        tree_depth=scene.tree_depth, scene_build_s=round(build_s, 3),
        scene_to_card_s=round(move_s, 3),
        scene_mb=round(scene.nbytes() / 1e6, 3), route=route, **pack_rec,
        frames_ms=times, trace_dvr_frame0_ms=round(trace_ms, 3),
        packed_batch_turns=turns, gradient_batches=grad_batches,
        peak_mem_mb=round(peak_mb, 1),
        region_iters=dict(mean=float(iters.mean()),
                          max=float(iters.max()),
                          total=float(iters.sum()),
                          rays_marched=int((iters > 0).sum())),
        frame0_retrace_max_abs=same,
        checks={k: dict(ok=v[0], max_abs=v[1], share_within_1e4=v[2])
                for k, v in checks.items()},
        cpu_rays=int(idx.numel()), cpu_packed_s=round(cpu_s, 1),
        lit_share=float((first > 0.05).any(-1).float().mean()),
        **profile_record(times[-1], prof))
    log("exact path:", json.dumps(rec))
    if not bool(torch.isfinite(r.accum).all()) or rec["lit_share"] < 0.05:
        raise SystemExit("headline_exact: frames not finite or blank")
    for k, (ok, mx, share) in checks.items():
        if not ok:
            raise SystemExit(f"headline_exact: {k} disagrees (max {mx}, "
                             f"share {share})")
    if same > 1e-6:
        raise SystemExit(f"headline_exact: frame 0 retraced differs {same}")
    if not all(g["finite"] for g in grad_batches):
        raise SystemExit("headline_exact: gradient-shaded rays not finite")
    return rec


def contour_row(setups, device, width, height):
    """``headline_contour``: the headline fast path (its grids, camera
    and TF) with one contour plane through the centre, colored from the
    exact scene the Renderer builds from the cells at first need."""
    import dataclasses

    from owlexabrick_tpu_torch.bench_scene import synthetic_volume
    from owlexabrick_tpu_torch.render.renderer import RenderConfig, Renderer
    from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

    grids, _, fs, _, meta = setups["headline"][:5]
    n = 64
    normals = np.zeros((3, 3), np.float32)
    normals[0] = CONTOUR_NORMAL
    fs = dataclasses.replace(
        fs, contour_enabled=np.asarray([True, False, False]),
        contour_normal=normals,
        contour_offset=np.asarray([CONTOUR_OFFSET, 0.5, 0.5], np.float32),
        contour_channel=np.zeros(3, np.int32))
    lower, level, scal = volume_to_cells(synthetic_volume(n), 0.004, 3)
    r = Renderer((lower, level, scal[None]), width, height,
                 cfg=RenderConfig(num_channels=1), frame_state=fs,
                 device=device)
    r._grids_cache[2] = grids
    r.enable_fast_path()
    if r._fast[2] is not None:
        raise SystemExit(f"headline_contour took {r._fast[2]!r}")
    return dict(headline_contour=dict(renderer=r, n=n, meta=meta,
                                      surf=None))


def phase_blobs256_scene(device, card):
    """``blobs256_scene``: the 256^3 bench scene built with the native
    core and moved to the card (build s, scene MB), its pack (grids s,
    ``build_pack`` s, table MB, descent, the start grid's macro-cell
    width), then one exact frame at BLOBS256_EXACT_SIZE with the bench
    camera through the packed route (ms, peak MB), and its packed rgba
    against the classic ``trace_dvr`` on every EXACT_CPU_STRIDE-th
    pixel's rays on the card under ``agree``."""
    import torch

    from owlexabrick_tpu_torch.render import prng
    from owlexabrick_tpu_torch.render.dvr import generate_rays, trace_dvr
    from owlexabrick_tpu_torch.render.renderer import (
        EXACT_SEED, RenderConfig, Renderer)
    from owlexabrick_tpu_torch.render.wavefront import trace_dvr_packed

    n = 256
    w, h = BLOBS256_EXACT_SIZE
    _, scene, cells, build_s, move_s = exact_scene(n, device)
    fs = bench_frame_state(n, float(cells[2].max()), w, h)
    r = Renderer(scene, w, h, cfg=RenderConfig(), frame_state=fs,
                 device=device)
    pack_rec, _ = build_exact_pack(r)
    log(f"blobs256_scene: pack {json.dumps(pack_rec)}")
    torch.cuda.reset_peak_memory_stats()
    times, first = exact_frames(r, 1)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    route = r.exact_route
    if route != "packed_compacted":
        raise SystemExit(f"blobs256_scene took the {route} route")
    # frame 0's rays on every EXACT_CPU_STRIDE-th pixel: packed against
    # classic on the card
    p = w * h
    key = prng.fold_in(prng.prng_key(EXACT_SEED), 0)
    jit = prng.uniform(prng.fold_in(key, 1), (p, 2), device)
    off = prng.uniform(prng.fold_in(key, 2), (p,), device)
    o, d = generate_rays(fs, w, h, jit, device)
    idx = torch.arange(0, p, EXACT_CPU_STRIDE, device=device)
    packed = trace_dvr_packed(r._wavefront_pack(), scene, fs, r.cfg,
                              o[idx], d[idx], off[idx])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    classic = trace_dvr(scene, fs, r.cfg, o[idx], d[idx], off[idx])
    torch.cuda.synchronize()
    classic_ms = (time.perf_counter() - t0) * 1e3
    ok, mx, share = agree(packed, classic)
    same = float((packed[:, :3] * packed[:, 3:4] - first[idx]).abs().max())
    rec = dict(row="blobs256_scene", card=card,
               cells=int(cells[0].shape[0]),
               regions=int(scene.region_lo.shape[0]),
               bricks=int(scene.brick_lower.shape[0]),
               max_bricks_per_region=scene.max_bricks_per_region,
               tree_depth=scene.tree_depth, scene_build_s=round(build_s, 3),
               scene_to_card_s=round(move_s, 3),
               scene_mb=round(scene.nbytes() / 1e6, 3), route=route,
               **pack_rec, exact_frame=[w, h], frames_ms=times,
               peak_mem_mb=round(peak_mb, 1),
               packed_vs_classic=dict(rays=int(idx.numel()), ok=ok,
                                      max_abs=mx, share_within_1e4=share,
                                      classic_ms=round(classic_ms, 3)),
               frame0_retrace_max_abs=same,
               lit_share=float((first > 0.05).any(-1).float().mean()))
    log("exact path:", json.dumps(rec))
    if not bool(torch.isfinite(r.accum).all()) or rec["lit_share"] < 0.05:
        raise SystemExit("blobs256_scene: frame not finite or blank")
    if not ok:
        raise SystemExit(f"blobs256_scene: packed disagrees with classic "
                         f"(max {mx}, share {share})")
    if same > 1e-6:
        raise SystemExit(f"blobs256_scene: frame 0 retraced differs {same}")
    return rec


def _cli(argv):
    """One in-process run of the port's offline CLI; returns its stdout
    lines (echoed to the log) and the ms per frame it printed."""
    import contextlib
    import io

    from owlexabrick_tpu_torch.viewer.offline import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([str(a) for a in argv])
    lines = buf.getvalue().splitlines()
    for line in lines:
        log("  " + line)
    if rc != 0:
        raise SystemExit(f"cli_exajet256: the CLI returned {rc}")
    return lines, _cli_ms(lines)


def _cli_ms(lines):
    import re

    for line in lines:
        m = (re.search(r"fast path [0-9.]+ FPS \(([0-9.]+) ms\)", line)
             or re.search(r"\(([0-9.]+) ms/frame\)", line))
        if m:
            return float(m.group(1))
    raise SystemExit(f"cli_exajet256: no frame time in {lines}")


def _srgb_u8(rgba, width, height):
    """A (P, 4) linear frame as the CLI's --fast PNG: sRGB, 8 bits, rows
    top down."""
    from owlexabrick_tpu_torch.render.dvr import linear_to_srgb

    srgb = linear_to_srgb(rgba.reshape(height, width, 4)[..., :3])
    return np.clip(srgb.cpu().numpy() * 255, 0, 255).astype(np.uint8)[::-1]


def _gate(name, img, want, phase="cli_exajet256"):
    from owlexabrick_tpu_torch.utils.png import golden_gate

    ok, mx, exact = golden_gate(img, want)
    log(f"{phase} {name}: max_diff={mx} exact={exact:.4f} "
        f"{'pass' if ok else 'FAIL'}")
    if not ok or not (img[..., :3] > 16).any():
        raise SystemExit(f"{phase}: {name} failed the golden gate")
    return dict(max_diff=mx, exact=round(exact, 5))


def _full_scene_golden(work, device):
    """tests/test_end_to_end.py's full-scene CLI golden (artificial ->
    builder CLI -> an expression field, a mesh, iso, a contour plane and
    the tracer; 48x36) through the port's tools and CLI on the card."""
    from owlexabrick_tpu_torch.builder.__main__ import main as build_main
    from owlexabrick_tpu_torch.core.types import TriangleMesh
    from owlexabrick_tpu_torch.io import formats
    from owlexabrick_tpu_torch.tools.artificial import generate
    from owlexabrick_tpu_torch.utils.png import read_png

    d = work / "full_scene"
    d.mkdir(parents=True, exist_ok=True)
    (d / "two.grids").write_text("0 0 0 6 6 6 0 0 1 2 3 4 5 6 7\n"
                                 "6 0 0 2 2 2 1 4\n")
    generate(str(d / "two.grids"), str(d / "d"))
    if build_main([str(d / "d.cells"), "-o", str(d / "d.bricks")]) != 0:
        raise SystemExit("cli_exajet256: the full scene's builder failed")
    dens = formats.read_scalars(str(d / "d.scalars"))
    formats.write_scalars(str(d / "inv.scalars"), 7.0 - dens)
    v = np.asarray([[0.5, 0.5, 5.5], [7.5, 0.5, 4.5], [7.5, 7.5, 4.5],
                    [0.5, 7.5, 5.5]], np.float32)
    formats.write_tris(str(d / "m.tris"), [TriangleMesh(
        vertices=v, indices=np.asarray([[0, 1, 2], [0, 2, 3]], np.int32))])
    (d / "scene.exa").write_text(
        "bricks d.bricks\nscalar density d.scalars\nvalue_range 0 7\n"
        "scalar inv inv.scalars\nvalue_range 0 7\n"
        'scalar combo expr "%0 %1 +"\ntriangles m.tris\n'
        "remap_from 0 0 0 8 8 8\nremap_to 0 0 0 8 8 8\n")
    out = d / "full.png"
    _cli([d / "scene.exa", "--size", "48", "36", "--camera", "20", "15",
          "25", "4", "3", "3", "0", "1", "0", "--fov", "45", "--range", "0",
          "7", "--dt", "0.7", "--isovals", "3.5", "--isochans", "0",
          "--contourplane", "0", "0", "1", "0.4", "--contourchan", "0",
          "--tracer", "3", "--tracer-channels", "0", "1", "2",
          "--tracer-seeds", "16", "--tracer-steplen", "0.5", "--frames",
          "2", "-o", out, "--device", device])
    return _gate("e2e_full_cli golden", read_png(str(out)), read_png(
        str(REPO / "tests" / "golden" / "e2e_full_cli.png")))


def phase_cli_exajet256(device, card, n=256, size=(1920, 1080)):
    """``cli_exajet256``: the README's Quick start chain at full width on
    the bench's exajet256 scene (bench.py:242; 1,981,414 cells):
    ``bench_scene.exajet_pattern_cells(256)`` written to .cells/.scalars
    by the port's ``io.formats``, ``python -m owlexabrick_tpu_torch.
    builder`` as a subprocess, a .exa with the field's value_range, and
    the port's offline CLI at 1920x1080 from the bench camera (fovy 45,
    dt 1, opacity scale 0.7, the TF domain from the .exa):

    1. ``--fast --frames 8`` aligned as a ``python -m`` subprocess (its
       printed ms per frame: a fresh process, the card's first frames
       included), held to the in-process ``--plain-kernels`` frame; then
       in process (warm): K6 and K1;
    2. ``--fast`` from the tilted eye (0.9n, 0.8n, 2.2n): shear-warp,
       K6, K1, K2a and K2b;
    3. ``--fast --bands 4 --no-adaptive-stride``: K6 and K1 per band;
       its image held to the unbanded ``render_slabs_camera`` frame of
       the same slabs (uniform stride: adaptive-stride groups form inside
       a chunk, and 66-slab bands do not fall on the 12-slab chunk
       lattice), then the banded sweep's first (host band grids built)
       and steady (reused, uploaded) frames with ``mem_stats`` and the
       card's peak;
    4. ``--fast --clip-box`` with the clipbox golden's box scaled to n:
       the Renderer's fast path, K6 and K3;

    each in-process kernel run held to the same command's
    ``--plain-kernels`` frame under the golden gate, and the
    ``e2e_full_cli`` golden through the port's CLI on the card.  Returns
    (launches of the in-process kernel runs, record)."""
    import torch

    from owlexabrick_tpu_torch.bench_scene import exajet_pattern_cells
    from owlexabrick_tpu_torch.io import formats
    from owlexabrick_tpu_torch.io.config import parse_config
    from owlexabrick_tpu_torch.render.camera import Camera
    from owlexabrick_tpu_torch.render.frame import make_frame_state
    from owlexabrick_tpu_torch.render.scene import scene_from_config
    from owlexabrick_tpu_torch.render.slabs import (
        SlabConfig, build_level_grids, render_slabs_banded,
        render_slabs_camera)
    from owlexabrick_tpu_torch.utils.png import read_png

    (w, h), bands = size, 4
    work = REPO / "build" / "cli_exajet256"
    work.mkdir(parents=True, exist_ok=True)
    rec = dict(row="cli_exajet256", card=card, size=[w, h])
    t0 = time.perf_counter()
    lower, level, scal = exajet_pattern_cells(n)
    formats.write_cells(str(work / "e.cells"), lower, level)
    formats.write_scalars(str(work / "e.scalars"), scal)
    rec.update(cells=int(lower.shape[0]),
               cells_by_level=np.bincount(level).tolist(),
               cells_s=round(time.perf_counter() - t0, 3))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "owlexabrick_tpu_torch.builder",
         str(work / "e.cells"), "-o", str(work / "e.bricks")],
        cwd=str(REPO), capture_output=True, text=True, timeout=600)
    rec["builder_s"] = round(time.perf_counter() - t0, 3)
    for line in proc.stdout.splitlines():
        log("  " + line)
    if proc.returncode:
        raise SystemExit(f"cli_exajet256: the builder failed:\n"
                         f"{proc.stderr[-4000:]}")
    vmax = float(scal.max())
    exa = work / "e.exa"
    exa.write_text(f"bricks e.bricks\nscalar density e.scalars\n"
                   f"value_range 0 {vmax!r}\n")
    # the scene build the CLI does first (the native region build)
    t0 = time.perf_counter()
    cfg = parse_config(str(exa))
    scene = scene_from_config(cfg, device=device)[0]
    torch.cuda.synchronize()
    rec.update(scene_s=round(time.perf_counter() - t0, 3),
               bricks=int(cfg.bricks.num_bricks),
               regions=int(scene.region_lo.shape[0]))
    del scene

    c = n / 2
    eye = dict(bench=[c, c, 2.2 * n], tilted=[0.9 * n, 0.8 * n, 2.2 * n])
    base = [exa, "--size", w, h, "--fov", "45", "--dt", "1", "--xf-scale",
            "0.7", "--device", device]

    def cam_args(which):
        return ["--camera", *eye[which], c, c, c, 0, 1, 0]

    # 1. aligned, as the module's own __main__
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "owlexabrick_tpu_torch.viewer.offline",
         *map(str, base + cam_args("bench") + [
             "--fast", "--frames", "8", "-o", work / "aligned.png"])],
        cwd=str(REPO), capture_output=True, text=True, timeout=600)
    lines = proc.stdout.splitlines()
    for line in lines:
        log("  " + line)
    if proc.returncode:
        raise SystemExit(f"cli_exajet256: the viewer CLI failed:\n"
                         f"{proc.stderr[-4000:]}")
    rec["aligned"] = dict(ms=_cli_ms(lines), subprocess_s=round(
        time.perf_counter() - t0, 3))
    _cli(base + cam_args("bench") + ["--fast", "--frames", "1",
                                     "--plain-kernels", "-o",
                                     work / "aligned_plain.png"])
    rec["aligned"]["subprocess_gate"] = _gate(
        "aligned (subprocess) vs plain", read_png(str(work / "aligned.png")),
        read_png(str(work / "aligned_plain.png")))

    # 2-4 in process: each launches its kernels
    clip = ["--clip-box", *(v * n for v in CLIP_LO), *(v * n for v in
                                                       CLIP_HI)]
    runs = dict(
        aligned=(cam_args("bench") + ["--fast", "--frames", "8"],
                 ("K1", "K6")),
        tilted=(cam_args("tilted") + ["--fast", "--frames", "2"],
                ("K1", "K2a", "K2b", "K6")),
        banded=(cam_args("bench") + ["--fast", "--bands", bands,
                                     "--no-adaptive-stride"], ("K1", "K6")),
        clip=(cam_args("bench") + clip + ["--fast", "--frames", "2"],
              ("K3", "K6")))
    total = {k: 0 for k in launch_counts()}
    for name, (args, kernels) in runs.items():
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        out = work / f"{name}{'_warm' if name == 'aligned' else ''}.png"
        _, ms = _cli(base + args + ["-o", out])
        got = launch_counts()
        rec.setdefault(name, {}).update(
            {"ms" if name != "aligned" else "warm_ms": ms, "launches": got,
             "peak_mb": round(torch.cuda.max_memory_allocated() / 1e6, 1)})
        if min(got[k] for k in kernels) <= 0:
            raise SystemExit(f"cli_exajet256 {name}: a kernel of its path "
                             f"was not launched: {got}")
        total = {k: total[k] + got[k] for k in total}
        if name in ("tilted", "clip"):
            _cli(base + args + ["--plain-kernels", "-o",
                                work / f"{name}_plain.png"])
        if name != "banded":
            rec[name][f"{name}_gate"] = _gate(
                f"{name} vs plain", read_png(str(out)),
                read_png(str(work / f"{name}_plain.png")))

    # 3b. the banded image against the unbanded frame of the same slabs
    # (the CLI's banded sweep keeps the knots), then its first and
    # steady frames through the host band-grid cache
    cam = Camera.look_at(eye["bench"], [c, c, c], [0, 1, 0], 45.0, w, h)
    fs = make_frame_state(cam, 1, [[0.0, vmax]], dt=1.0, opacity_scale=0.7)
    lo3, hi3 = cfg.bricks.bounds()
    extent = float(hi3[:, 2].max() - lo3[:, 2].min()) + float(
        1 << int(cfg.bricks.level.max()))
    scfg = SlabConfig(nslabs=int(np.ceil(extent)), adaptive_stride=False)
    scalars = cfg.scalar_fields[0].values[cfg.cell_ids]
    torch.cuda.reset_peak_memory_stats()
    grids = build_level_grids(cfg.bricks, scalars, axis=2, device=device)
    t0 = time.perf_counter()
    full = render_slabs_camera(grids, fs, scfg, cam, w, h)
    torch.cuda.synchronize()
    rec["banded"]["unbanded_ms"] = round((time.perf_counter() - t0) * 1e3,
                                         3)
    rec["banded"]["unbanded_peak_mb"] = round(
        torch.cuda.max_memory_allocated() / 1e6, 1)
    rec["banded"].update(_gate("banded vs unbanded", read_png(
        str(work / "banded.png")), _srgb_u8(full, w, h)))
    del grids, full
    torch.cuda.empty_cache()
    mem, times = {}, []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        t0 = time.perf_counter()
        render_slabs_banded(cfg.bricks, scalars, fs, scfg, cam, w, h,
                            n_bands=bands, mem_stats=mem, device=device)
        torch.cuda.synchronize()
        times.append(round((time.perf_counter() - t0) * 1e3, 3))
    rec["banded"].update(
        first_ms=times[0], steady_ms=times[1:],
        peak_band_bytes=mem["peak_band_bytes"], full_bytes=mem["full_bytes"],
        band_peak_mb=round(torch.cuda.max_memory_allocated() / 1e6, 1))
    if mem["peak_band_bytes"] >= mem["full_bytes"]:
        raise SystemExit(f"cli_exajet256: a band holds the full grids {mem}")
    rec["e2e_full_cli"] = _full_scene_golden(work, device)
    log("cli_exajet256:", json.dumps(rec))
    log("launches on the CLI path:", json.dumps(total))
    return total, rec


def deep_chunk(n_levels, device, seed, height=1080, width=1920, slabs=12):
    """A seeded chunk of ``n_levels`` levels at the main path's 1080p
    shapes (K1's inputs): level l of cell width 2^l over a 256-row
    level-0 lattice, mids (2, S, ny_l, W) with empty samples, the y
    positions of the chunk's slabs, every slab live, the Jet LUT's
    knots and dense tables, the activity tables these give."""
    import torch

    from owlexabrick_tpu_torch.render.slabs import compress_pwl
    from owlexabrick_tpu_torch.render.sweep import (
        combine_activity, pack_luts, prepare_chunk)
    from owlexabrick_tpu_torch.viewer.colormaps import colormap_colors

    g = torch.Generator(device=device).manual_seed(seed)
    mids = []
    for lv in range(n_levels):
        ny = (256 >> lv) + 3
        r = torch.rand((2, slabs, ny, width), generator=g, device=device)
        mask = torch.where(r[1:] < 0.2, 0.0, r[1:])
        mids.append(torch.cat([r[:1] * mask, mask]).contiguous())
    rows = torch.linspace(-2.0, 258.0, height, device=device)
    y_pos = (rows[None] * (1.0 + 0.002 * torch.arange(
        slabs, device=device, dtype=torch.float32)[:, None])).contiguous()
    prep = prepare_chunk(mids, [-1.0] * n_levels,
                         [float(1 << lv) for lv in range(n_levels)], y_pos,
                         height, width)
    opac = np.clip(np.linspace(-0.2, 1.0, 128), 0.0, 1.0)
    lut_np = np.concatenate([colormap_colors("Jet", 128),
                             0.1 * opac[:, None]], 1).astype(np.float32)
    lut = torch.from_numpy(lut_np).to(device)
    domains = torch.tensor([[0.0, 1.0]], device=device)
    act_f, act_all_f, live = combine_activity(
        prep, torch.ones(slabs, dtype=torch.bool), [lut], domains)
    sec = 1.0 + 0.2 * torch.rand((height, width), generator=g,
                                 device=device)
    pt = 0.2 + 0.8 * torch.rand((height, width), generator=g, device=device)
    return dict(prep=prep, live=live, act_f=act_f, act_all_f=act_all_f,
                sec=sec, dz=np.float32(0.75), pt=pt,
                tables_knots=pack_luts([lut], domains, compress_pwl([lut_np]),
                                       device))


def deep_k3_inputs(n_levels, device, seed, height=1080, width=1920,
                   slabs=12):
    """K3's inputs (mids, y taps, scale, t_start, t_stop, sec, LUT,
    domain, dz) for a seeded 1080p chunk of ``n_levels`` occupied
    levels: level l's mids (2, S, ny_l, W) over a 256-row level-0
    lattice, its tent taps at screen rows running past both lattice
    ends, a clip interval that 10% of pixels miss."""
    import torch

    from owlexabrick_tpu_torch.render.mids import tent_taps

    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    mids, taps = [], []
    for lv in range(n_levels):
        ny = (256 >> lv) + 3
        mask = torch.where(rand(slabs, ny, width) < 0.2, 0.0,
                           rand(slabs, ny, width))
        mids.append(torch.stack([(1.6 * rand(slabs, ny, width) - 0.3)
                                 * mask, mask]).contiguous())
        qy = (torch.linspace(-1.5, ny + 0.5, height, device=device)[None]
              * (1.0 + 0.01 * torch.arange(slabs, device=device)[:, None]))
        (i0, i1), (w0, w1), _ = tent_taps(qy, ny)
        taps.append(torch.stack([w0, w1, i0.float(), i1.float()],
                                -1).contiguous())
    scale = torch.sort(1.0 + 29.0 * rand(slabs)).values
    t_start = 20.0 * rand(height, width)
    t_stop = t_start + 3.0 + 17.0 * rand(height, width)
    miss = rand(height, width) < 0.1
    t_start = torch.where(miss, float("inf"), t_start).contiguous()
    t_stop = torch.where(miss, float("-inf"), t_stop).contiguous()
    sec = (1.0 + 5.0 * rand(height, width)).contiguous()
    lut = rand(128, 4)
    lut[64:80, 3] = 1.0
    return (mids, taps, scale, t_start, t_stop, sec, lut.contiguous(),
            np.asarray([0.1, 0.9], np.float32), np.float32(0.75))


def phase_levels(device, size=(1920, 1080)):
    """``phase_levels``: K1 and K3 past 8 levels (their level tables
    hold every level a scene can have): seeded 1080p chunks of 9 and 12
    levels through K1 at 1 and 4 channels and through K3, each against
    its plain twin (K1 within TOL_K1 on every value, K3 bit for bit),
    timed by CUDA-graph replay and events.  Returns (K1 results, K3
    results)."""
    k1, k3 = [], []
    for n_levels in (9, 12):
        ci = deep_chunk(n_levels, device, 900 + n_levels, *size[::-1])
        log(f"levels {n_levels}: K1 mids shapes (C+1, S, ny, W):",
            [tuple(m.shape) for m in ci["prep"].mids])
        k1.append(k1_check(f"levels{n_levels}_1ch", ci, ci["prep"],
                           ci["pt"], ci["tables_knots"], *size))
        prep_c, pt_c, tables_c = seeded_channels_chunk(
            ci, 950 + n_levels, device, 4)
        k1.append(k1_check(f"levels{n_levels}_4ch", ci, prep_c, pt_c,
                           tables_c, *size))
        del ci, prep_c
        k3.append(k3_check(f"levels{n_levels}", deep_k3_inputs(
            n_levels, device, 970 + n_levels, *size[::-1])))
    return k1, k3


def _serve_get(base, path, timeout=600):
    """One GET; (status, body, host ms)."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(base + path, timeout=timeout) as r:
            status, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    return status, body, round((time.perf_counter() - t0) * 1e3, 3)


def phase_serve(device, card, size=(1920, 1080),
                exa=REPO / "build" / "cli_exajet256" / "e.exa"):
    """``phase_serve``: the port's web viewer (``viewer.serve``) on the
    ``.exa`` that ``phase_cli_exajet256`` wrote (exajet256: 1,981,414
    cells), at 1920x1080 with ``device="cuda"``, behind a
    ThreadingHTTPServer on 127.0.0.1 in this process (rendering on its
    handler threads), through real HTTP requests: ``/``, the orbit pose
    (frames 0-2: shear-warp, K6, K1, K2a, K2b), an axis view (frames 0,
    1), a fly pose, the clipbox golden's box (K3), ``gsdvr=1`` (K4), an
    iso value at 0.524 of the value range, ``tron=1`` (two frames),
    ``clock=0.05`` and ``/xf``.  Every response 200, every frame a
    1920x1080 PNG with lit pixels; orbit frame 0 and clip frame 0 held
    to a ``plain_kernels`` ViewerState's under the golden gate.  Logs
    each request's host ms and the peak MB.  Returns the record."""
    import io
    import threading
    from http.server import ThreadingHTTPServer
    from urllib.parse import urlencode

    import torch

    from owlexabrick_tpu_torch.utils.png import read_png
    from owlexabrick_tpu_torch.viewer import serve

    w, h = size
    t0 = time.perf_counter()
    state = serve.ViewerState(str(exa), w, h, device=device)
    rec = dict(row="serve_exajet256", card=card, size=[w, h],
               state_s=round(time.perf_counter() - t0, 3), requests=[])
    vmax = float(state.value_range[1])
    lo, ext = state.world_lo, state.world_hi - state.world_lo
    # the tilted bench eye (0.9n, 0.8n, 2.2n) at the center, as a fly pose
    eye = lo + np.asarray([0.9, 0.8, 2.2]) * ext
    fly = dict(ex=eye[0], ey=eye[1], ez=eye[2], ax=state.center[0],
               ay=state.center[1], az=state.center[2])
    clip = dict(clip=1, cx0=CLIP_LO[0], cy0=CLIP_LO[1], cz0=CLIP_LO[2],
                cx1=CLIP_HI[0], cy1=CLIP_HI[1], cz1=CLIP_HI[2])
    queries = [
        ("orbit_0", dict(frame=0)), ("orbit_1", dict(frame=1)),
        ("orbit_2", dict(frame=2)),
        ("axis_0", dict(theta=0, phi=0, frame=0)),
        ("axis_1", dict(theta=0, phi=0, frame=1)),
        ("fly_0", dict(fly, frame=0)),
        ("clip_0", dict(clip, frame=0)),
        ("gsdvr_0", dict(gsdvr=1, frame=0)),
        ("iso_0", dict(iso=ISO_FRAC * vmax, frame=0)),
        ("tron_0", dict(tron=1, frame=0)), ("tron_1", dict(tron=1, frame=1)),
        ("clock_0", dict(fly, clock=0.05, frame=0)),
    ]
    server = ThreadingHTTPServer(("127.0.0.1", 0), type(
        "Handler", (serve._Handler,), {"state": state}))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    pngs = {}
    try:
        status, body, ms = _serve_get(base, "/")
        rec["requests"].append(dict(path="/", status=status, ms=ms))
        if status != 200 or b"<canvas" not in body:
            raise SystemExit(f"serve: / answered {status}")
        for name, kw in queries:
            q = dict(theta=0.5, phi=0.3, dist=1.2, lo=0, hi=vmax)
            q.update(kw)
            torch.cuda.reset_peak_memory_stats()
            status, body, ms = _serve_get(base, "/frame?" + urlencode(q))
            r = dict(path=name, status=status, ms=ms, peak_mb=round(
                torch.cuda.max_memory_allocated() / 1e6, 1))
            rec["requests"].append(r)
            log("serve request:", json.dumps(r))
            if status != 200:
                raise SystemExit(f"serve: /frame {name} answered {status}: "
                                 f"{body[:2000]!r}")
            img = read_png(io.BytesIO(body))
            if img.shape != (h, w, 4) or not (img[..., :3] > 16).any():
                raise SystemExit(f"serve: /frame {name} gave {img.shape}, "
                                 f"lit={bool((img[..., :3] > 16).any())}")
            pngs[name] = (q, img)
        status, body, ms = _serve_get(base, "/xf?" + urlencode(
            dict(theta=0.5, phi=0.3, dist=1.2, lo=0, hi=vmax)))
        rec["requests"].append(dict(path="/xf", status=status, ms=ms))
        if status != 200 or len(body) != 128 * 4:
            raise SystemExit(f"serve: /xf answered {status}, {len(body)} B")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise SystemExit("serve: the server thread did not stop")
    del state
    torch.cuda.empty_cache()
    # the PNG encoding a request pays (utils.png.write_png on the host)
    from owlexabrick_tpu_torch.utils.png import write_png

    t0 = time.perf_counter()
    write_png(io.BytesIO(), pngs["orbit_0"][1])
    rec["png_encode_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
    plain = serve.ViewerState(str(exa), w, h, device=device,
                              plain_kernels=True)
    for name in ("orbit_0", "clip_0"):
        q, img = pngs[name]
        t0 = time.perf_counter()
        want = read_png(io.BytesIO(plain.render(
            {k: [str(v)] for k, v in q.items()})))
        rec[f"{name}_plain_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        rec[f"{name}_gate"] = _gate(f"{name} vs plain", img, want,
                                    phase="serve")
    log("serve:", json.dumps(rec))
    return rec


def _mesh_rank(rank, world, port, in_path, out_dir, device):
    """One rank of ``phase_mesh`` (spawned): gloo, every rank on
    ``device``; each case's mesh, its frame's host ms, peak MB, band
    bytes and K1 / K6 launches, and the digest of its image (rank 0 also
    writes the image)."""
    import hashlib

    import torch
    import torch.distributed as dist

    from owlexabrick_tpu_torch.parallel import mesh as M

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(torch.device(device))

    def sync():
        if cuda:
            torch.cuda.synchronize()

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    out_dir = pathlib.Path(out_dir)
    recs = {}
    try:
        cases = torch.load(in_path, weights_only=False)
        for name, case in cases.items():
            reset_launch_counts()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            band_bytes = 0
            if case["mode"] == "z":
                mesh = M.make_band_mesh(case["n_bands"], device=device)
                band = M.shard_bands(mesh, case["stacked"])
                band_bytes = nbytes(*band["vals"], *band["masks"],
                                    band["zranges"])
                f = M.make_band_sharded_slab_renderer(
                    mesh, case["cfg"], case["meta"], case["w"], case["h"])
                args = (band, case["fs"], *case["camera"])
            elif case["mode"] == "pixel_bands":
                mesh = M.make_mesh(case["n_px"], case["n_spp"],
                                   device=device)
                f = M.make_sharded_slab_renderer(mesh, case["cfg"],
                                                 case["w"], case["h"])
                args = (M.replicate(mesh, case["grids"]), case["fs"],
                        *case["camera"], case["key"])
            else:
                mesh = M.make_mesh(case["n_px"], case["n_spp"],
                                   device=device)
                f = M.make_sharded_renderer(mesh, case["cfg"])
                args = (M.replicate(mesh, case["scene"]), case["fs"],
                        M.replicate(mesh, case["surf"]),
                        *M.shard_rays(mesh, case["o"], case["d"]),
                        case["key"])
            sync()
            dist.barrier()
            t0 = time.perf_counter()
            out = f(*args)
            sync()
            ms = round((time.perf_counter() - t0) * 1e3, 3)
            img = out.cpu().numpy()
            recs[name] = dict(ms=ms, launches={
                k: v for k, v in launch_counts().items() if v},
                peak_mb=(round(torch.cuda.max_memory_allocated() / 1e6, 1)
                         if cuda else None),
                band_bytes=band_bytes, backend=mesh.backend,
                digest=hashlib.sha256(img.tobytes()).hexdigest())
            if rank == 0:
                np.save(out_dir / f"{name}.npy", img)
            del args, out
    finally:
        dist.destroy_process_group()
    (out_dir / f"rank{rank}.json").write_text(json.dumps(recs))


def phase_mesh(setups, device, card, world=2, size=(1920, 1080),
               spp_size=(480, 270)):
    """``phase_mesh``: the multi-device modes (``parallel.mesh``) on
    ``world`` gloo ranks sharing cuda:0 (spawned; their exchanges staged
    through host memory): a 2x1 px mesh of the exact path (the 64^3
    headline scene and bench camera at 1920x1080), a 1x2 spp mesh of it
    at 480x270, a 2-band pixel mesh and a 2-band z mesh of blobs256 at
    1920x1080 under the bench row's SlabConfig.  Each held to the same
    work done in this process on the card: px / spp by the per-tile,
    per-spp loop at rtol 1e-5 with atol 1e-6, the pixel bands by
    ``render_slabs`` with the same jitter shifts at the same tolerance,
    the z bands swept in turn and combined by the same prefix 'over'
    within 1e-6; every rank's image equal.  Logs the z-band image's
    distance to the unbanded frame (no gate: the JAX per-band merge is
    what is ported), per-rank frame ms, peak MB and band bytes, and the
    backend.  Returns (the ranks' launches, record)."""
    import dataclasses
    import socket

    import torch
    import torch.multiprocessing as mp

    from owlexabrick_tpu_torch.bench_scene import synthetic_volume
    from owlexabrick_tpu_torch.native import native_build_bricks_flat
    from owlexabrick_tpu_torch.parallel import mesh as M
    from owlexabrick_tpu_torch.render import prng
    from owlexabrick_tpu_torch.render.camera import Camera
    from owlexabrick_tpu_torch.render.dvr import RenderConfig
    from owlexabrick_tpu_torch.render.slabs import (
        permute_camera, render_slabs)
    from owlexabrick_tpu_torch.render.surfaces import SurfaceData
    from owlexabrick_tpu_torch.tools.raw2cells import volume_to_cells

    work = REPO / "build" / "mesh"
    work.mkdir(parents=True, exist_ok=True)
    rec = dict(row="mesh", card=card, world=world)
    t0 = time.perf_counter()
    rec["full_grid_bytes"] = nbytes(*setups["blobs256"][0].vals,
                                    *setups["blobs256"][0].masks,
                                    setups["blobs256"][0].zranges)
    n_e = int(setups["headline"][4]["n"])
    host, _, _, _, _ = exact_scene(n_e, device)
    vmax_e = float(setups["headline"][4]["value_max"])
    grids, cam, fs, cfg, meta = setups["blobs256"]
    pos, dir00, du, dv = permute_camera(cam, grids.axis)
    cfg_b = dataclasses.replace(cfg, flip=bool(dir00[0] < 0))
    (w, h), rank_dev = size, f"{device.type}:0"
    cells = volume_to_cells(synthetic_volume(int(meta["n"])), 0.004, 3)
    bricks, ids = native_build_bricks_flat(cells[0], cells[1])
    stacked, bmeta = M.build_band_grids(
        bricks, np.asarray(cells[2], np.float32)[ids][None], 2,
        cfg_b.nslabs)
    del cells
    cases, rays = {}, {}
    for name, ((we, he), n_px, n_spp) in (("px_exact", (size, 2, 1)),
                                          ("spp_exact", (spp_size, 1, 2))):
        fs_e = bench_frame_state(n_e, vmax_e, we, he)
        c = n_e / 2
        cam_e = Camera.look_at(from_=[c, c, 2.2 * n_e], at=[c, c, c],
                               up=[0, 1, 0], fovy_degrees=45.0, width=we,
                               height=he)
        o, d = cam_e.rays(we, he)
        rays[name] = (o, d)
        cases[name] = dict(mode="px", n_px=n_px, n_spp=n_spp, scene=host,
                           fs=fs_e, surf=SurfaceData.empty("cpu"), o=o, d=d,
                           key=prng.prng_key(11),
                           cfg=RenderConfig(num_channels=1))
    cases["bands_blobs256"] = dict(
        mode="pixel_bands", n_px=2, n_spp=1, grids=grids.to("cpu"), fs=fs,
        camera=(pos, dir00, du, dv), key=prng.prng_key(12), cfg=cfg_b,
        w=w, h=h)
    cases["z_blobs256"] = dict(
        mode="z", n_bands=2, stacked=stacked, meta=bmeta, fs=fs,
        camera=(pos, dir00, du, dv), cfg=cfg_b, w=w, h=h)
    torch.save(cases, work / "cases.pt")
    rec["inputs_s"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mp.start_processes(_mesh_rank, args=(world, port, str(work / "cases.pt"),
                                         str(work), rank_dev),
                       nprocs=world, join=True, start_method="spawn")
    rec["ranks_s"] = round(time.perf_counter() - t0, 3)
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(world)]
    # bytes each rank sends per frame, from the shapes (two ranks): the
    # px gather and the spp sum send one rank's share of the image, the z
    # prefix one (P, 4) step and the back band's broadcast (P, 4)
    for name, c in cases.items():
        if c["mode"] == "px":
            p_ = c["o"].shape[0] * 3 * 4
            sent = p_ // 2 if c["n_px"] == 2 else p_
        elif c["mode"] == "pixel_bands":
            sent = c["w"] * c["h"] * 4 * 4 // 2
        else:
            sent = c["w"] * c["h"] * 4 * 4
        rec.setdefault(name, {})["sent_mb_per_rank"] = round(sent / 1e6, 3)
    rec["ranks"] = ranks
    log("mesh ranks:", json.dumps(ranks))
    total = {k: 0 for k in launch_counts()}
    for r in ranks:
        for name, res in r.items():
            for k, v in res["launches"].items():
                total[k] += v
            if res["digest"] != ranks[0][name]["digest"]:
                raise SystemExit(f"mesh {name}: the ranks' images differ")
            if res["backend"] != "gloo":
                raise SystemExit(f"mesh {name}: backend {res['backend']}")
        for name in ("bands_blobs256", "z_blobs256"):
            if min(r[name]["launches"].get(k, 0) for k in ("K1", "K6")) <= 0:
                raise SystemExit(f"mesh {name}: a rank launched no K1 or K6:"
                                 f" {r[name]['launches']}")

    # the same work in this process on the card
    def check(name, one, one_ms, rtol, atol):
        got = np.load(work / f"{name}.npy")
        want = one.cpu().numpy()
        err = float(np.abs(got - want).max())
        ok = bool(np.allclose(got, want, rtol=rtol, atol=atol)
                  and np.isfinite(got).all())
        rec[name].update(max_abs_err=err, one_process_ms=one_ms, ok=ok)
        log(f"mesh {name}: max |ranks - one process| {err:.3g} "
            f"({'pass' if ok else 'FAIL'}), one process {one_ms} ms")
        if not ok:
            raise SystemExit(f"mesh {name} differs from one process: {err}")
        return got

    dev = torch.device(device)
    for name in ("px_exact", "spp_exact"):
        c = cases[name]
        o, d = rays[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = M.sharded_render_reference(
            host.to(dev), c["fs"], SurfaceData.empty(dev), c["cfg"],
            torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
            c["key"], c["n_px"], c["n_spp"])
        torch.cuda.synchronize()
        check(name, one, round((time.perf_counter() - t0) * 1e3, 3), 1e-5,
              1e-6)
    t0 = time.perf_counter()
    one = M.sharded_slab_reference(grids, fs, cfg_b, pos, dir00, du, dv,
                                   prng.prng_key(12), w, h, 2)
    torch.cuda.synchronize()
    check("bands_blobs256", one, round((time.perf_counter() - t0) * 1e3, 3),
          1e-5, 1e-6)
    t0 = time.perf_counter()
    one = M.band_sharded_reference(
        [M.band_of(stacked, b, dev) for b in range(2)], fs, cfg_b, bmeta,
        pos, dir00, du, dv, w, h)
    torch.cuda.synchronize()
    zb = check("z_blobs256", one, round((time.perf_counter() - t0) * 1e3, 3),
               0.0, 1e-6)
    full = render_slabs(grids, fs, cfg_b, pos, dir00, du, dv, w, h)
    rec["z_blobs256"]["vs_unbanded_max_abs"] = float(
        np.abs(zb - full.cpu().numpy()).max())
    log(f"mesh z_blobs256 vs the unbanded render_slabs frame (no gate): "
        f"max {rec['z_blobs256']['vs_unbanded_max_abs']:.4g}")
    log("mesh:", json.dumps(rec))
    log("launches on the mesh path (ranks):", json.dumps(total))
    return total, rec


def phase_fields(row, width, height):
    """The SlabConfig fields on the card (``FIELD_CASES``): one frame of
    the headline at 1920x1080 per field, against its plain frame under
    ``agree``'s gate; each must launch its kernels and be finite and
    lit."""
    import dataclasses

    import torch

    for name, kw, want in FIELD_CASES:
        cfg = dataclasses.replace(row[3], **kw)
        n0 = launch_counts()
        t0 = time.perf_counter()
        img = render_row(row, width, height, cfg=cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {k: v - n0[k] for k, v in launch_counts().items()}
        t0 = time.perf_counter()
        plain = render_row(row, width, height,
                           cfg=dataclasses.replace(cfg, plain_sweep=True))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        ok, mx, share = agree(img, plain)
        rec = dict(case=name, fields=kw, frame_ms=round(ms, 3),
                   plain_frame_ms=round(plain_ms, 3), max_abs=mx,
                   share_within_1e_4=share,
                   alpha_mean=float(img[:, 3].mean()),
                   launches={k: v for k, v in got.items() if v})
        log("field:", json.dumps(rec))
        if not bool(torch.isfinite(img).all()) or rec["alpha_mean"] <= 1e-3:
            raise SystemExit(f"field {name}: frame not finite or blank")
        if not ok:
            raise SystemExit(f"field {name}: kernel frame disagrees with "
                             "its plain frame")
        if min(got[k] for k in want) <= 0:
            raise SystemExit(f"field {name}: launched {got}, not {want}")


def phase_scale(device, card, size=(1920, 1080)):
    """The reference-scale scene resident on the card (the JAX bench's
    scale1024 row at full size): ``exajet_pattern_cells(1024, wings=2)``
    in a process pool, then ``level_grids_from_cells`` on the card (the
    scatter and the TF-cull tables); the bench camera and config (``bench_setup``'s,
    adaptive stride on as bench.py:206 has it).  Steps, each logged with
    its frame times (median, spread), peak device MB and K1/K6 launches:

    a. the default cache gate (half the card): the first frame, which
       builds the products (full tier), then SCALE_CACHED cached frames;
    b. the JAX row's gate SCALE_GATE_MB (partial tier): likewise;
    c. the pose switch to (n/2, n/2, 2.25n) through that cache, and back;
    d. the TF drag: SCALE_TF frames at the cached pose with opacity scale
       0.6 + 0.05 (k % 4);
    e. the orbit rate: SCALE_ORBIT uncached frames.

    Checks (each fails the run): the cell count; the full-tier,
    partial-tier and uncached frames equal bit for bit; each TF-drag
    frame within ``agree``'s gate of an uncached frame with its frame
    state; an uncached frame launches K6 once per 8 levels of every
    chunk it sweeps; a SCALE_PLAIN_SIZE kernel frame within the gate of
    its plain frame; K1 on chunk SCALE_K1_CHUNK within TOL_K1 of its
    twin (timed).  One cached and one uncached frame run under
    torch.profiler.  K6 against its plain version on one uncached 1080p
    frame's calls: the largest level block, the largest chunk, the whole
    frame.  K7 launches once per chunk swept in every step, and matches
    its twin bit for bit on chunk SCALE_K1_CHUNK (timed).  Returns (the
    launches of steps a-e, [K1's chunk result], K6's results, [K7's chunk
    result])."""
    import dataclasses

    import torch

    from owlexabrick_tpu_torch.bench_scene import (
        default_workers, scale_scene_grids)
    from owlexabrick_tpu_torch.render import slabs
    from owlexabrick_tpu_torch.render.camera import Camera
    from owlexabrick_tpu_torch.render.frame import make_frame_state
    from owlexabrick_tpu_torch.render.mids import K6_MAX_LEVELS

    t_phase = time.perf_counter()
    n, (w, h) = SCALE_N, size
    grids, cells, meta = scale_scene_grids(n, SCALE_WINGS, device)
    n_cells, value_max = meta["n_cells"], meta["value_max"]
    per_level = np.bincount(cells[1]).tolist()
    del cells

    def camera(dist, ww=w, hh=h):
        return Camera.look_at(from_=[n / 2, n / 2, n * dist],
                              at=[n / 2, n / 2, n / 2], up=[0, 1, 0],
                              fovy_degrees=45.0, width=ww, height=hh)

    cam = camera(2.2)
    fs = make_frame_state(cam, 1, [[0.0, value_max]], dt=1.0,
                          opacity_scale=0.7)
    ns = int(np.ceil(float(grids.bounds_hi[0] - grids.bounds_lo[0])))
    chunk, budget = (24, 16) if 200 <= ns <= 600 else (12, 7)
    cfg = slabs.SlabConfig(num_channels=1, nslabs=ns, chunk=chunk,
                           chunk_budget_mb=budget, adaptive_stride=True)
    pos, d00, _, dv = slabs.permute_camera(cam, grids.axis)
    s_eff = slabs.effective_chunk(grids, cfg, h, w, slabs.ky_hints_for_camera(
        grids, cfg, pos, d00, dv, h, w))
    log("scale scene:", json.dumps(dict(
        n=n, wings=SCALE_WINGS, cells=n_cells, cells_per_level=per_level,
        grid_bytes=meta["grid_bytes"],
        level_shapes_zyx=[list(m.shape) for m in grids.masks],
        nslabs=ns, chunk=s_eff, chunks_per_frame=-(-ns // s_eff),
        cells_s=round(meta["gen_s"], 3), cell_workers=default_workers(),
        grids_s=round(meta["grids_s"], 3), value_max=value_max)))
    if n_cells != SCALE_CELLS:
        raise SystemExit(f"scale scene: {n_cells} cells, not {SCALE_CELLS}")

    def frame(cfg_=cfg, fs_=fs, cam_=cam, cache=None, ww=w, hh=h):
        t0 = time.perf_counter()
        out = slabs.render_slabs_camera(grids, fs_, cfg_, cam_, ww, hh,
                                        camera_cache=cache)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def step(name, run):
        """run() -> (frame ms list, extra fields); logs the step."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n0 = launch_counts()
        times, extra = run()
        got = launch_counts()
        rec = dict(step=name, frames_ms=[round(t, 3) for t in times],
                   median_ms=round(float(np.median(times)), 3),
                   spread_ms=round(float(max(times) - min(times)), 3),
                   peak_mb=round(torch.cuda.max_memory_allocated() / 1e6, 1),
                   k1_launches=got["K1"] - n0["K1"],
                   k6_launches=got["K6"] - n0["K6"],
                   k7_launches=got["K7"] - n0["K7"], **extra)
        if rec["k7_launches"] != rec["k1_launches"]:
            raise SystemExit(f"scale: {name} launched K7 "
                             f"{rec['k7_launches']} times for "
                             f"{rec['k1_launches']} chunks swept")
        log("scale:", json.dumps(rec))
        return rec

    imgs = {}

    def cached_run(key, cfg_, cache):
        def run():
            imgs[key + "_first"], first_ms = frame(cfg_, cache=cache)
            tier = cache.get("tier", "full")
            times = []
            for _ in range(SCALE_CACHED):
                imgs[key], t = frame(cfg_, cache=cache)
                times.append(t)
            return times, dict(first_frame_ms=round(first_ms, 3), tier=tier,
                               declined=cache.get("declined"))
        return run

    # the main path: launch counts from 0 here to the end of step e
    reset_launch_counts()
    full = {}
    rec = step("a_static_default_gate", cached_run("full", cfg, full))
    if rec["tier"] != "full" or "products" not in full:
        raise SystemExit(f"scale: the default gate gave {rec['tier']!r} "
                         f"{rec['declined']!r}, not the full tier")
    full.clear()
    torch.cuda.empty_cache()
    cfg_p = dataclasses.replace(cfg, camera_cache_max_mb=SCALE_GATE_MB)
    part = {}
    rec = step("b_static_jax_gate", cached_run("part", cfg_p, part))
    if not rec["tier"].startswith("partial"):
        raise SystemExit(f"scale: gate {SCALE_GATE_MB} MB gave "
                         f"{rec['tier']!r}, not the partial tier")

    def pose_switch():
        img, t_switch = frame(cfg_p, cam_=camera(2.25), cache=part)
        tier = part.get("tier", "full")
        ok = bool(torch.isfinite(img).all()) and float(img[:, 3].mean()) > 1e-3
        if not ok:
            raise SystemExit("scale: the switched pose's frame is blank")
        _, t_back = frame(cfg_p, cache=part)
        return [t_switch, t_back], dict(tier_switched=tier,
                                        note="frames: switch, back")

    step("c_pose_switch", pose_switch)

    def tf_state(k):
        return dataclasses.replace(fs, xf_opacity_scale=np.float32(
            0.6 + 0.05 * (k % 4)))

    def tf_drag():
        times = []
        for k in range(SCALE_TF):
            imgs[f"tf{k}"], t = frame(cfg_p, fs_=tf_state(k), cache=part)
            times.append(t)
        return times, dict(tier=part.get("tier", "full"))

    step("d_tf_drag", tf_drag)
    wall_cached = float(np.median(
        [frame(cfg_p, cache=part)[1] for _ in range(2)]))
    t0 = time.perf_counter()
    prof_cached = profile_once(lambda: frame(cfg_p, cache=part))
    log(f"scale: profiled the cached frame in "
        f"{time.perf_counter() - t0:.1f} s")
    part.clear()
    torch.cuda.empty_cache()

    chunks = []

    def orbit():
        c0 = launch_counts()
        imgs["uncached"], t = frame()
        c1 = launch_counts()
        chunks.append((c1["K1"] - c0["K1"], c1["K6"] - c0["K6"]))
        return [t] + [frame()[1] for _ in range(SCALE_ORBIT - 1)], {}

    rec_o = step("e_orbit_uncached", orbit)
    counts = launch_counts()
    log("launches on the scale path:", json.dumps(counts))
    if min(counts[k] for k in ("K1", "K6")) <= 0:
        raise SystemExit(f"the scale path left a kernel unlaunched: {counts}")
    k1_n, k6_n = chunks[0]
    k6_want = k1_n * -(-len(grids.levels) // K6_MAX_LEVELS)
    if k1_n <= 0 or k6_n != k6_want:
        raise SystemExit(f"scale: an uncached frame swept {k1_n} chunks in "
                         f"{k6_n} K6 launches, not {k6_want}")
    t0 = time.perf_counter()
    prof_unc = profile_once(frame)
    log(f"scale: profiled the uncached frame in "
        f"{time.perf_counter() - t0:.1f} s")
    for mode, wall, prof in (("cached_partial", wall_cached, prof_cached),
                             ("uncached", rec_o["median_ms"], prof_unc)):
        log("scale profile:", json.dumps(dict(
            mode=mode, **profile_record(wall, prof))))

    # checks: the tiers and the uncached frame bit for bit, the TF drag
    unc = imgs["uncached"]
    same = {k: bool(torch.equal(imgs[k], unc))
            for k in ("full_first", "full", "part_first", "part")}
    log("scale bit-equal to the uncached frame:", json.dumps(same))
    if not all(same.values()):
        raise SystemExit(f"scale: cached frames differ from the uncached "
                         f"frame: {same}")
    if not bool(torch.isfinite(unc).all()) or float(unc[:, 3].mean()) <= 1e-3:
        raise SystemExit("scale: the uncached frame is not finite or blank")
    want_tf = {}
    for k in range(SCALE_TF):
        j = k % 4
        if j not in want_tf:
            want_tf[j] = frame(fs_=tf_state(k))[0]
        ok, mx, share = agree(imgs[f"tf{k}"], want_tf[j])
        log(f"scale tf drag frame {k}: vs uncached max_abs={mx} "
            f"share_within_1e-4={share:.6f}")
        if not ok:
            raise SystemExit(f"scale: TF-drag frame {k} disagrees with its "
                             "uncached frame")
    del want_tf, imgs

    log(f"scale: frames and checks done at "
        f"{time.perf_counter() - t_phase:.1f} s")
    # the kernels against their plain versions on this scene
    pw, ph = SCALE_PLAIN_SIZE
    cam_s = camera(2.2, pw, ph)
    img, ms = frame(cam_=cam_s, ww=pw, hh=ph)
    plain, plain_ms = frame(dataclasses.replace(cfg, plain_sweep=True),
                            cam_=cam_s, ww=pw, hh=ph)
    ok, mx, share = agree(img, plain)
    log(f"scale {pw}x{ph}: kernel vs plain frame max_abs={mx} "
        f"share_within_1e-4={share:.6f} frame_ms={ms:.1f} "
        f"plain_frame_ms={plain_ms:.1f}")
    if not ok:
        raise SystemExit("scale: kernel frame disagrees with plain")
    ci = chunk_inputs(grids, cam, fs, cfg, w, h, chunk_index=SCALE_K1_CHUNK)
    log("k1 scale chunk mids shapes (C+1, S, ny, W):",
        [tuple(m.shape) for m in ci["prep"].mids])
    k1 = k1_check("scale1024_real_chunk", ci, ci["prep"], None,
                  ci["tables_knots"], w, h)
    k7 = k7_check("scale1024_real_chunk", ci["prep"], ci["scale"] > 1e-6,
                  [ci["lut"]], ci["domains"], stride=ci["stride"])
    del ci
    # K6 at this path's shapes: one uncached 1080p frame's calls
    calls = [c[:2] for c in capture_all_calls(
        slabs, "xresample_mids_levels", frame)]
    chunk = max(calls, key=lambda c: sum(z.numel() for z in c[0]))
    big = max(range(len(chunk[0])), key=lambda i: chunk[0][i].numel())
    k6 = [k6_check("scale1024_largest_level",
                   [([chunk[0][big]], [chunk[1][big]])], 50),
          k6_check("scale1024_chunk", [chunk], 20),
          k6_check_frame("scale1024_frame", calls, 5)]
    del calls, chunk, grids
    torch.cuda.empty_cache()
    log(f"scale phase {time.perf_counter() - t_phase:.1f} s on {card}")
    return counts, [k1], k6, [k7]


def profile_once(fn, trace_path=None):
    """One ``fn()`` (ending in a synchronize) under torch.profiler:
    (device ms, device launches, the port's kernels' {id: (ms, n)}, the
    top eight kernels [(us, n, name)]); the Chrome trace to
    ``trace_path`` if given, which alone records the host's ops too.
    The device events are summed by name straight from the profiler's
    results (building its event tree costs tens of seconds a frame of
    ~10^5 launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                      if trace_path is not None else [])
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    if trace_path is not None:
        prof.export_chrome_trace(str(trace_path))
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        # the device's kernels, copies and fills; host ops and the
        # runtime's launch calls are CPU events
        if e.device_type() != DeviceType.CUDA:
            continue
        us, n = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    rows = sorted(((us, n, k[:60]) for k, (us, n) in by_name.items()
                   if us > 0), reverse=True)
    ours = {}
    for us, n, k in rows:
        tag = next((t for f, t in PORT_KERNELS.items() if f in k), None)
        if tag:
            ms0, n0 = ours.get(tag, (0.0, 0))
            ours[tag] = (ms0 + us / 1e3, n0 + n)
    return (sum(r[0] for r in rows) / 1e3, sum(r[1] for r in rows), ours,
            rows[:8])


def profile_record(wall_ms, prof):
    """The fields a profiled frame logs (wall: an unprofiled frame)."""
    dev_ms, launches, ours, top = prof
    return dict(frame_wall_ms=round(wall_ms, 3), device_ms=round(dev_ms, 3),
                device_busy_share=round(dev_ms / wall_ms, 4),
                device_launches=launches,
                port_kernels={t: dict(ms=round(ms, 3), n=n)
                              for t, (ms, n) in sorted(ours.items())},
                top=[dict(kernel=k, ms=round(us / 1e3, 3), n=n)
                     for us, n, k in top])


def phase_profile(setups, width, height, render=render_row,
                  modes=("uncached", "cached"), traces=True):
    """With ``--profile``: trace one frame per row and mode (uncached,
    cached) with torch.profiler; print the device time by kernel, the
    device's busy share of the unprofiled frame time, and write the
    Chrome traces to ``out_dir`` below (if ``traces``)."""
    import torch

    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    for name, row in setups.items():
        cache = {}
        for mode in modes:
            c = cache if mode == "cached" else None
            for _ in range(2):  # warm up (and fill the cache)
                render(row, width, height, cache=c)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render(row, width, height, cache=c)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof = profile_once(
                lambda: render(row, width, height, cache=c),
                out_dir / f"trace_{name}_{mode}.json" if traces else None)
            log("profile:", json.dumps(dict(row=name, mode=mode,
                                            **profile_record(wall_ms, prof))))


def main() -> int:
    import torch

    t_start = time.perf_counter()
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
    log("k1 registers and spills by channel count:",
        json.dumps(k1_registers(kernels.build_log())))

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
    k7 = phase_k7(dev)
    k2 = phase_k2(tilted, width, height, dev)
    phase_goldens(dev)

    # each path runs with the launch counts set to 0 just before it
    reset_launch_counts()
    frames = phase_rows(setups, width, height)
    aligned = launch_counts()
    log("launches on the aligned path:", json.dumps(aligned))
    if min(aligned[k] for k in ("K1", "K6")) <= 0:
        raise SystemExit(f"the aligned path left a kernel unlaunched: "
                         f"{aligned}")
    reset_launch_counts()
    frames.update(phase_rows(tilted, width, height))
    phase_renderer(tilted["headline_tilted"], 64, width, height, dev)
    tilt = launch_counts()
    log("launches on the tilted path:", json.dumps(tilt))
    if min(tilt[k] for k in ("K1", "K2a", "K2b", "K6")) <= 0:
        raise SystemExit(f"the tilted path left a kernel unlaunched: {tilt}")

    rows = {**setups, **tilted}
    phase_plain(rows, frames, width, height)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    lanes = lane_setups(setups, tilted, dev)
    xf, k3 = phase_xf(lanes, width, height, dev)
    reset_launch_counts()
    lane_frames = phase_lane_rows(lanes, width, height)
    phase_renderer_lane(setups, tilted, 64, width, height, dev)
    einsum = launch_counts()
    log("launches on the einsum path:", json.dumps(einsum))
    if min(einsum[k] for k in ("K3", "K4", "K2a", "K2b", "K6")) <= 0:
        raise SystemExit(f"the einsum path left a kernel unlaunched: "
                         f"{einsum}")
    phase_lane_plain(lanes, lane_frames, width, height)
    reset_launch_counts()
    phase_fields(setups["headline"], width, height)
    fields = launch_counts()
    log("launches on the fields' frames:", json.dumps(fields))
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    iso_rows = iso_setups(setups, tilted, lanes)
    k5 = phase_k5(iso_rows, width, height, dev)
    k6 = phase_k6(setups, width, height, dev)
    reset_launch_counts()
    iso_frames = phase_iso_rows(iso_rows, width, height)
    phase_renderer_iso(setups, tilted, 64, width, height, dev)
    iso = launch_counts()
    log("launches on the iso path:", json.dumps(iso))
    if min(iso[k] for k in ("K1", "K2a", "K2b", "K5", "K6")) <= 0:
        raise SystemExit(f"the iso path left a kernel unlaunched: {iso}")
    phase_iso_plain(iso_rows, iso_frames, width, height)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    surf_rows = surface_setups(setups, tilted, dev, width, height)
    reset_launch_counts()
    surf_frames = phase_surface_rows(surf_rows, card)
    surf = launch_counts()
    log("launches on the surface path:", json.dumps(surf))
    if min(surf[k] for k in ("K1", "K2a", "K2b", "K6")) <= 0:
        raise SystemExit(f"the surface path left a kernel unlaunched: "
                         f"{surf}")
    k1 += phase_surface_checks(surf_rows, surf_frames, card, dev)
    del surf_rows, surf_frames
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    # the exact path: goldens, headline_exact (no port kernel runs
    # there), the fast path's contour plane, and the 256^3 scene
    phase_exact_goldens(dev, card)
    phase_headline_exact(dev, card)
    c_rows = contour_row(setups, dev, width, height)
    reset_launch_counts()
    c_frames = phase_surface_rows(c_rows, card)
    contour = launch_counts()
    log("launches on the contour path:", json.dumps(contour))
    if min(contour[k] for k in ("K1", "K6")) <= 0:
        raise SystemExit(f"the contour path left a kernel unlaunched: "
                         f"{contour}")
    k1 += phase_surface_checks(c_rows, c_frames, card, dev)
    del c_rows, c_frames
    phase_blobs256_scene(dev, card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    # the front door: the Quick start chain through the port's CLI
    cli, _ = phase_cli_exajet256(dev, card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    # K1 and K3 past 8 levels, the web viewer, the multi-device modes
    lv_k1, lv_k3 = phase_levels(dev)
    k1 += lv_k1
    k3 += lv_k3
    reset_launch_counts()
    phase_serve(dev, card)
    served = launch_counts()
    log("launches on the serve path:", json.dumps(served))
    if min(served[k] for k in ("K1", "K2a", "K2b", "K3", "K4", "K6")) <= 0:
        raise SystemExit(f"the serve path left a kernel unlaunched: "
                         f"{served}")
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")
    meshed, _ = phase_mesh(setups, dev, card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")
    # the reference-scale scene (its launches counted inside the phase)
    scaled, sc_k1, sc_k6, sc_k7 = phase_scale(dev, card)
    k1 += sc_k1
    k6 += sc_k6
    k7 += sc_k7
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")
    if "--profile" in sys.argv[1:]:
        phase_profile(rows, width, height)
        # no Chrome traces: a 1080p einsum-lane frame's is tens of MB
        phase_profile(lanes, width, height, modes=("uncached",),
                      render=lambda row, w, h, cache: render_lane(row, w, h),
                      traces=False)
        phase_profile(iso_rows, width, height, render=render_iso,
                      modes=("uncached",), traces=False)

    timed = next(r for r in k1 if r["name"] == "headline_seeded_knots")
    k2_rows = next(r for r in k2 if r["channels"] == 4)
    xf_real = next(r for r in xf if r["name"] == "headline_clip_real_chunk")
    k3_real = next(r for r in k3 if r["name"] == "headline_clip_real_chunk")
    k5_real = next(r for r in k5 if r["name"].endswith("_hits"))
    k6_chunk = next(r for r in k6 if r["name"] == "headline_chunk")
    k7_tf = next(r for r in k7 if r["name"] == "tf_drag_chunk")
    src_warp = "owlexabrick_tpu_torch/csrc/warp.cu"
    src_xf = "owlexabrick_tpu_torch/csrc/xf.cu"
    launches = {k: aligned[k] + tilt[k] + einsum[k] + iso[k] + surf[k]
                + contour[k] + cli[k] + served[k] + meshed[k] + fields[k]
                + scaled[k] for k in aligned}

    def entry(name, source, replaces, key, err, res, prefix=""):
        # one PyTorch call computes K5's and K6's functions (grid_sample),
        # none computes K1's to K4's
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches[key],
                    max_abs_err=err, ms=res[prefix + "ms"],
                    plain_ms=res[prefix + "plain_ms"],
                    bound_ms=res[prefix + "bound_ms"],
                    bound_by=res[prefix + "bound_by"],
                    library_ms=res.get(prefix + "library_ms"))

    log(json.dumps({"kernels": [
        entry("K1 slab-sweep megakernel",
              "owlexabrick_tpu_torch/csrc/sweep.cu", K1_REPLACES, "K1",
              max(r["max_abs_err"] for r in k1), timed),
        entry("K2a warp pass 1 (vertical Catmull-Rom)", src_warp,
              K2A_REPLACES, "K2a", max(r["k2a_max_abs_err"] for r in k2),
              k2_rows, "k2a_"),
        entry("K2b warp pass 2 (horizontal Catmull-Rom)", src_warp,
              K2B_REPLACES, "K2b", max(r["k2b_max_abs_err"] for r in k2),
              k2_rows, "k2b_"),
        entry("K3 y lerp of the mids, clip masks, classify + composite a "
              "chunk (one channel)", src_xf, K3_REPLACES, "K3",
              max(r["max_abs_err"] for r in k3), k3_real),
        entry("K4 classify a field per slab", src_xf, K4_REPLACES, "K4",
              max(r["k4_max_abs_err"] for r in xf), xf_real, "k4_"),
        entry("K5 LUT lookup (iso colormap recolor)", src_xf, K5_REPLACES,
              "K5", max(r["max_abs_err"] for r in k5), k5_real),
        entry("K6 x-tent resample of a chunk's level mids",
              "owlexabrick_tpu_torch/csrc/mids.cu", K6_REPLACES, "K6",
              max(r["max_abs_err"] for r in k6), k6_chunk),
        entry("K7 activity and stride tables of a chunk",
              "owlexabrick_tpu_torch/csrc/sweep.cu", K7_REPLACES, "K7",
              max(r["max_abs_err"] for r in k7), k7_tf),
    ]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _children(pid):
    """The live processes whose parent is ``pid`` (from /proc)."""
    kids = []
    for d in pathlib.Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            stat = (d / "stat").read_text()
        except OSError:
            continue
        # the fields after the command's closing parenthesis: state, ppid
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            kids.append(int(d.name))
    return kids


def stop_children(timeout=10.0):
    """Stops every process this one started and left running, so none
    outlives the script: multiprocessing's resource tracker (started by
    the first spawned pool or rank, it otherwise lives until this process
    has exited) and then any other child and its descendants, terminated,
    killed after ``timeout`` seconds, and reaped.  Logs what it ended."""
    import os
    import signal
    from multiprocessing import resource_tracker

    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        try:
            stop()
        except ChildProcessError:  # already reaped
            pass
    if not pathlib.Path("/proc").is_dir():
        return
    tree, todo = [], _children(os.getpid())
    while todo:
        pid = todo.pop()
        tree.append(pid)
        todo += _children(pid)
    if not tree:
        return
    log("stopping processes left running:", tree)
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in tree:
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            for pid in tree:
                try:  # reaps a child; a grandchild's parent reaps it
                    os.waitpid(pid, os.WNOHANG)
                except ChildProcessError:
                    pass
            if not any(pathlib.Path(f"/proc/{p}").exists() for p in tree):
                return
            time.sleep(0.05)


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        stop_children()
    sys.exit(rc)
