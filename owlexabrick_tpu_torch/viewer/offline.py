"""exaViewer-compatible offline renderer CLI (the port of
``owlexabrick_tpu/viewer/offline.py``).

    python -m owlexabrick_tpu_torch.viewer.offline <config.exa>
        [--fast [--bands N]] [--device cuda|cpu] [-o out.png] ...

Accepts the reference viewer's command line (exa/viewer.cpp:1087-1221)
plus offline-rendering extras (--frames, -o, --fast, --bands).  Renders N
progressive frames of the scene described by a .exa config and writes a
PNG (the reference's benchmark protocol: 50-frame average + screenshot,
viewer.cpp:297-339), printing the JAX package's ``#viewer:`` lines.

Everything renders on ``--device`` (default ``cuda``; asking for a card
where there is none raises).  On the card the fast path runs the port's
kernels (K6 and K1 aligned, K2a and K2b after a shear-warp sweep, K3, K4
and K5 through the Renderer's fast path); a kernel that fails to build
or launch raises.  ``--plain-kernels`` renders with their plain-torch
twins instead, the comparison lane, never chosen implicitly.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

import numpy as np
import torch

from ..core.constants import MAX_CONTOUR_PLANES, MAX_ISO_SURFACES, NUM_XF_VALUES
from ..io.config import parse_config
from ..io.xf_file import camera_echo, write_xf
from ..render.camera import Camera
from ..render.dvr import RenderConfig, linear_to_srgb
from ..render.frame import make_frame_state
from ..render.renderer import Renderer
from ..render.scene import scene_from_config
from ..render.slabs import render_device
from ..render.surfaces import SurfaceData
from ..utils.png import write_png
from .colormaps import ColorMapper, colormap_colors


def _parse_onoff(flag: str, arg: str) -> bool:
    if flag in ("on", "1"):
        return True
    if flag in ("off", "0"):
        return False
    raise SystemExit(f"invalid value '{flag}' for {arg} argument")


def _sync(dev: torch.device) -> None:
    """Wait for the card's queued work, so a frame time ends with it."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _render_fast(cfg, scene, fs, cam, size, n_channels, dt, frames, bands,
                 adaptive_stride, plain, dev):
    """The bare ``--fast`` slab path (DVR only): the banded sweep for
    ``--bands N`` and an axis-aligned camera, else per-frame
    ``render_slabs_camera`` (aligned) or ``render_slabs_shearwarp``
    (tilted; the reorientation preview when no axis factorizes), with
    the per-pose camera cache.  Returns ((P, 4) rgba, seconds per
    frame)."""
    from ..render.slabs import (
        SlabConfig,
        build_level_grids,
        camera_to_voxel,
        check_separable,
        principal_axis,
        render_slabs_banded,
        render_slabs_camera,
        reorient_grids,
    )
    from ..render.shearwarp import (
        inter_dims,
        render_slabs_shearwarp,
        setup_shearwarp,
    )

    # the grids hold the rendered channels alone (the JAX CLI scatters
    # every field and fails on a second one it does not render)
    scalars = scene.scalars[:n_channels].cpu().numpy()
    vcam = camera_to_voxel(cam, scene.voxel_from_world.cpu().numpy())
    view = np.asarray(vcam.dir00) + 0.5 * (
        size[0] * np.asarray(vcam.dir_du) + size[1] * np.asarray(vcam.dir_dv)
    )
    axis = principal_axis(view)
    reorient = not check_separable(vcam, axis)
    if bands > 1 and not reorient:
        # out-of-core z-banded sweep: grids are built and streamed per
        # band (render_slabs_banded)
        lo3, hi3 = cfg.bricks.bounds()
        coarsest = float(1 << int(np.max(cfg.bricks.level)))
        extent = float(hi3[:, axis].max() - lo3[:, axis].min()) + coarsest
        finest = float(1 << int(np.min(cfg.bricks.level)))
        scfg = SlabConfig(
            num_channels=n_channels,
            nslabs=int(np.ceil(extent / (dt * finest))),
            adaptive_stride=adaptive_stride,
            plain_sweep=plain,
        )
        print(f"#viewer: banded fast path ({bands} z-bands)")
        t0 = time.time()
        rgba = render_slabs_banded(cfg.bricks, scalars, fs, scfg, vcam,
                                   *size, n_bands=bands, axis=axis,
                                   device=dev)
        _sync(dev)
        return rgba, time.time() - t0

    if bands > 1:
        print("#viewer: --bands requires an axis-aligned camera; "
              "rendering unbanded")
    shear = None
    if reorient:
        # tilted view: exact shear-warp factorization (sweep an
        # axis-aligned intermediate camera, warp once); grid
        # reorientation remains the fallback for frusta too oblique to
        # factorize
        grids = build_level_grids(cfg.bricks, scalars, axis=axis,
                                  device=dev)
        shear = setup_shearwarp(vcam, axis, size[0], size[1],
                                *inter_dims(*size))
        if shear is not None:
            print("#viewer: fast path via shear-warp (exact)")
        else:
            grids = build_level_grids(cfg.bricks, scalars, axis=2,
                                      device=dev)
            grids, vcam = reorient_grids(grids, vcam)
            print("#viewer: fast path via grid reorientation (preview)")
    else:
        grids = build_level_grids(cfg.bricks, scalars, axis=axis,
                                  device=dev)
    extent = float(grids.bounds_hi[0] - grids.bounds_lo[0])
    finest = float(min(1 << l for l in grids.levels))
    # the JAX CLI's per-frame path hands the sweep a device-side frame
    # state, which classifies the dense LUT (its banded path keeps the
    # host frame state and the knots)
    scfg = SlabConfig(
        num_channels=n_channels,
        nslabs=int(np.ceil(extent / (dt * finest))),
        adaptive_stride=adaptive_stride,
        xf_compress=False,
        plain_sweep=plain,
    )
    # the camera is fixed for the whole run: cache the per-chunk camera
    # products so frames 2..N pay only the sweep
    cam_cache = {}
    if shear is not None:
        def render_one():
            return render_slabs_shearwarp(grids, fs, scfg, vcam, *size,
                                          sw=shear, camera_cache=cam_cache)
    else:
        def render_one():
            return render_slabs_camera(grids, fs, scfg, vcam, *size,
                                       camera_cache=cam_cache)
    t0 = time.time()
    rgba = None
    for _ in range(frames):
        rgba = render_one()
        _sync(dev)
    return rgba, (time.time() - t0) / frames


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])

    config_path = None
    size = (1024, 1024)
    camera = None  # (vp, vi, vu)
    fov = 70.0
    value_range = None
    colormaps: List[str] = []
    custom_colormap = None
    xf_files: List[str] = []
    xf_scale = 1.0
    isovals: List[float] = []
    isochans: List[int] = []
    contour_planes: List[List[float]] = []
    contour_chans: List[int] = []
    clip_box = None
    dt = 0.5
    ao = False
    ao_length = 1e20
    grad_dvr = False
    grad_iso = True
    frames = 8
    out = "exa_render.png"
    fast = False
    bands = 1
    # coarse-only tiles take wider sweep steps, like the reference's
    # per-region dt (exabrick.cu:1129, always on there);
    # --no-adaptive-stride restores uniform (oversampled) slabs
    adaptive_stride = True
    display_string = ""
    multi_field = False
    bench = 0
    dump_xf = None
    colorbar = False
    colorbar_channel = 0
    heatmap_scale = 0.0
    tracer_steps = 0
    tracer_channels = (0, 0, 0)
    tracer_seeds = 1000
    tracer_steplen = 1.0
    space_skipping = True
    device = "cuda"
    plain = False

    i = 0
    while i < len(argv):
        a = argv[i]
        if not a.startswith("-"):
            config_path = a
            i += 1
        elif a in ("-win", "--size"):
            size = (int(argv[i + 1]), int(argv[i + 2]))
            i += 3
        elif a == "--camera":
            vals = [float(argv[i + 1 + k]) for k in range(9)]
            camera = (vals[0:3], vals[3:6], vals[6:9])
            i += 10
        elif a == "--fov":
            fov = float(argv[i + 1])
            i += 2
        elif a == "--range":
            value_range = (float(argv[i + 1]), float(argv[i + 2]))
            i += 3
        elif a == "--colormap":
            colormaps.append(argv[i + 1])
            i += 2
        elif a == "--custom-colormap":
            custom_colormap = argv[i + 1]
            i += 2
        elif a == "--xf":
            xf_files.append(argv[i + 1])
            i += 2
        elif a == "--xf-scale":
            xf_scale = float(argv[i + 1])
            i += 2
        elif a == "--isovals":
            i += 1
            while i < len(argv) and not argv[i].startswith("-"):
                isovals.append(float(argv[i]))
                i += 1
        elif a == "--isochans":
            i += 1
            while i < len(argv) and not argv[i].startswith("-"):
                isochans.append(int(argv[i]))
                i += 1
        elif a == "--contourplane":
            contour_planes.append([float(argv[i + 1 + k]) for k in range(4)])
            i += 5
        elif a == "--contourchan":
            contour_chans.append(int(argv[i + 1]))
            i += 2
        elif a == "--clip-box":
            clip_box = [float(argv[i + 1 + k]) for k in range(6)]
            i += 7
        elif a == "--dt":
            dt = float(argv[i + 1])
            i += 2
        elif a == "--ao":
            ao = _parse_onoff(argv[i + 1], a)
            i += 2
        elif a == "--ao-length":
            ao_length = float(argv[i + 1])
            i += 2
        elif a == "--gradientShadingDVR":
            grad_dvr = _parse_onoff(argv[i + 1], a)
            i += 2
        elif a == "--gradientShadingISO":
            grad_iso = _parse_onoff(argv[i + 1], a)
            i += 2
        elif a == "--colorbar":
            colorbar = _parse_onoff(argv[i + 1], a)
            i += 2
        elif a == "--colorbar-channel":
            colorbar = True
            colorbar_channel = int(argv[i + 1])
            i += 2
        elif a == "--bench":
            bench = int(argv[i + 1])
            i += 2
        elif a == "--dump-xf":
            dump_xf = argv[i + 1]
            i += 2
        elif a == "--heatmap":
            heatmap_scale = float(argv[i + 1])
            i += 2
        elif a == "--tracer":
            tracer_steps = int(argv[i + 1])
            i += 2
        elif a == "--tracer-channels":
            tracer_channels = tuple(int(argv[i + 1 + k]) for k in range(3))
            i += 4
        elif a == "--tracer-seeds":
            tracer_seeds = int(argv[i + 1])
            i += 2
        elif a == "--tracer-steplen":
            tracer_steplen = float(argv[i + 1])
            i += 2
        elif a == "--no-pg":
            frames = 1
            i += 1
        elif a == "--no-space-skipping":
            space_skipping = False
            i += 1
        elif a == "--frames":
            frames = int(argv[i + 1])
            i += 2
        elif a == "-o":
            out = argv[i + 1]
            i += 2
        elif a == "--multi-field":
            multi_field = True
            i += 1
        elif a == "--fast":
            fast = True
            i += 1
        elif a == "--adaptive-stride":
            adaptive_stride = True
            i += 1
        elif a == "--no-adaptive-stride":
            adaptive_stride = False
            i += 1
        elif a == "--display-string":
            display_string = argv[i + 1]
            i += 2
        elif a == "--bands":
            bands = int(argv[i + 1])
            i += 2
        elif a == "--device":
            device = argv[i + 1]
            i += 2
        elif a == "--plain-kernels":
            plain = True
            i += 1
        else:
            raise SystemExit(f"unrecognized parameter '{a}'")

    if config_path is None:
        raise SystemExit(
            "usage: exa-viewer <config.exa> [--camera px py pz ix iy iz "
            "ux uy uz] [--fov f] [--size w h] [--range lo hi] [--colormap "
            "name] [--xf file] [--xf-scale s] [--isovals v..] [--isochans "
            "c..] [--contourplane a b c d] [--contourchan c] [--clip-box "
            "x0 y0 z0 x1 y1 z1] [--dt v] [--ao on|off] [--frames n] "
            "[--fast] [--adaptive-stride] [--bands n] [--device cuda|cpu] "
            "[-o out.png]"
        )
    dev = render_device(device)

    cfg = parse_config(config_path)
    scene = scene_from_config(cfg, multi_field_dvr=multi_field,
                              device=dev)[0]
    n_channels = len(cfg.scalar_fields) if multi_field else 1

    w_lo, w_hi = cfg.world_bounds()
    center = 0.5 * (w_lo + w_hi)
    if camera is None:
        diag = float(np.linalg.norm(w_hi - w_lo))
        camera = (center + np.asarray([0.0, 0.0, 1.2 * diag]), center,
                  (0, 1, 0))
    cam = Camera.look_at(camera[0], camera[1], camera[2], fov, *size)

    # transfer function: per channel domain from --range / config value_range
    domains = []
    for c in range(n_channels):
        if value_range is not None:
            domains.append(value_range)
        else:
            domains.append(cfg.scalar_fields[c].value_range)
    if custom_colormap is not None:
        colors = ColorMapper.from_string(custom_colormap).sample(NUM_XF_VALUES)
    else:
        colors = colormap_colors(
            colormaps[0] if colormaps else "Paraview Cool Warm", NUM_XF_VALUES
        )
    opacities = None
    if xf_files:
        opacities = np.fromfile(xf_files[0], np.float32, NUM_XF_VALUES)

    fs = make_frame_state(
        cam,
        num_channels=n_channels,
        xf_domains=np.asarray(domains, np.float32),
        opacities=opacities,
        opacity_scale=xf_scale,
        dt=dt,
        gradient_shading_dvr=grad_dvr,
        gradient_shading_iso=grad_iso,
        ao_enabled=ao,
        ao_length=ao_length,
    )
    # as in the JAX package, channel 0 keeps make_frame_state's Jet map:
    # ``colors`` (the first --colormap or --custom-colormap) is parsed
    # and checked but not applied
    # per-channel colormaps when several --colormap flags are given
    # (the GLUI keeps one map per channel, exa/viewer.cpp:548-560)
    for c, name in enumerate(colormaps[1:n_channels], start=1):
        fs.xf_lut[c, :, :3] = colormap_colors(name, NUM_XF_VALUES)
    for k in range(len(isovals[:MAX_ISO_SURFACES])):
        fs.iso_enabled[k] = True
        fs.iso_value[k] = isovals[k]
        fs.iso_channel[k] = isochans[k] if k < len(isochans) else 0
    for k in range(len(contour_planes[:MAX_CONTOUR_PLANES])):
        fs.contour_enabled[k] = True
        fs.contour_normal[k] = np.asarray(contour_planes[k][:3], np.float32)
        fs.contour_offset[k] = contour_planes[k][3]
        fs.contour_channel[k] = (
            contour_chans[k] if k < len(contour_chans) else 0
        )

    rcfg = RenderConfig(
        num_channels=n_channels,
        gradient_shading_dvr=grad_dvr,
        gradient_shading_iso=grad_iso,
        iso_surfaces=bool(isovals),
        ao_samples=2 if ao else 0,
        space_skipping=space_skipping,
        # with 2+ fields in single-field mode the second channel colormaps
        # the iso surface (OptixRenderer.cpp:277-282)
        colormap_channel=(
            1 if (not multi_field and len(cfg.scalar_fields) > 1) else 0
        ),
        adaptive_stride=adaptive_stride,
    )
    surf = SurfaceData.from_meshes(cfg.surfaces, device=dev)
    r = Renderer(scene, size[0], size[1], cfg=rcfg, surfaces=surf,
                 frame_state=fs, device=dev)
    r.plain_kernels = plain
    if clip_box is not None:
        r.set_clip_box(True, clip_box[:3], clip_box[3:])

    # camera echo, reusable on the next command line ('C' key,
    # exa/viewer.cpp:147-166)
    print("#viewer: " + camera_echo(camera[0], camera[1], camera[2])
          + f" --fov {fov}")

    if dump_xf:
        write_xf(dump_xf, np.asarray(r.fs.xf_lut)[0, :, 3])
        print(f"#viewer: wrote transfer function to {dump_xf}")

    if tracer_steps > 0:
        from ..render.tracer import Tracer

        tr = Tracer(r.scene, num_traces=tracer_seeds,
                    num_timesteps=tracer_steps + 1,
                    steplen=tracer_steplen, channels=tracer_channels)
        for _ in range(tracer_steps):
            if not tr.advance():
                break
        seg = tr.surface_data()
        r.surf = SurfaceData(
            tri_v0=surf.tri_v0, tri_e1=surf.tri_e1, tri_e2=surf.tri_e2,
            tri_n=surf.tri_n, seg_a=seg.seg_a, seg_b=seg.seg_b,
            seg_t=seg.seg_t, seg_radius=seg.seg_radius,
        )
        print(f"#viewer: traced {tracer_seeds} particles for "
              f"{tr.timestep} steps ({seg.num_segments} segments)")

    if fast and (
        clip_box is not None
        or grad_dvr
        or any(np.asarray(fs.contour_enabled))
        or ao
        or bool(isovals)
        or r.surf.num_tris > 0
        or r.surf.num_segments > 0
    ):
        # feature-rich configs go through the Renderer's fast path (slab
        # sweep + surface/clip/AO compositing)
        if r.enable_fast_path():
            print("#viewer: fast path via Renderer (surfaces/clip/shading"
                  " composited)")
        else:
            print("#viewer: --fast refused by the Renderer; exact path")
        fast = False
    if fast:
        rgba, dt_s = _render_fast(cfg, scene, fs, cam, size, n_channels, dt,
                                  frames, bands, adaptive_stride, plain, dev)
        print(f"#viewer: fast path {1/dt_s:.2f} FPS ({dt_s*1e3:.1f} ms)")
        arr = rgba.reshape(size[1], size[0], 4)
        srgb = linear_to_srgb(arr[..., :3]).cpu().numpy()
        img = np.clip(srgb * 255, 0, 255).astype(np.uint8)[::-1]
        if display_string:
            from ..utils.text import draw_text

            img = np.ascontiguousarray(img)
            draw_text(img, display_string, 8, size[1] - 16)
        write_png(out, img)
        print(f"#viewer: wrote {out}")
        return 0

    if bench > 0:
        # the reference's benchmark protocol: running average printed at
        # frame N + numbered screenshot (exa/viewer.cpp:297-339)
        from ..utils.profiling import FrameStats

        stats = FrameStats(bench_frames=bench)
        stats.tick()
        img = None
        for f in range(bench):
            img = r.render()
            msg = stats.tick()
            if msg:
                print(msg)
        shot = f"bench_screenshot{bench:08d}.png"
        write_png(shot, r.image_uint8(img))
        print(f"#viewer: wrote {shot}")
        return 0

    t0 = time.time()
    img = r.render_frames(frames)
    dt_s = (time.time() - t0) / frames
    print(
        f"#viewer: rendered {frames} frames, avg {1/dt_s:.2f} FPS "
        f"({dt_s*1e3:.1f} ms/frame)"
    )

    rgba8 = r.image_uint8(img).copy()

    if heatmap_scale > 0.0:
        # deterministic cost heat map (the clockScale analog,
        # exabrick.cu:1703-1707): per-ray traversal iterations -> red
        from ..render.dvr import trace_dvr
        from ..utils.profiling import cost_heatmap

        o, d = cam.rays(*size)
        _, iters = trace_dvr(
            r.scene, r.fs, rcfg, torch.from_numpy(o).to(dev),
            torch.from_numpy(d).to(dev),
            torch.zeros(o.shape[0], dtype=torch.float32, device=dev),
            return_stats=True)
        red = cost_heatmap(iters.cpu().numpy().reshape(size[1], size[0]),
                           heatmap_scale)[::-1]
        rgba8[..., 0] = (red * 255).astype(np.uint8)

    if colorbar:
        # color bar legend strip on the right (draw(), viewer.cpp:341-440)
        lut = np.asarray(r.fs.xf_lut)[colorbar_channel]
        strip_w = max(8, size[0] // 48)
        rows = np.linspace(0, lut.shape[0] - 1, size[1]).astype(int)[::-1]
        colors = np.clip(lut[rows][:, :3] * 255, 0, 255).astype(np.uint8)
        rgba8[:, -strip_w:, :3] = colors[:, None, :]
        rgba8[:, -strip_w:, 3] = 255
        # domain legend values next to the strip (viewer.cpp:399-430)
        from ..utils.text import draw_text, text_size

        dom = np.asarray(r.fs.xf_domain)[colorbar_channel]
        for val, yy in ((dom[1], 4), (dom[0], size[1] - 16)):
            s = f"{float(val):g}"
            tw, _ = text_size(s)
            draw_text(rgba8, s, size[0] - strip_w - tw - 4, yy)

    if display_string:
        from ..utils.text import draw_text

        draw_text(rgba8, display_string, 8, size[1] - 16)

    write_png(out, rgba8)
    print(f"#viewer: wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
