"""Rank bodies of the port's multi-device modes (``owlexabrick_tpu_torch.
parallel.mesh``) for ``tests/test_torch_mesh.py`` (gloo ranks on the
CPU) and ``tests/test_torch_cuda.py`` (gloo ranks sharing the card):
``run`` is what each process that ``torch.multiprocessing`` spawns
executes, so it lives in a module spawn can import, which imports no
jax.  A case is a dict: its mode ("px", "pixel_bands" or "z"), the
mesh's shape, the inputs and the device.  Every rank writes the image it
returns (the whole image; nothing outside a mesh) to
``out_dir/<case>_r<rank>.npy`` and its K1 / K6 launches per case to
``out_dir/launches_r<rank>.json``; ``one_process`` is the same work in
one process."""

import json
import pathlib
import socket

import numpy as np
import torch
import torch.distributed as dist

from owlexabrick_tpu_torch.core.types import Bricks
from owlexabrick_tpu_torch.parallel import mesh as M
from owlexabrick_tpu_torch.utils import profiling


def _px(case):
    mesh = M.make_mesh(case["n_px"], case["n_spp"], device=case["device"])
    f = M.make_sharded_renderer(mesh, case["cfg"])
    o, d = M.shard_rays(mesh, case["o"], case["d"])
    return f(M.replicate(mesh, case["scene"]), case["fs"],
             M.replicate(mesh, case["surf"]), o, d, case["key"])


def _pixel_bands(case):
    mesh = M.make_mesh(case["n_px"], case["n_spp"], device=case["device"])
    f = M.make_sharded_slab_renderer(mesh, case["cfg"], case["w"], case["h"],
                                     jitter=case["jitter"])
    return f(M.replicate(mesh, case["grids"]), case["fs"], *case["camera"],
             case["key"])


def _band_grids(case):
    return M.build_band_grids(Bricks(**case["bricks"]), case["scalars"],
                              case["n_bands"], case["cfg"].nslabs)


def _z_bands(case):
    mesh = M.make_band_mesh(case["n_bands"], device=case["device"])
    stacked, meta = _band_grids(case)
    f = M.make_band_sharded_slab_renderer(mesh, case["cfg"], meta,
                                          case["w"], case["h"])
    return f(M.shard_bands(mesh, stacked), case["fs"], *case["camera"])


RUNNERS = {"px": _px, "pixel_bands": _pixel_bands, "z": _z_bands}


def one_process(case):
    """The case's image computed in one process (the module's
    ``*_reference``) on its device."""
    dev = torch.device(case["device"])
    if case["mode"] == "px":
        return M.sharded_render_reference(
            case["scene"].to(dev), case["fs"], case["surf"], case["cfg"],
            torch.as_tensor(case["o"]).to(dev),
            torch.as_tensor(case["d"]).to(dev), case["key"], case["n_px"],
            case["n_spp"])
    if case["mode"] == "pixel_bands":
        return M.sharded_slab_reference(
            case["grids"].to(dev), case["fs"], case["cfg"], *case["camera"],
            case["key"], case["w"], case["h"], case["n_px"], case["n_spp"],
            jitter=case["jitter"])
    stacked, meta = _band_grids(case)
    return M.band_sharded_reference(
        [M.band_of(stacked, b, dev) for b in range(case["n_bands"])],
        case["fs"], case["cfg"], meta, *case["camera"], case["w"],
        case["h"])


def _counts():
    return {"K1": profiling.counts["launch.K1"],
            "K6": profiling.counts["launch.K6"]}


def run(rank, world, port, in_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    out_dir = pathlib.Path(out_dir)
    launches = {}
    try:
        cases = torch.load(in_path, weights_only=False)
        for name, case in cases.items():
            c0 = _counts()
            out = RUNNERS[case["mode"]](case)
            launches[name] = {k: v - c0[k] for k, v in _counts().items()}
            if out is not None:
                np.save(out_dir / f"{name}_r{rank}.npy", out.cpu().numpy())
    finally:
        dist.destroy_process_group()
    (out_dir / f"launches_r{rank}.json").write_text(json.dumps(launches))


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def port_cases(device):
    """Two-rank cases built by the port alone (no jax): a 2x1 px mesh of
    the exact path on the dry run's tiny scene, 2 pixel bands and 2 z
    bands of its slab frame (``__graft_entry__.py``'s cameras)."""
    from owlexabrick_tpu_torch.pipeline import scene_from_cells
    from owlexabrick_tpu_torch.render import prng
    from owlexabrick_tpu_torch.render.camera import Camera
    from owlexabrick_tpu_torch.render.dvr import RenderConfig
    from owlexabrick_tpu_torch.render.frame import make_frame_state
    from owlexabrick_tpu_torch.render.slabs import (
        SlabConfig, build_level_grids, permute_camera)
    from owlexabrick_tpu_torch.render.surfaces import SurfaceData
    from owlexabrick_tpu_torch.tools.artificial import parse_grids_text

    lower, level, scal = parse_grids_text(
        "0 0 0 4 4 4 0 0 1 0 1 0 1 0 1\n4 0 0 2 2 2 1 2\n")
    scene, bricks, *_ = scene_from_cells(lower, level, [scal], device="cpu")
    cam = Camera.look_at([14.0, 10.0, 16.0], [4.0, 2.0, 2.0], [0, 1, 0],
                         50.0, 16, 8)
    o, d = cam.rays(16, 8)
    cam2 = Camera.look_at([4.0, 2.0, 30.0], [4.0, 2.0, 2.0], [0, 1, 0],
                          40.0, 16, 16)
    fs2 = make_frame_state(cam2, 1, [[0.0, 2.0]], dt=0.7)
    scfg = SlabConfig(nslabs=32, chunk=8, flip=True)
    scalars = scene.scalars.numpy()
    return {
        "px2": dict(mode="px", n_px=2, n_spp=1, device=device, scene=scene,
                    fs=make_frame_state(cam, 1, [[0.0, 2.0]], dt=0.7),
                    surf=SurfaceData.empty("cpu"), o=o, d=d,
                    key=prng.prng_key(0), cfg=RenderConfig(num_channels=1)),
        "bands2": dict(mode="pixel_bands", n_px=2, n_spp=1, device=device,
                       grids=build_level_grids(bricks, scalars, device="cpu"),
                       fs=fs2, camera=permute_camera(cam2, 2),
                       key=prng.prng_key(1), cfg=scfg, w=16, h=16,
                       jitter=True),
        "z2": dict(mode="z", n_bands=2, device=device,
                   bricks={k: np.asarray(getattr(bricks, k))
                           for k in ("lower", "size", "level", "begin")},
                   scalars=scalars, fs=fs2, camera=permute_camera(cam2, 2),
                   cfg=scfg, w=16, h=16),
    }
