"""PyTorch port, main path: render_slabs_camera of the port against the
JAX package's on the EX3/EX4 fixtures (24x24, 16 slabs, chunk 4), with
adaptive stride off and on, uncached, cached and through the tiered
camera-product cache; both packages render from the same level grids
and frame state (``interop``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owlexabrick_tpu.pipeline import scene_from_cells
from owlexabrick_tpu.render import slabs as R
from owlexabrick_tpu.render.camera import Camera
from owlexabrick_tpu.render.frame import make_frame_state
from owlexabrick_tpu.tools.artificial import parse_grids_text
from owlexabrick_tpu_torch import interop
from owlexabrick_tpu_torch.render import slabs as P

from conftest import EX3, EX4

W = H = 24


def _gate(got, ref, tol):
    """rgba within ``tol`` on >= 99.5% of pixels, 2e-2 on every pixel
    (the 2e-2 admits the saturation-collapse flip class at alpha ~0.98,
    PERFORMANCE.md note 21)."""
    d = np.abs(got - ref).max(1)
    assert d.max() <= 2e-2, d.max()
    assert (d <= tol).mean() >= 0.995, ((d > tol).mean(), d.max())


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, text in (("EX3", EX3), ("EX4", EX4)):
        lower, level, scal = parse_grids_text(text)
        scene, bricks, *_ = scene_from_cells(lower, level, [scal])
        g = R.build_level_grids(bricks, scene.scalars, axis=2, device=False)
        out[name] = (jax.tree.map(jnp.asarray, g),
                     interop.level_grids_from_reference(g, device="cpu"))
    return out


def _case(eye=(4.0, 4.0, 26.0), at=(4.0, 4.0, 4.0), up=(0, 1, 0), fov=30.0):
    cam = Camera.look_at(list(eye), list(at), list(up), fov, W, H)
    fs = make_frame_state(cam, 1, [[0.0, 7.0]], dt=1.0, opacity_scale=0.8)
    return cam, fs


def _cfgs(grids, stride, prec="hi_lo", **kw):
    extent = float(np.asarray(grids.bounds_hi[0] - grids.bounds_lo[0]))
    base = dict(num_channels=1, nslabs=16, chunk=4,
                adaptive_stride=stride, **kw)
    return (R.SlabConfig(dot_precision=prec, extent_z=extent, **base),
            P.SlabConfig(**base))


@pytest.mark.parametrize("name,stride,prec,camera", [
    ("EX3", False, "highest", "front"),
    ("EX3", True, "highest", "front"),
    ("EX3", True, "hi_lo", "front"),
    ("EX4", True, "hi_lo", "front"),
    ("EX3", True, "hi_lo", "swapped"),
    ("EX4", False, "highest", "back"),
])
def test_render_slabs_camera_matches_reference(scenes, name, stride, prec,
                                               camera):
    """highest: 1e-4 on 99.5% of pixels; the default hi_lo (bf16 MXU
    passes in the reference, f32 in the port): 2e-4."""
    g_ref, g_port = scenes[name]
    cam, fs = _case(**{
        "front": {},
        # pixel x along grid y: rendered transposed
        "swapped": dict(up=(1, 0, 0)),
        # looking down -z from behind: the sweep runs back to front
        "back": dict(eye=(4.0, 4.0, -18.0)),
    }[camera])
    rcfg, pcfg = _cfgs(g_ref, stride, prec)
    ref = np.asarray(R.render_slabs_camera(g_ref, fs, rcfg, cam, W, H))
    got = P.render_slabs_camera(g_port, interop.frame_state_from_reference(fs),
                                pcfg, cam, W, H).numpy()
    assert ref[:, 3].max() > 0.5
    _gate(got, ref, 1e-4 if prec == "highest" else 2e-4)


def test_camera_cache_matches_live_and_reference(scenes):
    """The port's per-pose product cache: populated once, reused at the
    same pose and across a TF edit, dropped on a camera change — and
    identical to the uncached frame every time."""
    g_ref, g_port = scenes["EX3"]
    cam, fs_r = _case()
    fs = interop.frame_state_from_reference(fs_r)
    rcfg, cfg = _cfgs(g_ref, True)
    live = P.render_slabs_camera(g_port, fs, cfg, cam, W, H)
    cache = {}
    first = P.render_slabs_camera(g_port, fs, cfg, cam, W, H,
                                  camera_cache=cache)
    key0 = cache["key"]
    again = P.render_slabs_camera(g_port, fs, cfg, cam, W, H,
                                  camera_cache=cache)
    assert cache["key"] is key0 and "tier" not in cache
    assert torch.equal(live, first) and torch.equal(first, again)
    ref = np.asarray(R.render_slabs_camera(g_ref, fs_r, rcfg, cam, W, H))
    _gate(first.numpy(), ref, 2e-4)

    fs2 = dataclasses.replace(fs, xf_opacity_scale=np.float32(0.3))
    out2 = P.render_slabs_camera(g_port, fs2, cfg, cam, W, H,
                                 camera_cache=cache)
    assert cache["key"] is key0
    assert torch.equal(out2, P.render_slabs_camera(g_port, fs2, cfg, cam,
                                                   W, H))
    cam2, _ = _case(eye=(4.0, 4.0, 30.0))
    out3 = P.render_slabs_camera(g_port, fs, cfg, cam2, W, H,
                                 camera_cache=cache)
    assert cache["key"] != key0
    assert torch.equal(out3, P.render_slabs_camera(g_port, fs, cfg, cam2,
                                                   W, H))


def test_camera_cache_tiered_prefix(scenes):
    """A cache budget below the products' size keeps a front prefix of
    chunks in full and light entries for the rest; the frame is
    unchanged (and still the reference's)."""
    g_ref, g_port = scenes["EX3"]
    cam, fs_r = _case(eye=(4.0, 4.0, 22.0))
    fs = interop.frame_state_from_reference(fs_r)
    rcfg, base = _cfgs(g_ref, True)
    live = P.render_slabs_camera(g_port, fs, base, cam, W, H)
    ref = np.asarray(R.render_slabs_camera(g_ref, fs_r, rcfg, cam, W, H))
    for gate_mb in (0.2, 0.1, 0.05, 0.03, 0.02, 0.012, 0.008, 0.005):
        cfg = dataclasses.replace(base, camera_cache_max_mb=gate_mb)
        cache = {}
        out = P.render_slabs_camera(g_port, fs, cfg, cam, W, H,
                                    camera_cache=cache)
        if "tier" in cache:
            break
    assert "tier" in cache and "light artifacts" in cache["tier"]
    prods = cache["products"]
    n_chunks = -(-cfg.nslabs // cfg.chunk)
    assert 1 <= len(prods["full"]) < n_chunks
    assert len(prods["full"]) + len(prods["light"]) == n_chunks
    assert all(p.mids == () for p, _ in prods["light"])
    assert torch.equal(live, out)
    _gate(out.numpy(), ref, 2e-4)
    key0 = cache["key"]
    again = P.render_slabs_camera(g_port, fs, cfg, cam, W, H,
                                  camera_cache=cache)
    assert cache["key"] is key0 and torch.equal(live, again)
    tiny = dataclasses.replace(base, camera_cache_max_mb=1e-6)
    cache = {}
    out = P.render_slabs_camera(g_port, fs, tiny, cam, W, H,
                                camera_cache=cache)
    assert "declined" in cache and torch.equal(live, out)
