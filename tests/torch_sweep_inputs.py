"""Seeded sweep inputs shared by the port's CPU and card tests
(numpy only, so the card tests run without jax)."""

import numpy as np

from owlexabrick_tpu_torch.viewer.colormaps import colormap_colors

H, W, S = 24, 40, 6
TILES = (8, 16)  # 3 x 3 tiles, the last column tile ragged
CWS = (1.0, 2.0)
ORG_Y = (0.0, 2.0)
NY = (24, 8)


def deep_levels(n_levels):
    """(ny, cw, lattice y origin) of ``n_levels`` levels of cell widths
    1, 2, 4, ...: each lattice spans the chunk's rows (y up to ~22) and
    a row past both ends."""
    return [(-(-24 // (1 << lv)) + 2, float(1 << lv), -1.0)
            for lv in range(n_levels)]


def seeded_inputs(seed, channels=1, levels=None, slabs=S):
    """Seeded chunk inputs; ``channels`` > 1 adds channels 1.. (their
    values, LUTs, domains and TF-cull bounds) from a second stream, so
    channel 0's inputs are the same at every count.  ``mids`` holds per
    level (channel values, mask); the values are (S, ny, W) for one
    channel, (C, S, ny, W) for more.  ``levels``: (ny, cw, origin y) per
    level (``deep_levels``), else the two levels NY, CWS, ORG_Y; ``cws``
    and ``org_y`` hold them.  ``slabs``: the chunk's S."""
    rng = np.random.default_rng(seed)
    nys = NY if levels is None else tuple(lv[0] for lv in levels)
    mids = []
    for ny in nys:
        m = rng.uniform(0.0, 1.0, (slabs, ny, W)).astype(np.float32)
        # empty patches so activity differs per tile
        m[:, :, rng.integers(0, W - 12):][:, :ny // 3] = 0.0
        m[rng.uniform(size=(slabs, ny, W)) < 0.3] = 0.0
        v = (m * rng.uniform(0.0, 1.0, (slabs, ny, W))).astype(np.float32)
        mids.append((v, m))
    yrow = np.linspace(1.0, 21.0, H, dtype=np.float32)
    y_pos = (yrow[None] * (1.0 + 0.01 * np.arange(slabs, dtype=np.float32)
                           [:, None])).astype(np.float32)
    live = rng.uniform(size=slabs) < 0.85
    live[0] = True
    vr = []
    for ny in nys:
        lo = rng.uniform(0.0, 1.0, (1, slabs, ny, 1)).astype(np.float32)
        hi = lo + rng.uniform(0.0, 0.5, (1, slabs, ny, 1)).astype(np.float32)
        r = np.concatenate([lo, hi], -1)
        r[:, :, ::5] = np.asarray([np.inf, -np.inf], np.float32)
        vr.append(r)
    opac = np.clip(np.linspace(-0.3, 1.0, 128), 0, 1).astype(np.float32)
    lut = np.concatenate([colormap_colors("Jet", 128), opac[:, None]], 1)
    lut = lut.astype(np.float32)
    lut[:, 3] *= np.float32(0.8)
    sec = (1.0 + 0.2 * rng.uniform(size=(H, W))).astype(np.float32)
    pt = rng.uniform(0.2, 1.0, (H, W)).astype(np.float32)
    pt[:8, :16] = 0.001  # a tile earlier chunks saturated
    d = dict(mids=mids, y_pos=y_pos, live=live, vr=vr, lut=lut,
             dom=np.asarray([[0.0, 1.0]], np.float32), sec=sec, pt=pt,
             cws=CWS if levels is None else tuple(lv[1] for lv in levels),
             org_y=ORG_Y if levels is None else tuple(lv[2] for lv in levels))
    if channels > 1:
        _add_channels(d, np.random.default_rng(seed + 1000), channels)
    return d


def _add_channels(d, rng, channels):
    """Channels 1.. of a multi-channel chunk: values of their own under
    the shared mask, each its own colormap, opacity ramp and domain (so
    the compressed knots differ per channel)."""
    maps = ("Paraview Cool Warm", "Matplotlib Plasma", "Blackbody",
            "Rainbow", "Ice Fire", "Matplotlib Virdis", "Blue Gold",
            "Covise", "HSV")
    extra = range(1, channels)
    d["mids"] = [(np.stack([v] + [
        (m * rng.uniform(0.0, 1.5, m.shape)).astype(np.float32)
        for _ in extra]), m) for v, m in d["mids"]]
    d["vr"] = [np.concatenate([r] + [np.sort(rng.uniform(
        0.0, 1.5, r.shape[1:]).astype(np.float32), -1)[None]
        for _ in extra]) for r in d["vr"]]
    d["luts"] = [d["lut"]]
    doms = [d["dom"][0]]
    for c in extra:
        lo = rng.uniform(-0.4, 0.6)
        opac = np.clip(np.linspace(lo, 1.0 - 0.05 * c, 128), 0, 1)
        lut = np.concatenate([colormap_colors(maps[c - 1], 128),
                              opac[:, None]], 1).astype(np.float32)
        lut[:, 3] *= np.float32(0.3 + 0.1 * c)
        d["luts"].append(lut)
        doms.append(np.asarray([0.1 * c, 1.2 + 0.05 * c], np.float32))
    d["dom"] = np.stack(doms)


def k6_level_cases():
    """Seeded level-batched K6 inputs by case name: per level zvs (C+1, S,
    ny, nx) and qx (S, W) float32, qx running past both lattice ends and
    sitting on lattice points.  "levels4": a chunk's 4 levels; "levels9":
    9 levels, two launches' worth; "ragged_w": W no multiple of 4 or of
    the column tile; "wide_window": a lattice ~2.7x denser than the
    screen on one level, so a block's columns reach ~690 lattice columns
    (and a sparse one on the other)."""
    rng = np.random.default_rng(66)

    def level(c1, s_, ny, nx, w):
        zvs = rng.uniform(-1.0, 2.0, (c1, s_, ny, nx)).astype(np.float32)
        qx = np.sort(rng.uniform(-2.5, nx + 1.5, (s_, w)), 1).astype(
            np.float32)
        k = min(10, w // 4, nx)
        qx[:, w // 2:w // 2 + k] = np.arange(k, dtype=np.float32)
        return zvs, qx

    def case(c1, s_, w, shapes):
        lv = [level(c1, s_, ny, nx, w) for ny, nx in shapes]
        return [z for z, _ in lv], [q for _, q in lv]

    return dict(
        levels4=case(2, 5, 300, [(37, 29), (19, 15), (10, 8), (5, 4)]),
        levels9=case(3, 3, 256, [(20 - 2 * i, 23 - 2 * i)
                                 for i in range(9)]),
        ragged_w=case(2, 4, 203, [(17, 31), (9, 16)]),
        wide_window=case(2, 3, 260, [(21, 700), (12, 40)]),
    )


# K3 (from the mids) cases: (levels' ny, S, H, W, interval)
K3_MIDS_CASES = {
    "levels1": ((23,), 5, 30, 64, "mixed"),
    "levels4": ((37, 19, 10, 5), 6, 40, 96, "mixed"),
    "levels8": (tuple(40 - 5 * i for i in range(8)), 4, 33, 70, "mixed"),
    "ragged_w": ((17, 9), 5, 21, 1000, "mixed"),
    "lattice": ((700, 360, 180), 2, 1624, 2944, "mixed"),
    "all_infinite": ((19, 10), 4, 24, 48, "infinite"),
    "no_interval": ((19, 10), 4, 24, 48, None),
    # more than K3's 8 unrolled levels: its grouped path
    "levels9": (tuple(46 - 4 * i for i in range(9)), 4, 33, 70, "mixed"),
    "levels12": (tuple(50 - 4 * i for i in range(12)), 3, 29, 66, "mixed"),
}
# each case's seed; a new case takes the next one, so the others keep
# their inputs
K3_MIDS_SEEDS = {c: 300 + i for i, c in enumerate(
    ["all_infinite", "lattice", "levels1", "levels4", "levels8",
     "no_interval", "ragged_w", "levels9", "levels12"])}


def k3_mids_inputs(case):
    """Seeded inputs of K3 from the mids (``composite_mids``) for a case of
    ``K3_MIDS_CASES``, numpy float32: per level mids (2, S, ny, W) (the
    value channel, then the mask, 0 on ~20% of samples) and y taps (S, H,
    4) (w0, w1, r0, r1) of ``tent_taps`` at lattice rows that run past
    both ends; scale (S,); t_start / t_stop (H, W): "mixed" has finite
    bounds with 10% of pixels missing the box (+inf / -inf), "infinite"
    every pixel missing it, None neither; sec (H, W) with grazing rays;
    a LUT with opacity-1 steps; the domain and dz."""
    import torch

    from owlexabrick_tpu_torch.render.mids import tent_taps

    nys, s_, h, w, interval = K3_MIDS_CASES[case]
    rng = np.random.default_rng(K3_MIDS_SEEDS[case])
    mids, taps = [], []
    for ny in nys:
        mask = rng.uniform(0.0, 1.0, (s_, ny, w))
        mask[rng.uniform(size=mask.shape) < 0.2] = 0.0
        value = rng.uniform(-0.3, 1.3, (s_, ny, w)) * mask
        mids.append(np.stack([value, mask]).astype(np.float32))
        qy = (np.linspace(-1.5, ny + 0.5, h)[None, :]
              * (1.0 + 0.01 * np.arange(s_))[:, None]).astype(np.float32)
        (i0, i1), (w0, w1), _ = tent_taps(torch.from_numpy(qy), ny)
        taps.append(torch.stack([w0, w1, i0.float(), i1.float()],
                                -1).numpy())
    scale = np.sort(rng.uniform(1.0, 30.0, s_)).astype(np.float32)
    t_start = t_stop = None
    if interval == "mixed":
        t_start = rng.uniform(0.0, 20.0, (h, w)).astype(np.float32)
        t_stop = (t_start + rng.uniform(3.0, 20.0, (h, w))).astype(
            np.float32)
        miss = rng.uniform(size=(h, w)) < 0.1
        t_start[miss], t_stop[miss] = np.inf, -np.inf
    elif interval == "infinite":
        t_start = np.full((h, w), np.inf, np.float32)
        t_stop = np.full((h, w), -np.inf, np.float32)
    sec = rng.uniform(1.0, 6.0, (h, w)).astype(np.float32)
    sec[0, :7] = 900.0
    lut = rng.uniform(0.0, 1.0, (128, 4)).astype(np.float32)
    lut[64:80, 3] = 1.0
    return dict(mids=mids, taps=taps, scale=scale, t_start=t_start,
                t_stop=t_stop, sec=sec, lut=lut,
                dom=np.asarray([0.1, 0.9], np.float32), dz=np.float32(0.75))


def camera_rays(w, h, eye, at, seed=1):
    """Unit pinhole rays of a w x h screen from ``eye`` toward ``at``
    (tests/test_streamline_tiled.py::_camera_rays with the eye and the
    target as arguments).  Returns (o (P, 3), d (P, 3)) float32 numpy."""
    rng = np.random.default_rng(seed)
    o0 = np.asarray(eye, np.float32)
    fwd = np.asarray(at, np.float32) - o0
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray([0, 1, 0], np.float32))
    right /= np.linalg.norm(right)
    vup = np.cross(right, fwd)
    i = (np.arange(w) + 0.5) / w - 0.5
    j = (np.arange(h) + 0.5) / h - 0.5
    d = (fwd[None, None] + 0.9 * i[None, :, None] * right[None, None]
         + 0.7 * j[:, None, None] * vup[None, None]).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(o0, d.shape).copy()
    o += rng.normal(0, 1e-3, o.shape).astype(np.float32)
    return o.astype(np.float32), d.astype(np.float32)


# the early exit's scene: the blobs lattice at 32^3 (cells tile it), seen
# head on through a 20 degree frustum that stays inside its sides, under
# a flat opacity of 0.3: every pixel crosses alpha 0.98 in chunk 3 of 8
EXIT_W, EXIT_H = 40, 32


def exit_scene(device, carry=None):
    """(grids, frame state, SlabConfig, camera, carry) of the early exit's
    scene on ``device``.  ``carry``: None; "partial", a seeded (P, 4)
    premultiplied rgba with alpha in [0, 0.6); or "saturated", one with
    every alpha in [0.98, 0.995), so the flag is set at the first chunk."""
    from owlexabrick_tpu_torch.bench_scene import slab_scene_grids
    from owlexabrick_tpu_torch.render.camera import Camera
    from owlexabrick_tpu_torch.render.frame import make_frame_state
    from owlexabrick_tpu_torch.render.slabs import SlabConfig

    grids, meta = slab_scene_grids("blobs", 32, device=device)
    cam = Camera.look_at([16, 16, 70], [16, 16, 16], [0, 1, 0], 20.0,
                         EXIT_W, EXIT_H)
    fs = make_frame_state(cam, 1, [[0.0, meta["value_max"]]], dt=1.0,
                          opacities=np.full(128, 0.3, np.float32))
    cfg = SlabConfig(nslabs=32, chunk=4, saturate_collapse=False)
    rgba = None
    if carry is not None:
        rng = np.random.default_rng(23)
        p = EXIT_W * EXIT_H
        a = (rng.uniform(0.0, 0.6, p) if carry == "partial"
             else rng.uniform(0.98, 0.995, p)).astype(np.float32)
        rgb = rng.uniform(0.0, 1.0, (p, 3)).astype(np.float32) * a[:, None]
        rgba = np.concatenate([rgb, a[:, None]], 1)
    return grids, fs, cfg, cam, rgba
