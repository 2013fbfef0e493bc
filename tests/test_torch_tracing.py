"""The port's spans and counters (``owlexabrick_tpu_torch/utils/
profiling.py``): spans record only under a ``torch.profiler`` session,
a Renderer frame is a ``frame`` span whose chunk loop nests in it with
its counter deltas, and the benchmark's five readers of them
(``portbench/metrics``, with two of them under the impact cell's names)
give numbers from such a session.  The tests
marked ``cuda`` hold the spans' clock to the profiler's device events
on the card, and hold the megakernel lane's chunk loop to no per-chunk
wait for the card there."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from owlexabrick_tpu_torch.utils import profiling

N, W, H = 64, 48, 32
POSES = {"aligned": [0.5, 0.5, 2.2], "tilted": [0.9, 0.8, 2.2]}
READERS = ("host_syncs_per_frame", "sync_wait_ms", "activity_host_ms",
           "chunk_loop_host_ms", "products_device_ms",
           "host_syncs_per_frame.impact", "sync_wait_ms.impact")


def _renderer(pose):
    from owlexabrick_tpu_torch.bench_scene import exajet_pattern_cells
    from owlexabrick_tpu_torch.render.camera import Camera
    from owlexabrick_tpu_torch.render.renderer import RenderConfig, Renderer

    r = Renderer(exajet_pattern_cells(N), W, H,
                 cfg=RenderConfig(num_channels=1), device="cpu")
    eye = [c * N for c in POSES[pose]]
    r.update_camera(Camera.look_at(eye, [N / 2] * 3, [0, 1, 0], 45.0, W, H))
    assert r.enable_fast_path()
    return r


@pytest.fixture(scope="module", params=sorted(POSES))
def traced(request):
    """Two frames of the pose under a CPU-only profiler, each K1 launch
    site's call counted in ``test.sweep``: (session, the registry's
    difference over the stretch, the pose, the Renderer's route)."""
    from owlexabrick_tpu_torch.render import slabs

    r = _renderer(request.param)
    run_chunk = slabs.run_chunk

    def counted(*args, **kwargs):
        profiling.count("test.sweep")
        return run_chunk(*args, **kwargs)

    mp = pytest.MonkeyPatch()
    mp.setattr(slabs, "run_chunk", counted)
    try:
        r.render()  # off: records nothing
        c0 = dict(profiling.counts)
        with profile(activities=[ProfilerActivity.CPU]):
            r.render()
            r.render()
        s = profiling.session()
    finally:
        mp.undo()
    diff = {k: v - c0.get(k, 0) for k, v in profiling.counts.items()
            if v != c0.get(k, 0)}
    return s, diff, request.param, r._fast[2]


def test_spans_off_without_profiler():
    """No profiler: every span site returns the shared no-op and a frame
    leaves the last session as it was; counters count all the same."""
    r = _renderer("aligned")
    before = profiling.session()
    n = len(before.spans)
    assert profiling.span("chunk") is profiling._NOOP
    assert profiling.frame(0) is profiling._NOOP
    assert profiling.sync("sync.x", torch.zeros(1)) is profiling._NOOP
    r.render()
    assert profiling.session() is before and len(before.spans) == n
    c0 = profiling.counts["test.off"]
    profiling.count("test.off", 3)
    assert profiling.counts["test.off"] == c0 + 3


def test_frame_spans(traced):
    """Two ``frame`` spans, the chunk loop's spans nested in them (each
    child within its parent, in its parent's frame), self times >= 0, and
    each frame's counter deltas summing to the registry's difference."""
    s, diff, pose, route = traced
    assert (route == "shearwarp") == (pose == "tilted")
    frames = [i for i, sp in enumerate(s.spans) if sp.name == "frame"]
    assert len(frames) == len(s.frames) == 2
    assert [f.span for f in s.frames] == frames
    assert [f.id for f in s.frames] == [1, 2]
    dur = [sp.end_ns - sp.start_ns for sp in s.spans]
    child = [0] * len(s.spans)
    for i, sp in enumerate(s.spans):
        assert sp.end_ns >= sp.start_ns > 0
        if sp.name == "frame":
            assert sp.parent == -1
            continue
        p = s.spans[sp.parent]
        assert p.start_ns <= sp.start_ns and sp.end_ns <= p.end_ns
        assert sp.frame == p.frame
        child[sp.parent] += dur[i]
    assert all(d - c >= 0 for d, c in zip(dur, child))
    names = {sp.name for sp in s.spans}
    assert {"chunk", "products", "tiles", "activity", "sweep"} <= names
    for sp in s.spans:
        if sp.name == "chunk":
            assert s.spans[sp.parent].name == "frame"
        if sp.name in ("products", "activity", "sweep"):
            assert s.spans[sp.parent].name == "chunk"
    chunks = [sum(1 for sp in s.spans if sp.name == "sweep" and sp.frame == f)
              for f in range(2)]
    assert [f.counts.get("test.sweep", 0) for f in s.frames] == chunks
    total = {}
    for f in s.frames:
        for k, v in f.counts.items():
            total[k] = total.get(k, 0) + v
    assert total == diff and diff["test.sweep"] == sum(chunks) > 0
    # CPU tensors never wait for a card
    assert not any(k.startswith("sync.") for k in diff)


@pytest.mark.parametrize("name", READERS)
def test_metric_readers(traced, name):
    """Each reader gives a number >= 0 from the traced session and a
    hand-built Trace (one 1 us device event starting in each
    ``products`` span), and None where the frames do not match."""
    from portbench import harness
    from portbench.trace import DeviceEvent, Trace

    s = traced[0]
    events = [DeviceEvent("kernel", sp.start_ns + 1, 1000)
              for sp in s.spans if sp.name == "products"]
    mod = harness._module(harness.ROOT / "metrics" / f"{name}.py")
    v = mod.read(Trace(events=events, frames=2, window_s=1.0))
    assert v is not None and v >= 0
    if name == "products_device_ms":
        assert v == pytest.approx(len(events) * 1e-3 / 2)
    if name == "chunk_loop_host_ms":
        assert v > 0
    assert mod.read(Trace(events=events, frames=3, window_s=1.0)) is None


@pytest.mark.cuda
def test_span_shares_the_device_clock():
    """A span around a 20 ms host sleep between two kernels holds the
    device's idle gap between them to within 0.5 ms at each end.  A
    session's first launch takes the profiler's set-up (1.5-2.5 ms of
    host time on the H100), so one launch goes first."""
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.ones(1 << 22, device="cuda")
    for _ in range(3):
        x.mul_(1.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            x.mul_(1.0)
            torch.cuda.synchronize()
        with profiling.span("sleep"):
            time.sleep(0.02)
        x.mul_(1.0)
        torch.cuda.synchronize()
    ev = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA)
    sp = [s for s in profiling.session().spans if s.name == "sleep"]
    assert len(ev) == 3 and len(sp) == 1
    gap = (ev[1][1], ev[2][0])
    assert abs(sp[0].start_ns - gap[0]) < 500_000, (sp[0], gap)
    assert abs(sp[0].end_ns - gap[1]) < 500_000, (sp[0], gap)


# the per-chunk sites the megakernel lane's chunk loop and camera products
# no longer have: nothing in the loop waits for the card
LOOP_SYNCS = ("sync.early_exit", "sync.chunk_planes", "sync.level_origins",
              "sync.cull_origins", "sync.row_planes")


def _card_frames(budget_mb, cfg=None):
    """Three frames of the aligned pose on the card through a Renderer
    whose camera-product cache has ``budget_mb`` (about half the pose's
    products: the partial tier), under a CPU-only profiler: the first
    builds every chunk's products, the next two take the cache's full
    and light chunks (the light ones' mids rebuilt).  Returns (the
    frames' words, the session's frame records, the Renderer)."""
    import dataclasses

    from owlexabrick_tpu_torch.bench_scene import exajet_pattern_cells
    from owlexabrick_tpu_torch.render.camera import Camera
    from owlexabrick_tpu_torch.render.renderer import RenderConfig, Renderer

    class Budget(Renderer):
        def _slab_config(self, grids):
            return dataclasses.replace(super()._slab_config(grids),
                                       camera_cache_max_mb=budget_mb)

    r = Budget(exajet_pattern_cells(N), W, H,
               cfg=cfg or RenderConfig(num_channels=1), device="cuda")
    eye = [c * N for c in POSES["aligned"]]
    r.update_camera(Camera.look_at(eye, [N / 2] * 3, [0, 1, 0], 45.0, W, H))
    assert r.enable_fast_path()
    words = []
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            r.reset_accumulation()
            words.append(r.render())
    return words, profiling.session().frames, r


@pytest.mark.cuda
def test_megakernel_chunk_loop_never_waits(monkeypatch):
    """On the card, an uncached frame and two frames from the partial
    cache tier count none of the chunk loop's old sync sites, and their
    frames and cached products are bit for bit those of the same frames
    with the camera products' eye and level origins on the card as
    tensors (what each product then copied to the card); a frame of the
    einsum lane (gradient shading) still waits at each chunk's top."""
    from owlexabrick_tpu_torch.render import slabs
    from owlexabrick_tpu_torch.render.renderer import RenderConfig

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    words, frames, r = _card_frames(3.0)
    assert len(frames) == 3
    tiers = [{k: v for k, v in f.counts.items() if k.startswith("cache.")}
             for f in frames]
    assert tiers[0].get("cache.none", 0) > 0
    assert tiers[1].get("cache.light", 0) > 0 and tiers[1] == tiers[2]
    for f in frames:
        assert f.counts.get("launch.K1", 0) > 0
        assert not set(f.counts) & set(LOOP_SYNCS), f.counts
        assert f.counts.get("sync.readback") == 1
    products = r._cam_cache["products"]

    monkeypatch.setattr(slabs, "_host_scalar",
                        lambda v: slabs._f32(v, "cuda"))
    words_d, _, r_d = _card_frames(3.0)
    for a, b in zip(words, words_d):
        np.testing.assert_array_equal(a, b)
    products_d = r_d._cam_cache["products"]
    for tier in ("full", "light"):
        assert len(products[tier]) == len(products_d[tier]) > 0
        for (prep, scale), (prep_d, scale_d) in zip(products[tier],
                                                     products_d[tier]):
            assert torch.equal(scale, scale_d)
            for name, a in prep._asdict().items():
                b = getattr(prep_d, name)
                if isinstance(a, torch.Tensor):
                    assert torch.equal(a, b), name
                elif name == "mids":
                    assert len(a) == len(b)
                    assert all(torch.equal(x, y) for x, y in zip(a, b))
                else:
                    assert a == b, name
    monkeypatch.undo()

    _, frames_e, _ = _card_frames(
        3.0, RenderConfig(num_channels=1, gradient_shading_dvr=True))
    assert all(f.counts.get("sync.early_exit", 0) > 0 for f in frames_e)
