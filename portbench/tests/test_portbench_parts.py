"""The general pieces on their own: the traffic generator, the trace's
interval and gap arithmetic, the kernels' counts and the comparison."""

import numpy as np
import pytest
import torch

from conftest import ROOT, tiny_cell


def _routes(traffic_spec, seeds, n=256):
    """{seed: [route of each frame of a period]} at 1920x1080."""
    from portbench.reference.camera import Camera
    from portbench.reference.render import FrameInputs, ReferenceRenderer
    from portbench.traffic import Traffic

    none = (np.zeros((1, 3), np.int32), np.zeros(1, np.int32),
            np.ones(1, np.float32))
    ref = ReferenceRenderer(none, 1920, 1080, "cpu")
    out = {}
    for seed in seeds:
        t = Traffic(traffic_spec, seed)
        routes = []
        for k in range(t.period):
            (name, args), = t.frame(k).calls
            assert name == "update_camera"
            c = Camera.look_at(np.multiply(args["eye"], n),
                               np.multiply(args["at"], n), args["up"],
                               args["fovy_deg"], 1920, 1080)
            fi = FrameInputs(c.pos, c.dir00, c.dir_du, c.dir_dv, None, None,
                             0.7, 1.0)
            routes.append(ref.route(fi)[0][0])
        out[seed] = routes
    return out


def test_zoom_takes_shearwarp_on_every_frame():
    """Every frame of the zoom's period, from any seed's phase, is a new
    pose through shear-warp at 1920x1080, the eye 0.85-1.15 of the tilted
    pose's distance from the centre."""
    from portbench import harness
    from portbench.traffic import Traffic

    cell = harness.load_cell("exajet256.zoom", ROOT / "BENCHMARK.json")
    for seed, routes in _routes(cell.traffic, [0, 7, 2 ** 31 + 5]).items():
        assert routes == ["shearwarp"] * 24, seed
    t = Traffic(cell.traffic, 2 ** 33 + 1)
    base = np.linalg.norm([0.4, 0.3, 1.7])
    dist = [np.linalg.norm(np.subtract(t.frame(k).calls[0][1]["eye"],
                                       0.5)) / base for k in range(24)]
    assert min(dist) == pytest.approx(0.85) and max(dist) == pytest.approx(1.15)


def test_orbit_mix_meets_the_diagonals():
    """The orbit mix (no cell runs it yet): the seed draws the start
    azimuth anywhere in the revolution; at 1920x1080 a revolution takes
    the reorientation preview on 0 or 4 frames (one a diagonal), and 4
    from a quarter-turn start."""
    import json

    spec = json.loads((ROOT / "portbench" / "traffic" / "orbit.json")
                      .read_text())
    counts = {s: r.count("reorient") for s, r in
              _routes(spec, range(12)).items()}
    assert set(counts.values()) <= {0, 4} and 4 in counts.values()
    spec["calls"][0]["eye"]["orbit"]["azimuth_deg"] = {"linear": [0.0, 3.0]}
    routes = _routes(spec, [0])[0]
    assert routes.count("reorient") == 4 and routes.count("shearwarp") == 116
    assert [k for k, r in enumerate(routes) if r == "reorient"] == [
        15, 45, 75, 105]


@pytest.mark.parametrize("workload", ["exajet256.zoom", "exajet1024.tf_drag"])
def test_traced_frames_are_the_same_for_every_seed(workload):
    from portbench import harness
    from portbench.traffic import Traffic

    cell = harness.load_cell(workload, ROOT / "BENCHMARK.json")
    phases = cell.params["trace"]["phases"]
    want = [Traffic(cell.traffic, 0).frame_at(p).calls for p in phases]
    for seed in (3, 2 ** 31 + 11, 10 ** 12):
        t = Traffic(cell.traffic, seed)
        assert [t.frame_at(p).calls for p in phases] == want


def test_tf_drag_ramp():
    from portbench.calls.update_xf import opacities
    from portbench.traffic import Traffic

    spec = tiny_cell("exajet1024.tf_drag").traffic
    t = Traffic(spec, 5)
    assert t.period == 24 and t.frame(0).phase == 5
    lows = [t.frame(k).calls[0][1]["lower"] for k in range(24)]
    assert min(lows) == pytest.approx(0.05) and max(lows) == pytest.approx(0.45)
    assert [c for c, _ in t.setup()] == ["update_camera"]
    assert t.setup()[0][1]["eye"] == [0.5, 0.5, 2.2]
    op = opacities(lows[0])
    assert op.shape == (128,) and op[0] == 0.0 and op[-1] == 1.0
    assert np.all(np.diff(op) >= 0)


def test_traffic_values():
    from portbench.traffic import Traffic

    t = Traffic({"period": 4}, 2)
    assert t.value({"linear": [1.0, 2.0]}, 3) == 7.0
    assert t.value({"triangle": [0.0, 1.0]}, 2) == 1.0
    assert t.value({"lerp": [[0, 0], [2, 4]], "t": 0.5}, 0) == [1.0, 2.0]
    a = t.value({"seeded": [0.0, 3.0]}, 0)
    assert 0.0 <= a < 3.0 and a == t.value({"seeded": [0.0, 3.0]}, 3)
    assert a != Traffic({"period": 4}, 3).value({"seeded": [0.0, 3.0]}, 0)
    with pytest.raises(ValueError):
        t.value({"spiral": 1}, 0)


def test_union_and_idle_gaps():
    from portbench.trace import DeviceEvent, Trace, idle_gaps, union_intervals

    ev = [DeviceEvent("a", 0, 10), DeviceEvent("b", 5, 10),
          DeviceEvent("Memcpy DtoH", 30, 5), DeviceEvent("c", 50, 10)]
    assert union_intervals(ev) == [(0, 15), (30, 35), (50, 60)]
    tr = Trace(events=ev, frames=1, window_s=1e-7,
               host_spans=[("outer", 0, 100), ("inner", 16, 29)])
    assert tr.busy_s() == pytest.approx(30e-9)
    gaps = dict(idle_gaps(tr))
    assert gaps == {"inner": pytest.approx(15e-9),
                    "outer": pytest.approx(15e-9)}
    assert not ev[2].is_kernel and ev[0].is_kernel


def test_split_metrics_read_as_their_base():
    """A metric split by the end-to-end metric it moves reads what its
    base reads, its tapped calls handed over under the base's name; the
    zoom's frame time is the window's, as ``frame_ms`` reads it."""
    from portbench import harness
    from portbench.harness import Run
    from portbench.trace import DeviceEvent, Trace

    ev = [DeviceEvent("void sweep_kernel<4>(Params)", 0, 4000),
          DeviceEvent("elementwise_kernel", 5000, 1000)]
    call = dict(nbytes=3.35e3, slab_pixels=8, comps=1, levels=1,
                act_f=torch.ones(4))
    tr = Trace(events=ev, frames=2, window_s=1e-5,
               calls={"k1_roofline_pct": [call],
                      "k1_roofline_pct.zoom": [call]})
    for base in ("device_idle_pct", "launches_per_frame", "glue_device_ms",
                 "k1_roofline_pct"):
        mine = harness._module(harness.ROOT / "metrics" / f"{base}.py")
        split = harness._module(harness.ROOT / "metrics"
                                / f"{base}.zoom.py")
        assert split.read(tr) == mine.read(tr) is not None
        assert getattr(split, "TAP", None) == getattr(mine, "TAP", None)
    k1 = harness._module(harness.ROOT / "metrics" / "k1_roofline_pct.zoom.py")
    tr.calls = {"k1_roofline_pct": [call]}
    assert k1.read(tr) is None
    fz = harness._module(harness.ROOT / "metrics" / "frame_ms.zoom.py")
    assert fz.read(tr) is None
    tr.run = Run(seconds=2.0, completed=8)
    assert fz.read(tr) == 250.0


def test_yardstick():
    from portbench import yardstick as Y

    assert Y.port_kernel("void sweep_kernel<4>(Params)") == "K1"
    assert Y.port_kernel("xresample_levels_kernel") == "K6"
    assert Y.port_kernel("elementwise_kernel") is None
    assert Y.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert Y.bound_s(0, 67e12) == pytest.approx(1.0)
    z = [torch.zeros(2, 4, 8, 16)]
    q = [torch.zeros(4, 32)]
    o = [torch.zeros(2, 4, 8, 32)]
    nb, ops = Y.k6_counts(z, q, o)
    assert nb == 4 * (2 * 4 * 8 * 16 + 4 * 32 + 2 * 4 * 8 * 32)
    assert ops == 3 * 2 * 4 * 8 * 32


def test_frame_numbers():
    from portbench.compare import frame_numbers

    a = np.full((4, 4), 0xFF000000, np.uint32)
    b = a.copy()
    assert frame_numbers(a, b) == dict(over1_ppm=0.0, max_gap=0.0,
                                       mean_gap=0.0)
    b[0, 0] = 0xFF000001  # one level of red: a rounding flip
    assert frame_numbers(a, b)["over1_ppm"] == 0.0
    b[1, 1] = 0xFF00000A  # ten levels of red
    r = frame_numbers(a, b)
    assert r["max_gap"] == 10.0
    assert r["over1_ppm"] == pytest.approx(1e6 / 48)
    assert r["mean_gap"] == pytest.approx(11 / 6)
