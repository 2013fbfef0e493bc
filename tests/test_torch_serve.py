"""PyTorch port, the web viewer: ``owlexabrick_tpu_torch.viewer.serve``'s
``ViewerState`` (``device="cpu"``) against the JAX package's on the same
scene (``test_torch_cli.make_scene_dir``'s one-field ``.exa``; its
two-field ``.exa`` for the field selector) at 32x24:
each query's PNG under the golden gate (every pixel within 1/255, at
least 99% bit-exact) and ``/xf`` byte for byte.  The queries: orbit and
fly poses, frames 0-2 and ``prog=0``, the clip box, a contour plane,
gradient shading, an iso value, a custom colormap, the second field, AO
(the lattice estimator and ``aox``), the tracer (one RK4 step a frame,
its fixed segment table, the reseed on a settings change) and the clock
overlay.  One test serves the port through a real ``ThreadingHTTPServer``
on 127.0.0.1."""

import io
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from owlexabrick_tpu_torch.utils.png import golden_gate, read_png

from test_torch_cli import make_scene_dir
from torch_threads import one_torch_thread  # noqa: F401

W, H = 32, 24
BASE = dict(theta=0.5, phi=0.3, dist=1.2, frame=0, field=0,
            cmap="Paraview Cool Warm", customcm="", lo=0, hi=7, os=1,
            dt=0.5, iso=0, gsiso=1, caxis="off", coff=0.5, clip=0, cx0=0,
            cy0=0, cz0=0, cx1=1, cy1=1, cz1=1, gsdvr=0, skip=1)
FLY = dict(ex=20, ey=15, ez=25, ax=3, ay=3, az=3)
TRACER = dict(tron=1, trseeds=8, trsteps=6, trlen=0.5, trcx=0, trcy=0,
              trcz=0, tr0x=0.2, tr0y=0.2, tr0z=0.2, tr1x=0.8, tr1y=0.8,
              tr1z=0.8)

# each case: the queries (overrides of BASE) rendered in turn
CASES = {
    "orbit_frames": [dict(frame=0), dict(frame=1), dict(frame=2),
                     dict(frame=1, prog=0)],
    "fly": [dict(FLY, frame=0), dict(FLY, frame=1)],
    "clip": [dict(clip=1, cx0=0.3, cz1=0.8), dict(clip=1, cx0=0.3, cz1=0.8,
                                                  frame=1)],
    "contour_y": [dict(caxis="y", coff=0.4)],
    "gradient": [dict(gsdvr=1)],
    "iso": [dict(iso=3.3)],
    "custom_colormap": [dict(cmap="Custom",
                             customcm="0.0,(1,0,0)\n1.0,(0,0,1)")],
    "ao": [dict(iso=3.3, ao=1, aolen=4)],
    "aox": [dict(iso=3.3, ao=1, aolen=4, aox=1), dict(iso=3.3, ao=1,
                                                      aolen=4, aox=1,
                                                      frame=1)],
    "clock": [dict(FLY, clock=0.05)],
}


def _q(kw):
    params = dict(BASE)
    params.update(kw)
    return {k: [str(v)] for k, v in params.items()}


@pytest.fixture(scope="module")
def states(tmp_path_factory):
    from owlexabrick_tpu.viewer.serve import ViewerState as JState
    from owlexabrick_tpu_torch.viewer.serve import ViewerState as PState

    d = make_scene_dir(tmp_path_factory.mktemp("serve"))
    # field 0 of a two-field scene renders its two channels through a
    # one-channel transfer function, which both viewers refuse (the
    # reference viewer's own behaviour, kept); field 1 renders that
    # field alone
    exa, two = str(d / "one.exa"), str(d / "scene.exa")
    return {"one": (JState(exa, W, H), PState(exa, W, H, device="cpu")),
            "two": (JState(two, W, H), PState(two, W, H, device="cpu"))}


def _both(states, kw):
    j, p = states
    want = read_png(io.BytesIO(j.render(_q(kw))))
    got = read_png(io.BytesIO(p.render(_q(kw))))
    assert got.shape == (H, W, 4)
    ok, dmax, exact = golden_gate(got, want)
    assert ok, (kw, dmax, exact)
    return got


@pytest.mark.parametrize("case", list(CASES))
def test_frame_matches_jax(states, case):
    imgs = [_both(states["one"], kw) for kw in CASES[case]]
    assert int((imgs[0][..., :3].max(-1) > 8).sum()) > 20


def test_second_field_matches_jax(states):
    """The field selector on the two-field scene: field 1 (7 - density)
    differs from the one-field scene's density frame."""
    got = _both(states["two"], dict(field=1))
    dens = _both(states["one"], dict())
    assert np.abs(got.astype(int) - dens.astype(int)).max() > 8


def test_tracer_frames_match_jax(states):
    """One RK4 step per displayed frame, the fixed-shape segment table,
    the frame state's timestep and the reseed on a settings change, on
    both viewers, each frame under the golden gate."""
    states = states["one"]
    j, p = states
    _both(states, dict(FLY, **TRACER))
    for st in states:
        assert st.tracer.timestep == 1
    _both(states, dict(FLY, frame=1, **TRACER))
    for st in states:
        assert st.tracer.timestep == 2
        assert st.renderer.surf.num_segments == 8 * 5
        assert int(st.renderer.fs.tracer_timestep) == 2
    _both(states, dict(FLY, **dict(TRACER, trseeds=4)))
    for st in states:
        assert st.tracer.timestep == 1
        assert st.renderer.surf.num_segments == 4 * 5
    _both(states, dict(FLY))
    assert j.tracer is None and p.tracer is None


def test_xf_bytes_equal(states):
    for which, kw in (("one", dict()),
                      ("one", dict(os=0.4, alpha="00" * 64 + "ff" * 64)),
                      ("two", dict(field=1, lo=1, hi=6))):
        j, p = states[which]
        want = j.xf_bytes(_q(kw))
        assert len(want) == 128 * 4
        assert p.xf_bytes(_q(kw)) == want


def test_http_server(states):
    """The port's handler behind a ThreadingHTTPServer on 127.0.0.1 (port
    0), served from a thread: the page, a frame equal to the in-process
    render of the same query, the .xf blob, a 404 and a 500."""
    from http.server import ThreadingHTTPServer
    from urllib.parse import urlencode

    from owlexabrick_tpu_torch.viewer import serve

    p = states["one"][1]
    handler = type("Handler", (serve._Handler,), {"state": p})
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/", timeout=60) as r:
            page = r.read().decode()
            assert r.status == 200 and "text/html" in r.headers[
                "Content-Type"]
        assert f'width="{W}" height="{H}"' in page
        assert "<option>Custom</option>" in page
        query = {k: v[0] for k, v in _q(dict(frame=0)).items()}
        with urllib.request.urlopen(base + "/frame?" + urlencode(query),
                                    timeout=120) as r:
            assert r.status == 200
            assert r.headers["Content-Type"] == "image/png"
            png = r.read()
        want = p.render(_q(dict(frame=0)))
        assert png == want
        with urllib.request.urlopen(base + "/xf?" + urlencode(query),
                                    timeout=60) as r:
            assert r.status == 200 and len(r.read()) == 128 * 4
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/nothing", timeout=60)
        assert e.value.code == 404
        # a frame that fails still reaches the client, as a 500 (field 0
        # of the two-field scene, which the viewer refuses)
        handler.state = states["two"][1]
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/frame?" + urlencode(query),
                                   timeout=120)
        assert e.value.code == 500
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=30)
    assert not t.is_alive()
