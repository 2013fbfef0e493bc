"""Interactive web viewer (the port of ``owlexabrick_tpu/viewer/serve.py``):
the headless-environment replacement for the reference's GLUT/GLUI window
(exa/viewer.cpp).

Zero-dependency: a stdlib http.server streams PNG frames to a canvas;
mouse-drag orbits the camera (InspectMode analog, glutViewer/InspectMode),
the wheel zooms, and a side panel exposes the GLUI controls
(exa/viewer.cpp:481-853): colormap + custom colormap string, a drawable
per-channel opacity curve (the GLUI_TransferFunction widget,
exa/viewer.cpp:577-580), domain range, opacity scale, dt, iso surface,
contour plane, clip box, gradient shading, space skipping, field
selector, plus the 'C'/'T'/'!' key equivalents (camera echo, .xf
download, screenshot).

Camera manipulators match the reference's key bindings
(glutViewer/Camera.cpp:124-174, FlyMode.cpp:33-150): 'i' = inspect
(orbit/zoom), 'f' = fly (WASD/RF move, drag looks around), '+'/'-'
motion speed, 'x'/'y'/'z' snap to an axis view.

Everything renders on ``--device`` (default ``cuda``; a missing card
raises); ``--plain-kernels`` renders with the kernels' plain-torch twins
on that device (the comparison lane).  The server renders on its handler
threads, which do not inherit the current CUDA device, so every frame
runs inside ``torch.cuda.device(...)`` and every tensor is placed on the
viewer's device explicitly.

Run:  python -m owlexabrick_tpu_torch.viewer.serve scene.exa --port 8000
      [--size W H] [--device cuda|cpu] [--plain-kernels]
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import sys
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..io.config import parse_config
from ..render.camera import Camera
from ..render.dvr import RenderConfig
from ..render.frame import make_frame_state
from ..render.renderer import Renderer
from ..render.scene import scene_from_config
from ..render.slabs import render_device
from .colormaps import COLORMAP_NAMES

_PAGE = """<!doctype html>
<html><head><title>owlexabrick-tpu viewer</title><style>
body { margin:0; background:#111; color:#ddd; font:13px sans-serif;
       display:flex; }
#view { flex:1; display:flex; align-items:center; justify-content:center; }
canvas { background:#000; }
#panel { width:260px; padding:12px; background:#1b1b1b; overflow-y:auto;
         max-height:100vh; }
#panel label { display:block; margin-top:8px; }
#panel input, #panel select, #panel textarea { width:100%;
         box-sizing:border-box; }
#panel .row { display:flex; gap:6px; }
#panel .row label { flex:1; }
#fps { color:#8c8; }
#cam { color:#789; font-size:10px; word-break:break-all; }
button { margin-top:8px; width:49%; }
fieldset { border:1px solid #333; margin-top:10px; padding:4px 8px 8px; }
legend { color:#9ab; }
</style></head><body>
<div id="view"><canvas id="c" width="__W__" height="__H__"></canvas></div>
<div id="panel">
  <b>owlexabrick-tpu</b>
  <div id="fps">-</div>
  <div id="cam"></div>
  <label>field <select id="field">__FIELDS__</select></label>
  <label>colormap <select id="cmap">__CMAPS__</select></label>
  <label>custom colormap (pos,(r,g,b) per line)
    <textarea id="customcm" rows="2"></textarea></label>
  <div class="row">
    <label>range lo <input id="lo" type="number" step="any"
      value="__LO__"></label>
    <label>range hi <input id="hi" type="number" step="any"
      value="__HI__"></label>
  </div>
  <label>opacity scale <input id="os" type="range" min="0" max="2"
    step="0.01" value="1"></label>
  <fieldset><legend>opacity curve (draw; per field)</legend>
    <canvas id="alpha" width="236" height="72"
      style="background:#000;border:1px solid #333;cursor:crosshair"></canvas>
    <button id="alpharamp" style="width:32%">ramp</button>
    <button id="alphaflat" style="width:32%">flat</button>
    <button id="alphazero" style="width:32%">zero</button>
  </fieldset>
  <label>dt <input id="dt" type="number" step="0.05" value="__DT__"></label>
  <fieldset><legend>iso surface</legend>
    <label>value (0=off) <input id="iso" type="number" step="any"
      value="0"></label>
    <label><input id="gsiso" type="checkbox" checked
      style="width:auto"> gradient shading</label>
  </fieldset>
  <fieldset><legend>contour plane</legend>
    <div class="row">
      <label>axis <select id="caxis"><option>off</option><option>x</option>
        <option>y</option><option>z</option></select></label>
      <label>offset <input id="coff" type="range" min="0" max="1"
        step="0.01" value="0.5"></label>
    </div>
  </fieldset>
  <fieldset><legend>ambient occlusion</legend>
    <label><input id="ao" type="checkbox" style="width:auto"> enable</label>
    <label>AO length <input id="aolen" type="number" step="any"
      value="__AOLEN__"></label>
    <label><input id="aox" type="checkbox" style="width:auto"> exact AO
      (progressive)</label>
  </fieldset>
  <fieldset><legend>tracer</legend>
    <label><input id="tron" type="checkbox" style="width:auto">
      enable (advances one RK4 step per frame)</label>
    <div class="row">
      <label># seeds <input id="trseeds" type="number" value="1000"></label>
      <label># steps <input id="trsteps" type="number" value="100"></label>
    </div>
    <label>step length <input id="trlen" type="number" step="any"
      value="1"></label>
    <div class="row">
      <label>ch x <select id="trcx">__FIELDS__</select></label>
      <label>ch y <select id="trcy">__FIELDS__</select></label>
      <label>ch z <select id="trcz">__FIELDS__</select></label>
    </div>
    seed region (fractions lo/hi)
    <div class="row">
      <label>x <input id="tr0x" type="range" min="0" max="1" step="0.01"
        value="0"><input id="tr1x" type="range" min="0" max="1" step="0.01"
        value="1"></label>
    </div>
    <div class="row">
      <label>y <input id="tr0y" type="range" min="0" max="1" step="0.01"
        value="0"><input id="tr1y" type="range" min="0" max="1" step="0.01"
        value="1"></label>
    </div>
    <div class="row">
      <label>z <input id="tr0z" type="range" min="0" max="1" step="0.01"
        value="0"><input id="tr1z" type="range" min="0" max="1" step="0.01"
        value="1"></label>
    </div>
  </fieldset>
  <fieldset><legend>clip box (fractions)</legend>
    <label><input id="clip" type="checkbox" style="width:auto"> enable</label>
    <div class="row">
      <label>x <input id="cx0" type="range" min="0" max="1" step="0.01"
        value="0"><input id="cx1" type="range" min="0" max="1" step="0.01"
        value="1"></label>
    </div>
    <div class="row">
      <label>y <input id="cy0" type="range" min="0" max="1" step="0.01"
        value="0"><input id="cy1" type="range" min="0" max="1" step="0.01"
        value="1"></label>
    </div>
    <div class="row">
      <label>z <input id="cz0" type="range" min="0" max="1" step="0.01"
        value="0"><input id="cz1" type="range" min="0" max="1" step="0.01"
        value="1"></label>
    </div>
  </fieldset>
  <label><input id="gsdvr" type="checkbox" style="width:auto">
    gradient shading DVR</label>
  <label><input id="skip" type="checkbox" checked style="width:auto">
    space skipping</label>
  <label><input id="astride" type="checkbox" checked style="width:auto">
    adaptive sampling (per-region dt)</label>
  <label><input id="prog" type="checkbox" checked style="width:auto">
    progressive refinement</label>
  <label>clock heat map scale (0=off)
    <input id="clock" type="number" step="any" min="0" value="0"></label>
  <div>
    <button id="shot">screenshot</button>
    <button id="xf">save .xf</button>
  </div>
  <div style="margin-top:10px" id="help">drag = orbit, wheel = zoom<br>
    keys: f fly / i inspect, WASD+RF move, +/- speed, x/y/z views</div>
</div>
<script>
const c = document.getElementById('c'), ctx = c.getContext('2d');
let theta = __THETA__, phi = __PHI__, dist = __DIST__;
const CENTER = __CENTER__, DIAG = __DIAG__;
let dirty = true, frame = 0, busy = false;
// fly mode state (FlyMode.cpp:33-150): explicit eye + yaw/pitch
let mode = 'inspect', speed = 0.05;
let eye = null, yaw = 0, pitch = 0;
const t0 = [];
const ids = ['field','cmap','customcm','lo','hi','os','dt','iso','gsiso',
             'caxis','coff','clip','cx0','cx1','cy0','cy1','cz0','cz1',
             'gsdvr','skip','astride','ao','aolen','aox','prog','clock',
             'tron','trseeds','trsteps','trlen','trcx','trcy','trcz',
             'tr0x','tr0y','tr0z','tr1x','tr1y','tr1z'];
const $ = id => document.getElementById(id);
function val(id) {
  const e = $(id);
  return e.type === 'checkbox' ? (e.checked ? 1 : 0) : e.value;
}
// --- per-field drawable opacity curve (GLUI_TransferFunction analog) ---
const NA = 128;
const curves = {};  // field -> Uint8Array(NA), only when user-edited
const ac = $('alpha'), actx = ac.getContext('2d');
function curFieldCurve() {
  const f = val('field');
  if (!(f in curves)) return null;
  return curves[f];
}
function drawAlpha() {
  actx.clearRect(0, 0, ac.width, ac.height);
  actx.strokeStyle = '#6c6';
  actx.beginPath();
  const cv = curFieldCurve();
  for (let i = 0; i < NA; i++) {
    const a = cv ? cv[i] / 255 : i / (NA - 1);
    const x = i / (NA - 1) * (ac.width - 1);
    const y = (1 - a) * (ac.height - 1);
    i ? actx.lineTo(x, y) : actx.moveTo(x, y);
  }
  actx.stroke();
}
function paintAlpha(e) {
  const r = ac.getBoundingClientRect();
  const i = Math.max(0, Math.min(NA - 1,
    Math.round((e.clientX - r.left) / (r.width - 1) * (NA - 1))));
  const a = Math.max(0, Math.min(1, 1 - (e.clientY - r.top) / (r.height - 1)));
  const f = val('field');
  if (!(f in curves)) {
    curves[f] = new Uint8Array(NA);
    for (let k = 0; k < NA; k++) curves[f][k] = Math.round(k/(NA-1)*255);
  }
  const cv = curves[f];
  if (paintAlpha.last !== null) {
    const [i0, a0] = paintAlpha.last;  // interpolate between drag samples
    const lo = Math.min(i0, i), hi = Math.max(i0, i);
    for (let k = lo; k <= hi; k++) {
      const w = hi > lo ? (k - i0) / (i - i0 || 1) : 1;
      cv[k] = Math.round((a0 + (a - a0) * Math.max(0, Math.min(1, w))) * 255);
    }
  } else cv[i] = Math.round(a * 255);
  paintAlpha.last = [i, a];
  drawAlpha(); dirty = true;
}
paintAlpha.last = null;
ac.onmousedown = e => { paintAlpha.last = null; paintAlpha(e);
  ac.onmousemove = paintAlpha; };
window.addEventListener('mouseup', () => { ac.onmousemove = null; });
$('alpharamp').onclick = () => { delete curves[val('field')];
  drawAlpha(); dirty = true; };
$('alphaflat').onclick = () => { const cv = new Uint8Array(NA).fill(255);
  curves[val('field')] = cv; drawAlpha(); dirty = true; };
$('alphazero').onclick = () => { curves[val('field')] = new Uint8Array(NA);
  drawAlpha(); dirty = true; };
$('field').addEventListener('input', drawAlpha);
drawAlpha();
function alphaHex() {
  const cv = curFieldCurve();
  if (!cv) return '';
  return Array.from(cv, b => b.toString(16).padStart(2, '0')).join('');
}
// --- camera ---
function orbitEye() {
  return [CENTER[0] + dist*DIAG*Math.cos(phi)*Math.sin(theta),
          CENTER[1] + dist*DIAG*Math.sin(phi),
          CENTER[2] + dist*DIAG*Math.cos(phi)*Math.cos(theta)];
}
function flyDir() {
  return [Math.cos(pitch)*Math.sin(yaw), Math.sin(pitch),
          Math.cos(pitch)*Math.cos(yaw)];
}
function camVecs() {
  if (mode === 'fly') {
    const d = flyDir();
    return [eye, [eye[0]+d[0]*DIAG, eye[1]+d[1]*DIAG, eye[2]+d[2]*DIAG]];
  }
  return [orbitEye(), CENTER];
}
function params() {
  const [e, at] = camVecs();
  const p = new URLSearchParams({frame,
    ex: e[0], ey: e[1], ez: e[2], ax: at[0], ay: at[1], az: at[2]});
  for (const id of ids) p.set(id, val(id));
  const ah = alphaHex();
  if (ah) p.set('alpha', ah);
  return p;
}
function camEcho() {
  const [e, at] = camVecs();
  const f = x => x.toPrecision(5);
  $('cam').textContent = `--camera ${f(e[0])} ${f(e[1])} ${f(e[2])} ` +
    `${f(at[0])} ${f(at[1])} ${f(at[2])} 0 1 0  [${mode}]`;
}
async function tick() {
  if (busy) return;
  busy = true;
  const t = performance.now();
  const r = await fetch('/frame?' + params());
  const blob = await r.blob();
  const img = await createImageBitmap(blob);
  ctx.drawImage(img, 0, 0);
  t0.push(performance.now() - t); if (t0.length > 10) t0.shift();
  const avg = t0.reduce((a,b)=>a+b,0)/t0.length;
  $('fps').textContent = (1000/avg).toFixed(1)+' fps ('+avg.toFixed(0)+' ms)';
  camEcho();
  frame = dirty ? 0 : frame + 1;
  dirty = false;
  busy = false;
}
setInterval(tick, 30);
let drag = null;
c.onmousedown = e => drag = [e.clientX, e.clientY];
window.onmouseup = () => drag = null;
window.onmousemove = e => {
  if (!drag) return;
  const dx = (e.clientX - drag[0]) * 0.01;
  const dy = (e.clientY - drag[1]) * 0.01;
  if (mode === 'fly') {           // look around (FlyMode rotate)
    yaw -= dx;
    pitch = Math.max(-1.5, Math.min(1.5, pitch - dy));
  } else {                        // orbit the POI (InspectMode rotate)
    theta += dx;
    phi = Math.max(-1.5, Math.min(1.5, phi + dy));
  }
  drag = [e.clientX, e.clientY];
  dirty = true;
};
c.onwheel = e => {
  if (mode === 'fly') {           // wheel = dolly along view
    const d = flyDir(), s = -e.deltaY * 0.001 * DIAG * speed * 10;
    eye = [eye[0]+d[0]*s, eye[1]+d[1]*s, eye[2]+d[2]*s];
  } else dist *= Math.exp(e.deltaY * 0.001);
  dirty = true; e.preventDefault();
};
// key bindings (Camera.cpp:124-174 + FlyMode WASD)
window.addEventListener('keydown', e => {
  if (e.target.tagName === 'INPUT' || e.target.tagName === 'TEXTAREA'
      || e.target.tagName === 'SELECT') return;
  const k = e.key;
  if (k === 'f' && mode !== 'fly') {
    // enter fly mode at the current orbit pose
    eye = orbitEye();
    const d = [CENTER[0]-eye[0], CENTER[1]-eye[1], CENTER[2]-eye[2]];
    const l = Math.hypot(...d);
    yaw = Math.atan2(d[0], d[2]); pitch = Math.asin(d[1]/l);
    mode = 'fly';
  } else if (k === 'i') {
    mode = 'inspect';
  } else if (k === '+' || k === '=') { speed *= 1.5;
  } else if (k === '-') { speed /= 1.5;
  } else if ('xyz'.includes(k.toLowerCase())) {
    mode = 'inspect';
    const s = k === k.toLowerCase() ? 1 : -1;  // shift = opposite side
    if (k.toLowerCase() === 'x') { theta = s*Math.PI/2; phi = 0; }
    if (k.toLowerCase() === 'y') { theta = 0; phi = s*1.5; }
    if (k.toLowerCase() === 'z') { theta = s > 0 ? 0 : Math.PI; phi = 0; }
  } else if (mode === 'fly' && 'wasdrf'.includes(k.toLowerCase())) {
    const d = flyDir();
    const right = [Math.cos(yaw), 0, -Math.sin(yaw)];
    const s = DIAG * speed;
    const mv = {w: d, s: d.map(v => -v), d: right,
                a: right.map(v => -v), r: [0, 1, 0], f: [0, -1, 0]
               }[k.toLowerCase()].map(v => v * s);
    eye = [eye[0]+mv[0], eye[1]+mv[1], eye[2]+mv[2]];
  } else return;
  dirty = true;
  e.preventDefault();
});
for (const id of ids) $(id).oninput = () => dirty = true;
$('shot').onclick = () => {
  const a = document.createElement('a');
  a.download = 'exa_screenshot.png';
  a.href = c.toDataURL('image/png');
  a.click();
};
$('xf').onclick = () => { location.href = '/xf?' + params(); };
</script></body></html>"""


class ViewerState:
    """The viewer's scene, renderer and tracer, rebuilt when the panel's
    settings change; every frame renders on ``device`` (``plain_kernels``:
    through the kernels' plain-torch twins there)."""

    def __init__(self, config_path: str, width: int, height: int,
                 device="cuda", plain_kernels: bool = False):
        self.device = render_device(device)
        self.plain_kernels = plain_kernels
        cfg = parse_config(config_path)
        self.scene, _, _ = scene_from_config(cfg, device=self.device)
        self.width = width
        self.height = height
        w_lo, w_hi = cfg.world_bounds()
        self.world_lo = np.asarray(w_lo, np.float32)
        self.world_hi = np.asarray(w_hi, np.float32)
        self.center = 0.5 * (w_lo + w_hi)
        self.diag = float(np.linalg.norm(w_hi - w_lo))
        self.field_names = [f.name for f in cfg.scalar_fields]
        self.value_ranges = [f.value_range for f in cfg.scalar_fields]
        self.value_range = self.value_ranges[0]
        self.lock = threading.Lock()
        self.renderer = None
        self.key = None
        self._field_scenes = {}
        self.tracer = None
        self.tracer_key = None
        self._heat = None  # (key, red overlay) cache

    def camera(self, theta, phi, dist):
        eye = self.center + dist * self.diag * np.asarray([
            np.cos(phi) * np.sin(theta),
            np.sin(phi),
            np.cos(phi) * np.cos(theta),
        ])
        return Camera.look_at(eye, self.center, [0, 1, 0], 55.0,
                              self.width, self.height)

    def camera_from_query(self, q):
        """Explicit eye/at camera (fly or inspect pose from the client);
        falls back to the orbit parameterization."""
        if "ex" in q:
            eye = [float(q[k][0]) for k in ("ex", "ey", "ez")]
            at = [float(q[k][0]) for k in ("ax", "ay", "az")]
            return Camera.look_at(eye, at, [0, 1, 0], 55.0,
                                  self.width, self.height)
        theta = float(q.get("theta", ["0.5"])[0])
        phi = float(q.get("phi", ["0.3"])[0])
        dist = float(q.get("dist", ["1.2"])[0])
        return self.camera(theta, phi, dist)

    def _scene_for_field(self, field: int):
        """Single-channel view of one scalar field (the GLUI channel
        selector, exa/viewer.cpp:641-650)."""
        if field == 0:
            return self.scene
        if field not in self._field_scenes:
            self._field_scenes[field] = dataclasses.replace(
                self.scene, scalars=self.scene.scalars[field : field + 1]
            )
        return self._field_scenes[field]

    def _ensure_renderer(self, q, cam):
        g1 = lambda k, d: q.get(k, [d])[0]
        field = min(int(g1("field", "0")), len(self.field_names) - 1)
        cmap = g1("cmap", "Paraview Cool Warm")
        custom = g1("customcm", "")
        vr = self.value_ranges[field]
        lo = float(g1("lo", str(vr[0])))
        hi = float(g1("hi", str(vr[1])))
        os_ = float(g1("os", "1"))
        dt = float(g1("dt", "0.5"))
        iso = float(g1("iso", "0"))
        gs_iso = g1("gsiso", "1") == "1"
        gs_dvr = g1("gsdvr", "0") == "1"
        skip = g1("skip", "1") == "1"
        astride = g1("astride", "1") == "1"
        caxis = g1("caxis", "off")
        coff = float(g1("coff", "0.5"))
        clip = g1("clip", "0") == "1"
        cfrac = [float(g1(k, d)) for k, d in
                 (("cx0", "0"), ("cy0", "0"), ("cz0", "0"),
                  ("cx1", "1"), ("cy1", "1"), ("cz1", "1"))]
        alpha_hex = g1("alpha", "")
        ao = g1("ao", "0") == "1"
        ao_len = float(g1("aolen", "1e20") or "1e20")
        # exact AO (progressive): per-frame hemisphere rays vs the exact
        # surfaces, averaged by the accumulation loop — the reference's
        # own progressive estimator (exabrick.cu:1612-1645) instead of
        # the sweep shadow volumes
        ao_exact = g1("aox", "0") == "1"
        tron = g1("tron", "0") == "1"

        key = (field, cmap, custom, lo, hi, os_, dt, iso != 0.0, gs_iso,
               gs_dvr, skip, astride, caxis, coff, clip, tuple(cfrac),
               alpha_hex, ao, ao_len, ao_exact, tron)
        if self.renderer is not None and key == self.key:
            return self.renderer

        colormap = cmap
        if cmap == "Custom" and custom.strip():
            from .colormaps import ColorMapper

            colormap = ColorMapper.from_string(custom)
        opacities = None
        if alpha_hex:
            # the drawn per-field opacity curve (GLUI_TransferFunction
            # widget analog, exa/viewer.cpp:577-580), 8-bit per texel
            opacities = (
                np.frombuffer(bytes.fromhex(alpha_hex), np.uint8)
                .astype(np.float32) / 255.0
            )
        fs = make_frame_state(
            cam, 1, [[lo, hi]], colormap=colormap,
            opacity_scale=os_, dt=dt, opacities=opacities,
            # AO checkbox + length spinner (exa/viewer.cpp:618-624)
            ao_enabled=ao, ao_length=ao_len,
        )
        if iso != 0.0:
            fs.iso_enabled[0] = True
            fs.iso_value[0] = iso
        if caxis in ("x", "y", "z"):
            ax = "xyz".index(caxis)
            n = np.zeros(3, np.float32)
            n[ax] = 1.0
            # the offset is fractional in the unit cube scaled to the
            # world bounds (exabrick.cu:1356-1362) — the slider value
            # passes through directly
            fs.contour_enabled[0] = True
            fs.contour_normal[0] = n
            fs.contour_offset[0] = coff
        rcfg = RenderConfig(
            num_channels=1,
            iso_surfaces=iso != 0.0,
            gradient_shading_dvr=gs_dvr,
            gradient_shading_iso=gs_iso,
            space_skipping=skip,
            adaptive_stride=astride,
            ao_samples=2 if ao else 0,
        )
        surf = None
        if tron and self.tracer is not None:
            surf = self.tracer.surface_data_full()
        self.renderer = Renderer(
            self._scene_for_field(field), self.width, self.height,
            cfg=rcfg, frame_state=fs, surfaces=surf, device=self.device,
        )
        self.renderer.ao_exact = ao_exact
        self.renderer.plain_kernels = self.plain_kernels
        if clip:
            lo3 = self.world_lo + np.asarray(cfrac[:3]) * (
                self.world_hi - self.world_lo
            )
            hi3 = self.world_lo + np.asarray(cfrac[3:]) * (
                self.world_hi - self.world_lo
            )
            self.renderer.set_clip_box(True, lo3, np.maximum(hi3, lo3))
        self.key = key
        return self.renderer

    def _ensure_tracer(self, q, r):
        """(Re)seed the tracer when its panel settings change
        (tracerSettingsChangedCB -> resetTracer, exa/viewer.cpp:961) and
        advance one RK4 step per displayed frame (viewer.cpp:283-284)."""
        g1 = lambda k, d: q.get(k, [d])[0]
        tron = g1("tron", "0") == "1"
        if not tron:
            if self.tracer is not None:
                self.tracer = None
                self.tracer_key = None
            return False
        nseeds = max(1, int(float(g1("trseeds", "1000"))))
        nsteps = max(2, int(float(g1("trsteps", "100"))))
        slen = float(g1("trlen", "1"))
        ch = tuple(
            min(int(float(g1(k, "0"))), len(self.field_names) - 1)
            for k in ("trcx", "trcy", "trcz")
        )
        lo = tuple(float(g1(k, "0")) for k in ("tr0x", "tr0y", "tr0z"))
        hi = tuple(float(g1(k, "1")) for k in ("tr1x", "tr1y", "tr1z"))
        key = (nseeds, nsteps, slen, ch, lo, hi)
        if key != self.tracer_key:
            from ..render.tracer import Tracer

            self.tracer = Tracer(
                r.scene, num_traces=nseeds, num_timesteps=nsteps,
                steplen=slen, channels=ch,
                seed_region_lo=lo, seed_region_hi=hi,
            )
            self.tracer_key = key
            r.reset_accumulation()
        # one RK4 step per displayed frame; the display culls segments
        # beyond the current timestep (exabrick.cu:536-570)
        self.tracer.advance()
        r.surf = self.tracer.surface_data_full()
        r.fs = dataclasses.replace(
            r.fs, tracer_timestep=np.int32(self.tracer.timestep)
        )
        return True

    def _clock_overlay(self, q, r, cam):
        """Per-pixel traversal-cost heat map (the clockScale spinner,
        exa/viewer.cpp:630-631 / exabrick.cu:1703-1707): wavefront
        iteration counts at 1/8 resolution, cached per pose/settings."""
        g1 = lambda k, d: q.get(k, [d])[0]
        scale = float(g1("clock", "0") or "0")
        if scale <= 0.0:
            return None
        from ..render.dvr import trace_dvr
        from ..utils.profiling import cost_heatmap

        w8, h8 = max(self.width // 8, 8), max(self.height // 8, 8)
        pose = tuple(np.round(np.asarray(r.fs.cam_pos), 4)) + tuple(
            np.round(np.asarray(r.fs.cam_dir00), 4)
        )
        key = (pose, self.key, scale, w8, h8)
        if self._heat is not None and self._heat[0] == key:
            return self._heat[1]
        eye = [float(q[k][0]) for k in ("ex", "ey", "ez")] if "ex" in q \
            else None
        at = [float(q[k][0]) for k in ("ax", "ay", "az")] if "ax" in q \
            else None
        if eye is None:
            return None
        lowcam = Camera.look_at(eye, at, [0, 1, 0], 55.0, w8, h8)
        o, d = lowcam.rays(w8, h8)
        dev = r.device
        _, iters = trace_dvr(
            r.scene, r.fs, r.cfg, torch.from_numpy(o).to(dev),
            torch.from_numpy(d).to(dev),
            torch.zeros(o.shape[0], dtype=torch.float32, device=dev),
            return_stats=True)
        red = cost_heatmap(
            iters.cpu().numpy().reshape(h8, w8), scale
        )[::-1]
        red = np.repeat(np.repeat(red, 8, 0), 8, 1)
        red = red[: self.height, : self.width]
        pad_r = self.height - red.shape[0]
        pad_c = self.width - red.shape[1]
        if pad_r > 0 or pad_c > 0:
            red = np.pad(red, ((0, max(pad_r, 0)), (0, max(pad_c, 0))),
                         mode="edge")
        overlay = (red * 255).astype(np.uint8)
        self._heat = (key, overlay)
        return overlay

    def _on_device(self):
        """This thread's current CUDA device set to the viewer's (a
        handler thread starts on device 0)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def render(self, q) -> bytes:
        frame = int(q.get("frame", ["0"])[0])
        progressive = q.get("prog", ["1"])[0] == "1"

        with self.lock, self._on_device():
            cam = self.camera_from_query(q)
            r = self._ensure_renderer(q, cam)
            tracing = self._ensure_tracer(q, r)
            from ..render.frame import with_camera

            if frame == 0:
                r.fs = with_camera(r.fs, cam)
                r.reset_accumulation()
                r.enable_fast_path()
            elif not progressive:
                # progressive-refinement toggle (exa/viewer.cpp:807):
                # off = every frame stands alone (accumID stays 0)
                r.reset_accumulation()
            img = r.render()
            rgba = r.image_uint8(img)
            heat = self._clock_overlay(q, r, cam)
            if heat is not None:
                rgba = rgba.copy()
                rgba[..., 0] = heat
            _ = tracing

        from ..utils.png import write_png

        buf = io.BytesIO()
        write_png(buf, rgba)
        return buf.getvalue()

    def xf_bytes(self, q) -> bytes:
        """Current transfer-function opacities as a .xf blob (the 'T'
        key, exa/viewer.cpp:140-145)."""
        with self.lock, self._on_device():
            cam = self.camera(0.5, 0.3, 1.2)
            r = self._ensure_renderer(q, cam)
            return np.asarray(
                r.fs.xf_lut[0][:, 3], np.float32
            ).tobytes()


class _Handler(BaseHTTPRequestHandler):
    state: ViewerState = None

    def log_message(self, *a):  # quiet
        pass

    def _send(self, data: bytes, ctype: str, code: int = 200,
              extra=()):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        for k, v in extra:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        url = urllib.parse.urlparse(self.path)
        if url.path == "/":
            st = self.state
            vr = st.value_range
            opts = "".join(
                f'<option{" selected" if n == "Paraview Cool Warm" else ""}>'
                f"{n}</option>" for n in COLORMAP_NAMES
            ) + "<option>Custom</option>"
            fields = "".join(
                f'<option value="{i}">{n}</option>'
                for i, n in enumerate(st.field_names)
            )
            page = (
                _PAGE.replace("__W__", str(st.width))
                .replace("__H__", str(st.height))
                .replace("__CMAPS__", opts)
                .replace("__FIELDS__", fields)
                .replace("__LO__", f"{vr[0]:g}")
                .replace("__HI__", f"{vr[1]:g}")
                .replace("__AOLEN__", f"{st.diag:g}")
                .replace("__DT__", "0.5")
                .replace("__THETA__", "0.5")
                .replace("__PHI__", "0.3")
                .replace("__DIST__", "1.2")
                .replace("__CENTER__", repr(list(map(float, st.center))))
                .replace("__DIAG__", f"{st.diag:g}")
            )
            self._send(page.encode(), "text/html")
        elif url.path == "/frame":
            q = urllib.parse.parse_qs(url.query)
            try:
                data = self.state.render(q)
            except Exception as e:  # pragma: no cover
                self._send(str(e).encode(), "text/plain", 500)
                return
            self._send(data, "image/png")
        elif url.path == "/xf":
            q = urllib.parse.parse_qs(url.query)
            data = self.state.xf_bytes(q)
            self._send(
                data, "application/octet-stream",
                extra=(("Content-Disposition",
                        'attachment; filename="currentTransferFunction.xf"'),),
            )
        else:
            self._send(b"not found", "text/plain", 404)


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    if not argv:
        print("usage: python -m owlexabrick_tpu_torch.viewer.serve "
              "<scene.exa> [--port N] [--size W H] [--device cuda|cpu] "
              "[--plain-kernels]")
        return 1
    config = argv[0]
    port = 8000
    size = (768, 576)
    device = "cuda"
    plain = False
    i = 1
    while i < len(argv):
        if argv[i] == "--port":
            port = int(argv[i + 1])
            i += 2
        elif argv[i] in ("--size", "-win"):
            size = (int(argv[i + 1]), int(argv[i + 2]))
            i += 3
        elif argv[i] == "--device":
            device = argv[i + 1]
            i += 2
        elif argv[i] == "--plain-kernels":
            plain = True
            i += 1
        else:
            i += 1

    _Handler.state = ViewerState(config, *size, device=device,
                                 plain_kernels=plain)
    server = ThreadingHTTPServer(("0.0.0.0", port), _Handler)
    print(f"#viewer: serving {config} on http://localhost:{port}/")
    server.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
