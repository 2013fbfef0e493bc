"""The one traffic generator: a traffic mix is a data file of parameters
(``portbench/traffic/<name>.json``), and this module turns it and a seed
into the frames one user asks for, back to back.

A mix names the viewer calls that make each frame, in order, before the
frame's ``enable_fast_path()`` and ``render()``:

* ``setup``: calls made once, before the warm-up (a fixed pose, say);
* ``calls``: the calls of every frame (a new pose, a transfer-function
  edit); an empty list renders the state again (progressive frames).

Each call is ``{"call": <viewer call>, <argument>: <value>, ...}``.  The
harness applies it to the program and to the reference through the file
``portbench/calls/<call>.py`` (``program`` and ``reference``), so a new
kind of call is a new file there.  An argument's value is evaluated at
the frame's phase ``p``:

* a number, a string or a list: as it stands;
* ``{"triangle": [lo, hi]}``: from lo up to hi and back over the period;
* ``{"linear": [a, step]}``: ``a + step * p``;
* ``{"seeded": [lo, hi]}``: one uniform draw from the seed, the same in
  every frame of a run;
* ``{"lerp": [A, B], "t": <value>}``: ``A + t (B - A)``, element-wise;
* ``{"orbit": {"center", "radius", "elevation_deg", "azimuth_deg"}}``:
  the point at that azimuth about the y axis of ``center``.

A frame's phase is ``(k + seed phase) % period``: every seed asks for the
same set of frames and only where the sequence starts differs, unless a
``seeded`` value says otherwise.  ``warmup``: ``frames`` first frames,
and with ``routes`` first one frame of each route the period takes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Frame:
    index: int
    phase: int
    calls: tuple  # ((call name, {argument: value}), ...)


def _tri(t: float) -> float:
    return 2.0 * t if t < 0.5 else 2.0 * (1.0 - t)


class Traffic:
    """The frames of one traffic mix for one seed."""

    def __init__(self, spec: dict, seed: int):
        self.spec, self.seed = spec, int(seed)
        self.period = int(spec.get("period", 1))
        if self.period < 1:
            raise ValueError("a traffic mix's period is at least 1 frame")
        self.phase = self.seed % self.period
        self._draw = np.random.default_rng(self.seed).random()

    def value(self, v, p: int):
        """Argument value ``v`` at phase ``p``."""
        if isinstance(v, list):
            return [self.value(x, p) for x in v]
        if not isinstance(v, dict):
            return v
        if len(v) == 1 and "triangle" in v:
            lo, hi = (float(self.value(x, p)) for x in v["triangle"])
            return lo + (hi - lo) * _tri(p / self.period)
        if len(v) == 1 and "linear" in v:
            a, step = (float(self.value(x, p)) for x in v["linear"])
            return a + step * p
        if len(v) == 1 and "seeded" in v:
            lo, hi = (float(x) for x in v["seeded"])
            return lo + (hi - lo) * self._draw
        if set(v) == {"lerp", "t"}:
            a, b = (np.asarray(self.value(x, p), np.float64)
                    for x in v["lerp"])
            t = float(self.value(v["t"], p))
            return (a + t * (b - a)).tolist()
        if len(v) == 1 and "orbit" in v:
            o = {k: self.value(x, p) for k, x in v["orbit"].items()}
            az = math.radians(float(o["azimuth_deg"]))
            el = math.radians(float(o["elevation_deg"]))
            c = np.asarray(o["center"], np.float64)
            d = np.array([math.cos(el) * math.sin(az), math.sin(el),
                          math.cos(el) * math.cos(az)])
            return (c + float(o["radius"]) * d).tolist()
        raise ValueError(f"unknown traffic value {v!r}")

    def _calls(self, specs, p: int):
        return tuple((c["call"], {k: self.value(x, p) for k, x in c.items()
                                  if k != "call"}) for c in specs)

    def setup(self) -> tuple:
        """The mix's set-up calls, evaluated at the seed's phase."""
        return self._calls(self.spec.get("setup", []), self.phase)

    def frame(self, k: int) -> Frame:
        """Frame ``k`` of this seed's sequence."""
        p = (k + self.phase) % self.period
        return Frame(index=k, phase=p,
                     calls=self._calls(self.spec.get("calls", []), p))

    def frame_at(self, phase: int) -> Frame:
        """The frame of this seed's sequence at ``phase`` (the same frame
        for every seed)."""
        return self.frame((int(phase) - self.phase) % self.period)
