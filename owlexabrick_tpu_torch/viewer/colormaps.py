"""Color maps: piecewise-linear control-point mapper + built-in palettes
(the port of ``owlexabrick_tpu/viewer/colormaps.py``).

The reference embeds 15 colormaps as PNG strips (exa/ColorMapper.h:46-61)
plus a "Custom" black-to-white map (exa/viewer.cpp:507-543); each strip
becomes one control point per pixel and ``ColorMapper`` reproduces the
upper_bound + lerp sampling (exa/ColorMapper.h:63-80).  A "Custom" map
also comes from the textbox format ``"pos,(r,g,b)\\n..."``
(exa/ColorMapper.cpp:92-131, ``from_string``) or a PNG strip's bytes
(``from_png_bytes``).  Host numpy, so the LUTs are bit-identical to the
JAX package's.
"""

from __future__ import annotations

import io
import re
from typing import Dict, Sequence, Tuple

import numpy as np

from .palettes_data import PALETTE_NAMES, palette_strip


class ColorMapper:
    """Piecewise-linear RGB map over [0,1] from (position, rgb) knots."""

    def __init__(self, points: Sequence[Tuple[float, Tuple[float, float, float]]]):
        if len(points) < 2:
            raise ValueError("need at least 2 control points")
        pts = sorted(points, key=lambda p: p[0])
        self.pos = np.asarray([p[0] for p in pts], np.float32)
        self.rgb = np.asarray([p[1] for p in pts], np.float32)

    @staticmethod
    def from_colors(colors: Sequence[Tuple[float, float, float]]
                    ) -> "ColorMapper":
        """Evenly spaced knots, one per color."""
        return ColorMapper(_knots(*colors))

    @staticmethod
    def from_png_bytes(buf: bytes) -> "ColorMapper":
        """One control point per pixel of a PNG strip's first row, RGB
        normalized to [0,1] (ColorMapper(const uint8_t*, size_t),
        exa/ColorMapper.h:46-61)."""
        from ..utils.png import read_png

        img = read_png(io.BytesIO(buf))
        return ColorMapper.from_strip(img[0, :, :3])

    @staticmethod
    def from_string(text: str) -> "ColorMapper":
        """Parse the custom-colormap textbox format: ``0.0,(r,g,b)`` per
        line or per ``;`` (exa/ColorMapper.cpp:92-131)."""
        num = r"([0-9.eE+-]+)"
        pat = re.compile(num + r"\s*,\s*\(\s*" + num + r"\s*,\s*" + num
                         + r"\s*,\s*" + num + r"\s*\)")
        pts = []
        for line in text.replace(";", "\n").splitlines():
            line = line.strip()
            if not line:
                continue
            m = pat.match(line)
            if not m:
                raise ValueError(f"bad colormap line: {line!r}")
            pts.append((float(m.group(1)), (float(m.group(2)),
                                            float(m.group(3)),
                                            float(m.group(4)))))
        return ColorMapper(pts)

    @staticmethod
    def from_strip(rgb_u8: np.ndarray) -> "ColorMapper":
        """(W, >=3) uint8 row -> control points at i/(W-1)."""
        rgb = np.asarray(rgb_u8, np.float32)[:, :3] / 255.0
        w = rgb.shape[0]
        return ColorMapper(
            [(i / (w - 1), tuple(rgb[i])) for i in range(w)]
        )

    def __call__(self, t) -> np.ndarray:
        t = np.clip(np.asarray(t, np.float32), 0.0, 1.0)
        idx = np.searchsorted(self.pos, t, side="right")
        idx = np.clip(idx, 1, len(self.pos) - 1)
        p0 = self.pos[idx - 1]
        p1 = self.pos[idx]
        w = np.where(p1 > p0, (t - p0) / np.maximum(p1 - p0, 1e-20), 0.0)
        return (1 - w)[..., None] * self.rgb[idx - 1] + w[..., None] * self.rgb[idx]

    def sample(self, n: int) -> np.ndarray:
        return self(np.linspace(0.0, 1.0, n)).astype(np.float32)


def _knots(*cols):
    n = len(cols)
    return [(i / (n - 1), c) for i, c in enumerate(cols)]


COLORMAP_NAMES = PALETTE_NAMES + ["Custom"]

_CACHE: Dict[str, ColorMapper] = {}


def get_colormap(name: str) -> ColorMapper:
    if name not in COLORMAP_NAMES:
        raise KeyError(f"unknown colormap '{name}' (have {COLORMAP_NAMES})")
    if name not in _CACHE:
        if name == "Custom":
            _CACHE[name] = ColorMapper(_knots((0.0, 0.0, 0.0),
                                              (1.0, 1.0, 1.0)))
        else:
            _CACHE[name] = ColorMapper.from_strip(palette_strip(name))
    return _CACHE[name]


def colormap_colors(name, n: int) -> np.ndarray:
    """Sample a colormap by name, or pass a ColorMapper through."""
    if isinstance(name, ColorMapper):
        return name.sample(n)
    return get_colormap(name).sample(n)
