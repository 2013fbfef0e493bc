"""Regenerate ``viewer/palettes_data.py`` from the reference's embedded
colormap PNG strips (the port's copy of
``owlexabrick_tpu/tools/extract_embedded_colormaps.py``).

The reference embeds its 15 named palettes as PNG byte arrays
(exa/embedded_colormaps.h:1-104) decoded at startup by the
``ColorMapper(const uint8_t*, size_t)`` ctor (exa/ColorMapper.h:46-61).
This maintenance script parses that header, decodes each strip with our
dependency-free PNG reader, and emits the palette *data* (RGB rows) as a
generated Python module so the framework reproduces the reference's
colors exactly without vendoring its header.

Usage:  python -m owlexabrick_tpu_torch.tools.extract_embedded_colormaps \
            path/to/embedded_colormaps.h [out.py]
"""

from __future__ import annotations

import base64
import io
import re
import sys

from ..utils.png import read_png

# header symbol -> GUI listbox name (exa/viewer.cpp:507-523)
SYMBOL_NAMES = [
    ("paraview_cool_warm", "Paraview Cool Warm"),
    ("rainbow", "Rainbow"),
    ("matplotlib_plasma", "Matplotlib Plasma"),
    ("matplotlib_virdis", "Matplotlib Virdis"),
    ("samsel_linear_green", "Samsel Linear Green"),
    ("samsel_linear_ygb_1211g", "Samsel Linear YGB 1211g"),
    ("cool_warm_extended", "Cool Warm Extended"),
    ("blackbody", "Blackbody"),
    ("jet", "Jet"),
    ("blue_gold", "Blue Gold"),
    ("ice_fire", "Ice Fire"),
    ("nic_edge", "Nic Edge"),
    ("covise", "Covise"),
    ("jamie_draft", "JamieDraft"),
    ("hsv", "HSV"),
]


def parse_header(text: str) -> dict:
    """symbol -> raw PNG bytes from ``uint8_t name[] = {0x..,..};`` blocks."""
    out = {}
    for m in re.finditer(r"uint8_t\s+(\w+)\[\]\s*=\s*\{([^}]*)\}", text):
        name = m.group(1)
        vals = [int(tok, 0) for tok in re.split(r"[\s,]+", m.group(2).strip()) if tok]
        out[name] = bytes(vals)
    return out


def decode_strips(header_path: str) -> dict:
    """GUI name -> (W, 3) uint8 RGB strip (alpha dropped, like stb's
    3-channel request in ColorMapper.h:49)."""
    with open(header_path) as f:
        arrays = parse_header(f.read())
    strips = {}
    for sym, gui in SYMBOL_NAMES:
        img = read_png(io.BytesIO(arrays[sym]))  # (1, W, C)
        strips[gui] = img[0, :, :3].copy()
    return strips


def emit_module(strips: dict, out_path: str) -> None:
    lines = [
        '"""GENERATED by tools/extract_embedded_colormaps.py — palette strips',
        "matching the reference's embedded colormap PNGs",
        '(exa/embedded_colormaps.h, decoded per exa/ColorMapper.h:46-61)."""',
        "",
        "import base64",
        "",
        "import numpy as np",
        "",
        "# name -> (width, base64 raw RGB bytes)",
        "_RAW = {",
    ]
    for gui, rgb in strips.items():
        b64 = base64.b64encode(rgb.tobytes()).decode()
        lines.append(f"    {gui!r}: ({rgb.shape[0]},")
        for i in range(0, len(b64), 72):
            lines.append(f"        {b64[i:i + 72]!r}")
        lines.append("    ),")
    lines += [
        "}",
        "",
        "",
        "def palette_strip(name):",
        '    """(W, 3) uint8 RGB row for a named embedded palette."""',
        "    w, *parts = _RAW[name]",
        "    raw = base64.b64decode(''.join(parts))",
        "    return np.frombuffer(raw, np.uint8).reshape(w, 3)",
        "",
        "",
        "PALETTE_NAMES = list(_RAW)",
        "",
    ]
    with open(out_path, "w") as f:
        f.write("\n".join(lines))


def main(argv):
    if len(argv) < 2:
        print("usage: extract_embedded_colormaps <embedded_colormaps.h> "
              "[out.py]")
        return 1
    header = argv[1]
    import os

    default_out = os.path.join(
        os.path.dirname(__file__), "..", "viewer", "palettes_data.py"
    )
    out = argv[2] if len(argv) > 2 else default_out
    strips = decode_strips(header)
    emit_module(strips, out)
    for gui, rgb in strips.items():
        print(f"{gui}: {rgb.shape[0]} px")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
