"""Tiny text-overlay helper for screenshots (the display-string / legend
overlay of the reference viewer, exa/viewer.cpp:341-440; the port's copy
of ``owlexabrick_tpu/utils/text.py``).

Uses PIL's built-in bitmap font when available; silently no-ops without
it so headless rendering never gains a hard dependency.
"""

from __future__ import annotations

import numpy as np


def draw_text(img: np.ndarray, text: str, x: int, y: int,
              color=(255, 255, 255), scale: int = 1) -> np.ndarray:
    """Rasterize ``text`` into ``img`` ((H, W, 3|4) uint8) with its top-left
    corner at (x, y).  Returns img (modified in place when possible)."""
    if not text:
        return img
    try:
        from PIL import Image, ImageDraw
    except ImportError:  # pragma: no cover
        return img
    h, w = img.shape[:2]
    mask_img = Image.new("L", (w, h), 0)
    ImageDraw.Draw(mask_img).text((x, y), text, fill=255)
    if scale != 1:
        mask_img = mask_img.resize((w * scale, h * scale), Image.NEAREST)
        mask_img = mask_img.crop((x * (scale - 1), y * (scale - 1),
                                  x * (scale - 1) + w, y * (scale - 1) + h))
    mask = np.asarray(mask_img) > 127
    col = np.asarray(color, np.uint8)
    img[mask, :3] = col[:3]
    if img.shape[-1] == 4:
        img[mask, 3] = 255
    return img


def text_size(text: str):
    """(width, height) in pixels of the default font, or a rough estimate
    without PIL."""
    try:
        from PIL import Image, ImageDraw
    except ImportError:  # pragma: no cover
        return 6 * len(text), 11
    d = ImageDraw.Draw(Image.new("L", (4, 4)))
    box = d.textbbox((0, 0), text)
    return box[2] - box[0], box[3] - box[1]
