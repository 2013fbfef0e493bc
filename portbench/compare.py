"""The numbers that decide ``correct``: a frame's RGBA8 words from the
program against the plain reference's, per color channel in 8-bit
levels."""

from __future__ import annotations

import numpy as np


def channels(words: np.ndarray) -> np.ndarray:
    """(H, W) uint32 RGBA8 words -> (H, W, 3) int16 red, green, blue."""
    w = np.asarray(words, np.uint32)
    return np.stack([(w >> s) & 0xFF for s in (0, 8, 16)],
                    -1).astype(np.int16)


def frame_numbers(got: np.ndarray, want: np.ndarray) -> dict:
    """over1_ppm: parts per million of color channels whose levels differ
    by more than 1 (a last-bit difference of float32 order flips a level
    by 1 at most); max_gap: the widest difference in levels; mean_gap:
    the mean difference over the pixels lit on either side."""
    if got.shape != want.shape:
        return dict(over1_ppm=1e6, max_gap=255.0, mean_gap=255.0)
    g, w = channels(got), channels(want)
    d = np.abs(g - w)
    lit = (g.any(-1) | w.any(-1))
    return dict(over1_ppm=float((d > 1).mean() * 1e6),
                max_gap=float(d.max()),
                mean_gap=float(d[lit].mean()) if lit.any() else 0.0)
