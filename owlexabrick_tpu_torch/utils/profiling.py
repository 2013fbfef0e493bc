"""Tracing/profiling utilities (the port of
``owlexabrick_tpu/utils/profiling.py``).

The reference offers: a per-pixel clock-cycle heat map (clockScale,
exabrick.cu:1588/1703-1707), an FPS title bar + 50-frame benchmark average
(viewer.cpp:297-339), preprocessing wall-clock prints, and memory usage
printouts.  Equivalents here:

  * ``FrameStats`` — running/average FPS with the 50-frame protocol
  * ``cost_heatmap`` — per-ray traversal-iteration counts from the exact
    march mapped to the red channel (the clock-scale analog;
    deterministic instead of clock-based)
  * ``trace_to`` — a torch.profiler trace (CPU and, where a card is
    present, CUDA activity) written as a Chrome trace
  * ``device_memory_stats`` — the card's allocator summary
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np


class FrameStats:
    """Running FPS + benchmark average (exa/viewer.cpp:297-339)."""

    def __init__(self, bench_frames: int = 50):
        self.bench_frames = bench_frames
        self.reset()

    def reset(self):
        self.t_last = None
        self.frame_times = []

    def tick(self) -> Optional[str]:
        now = time.time()
        msg = None
        if self.t_last is not None:
            self.frame_times.append(now - self.t_last)
            if len(self.frame_times) == self.bench_frames:
                avg = sum(self.frame_times) / len(self.frame_times)
                msg = (
                    f"#exa: bench avg over {self.bench_frames} frames: "
                    f"{1.0/avg:.2f} FPS ({avg*1e3:.1f} ms/frame)"
                )
        self.t_last = now
        return msg

    @property
    def fps(self) -> float:
        if not self.frame_times:
            return 0.0
        window = self.frame_times[-10:]
        return len(window) / sum(window)


def cost_heatmap(iters: np.ndarray, scale: float = 0.05) -> np.ndarray:
    """Map per-ray iteration counts to [0,1] red-channel intensities, like
    the clock heat map's clockScale (exabrick.cu:1703-1707)."""
    return np.clip(np.asarray(iters, np.float32) * scale, 0.0, 1.0)


@contextlib.contextmanager
def trace_to(log_dir: str):
    """torch.profiler trace of the block, written to
    ``<log_dir>/trace.json`` (open in chrome://tracing or Perfetto)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats(device=None) -> dict:
    """The card's allocator counters (bytes in use, peak, the card's
    total); empty without a card."""
    import torch

    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current"),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
        "bytes_limit": torch.cuda.get_device_properties(
            device or 0).total_memory,
    }
