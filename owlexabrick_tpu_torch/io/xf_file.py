"""Transfer-function opacity dump/load (.xf files; the port's copy of
``owlexabrick_tpu/io/xf_file.py``).

The reference's ``T`` key writes the 128 alpha values of the current
transfer function as raw float32 to ``currentTransferFunction.xf`` and
``--xf`` reloads them (exa/viewer.cpp:140-145, 1147-1152).  Same format
here — the persistent-state story of the renderer (SURVEY.md §5
checkpoint/resume) is: preprocessed files + .xf dumps + --camera lines.
"""

from __future__ import annotations

import numpy as np

from ..core.constants import NUM_XF_VALUES


def write_xf(path: str, opacities: np.ndarray) -> None:
    a = np.asarray(opacities, np.float32).reshape(-1)
    if a.size != NUM_XF_VALUES:
        raise ValueError(f".xf must hold {NUM_XF_VALUES} float32 alphas")
    a.tofile(path)


def read_xf(path: str) -> np.ndarray:
    a = np.fromfile(path, np.float32, NUM_XF_VALUES)
    if a.size != NUM_XF_VALUES:
        raise ValueError(f"{path}: expected {NUM_XF_VALUES} float32 alphas")
    return a


def camera_echo(pos, at, up) -> str:
    """The reference's 'C' key output: a reusable --camera command line
    (exa/viewer.cpp:147-166)."""
    v = lambda x: " ".join(f"{float(c):g}" for c in np.asarray(x))
    return f"--camera {v(pos)} {v(at)} {v(up)}"
