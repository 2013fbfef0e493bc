"""A two-field scene for the harness's own tests: the exajet pattern as
field 0 and, on the same cells, 1.05 times its largest value less it as
field 1, so the two fields' domains differ."""

import numpy as np

from portbench.scene import exajet_pattern_cells


def cells(scene: dict):
    lower, level, f0 = exajet_pattern_cells(
        n=int(scene["n"]), threshold=float(scene["threshold"]),
        max_level=int(scene["max_level"]), wings=int(scene["wings"]))
    f1 = (np.float32(1.05) * f0.max() - f0).astype(np.float32)
    return lower, level, np.stack([f0, f1])
