"""The exajet pattern (one field): the frozen
``portbench.scene.exajet_pattern_cells`` on the section's ``n``,
``threshold``, ``max_level`` and ``wings``."""

from portbench.scene import exajet_pattern_cells


def cells(scene: dict):
    return exajet_pattern_cells(
        n=int(scene["n"]), threshold=float(scene["threshold"]),
        max_level=int(scene["max_level"]), wings=int(scene["wings"]))
