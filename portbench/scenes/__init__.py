"""The benchmark's scene generators, one module per ``scene.pattern`` of a
configuration, found by name (``scenes/<pattern>.py``) by
``portbench.scene.scene_cells``.

A generator module defines ``cells(scene: dict)``: from the
configuration's ``scene`` section, which states at least ``n`` (the
lattice edge the traffic's camera units are fractions of), it returns
(lower (N, 3) int32, level (N,) int32, scalars), where scalars is (N,)
float32 for one field or (C, N) float32 for C fields.  Field c is drawn
by channel c.  It makes the same arrays from the same section on every
call, imports neither the port nor JAX, and leaves the cache to
``scene_cells``.
"""
