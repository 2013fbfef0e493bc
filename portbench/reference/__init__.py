"""The plain reference that decides a run's ``correct``.

A frozen copy, in plain torch and numpy, of the slab-sweep frame that
``owlexabrick_tpu_torch``'s ``Renderer.render()`` computes once
``enable_fast_path()`` has run: the level grids built from the cells, the
camera products (z lerp, then the x tent resample), the activity and
adaptive-stride tables, the sweep with its y lerp, classification and
front-to-back composite, the shear-warp factorization and its two-pass
Catmull-Rom warp, the reorientation preview, accumulation and the RGBA8
packing.  Every kernel of the port is replaced by the plain-torch
function it was held to, and the reference imports nothing of the port:
later changes to the port are judged against this copy, which they may
not edit.

``bf16=True`` (threaded through every stage) rounds the grids, the camera
products, the sweep's fields, the classified samples, the running
composite and the warped image to bfloat16: the reference computed in
the next precision below the float32 the configuration states, which is
the control the comparison's limits are set against.
"""
