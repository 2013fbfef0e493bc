"""owlexabrick-tpu, PyTorch/CUDA port.

The AMR volume renderer of ``owlexabrick_tpu`` (the JAX package, kept as
the reference) on PyTorch: the exact path (the scene build with the
native C++ core, the region march over the BSP of same-bricks regions,
exact iso surfaces, contour planes, exact AO and the RK4 particle
tracer, as torch ops) and the slab-sweep fast path for any camera, with
its kernels written by hand in CUDA C++ for Hopper (``csrc/``).  Module
names mirror the JAX package so each counterpart is easy to find.  This
package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
