"""owlexabrick-tpu, PyTorch/CUDA port.

The single-channel slab-sweep DVR of ``owlexabrick_tpu`` (the JAX
package, kept as the reference) on PyTorch, for axis-aligned cameras and,
through shear-warp, any other, with the sweep megakernel and the two warp
passes written by hand in CUDA C++ for Hopper (``csrc/sweep.cu``,
``csrc/warp.cu``).  Module names mirror the JAX package so each
counterpart is easy to find.  This package imports ``torch`` and never
``jax``.
"""

__version__ = "0.1.0"
