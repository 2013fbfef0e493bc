"""The benchmark of ``owlexabrick_tpu_torch``, the PyTorch and CUDA port
(``portbench/README.md``).  Nothing here imports JAX or the JAX package;
the plain reference (``portbench/reference``) imports nothing of the
port either."""
