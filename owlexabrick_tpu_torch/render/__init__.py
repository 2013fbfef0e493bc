"""Rendering: camera, transfer function, frame state, the exact region
march and iso march, the level grids and the slab sweep with its CUDA
kernels' wrappers, surfaces, the tracer and the renderer (PyTorch
port)."""
