"""The benchmark's plain reference of F2-NeRF in PyTorch.

The modules beside ``step.py`` and ``data.py`` are frozen copies of the
port's modules as they stood when the benchmark was written, made
mechanically: each kernel wrapper reduced to the plain version it runs on
CPU tensors, the imports pointed at the copies, the spans dropped, the
rest as it was. ``step.py`` holds the step body, the eval chunk and the
weights' init; ``data.py`` the scene's arrays, ray draws and ray grids.
Nothing here imports the port, JAX or the JAX package.
"""
