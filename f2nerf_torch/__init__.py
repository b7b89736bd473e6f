"""f2nerf_torch: the PyTorch + CUDA port of f2nerf_tpu for NVIDIA Hopper.

Module paths and function names mirror ``f2nerf_tpu`` so every function
has an obvious counterpart. The package imports torch and numpy only; the
framework-neutral host code (config composer, schedules, synthetic scene,
octree host logic, warp camera selection) is carried over as copies
because importing any ``f2nerf_tpu`` module imports jax.

Hand-written CUDA kernels live under ``csrc/`` and are compiled with nvcc
at first use (``kernels.py``); each has a plain PyTorch version beside its
wrapper, which runs only for tensors that live on the CPU.
"""

__version__ = "0.1.0"
