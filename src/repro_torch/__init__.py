"""PyTorch/CUDA port of the repro package for an NVIDIA H100.

Mirrors src/repro's layout (configs, kernels, models, serve, launch) and
imports neither jax nor anything of repro.  Entry points run on CUDA unless
the caller asks for the CPU; each hand-written kernel in `kernels/` has its
plain PyTorch version beside it, which CPU tensors take.
"""
