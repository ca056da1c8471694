"""The benchmark of the PyTorch and CUDA port (`repro_torch`): see
README.md.  Nothing here imports the JAX package or JAX."""
