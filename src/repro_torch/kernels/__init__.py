"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``),
each with its plain PyTorch version and a launch counter."""
