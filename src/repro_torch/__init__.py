"""S²FL on PyTorch and CUDA: the split-federated CNN trainer, its
cut-layer codecs and their hand-written Hopper kernels.

The package imports torch and numpy only. Every entry point takes an
explicit ``device``; a tensor on the card goes through the CUDA kernels
(built from ``csrc/`` on first use), a tensor on the CPU through their
plain PyTorch versions.
"""
