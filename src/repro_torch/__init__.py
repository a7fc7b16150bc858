"""S²FL on PyTorch and CUDA: the split-federated CNN trainer with its
cut-layer codecs, the LM stack and its batched server, and their
hand-written Hopper kernels.

The package imports torch and numpy only. Every entry point takes an
explicit ``device``; a tensor on the card goes through the CUDA kernels
(built from ``csrc/`` on first use), a tensor on the CPU through their
plain PyTorch versions.
"""
from repro_torch.configs.base import (CNNConfig, CommConfig, DriverConfig,
                                      ModelConfig, get_config, list_configs,
                                      make_reduced, register)

__all__ = ["CNNConfig", "CommConfig", "DriverConfig", "ModelConfig",
           "get_config", "list_configs", "make_reduced", "register"]
