from repro_torch.configs.base import (CNNConfig, CommConfig, DriverConfig,
                                      ModelConfig, get_config, list_configs,
                                      make_reduced, register)

__all__ = ["ModelConfig", "CNNConfig", "CommConfig", "DriverConfig",
           "get_config", "list_configs", "make_reduced", "register"]
