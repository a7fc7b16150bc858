from repro_torch.configs.base import (CNNConfig, CommConfig, DriverConfig,
                                      get_config, list_configs, register)

__all__ = ["CNNConfig", "CommConfig", "DriverConfig", "get_config",
           "list_configs", "register"]
