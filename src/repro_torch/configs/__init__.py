from repro_torch.configs.base import (ARCH_IDS, ModelConfig, OptimizerConfig,
                                      get_config)

__all__ = ["ARCH_IDS", "ModelConfig", "OptimizerConfig", "get_config"]
