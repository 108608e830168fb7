from repro_torch.configs.base import (ArchConfig, all_archs, get_arch,
                                      smoke_config)

__all__ = ["ArchConfig", "all_archs", "get_arch", "smoke_config"]
