from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeSpec,
                                      all_archs, get_arch, runnable,
                                      smoke_config)

__all__ = ["ArchConfig", "SHAPES", "ShapeSpec", "all_archs", "get_arch",
           "runnable", "smoke_config"]
