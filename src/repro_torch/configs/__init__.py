from repro_torch.configs.base import (PORT_ONLY, SHAPES, ArchConfig,
                                      PatternConfig, ShapeSpec, all_archs,
                                      get_arch, runnable, smoke_config)

__all__ = ["ArchConfig", "PORT_ONLY", "PatternConfig", "SHAPES", "ShapeSpec",
           "all_archs", "get_arch", "runnable", "smoke_config"]
