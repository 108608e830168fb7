from repro_torch.configs.base import ArchConfig, get_arch, smoke_config

__all__ = ["ArchConfig", "get_arch", "smoke_config"]
