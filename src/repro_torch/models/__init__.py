from repro_torch.models.common import TPCtx
from repro_torch.models.zoo import Model, build

__all__ = ["Model", "TPCtx", "build"]
