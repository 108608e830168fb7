from repro_torch.optim.adamw import (AdamWConfig, apply_updates, global_norm,
                                     init_state, lr_at)

__all__ = ["AdamWConfig", "apply_updates", "global_norm", "init_state",
           "lr_at"]
