from repro_torch.ckpt.checkpoint import (AsyncCheckpointer, gather_tree,
                                         latest_step, restore, save)

__all__ = ["AsyncCheckpointer", "gather_tree", "latest_step", "restore",
           "save"]
