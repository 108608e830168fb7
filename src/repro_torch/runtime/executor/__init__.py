"""Batched slot executor: ``slotbatch`` stacks the decode slots into one
state, ``vstep`` advances them one round (reference or fused variant),
and ``pool`` dispatches rounds and harvests their tokens."""
from repro_torch.runtime.executor.pool import RoundHandle, SlotPoolExecutor
from repro_torch.runtime.executor.slotbatch import (blank_state,
                                                    clone_state, read_slot,
                                                    request_batch,
                                                    write_slot)
from repro_torch.runtime.executor.vstep import VStep

__all__ = ["RoundHandle", "SlotPoolExecutor", "VStep", "blank_state",
           "clone_state", "read_slot", "request_batch", "write_slot"]
