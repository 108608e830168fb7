"""PyTorch + CUDA port of the CDC-coded serving stack.

The package mirrors the reference package's layout (``configs``, ``core``,
``kernels``, ``models``, ``serve``, ``runtime/executor``, ``launch``) and
keeps its tensor layouts at every public function. Entry points run on the
CUDA device unless the caller passes ``device="cpu"``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
