"""Serving runtime of the port (the batched slot executor so far)."""
