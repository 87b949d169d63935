"""PyTorch/CUDA port of the C-DFL package ``repro``, for one NVIDIA H100.

The layout mirrors ``src/repro/`` path for path. The port imports torch
and numpy only, never JAX or ``repro``. Entry points run on the card
unless the caller passes ``device="cpu"``.
"""
