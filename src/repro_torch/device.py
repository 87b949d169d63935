"""The port's device rule: ``device=None`` means ``"cuda"``, and a CUDA
device without CUDA raises. Nothing falls back to the CPU unless the
caller asks for it."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    return dev
