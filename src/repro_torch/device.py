"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card. A CUDA device without a card raises:
    the port never carries on on the CPU unless it is asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA GPU is available (torch.cuda.is_available() is False); "
            "pass device='cpu' (--device cpu) to run the plain CPU path")
    return dev
