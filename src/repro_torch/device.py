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


def seeded_generator(device: torch.device, seed: int):
    """A generator on ``device`` seeded with ``seed``; None on the meta
    device, whose draws have shapes and no values (a model's
    ``init_params(..., device="meta")`` gives its tree's shapes)."""
    if device.type == "meta":
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen
