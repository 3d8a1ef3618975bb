"""Where the port's tensors live.

Every entry point and constructor of the port takes ``device=None``,
which means the card.  Asking for CUDA without one raises: nothing
falls back to the CPU unless the caller asks for it with
``device="cpu"``, which runs the plain PyTorch versions.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev
