"""u32 words on torch tensors.

Device state keeps u32 words as ``torch.int32`` bit patterns (the CUDA
kernels take ``uint32_t*``).  Torch on the CPU implements neither
unsigned add, shift, compare nor max, so the plain versions compute in
int64 over values in ``[0, 2^32)`` and wrap back with :func:`narrow`.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

MASK = 0xFFFFFFFF


def widen(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or any integer tensor) -> int64 in [0, 2^32)."""
    return t.to(torch.int64) & MASK


def narrow(t: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 bit patterns of their low 32 bits."""
    t = t & MASK
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


def mul(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for widened ``a`` and a u32 constant ``b``.

    Split in 16-bit halves so no partial product leaves int64's range
    (a full 32 x 32 bit product would overflow signed int64)."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def as_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """XLA's gather index rule, for int32 bit-pattern indices: negative
    values count from the end once, then the index clamps into
    ``[0, n)``."""
    i = idx.to(torch.int64)
    i = torch.where(i < 0, i + n, i)
    return i.clamp(0, n - 1)


def from_numpy(a, device=None) -> torch.Tensor:
    """numpy u32 (or any integer) array -> int32 bit-pattern tensor on
    ``device`` (None: the card)."""
    a = np.ascontiguousarray(np.asarray(a).astype(np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(
        resolve_device(device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor -> numpy u32 array (host copy)."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint32)
