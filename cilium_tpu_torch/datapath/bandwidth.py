"""Bandwidth manager: per-endpoint egress rate limiting on the device.

Reference: the JAX package's ``datapath/bandwidth.py`` (itself upstream
``pkg/bandwidth`` and the EDT logic of ``bpf_lxc.c``).  There is no
queue between batches to hold packets in, so pacing becomes
proportional policing at batch granularity: each endpoint accrues a
byte budget (a token bucket: ``rate`` bytes/s, capped at the burst), a
batch spends it, and when a batch's egress bytes exceed the budget a
deterministic per-row hash keeps the budget's fraction of rows and
drops the rest with ``REASON_BANDWIDTH``.

:func:`bw_stage` sends CUDA tensors to K13 (``csrc/bandwidth.cu``) and
CPU tensors to :func:`bw_stage_plain`.  The buckets update in place.
u32 words are int32 bit patterns; the plain version computes in int64
over ``[0, 2^32)`` (unsigned compares, wrapping products) and in f32
where the reference does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.packets import COL_DIR, COL_EP, COL_LEN, COL_SPORT, COL_SRC_IP3
from ..device import resolve_device
from ..u32 import MASK, mul, narrow, widen
from .conntrack import _require_cpu
from .verdict import MAX_ENDPOINTS, REASON_BANDWIDTH

# default burst: one second's worth of the configured rate
BURST_SECONDS = 1


@dataclass
class BandwidthState:
    """Per-endpoint token buckets (bytes) + the last accrual tick."""

    tokens: torch.Tensor  # [MAX_ENDPOINTS] int32 (u32): available bytes
    last: torch.Tensor  # [] int32 (u32): the last accrual's ``now``

    @staticmethod
    def create(device=None) -> "BandwidthState":
        device = resolve_device(device)
        return BandwidthState(
            tokens=torch.zeros((MAX_ENDPOINTS,), dtype=torch.int32,
                               device=device),
            last=torch.zeros((), dtype=torch.int32, device=device))


def _segment_sum(values: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """u32 segment_sum over MAX_ENDPOINTS segments (wrapping)."""
    out = torch.zeros(MAX_ENDPOINTS, dtype=torch.int64, device=seg.device)
    return out.index_add_(0, seg, values) & MASK


def bw_stage_plain(state: BandwidthState, hdr: torch.Tensor, now: int,
                   rates: torch.Tensor) -> torch.Tensor:
    """Police one batch (plain version): -> [N] int32 reasons, with
    ``REASON_BANDWIDTH`` on rows to drop and 0 elsewhere (feed it to the
    datapath step's ``pre_drop_reason``); ``state`` updated in place.

    ``rates`` is [MAX_ENDPOINTS] u32 bytes/s (0: unlimited).  dt clamps
    to the burst window BEFORE the accrual, so ``rates * dt`` cannot
    wrap after a long idle gap; tokens then cap at the burst."""
    now = int(now) & MASK
    h = widen(hdr)
    r = widen(rates)
    ep = torch.clamp(h[:, COL_EP], max=MAX_ENDPOINTS - 1)
    dt = min((now - (int(state.last) & MASK)) & MASK, BURST_SECONDS)
    burst = mul(r, BURST_SECONDS)
    tokens = torch.minimum((widen(state.tokens) + mul(r, dt)) & MASK, burst)

    policed = (r[ep] > 0) & (h[:, COL_DIR] == 1)  # egress only
    length = torch.where(policed, h[:, COL_LEN], 0)
    batch_bytes = _segment_sum(length, ep)
    # keep-fraction per endpoint, in f32 as the reference computes it
    frac = torch.where(
        batch_bytes > 0,
        torch.clamp(tokens.to(torch.float32)
                    / torch.clamp(batch_bytes, min=1).to(torch.float32),
                    max=1.0),
        1.0)
    # a deterministic per-flow hash: one flow's rows keep or drop
    # together within the batch
    x = (mul(h[:, COL_SRC_IP3], 0x9E3779B1)
         ^ mul(h[:, COL_SPORT], 0x85EBCA6B)
         ^ mul(ep, 0xC2B2AE35))
    x = x ^ (x >> 15)
    x = mul(x, 0x2C1B3C6D)
    u = (x >> 8).to(torch.float32) / np.float32(1 << 24)  # [0, 1)
    drop = policed & (u >= frac[ep])
    consumed = _segment_sum(torch.where(drop, 0, length), ep)
    state.tokens.copy_(narrow(tokens - torch.minimum(consumed, tokens)))
    state.last.fill_(now - (1 << 32) if now >= 1 << 31 else now)
    return torch.where(drop, REASON_BANDWIDTH, 0).to(torch.int32)


def bw_stage(state: BandwidthState, hdr: torch.Tensor, now: int,
             rates: torch.Tensor) -> torch.Tensor:
    """Police one batch: see :func:`bw_stage_plain`.  CUDA tensors launch
    K13 ``bw_stage`` (``csrc/bandwidth.cu``)."""
    if hdr.is_cuda:
        from ..kernels import launch_bw_stage

        return launch_bw_stage(state, hdr, now, rates)
    _require_cpu(hdr, "bw_stage")
    return bw_stage_plain(state, hdr, now, rates)


def rates_array(limits: dict) -> np.ndarray:
    """{endpoint id -> bytes/s} -> the [MAX_ENDPOINTS] u32 rates."""
    rates = np.zeros(MAX_ENDPOINTS, dtype=np.uint32)
    for ep_id, bps in limits.items():
        if 0 <= int(ep_id) < MAX_ENDPOINTS and bps:
            # clamp so tokens + rate * dt can never wrap u32: burst
            # must stay under 2^31 (a pod faster than ~17 Gbit/s is
            # effectively unlimited here)
            rates[int(ep_id)] = min(int(bps), 0x7FFFFFFF // BURST_SECONDS)
    return rates
