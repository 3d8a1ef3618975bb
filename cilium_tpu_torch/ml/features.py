"""Flow feature extraction, straight from the datapath tensors.

A port of the JAX package's ``ml/features.py``: per-packet columns
(sizes, flags, ports, direction, CT state, the policy's judgment) and
batch rate aggregates over hashed traffic keys, computed as segment
counts over ``_N_BUCKETS`` buckets:

- the (dst, dport, proto) key: how much of the batch converges on one
  service (log count), how SYN-heavy and NEW-heavy that convergence is,
  and the modal shares of its sources and source ports (the flood
  signature);
- the (src, proto) key: how many NEW SYNs one source emits and how
  spread its destination ports are (the scan signature).

The remote identity rides separately as an embedding row
(``ml/model.py``).  :func:`flow_features` sends CUDA tensors to K18
``flow_features`` (``csrc/ml.cu``) and CPU tensors to
:func:`flow_features_plain`.  As on the reference, there is no ``valid``
mask: every row of the batch, padding included, counts in the
aggregates.  u32 words are int32 bit patterns; the plain version widens
them to int64 (``u32.widen``) and computes the floats in float32 where
the reference does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.packets import (
    COL_DIR,
    COL_DPORT,
    COL_DST_IP3,
    COL_FLAGS,
    COL_LEN,
    COL_PROTO,
    COL_SPORT,
    COL_SRC_IP3,
)
from ..datapath.conntrack import _require_cpu
from ..datapath.verdict import OUT_CT, OUT_ID_ROW, OUT_REASON, OUT_VERDICT
from ..u32 import MASK, mul, widen

FEAT_DIM = 27

_N_BUCKETS = 4096  # hashed segment space for the batch aggregates


def _bucket(*words: torch.Tensor) -> torch.Tensor:
    """Fold widened u32 words into [0, _N_BUCKETS) segment ids (int64)."""
    h = torch.zeros_like(words[0])
    for i, w in enumerate(words):
        h = mul(h ^ mul(w, (0x9E3779B1 + 2 * i) & MASK), 0x85EBCA77)
    h = h ^ (h >> 15)
    return h & (_N_BUCKETS - 1)


def _log1p12(x: torch.Tensor) -> torch.Tensor:
    """log1p(x) / 12 with an elementwise IEEE division, as the reference
    and K18 divide (a Python-scalar divisor lets torch on the card
    multiply by the reciprocal instead, an ulp off now and then)."""
    return torch.log1p(x) / torch.full_like(x, 12.0)


def _seg_count(key: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Per-row gather of the per-segment float32 sum of ``weight``."""
    sums = torch.zeros(_N_BUCKETS, dtype=torch.float32, device=key.device)
    return sums.index_add_(0, key, weight)[key]


def flow_features_plain(hdr: torch.Tensor, out: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Header rows [N, 16] + out rows [N, 6] (int32 bit patterns) ->
    (id_row [N] int32, feats [N, FEAT_DIM] float32 in roughly [0, 1]);
    the plain version, on any device."""
    h = widen(hdr)
    o = widen(out)
    f32 = torch.float32
    proto = h[:, COL_PROTO].to(f32)
    dport = h[:, COL_DPORT].to(f32)
    sport = h[:, COL_SPORT].to(f32)
    length = h[:, COL_LEN].to(f32)
    flags = h[:, COL_FLAGS]
    dirn = h[:, COL_DIR].to(f32)
    ct = o[:, OUT_CT].to(f32)

    def bit(b):
        return ((flags >> b) & 1).to(f32)

    syn = bit(1)
    is_new = (ct == 0).to(f32)

    # -- batch rate aggregates (see module doc) -----------------------
    one = torch.ones_like(proto)
    dst, dp, pr = h[:, COL_DST_IP3], h[:, COL_DPORT], h[:, COL_PROTO]
    src = h[:, COL_SRC_IP3]
    svc = _bucket(dst, dp, pr)
    svc_n = _seg_count(svc, one)
    svc_syn = _seg_count(svc, syn) / svc_n
    svc_new = _seg_count(svc, is_new) / svc_n
    src_share = _seg_count(_bucket(dst, dp, pr, src), one) / svc_n
    sport_share = _seg_count(_bucket(dst, dp, pr, h[:, COL_SPORT]),
                             one) / svc_n
    scan = _bucket(src, pr)
    scan_newsyn = _seg_count(scan, syn * is_new)
    dport_share = _seg_count(_bucket(src, pr, dp), one) / torch.clamp(
        _seg_count(scan, one), min=1.0)

    feats = torch.stack([
        (proto == 6).to(f32),
        (proto == 17).to(f32),
        (proto == 1).to(f32) + (proto == 58).to(f32),
        _log1p12(dport),
        _log1p12(sport),
        (dport < 1024).to(f32),  # well-known port
        _log1p12(length),
        (length < 100).to(f32),  # tiny packets (scans)
        bit(0),  # FIN
        syn,  # SYN
        bit(2),  # RST
        bit(3),  # PSH
        bit(4),  # ACK
        dirn,
        is_new,  # NEW
        (ct == 1).to(f32),  # ESTABLISHED
        (ct == 2).to(f32),  # REPLY
        (o[:, OUT_VERDICT] == 1).to(f32),  # allowed
        (o[:, OUT_REASON] == 2).to(f32),  # default-deny
        _log1p12(svc_n),
        svc_syn,
        svc_new,
        src_share,
        sport_share,
        _log1p12(scan_newsyn),
        dport_share,
        torch.ones_like(dirn),  # bias
    ], dim=1)
    return out[:, OUT_ID_ROW].contiguous(), feats


def flow_features(hdr: torch.Tensor, out: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """See :func:`flow_features_plain`.  CUDA tensors launch K18
    ``flow_features`` (``csrc/ml.cu``)."""
    if hdr.is_cuda:
        from ..kernels import launch_flow_features

        return launch_flow_features(hdr, out)
    _require_cpu(hdr, "flow_features")
    return flow_features_plain(hdr, out)
