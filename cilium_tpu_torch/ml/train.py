"""Training data: synthetic labeled traffic and the AUC.

The host half of the JAX package's ``ml/train.py``: the attack
taxonomy, ``synth_labeled_traffic`` (port scans, volumetric floods and
exfiltration against the benign steady-state mix of
``testing.fixtures.bench_traffic``, with hard negatives) and ``auc``.
The training step (``bce_loss``, ``make_train_step``, ``train``) needs
backward kernels and comes with the training slice (ROADMAP A11b, B16b).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core.packets import (
    COL_DIR,
    COL_DPORT,
    COL_DST_IP3,
    COL_FLAGS,
    COL_LEN,
    COL_PROTO,
    COL_SRC_IP3,
    TCP_ACK,
    TCP_SYN,
)

ATTACK_KINDS = {0: "portscan", 1: "flood", 2: "exfil"}


def synth_labeled_traffic(world, n: int, rng: np.random.Generator,
                          attack_frac: float = 0.25,
                          kinds: Tuple[int, ...] = (0, 1, 2),
                          hard_negatives: bool = True,
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (hdr [n, N_COLS] uint32, labels [n] float32 1=attack).

    ``kinds`` restricts which attack kinds appear (held-out-kind
    evaluation trains on a subset and tests generalization on the
    rest).  ``hard_negatives`` injects BENIGN traffic that resembles
    attacks along single features — reconnect storms (SYN bursts to a
    real service) and bulk transfers (MTU-size pushes on a well-known
    port) — so separability must come from feature conjunctions, not
    one trivial column."""
    import ipaddress

    from ..testing.fixtures import bench_traffic

    hdr = bench_traffic(world, n, rng)
    labels = np.zeros(n, dtype=np.float32)
    n_attack = int(n * attack_frac)
    idx = rng.choice(n, n_attack, replace=False)
    kind_of = rng.choice(np.asarray(kinds, dtype=np.int64), n_attack)
    ips = np.array([int(ipaddress.IPv4Address(ip))
                    for ip in world.pod_ips], dtype=np.uint32)
    scanner = ips[0]
    victim = ips[1]
    for i, kind in zip(idx, kind_of):
        labels[i] = 1.0
        if kind == 0:  # port scan: tiny SYNs sweeping the port space
            hdr[i, COL_SRC_IP3] = rng.choice(ips[:8])  # several scanners
            hdr[i, COL_DPORT] = rng.integers(1, 65535)
            hdr[i, COL_FLAGS] = TCP_SYN
            hdr[i, COL_LEN] = rng.integers(40, 60)
            hdr[i, COL_PROTO] = 6
        elif kind == 1:  # flood: spoofed sources hammering one service
            hdr[i, COL_SRC_IP3] = rng.choice(ips)
            hdr[i, COL_DST_IP3] = victim
            hdr[i, COL_DPORT] = 80
            hdr[i, COL_FLAGS] = TCP_SYN
            hdr[i, COL_LEN] = rng.integers(40, 60)
            hdr[i, COL_PROTO] = 6
        else:  # exfiltration: huge egress pushes to odd ports
            hdr[i, COL_DIR] = 1
            hdr[i, COL_DPORT] = rng.integers(20000, 65000)
            hdr[i, COL_FLAGS] = TCP_ACK | 0x08  # PSH|ACK
            hdr[i, COL_LEN] = rng.integers(1400, 1500)
            hdr[i, COL_PROTO] = 6
    if hard_negatives:
        # benign rows that share single attack features
        benign = np.nonzero(labels == 0)[0]
        n_hard = len(benign) // 5
        hard = rng.choice(benign, n_hard, replace=False)
        half = n_hard // 2
        # reconnect storm: SYNs to a real service port, normal sizes
        storm = hard[:half]
        hdr[storm, COL_DPORT] = 5432
        hdr[storm, COL_FLAGS] = TCP_SYN
        hdr[storm, COL_LEN] = rng.integers(52, 80, len(storm))
        # bulk transfer: MTU-size PSH|ACK egress on a well-known port
        bulk = hard[half:]
        hdr[bulk, COL_DIR] = 1
        hdr[bulk, COL_DPORT] = 443
        hdr[bulk, COL_FLAGS] = TCP_ACK | 0x08
        hdr[bulk, COL_LEN] = rng.integers(1400, 1500, len(bulk))
    return hdr, labels


def auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """ROC AUC by rank statistic (no sklearn dependency)."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels)
    pos = scores[labels > 0.5]
    neg = scores[labels <= 0.5]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    order = np.argsort(np.concatenate([pos, neg]), kind="mergesort")
    ranks = np.empty(len(order), dtype=np.float64)
    ranks[order] = np.arange(1, len(order) + 1)
    # average ties
    allscores = np.concatenate([pos, neg])
    sorted_scores = allscores[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and \
                sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    r_pos = ranks[:len(pos)].sum()
    n_pos, n_neg = len(pos), len(neg)
    return float((r_pos - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
