"""Seeded inputs for the egress stages' kernels (K11-K14).

Wide header rows ``[N, N_COLS]`` u32 that drive every branch of
``snat_egress``, ``snat_reverse``, ``masq_rewrite`` and ``bw_stage``:
pods to the world and inside the cluster, v6, ICMP, SCTP, ingress rows,
repeats of one flow in a batch, flows crafted to hash into one claim
window, replies to allocated node ports (and to the wrong IP, with a
forged protocol word), and inbound connections whose reverse CT entries
make the pods' replies keep their source (also behind crowds of entries
of their fingerprint, and in windows that wrap the table's end).
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` feed the same rows to
a kernel and to its plain version.
"""

from __future__ import annotations

import ipaddress
from typing import Sequence, Tuple

import numpy as np

from ..core.packets import (COL_DIR, COL_DPORT, COL_DST_IP3, COL_EP,
                            COL_FAMILY, COL_FLAGS, COL_LEN, COL_PROTO,
                            COL_SPORT, COL_SRC_IP3, N_COLS, TCP_ACK, TCP_SYN)
from ..service.nat import NAT_PORT_MIN, _nat_hash_py

NODE_IP = "192.168.0.1"
EGRESS_IP = "192.168.9.9"
EGRESS_IP2 = "192.168.9.10"
WORLD = ("8.8.8.8", "8.8.4.4", "93.184.0.7", "198.51.100.9", "1.2.3.4")
CLUSTER = ("10.0.1.1", "10.9.0.3")


def ip(s: str) -> int:
    return int(ipaddress.IPv4Address(s))


def pod_ips(n: int) -> np.ndarray:
    """n pod addresses in 10.0.0.0/8 from 10.1.0.1."""
    return (ip("10.1.0.1") + np.arange(n)).astype(np.uint32)


def gateway_rules(pods: np.ndarray, n: int = 64,
                  dst: str = "93.184.0.0/16") -> Tuple:
    """An egress-gateway rule table as the daemon compiles one policy
    over ``n`` pods (one rule a pod, ``pods[:n]`` toward ``dst`` through
    EGRESS_IP), between two rules through EGRESS_IP2 that overlap it: a
    /32 for ``pods[7]`` ahead of it, which wins that pod's rows to
    93.184.0.7, and a /24 for ``pods[5]`` behind it, which never wins.
    Taking the last match instead of the first shows in the rewrite."""
    def addr(a):
        return str(ipaddress.IPv4Address(int(a)))

    return ((addr(pods[7]), "93.184.0.7/32", EGRESS_IP2),
            *((addr(p), dst, EGRESS_IP) for p in pods[:n]),
            (addr(pods[5]), "93.184.0.0/24", EGRESS_IP2))


def egress_rows(rng: np.random.Generator, n: int, pods: np.ndarray,
                sports: int = 4096, dup_frac: float = 0.1) -> np.ndarray:
    """Mixed rows: pods to the world (most), to the cluster and to v6,
    ingress rows, TCP/UDP/SCTP/ICMP, and a ``dup_frac`` share repeating
    earlier rows of the same batch."""
    rows = np.zeros((n, N_COLS), np.uint32)
    rows[:, COL_SRC_IP3] = rng.choice(pods, n)
    dsts = np.array([ip(x) for x in WORLD * 3 + CLUSTER], np.uint32)
    rows[:, COL_DST_IP3] = rng.choice(dsts, n)
    rows[:, COL_SPORT] = 20000 + rng.integers(0, sports, n)
    rows[:, COL_DPORT] = rng.choice(np.array([53, 443, 80], np.uint32), n)
    rows[:, COL_PROTO] = rng.choice(np.array([6, 6, 17, 17, 1, 132],
                                             np.uint32), n)
    rows[:, COL_FLAGS] = TCP_SYN
    rows[:, COL_LEN] = rng.integers(60, 1500, n)
    rows[:, COL_FAMILY] = rng.choice(np.array([4] * 19 + [6], np.uint32), n)
    rows[:, COL_EP] = rng.integers(1, 64, n)
    rows[:, COL_DIR] = rng.random(n) < 0.9
    dup = np.flatnonzero(rng.random(n) < dup_frac)
    dup = dup[dup > 0]
    rows[dup] = rows[rng.integers(0, dup)]
    return rows


def colliding_rows(n: int, cap: int, home: int, dst: str = "8.8.8.8",
                   dport: int = 53, proto: int = 17) -> np.ndarray:
    """n egress flows from distinct pods whose tuple hashes all land on
    slot ``home`` of a ``cap``-slot pool: one claim window for all."""
    mask = cap - 1
    dp = (dport << 8) | proto
    rows = np.zeros((n, N_COLS), np.uint32)
    src, sport, k = ip("10.2.0.1"), 1024, 0
    while k < n:
        if (_nat_hash_py((src, sport, ip(dst), dp)) & mask) == home:
            rows[k, COL_SRC_IP3], rows[k, COL_SPORT] = src, sport
            k += 1
            src += 1
        sport = sport + 1 if sport < 65535 else 1024
    rows[:, COL_DST_IP3] = ip(dst)
    rows[:, COL_DPORT], rows[:, COL_PROTO] = dport, proto
    rows[:, COL_FAMILY], rows[:, COL_DIR], rows[:, COL_EP] = 4, 1, 1
    rows[:, COL_LEN] = 100
    return rows


def inbound_pairs(rng: np.random.Generator, n: int, pods: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(inbound, replies): n connections from the world into pods on
    port 80, and the pods' egress replies to them."""
    inbound = np.zeros((n, N_COLS), np.uint32)
    inbound[:, COL_SRC_IP3] = rng.choice(
        np.array([ip(x) for x in WORLD], np.uint32), n)
    inbound[:, COL_DST_IP3] = rng.choice(pods, n)
    inbound[:, COL_SPORT] = rng.integers(1024, 65535, n)
    inbound[:, COL_DPORT], inbound[:, COL_PROTO] = 80, 6
    inbound[:, COL_FLAGS], inbound[:, COL_FAMILY] = TCP_SYN, 4
    inbound[:, COL_LEN] = 60
    return inbound, replies_to(inbound)


def replies_to(inbound: np.ndarray) -> np.ndarray:
    """The pods' egress replies to ``inbound`` connections (port 80):
    each reply's reverse CT key is its connection's forward key."""
    replies = inbound.copy()
    replies[:, COL_SRC_IP3] = inbound[:, COL_DST_IP3]
    replies[:, COL_DST_IP3] = inbound[:, COL_SRC_IP3]
    replies[:, COL_SPORT] = 80
    replies[:, COL_DPORT] = inbound[:, COL_SPORT]
    replies[:, COL_FLAGS], replies[:, COL_DIR] = TCP_ACK, 1
    return replies


def _forward_keys(rows: np.ndarray) -> np.ndarray:
    """[N, KEY_WORDS] forward CT keys of header rows."""
    from .. import u32
    from ..datapath import conntrack as ct

    return u32.to_numpy(ct.ct_keys_from_headers(u32.from_numpy(rows,
                                                               "cpu"))[0])


def wrap_inbound(rng: np.random.Generator, n: int, pods: np.ndarray,
                 capacity: int) -> np.ndarray:
    """n inbound connections from the world into ``pods`` on port 80
    whose forward key homes in the last N_PROBE - 1 slots of a
    ``capacity``-slot CT, so that its probe window wraps the table's
    end (the remote ports searched, a (remote, pod) pair at a time)."""
    from ..datapath.conntrack import N_PROBE, _hash_np

    world = np.array([ip(x) for x in WORLD], np.uint32)
    found, got = [], 0
    while got < n:
        rows = np.zeros((64512, N_COLS), np.uint32)
        rows[:, COL_SRC_IP3] = rng.choice(world)
        rows[:, COL_DST_IP3] = rng.choice(pods)
        rows[:, COL_SPORT] = np.arange(1024, 65536, dtype=np.uint32)
        rows[:, COL_DPORT], rows[:, COL_PROTO] = 80, 6
        rows[:, COL_FLAGS], rows[:, COL_FAMILY] = TCP_SYN, 4
        rows[:, COL_LEN] = 60
        home = _hash_np(_forward_keys(rows)) & np.uint32(capacity - 1)
        rows = rows[home >= capacity - (N_PROBE - 1)]
        found.append(rows)
        got += len(rows)
    return np.concatenate(found)[:n]


def crowded_ct(rng: np.random.Generator, inbound: np.ndarray, now: int,
               capacity: int, crowded: float = 0.75
               ) -> Tuple[np.ndarray, np.ndarray]:
    """A CT table (table, fingerprints) of ``capacity`` slots whose
    windows the ``inbound`` connections' forward keys crowd.  Each key
    in turn takes the free slots of its window in window order: a
    ``crowded`` share first fill N_CAND + 1 to N_PROBE - 2 of them with
    live entries of other keys that share its fingerprint (a probe
    filtered by fingerprint then passes its candidate budget), then
    hold the key live, expired (now - 1) or not at all, a third each;
    the rest hold it live, or expired one time in four.  A key whose
    window has too few free slots left is not placed.  Every slot keeps
    the invariant the kernels' probes rest on: its fingerprint is
    nonzero, and its key's, exactly where its state is not ST_FREE."""
    from ..datapath.conntrack import (KEY_WORDS, N_CAND, N_PROBE,
                                      ROW_WORDS, ST_ESTABLISHED, V_EXPIRES,
                                      V_STATE, _fp_mix_np, _hash_np)

    keys = _forward_keys(inbound)
    h = _hash_np(keys)
    kfp = _fp_mix_np(h)
    others = rng.integers(0, 1 << 32, (1 << 16, KEY_WORDS),
                          dtype=np.uint64).astype(np.uint32)
    ofp = _fp_mix_np(_hash_np(others))
    table = np.zeros((capacity, ROW_WORDS), np.uint32)
    fp = np.zeros(capacity, np.uint32)

    def put(s, key, f, expires):
        table[s, :KEY_WORDS] = key
        table[s, V_STATE] = ST_ESTABLISHED
        table[s, V_EXPIRES] = expires & 0xFFFFFFFF
        fp[s] = f

    live, dead = now + 1000, now - 1
    for j in range(len(keys)):
        win = (h[j] + np.arange(N_PROBE, dtype=np.uint32)) & np.uint32(
            capacity - 1)
        free = win[fp[win] == 0]
        crowd = rng.random() < crowded
        c = int(rng.integers(N_CAND + 1, N_PROBE - 1)) if crowd else 0
        if len(free) < c + 1:
            continue
        same = others[ofp == kfp[j]]
        for q in range(c):
            put(free[q], same[rng.integers(len(same))], kfp[j], live)
        kind = int(rng.integers(3)) if crowd else int(rng.random() < 0.25)
        if kind < 2:
            put(free[c], keys[j], kfp[j], dead if kind else live)
    return table, fp


def reply_rows(rng: np.random.Generator, out: np.ndarray, n: int,
               ips: Sequence[str] = (NODE_IP, EGRESS_IP, EGRESS_IP2)
               ) -> np.ndarray:
    """n ingress replies to the node ports in ``out`` (snat_egress's
    rewritten rows), with misses mixed in: a wrong destination IP, a
    wrong peer, ports below the pool, and forged protocol words that
    alias a TCP slot's low byte."""
    pool = np.flatnonzero((out[:, COL_SPORT] >= NAT_PORT_MIN)
                          & (out[:, COL_DIR] == 1))
    sel = out[rng.choice(pool, n)] if len(pool) else out[:n].copy()
    rows = sel.copy()
    rows[:, COL_SRC_IP3], rows[:, COL_DST_IP3] = (sel[:, COL_DST_IP3],
                                                  sel[:, COL_SRC_IP3])
    rows[:, COL_SPORT], rows[:, COL_DPORT] = (sel[:, COL_DPORT],
                                              sel[:, COL_SPORT])
    rows[:, COL_FLAGS], rows[:, COL_DIR] = TCP_ACK, 0
    k = rng.random(n)
    wrong_ip = k < 0.05
    rows[wrong_ip, COL_DST_IP3] = rng.choice(
        np.array([ip(x) for x in ips] + [ip("192.168.0.2")], np.uint32),
        int(wrong_ip.sum()))
    rows[(k >= 0.05) & (k < 0.08), COL_SRC_IP3] = ip("9.9.9.9")
    rows[(k >= 0.08) & (k < 0.1), COL_DPORT] = 1000
    forged = (k >= 0.1) & (k < 0.12) & (rows[:, COL_PROTO] == 6)
    rows[forged, COL_PROTO] = 6 | 0x100
    rows[forged, COL_SPORT] &= ~np.uint32(1)
    return rows


def bw_rows(rng: np.random.Generator, n: int, eps: Sequence[int],
            length: Tuple[int, int] = (60, 1500)) -> np.ndarray:
    """Rows of the given endpoints (limited or not, some beyond
    MAX_ENDPOINTS), 80% egress, with flows repeating within the
    batch."""
    rows = np.zeros((n, N_COLS), np.uint32)
    rows[:, COL_SRC_IP3] = ip("10.0.0.0") + rng.integers(1, 4096, n)
    rows[:, COL_SPORT] = rng.integers(1024, 1024 + n // 2, n)
    rows[:, COL_PROTO], rows[:, COL_FAMILY] = 6, 4
    rows[:, COL_LEN] = rng.integers(length[0], length[1], n)
    rows[:, COL_EP] = rng.choice(np.asarray(eps, np.uint32), n)
    rows[:, COL_DIR] = rng.random(n) < 0.8
    return rows


def inbound_ct(inbound: np.ndarray, now: int, capacity: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """A CT table (table, fingerprints) of ``capacity`` slots holding the
    forward entries of the ``inbound`` rows, established and live until
    ``now + 1000``."""
    from ..datapath import conntrack as ct

    rows = np.zeros((len(inbound), ct.ROW_WORDS), np.uint32)
    rows[:, :ct.KEY_WORDS] = _forward_keys(inbound)
    rows[:, ct.V_STATE] = ct.ST_ESTABLISHED
    rows[:, ct.V_EXPIRES] = (now + 1000) & 0xFFFFFFFF
    table, _dropped = ct.ct_table_from_rows(rows, capacity)
    return table, ct.ct_fp_from_table(table)
