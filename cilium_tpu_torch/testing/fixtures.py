"""Canned worlds: policy sets + ipcache + device state for bench/demo.

A copy of the JAX package's fixtures over this package's modules; the
world's ``state`` lives on ``device`` (None = the card).

The big one mirrors BASELINE.md's "10k-identity L3/L4 CIDR policy set"
config: 10k distinct identities with /32 ipcache entries, a rule set
mixing selector allows, CIDR ranges, port ranges, denies and an L7
redirect, compiled to device tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..identity.allocator import CachingIdentityAllocator
from ..labels import LabelSet
from ..policy import IdentityRowMap, PolicyRepository, compile_policy
from ..policy.compiler import PolicyTensors
from ..policy.resolve import EndpointPolicy
from ..device import resolve_device
from ..datapath.lpm import LPMTensors, compile_lpm
from ..datapath.verdict import DatapathState, build_state


@dataclass
class World:
    state: DatapathState
    policies: List[EndpointPolicy]
    ep_policy: np.ndarray
    row_map: IdentityRowMap
    ipcache: Dict[str, int]  # cidr -> numeric identity
    alloc: CachingIdentityAllocator
    repo: PolicyRepository
    tensors: PolicyTensors
    lpm: LPMTensors
    pod_ips: List[str]
    pod_ips6: List[str] = None  # v6 pods (build_world(n_v6=...))


def _pod_ip(i: int) -> str:
    return f"10.{(i >> 16) & 0xFF}.{(i >> 8) & 0xFF}.{i & 0xFF}"


def world_rules(n_identities: int = 10_000,
                n_rules: int = 64) -> List[dict]:
    """The rule set of :func:`build_world` for the ``db`` endpoint, as
    policy-import dicts."""
    # rule set: each rule allows one "service group" label slice on a
    # port range; every identity matches ns=default so selector slices
    # use app labels
    rules: List[dict] = []
    group = max(n_identities // n_rules, 1)
    for r in range(n_rules):
        ports = [{"port": str(1000 + r * 7), "protocol": "TCP",
                  "endPort": 1000 + r * 7 + 5}]
        sel = {"matchLabels": {"app": f"svc{r * group}"}}
        rules.append({
            "endpointSelector": {"matchLabels": {"app": "db"}},
            "ingress": [
                {"fromEndpoints": [sel], "toPorts": [{"ports": ports}]},
            ],
        })
    rules.append({
        "endpointSelector": {"matchLabels": {"app": "db"}},
        "ingress": [
            # broad: everyone in the namespace may reach 5432/TCP
            {"fromEndpoints": [{"matchLabels": {"ns": "default"}}],
             "toPorts": [{"ports": [{"port": "5432", "protocol": "TCP"}]}]},
            {"fromCIDR": ["192.168.0.0/16"],
             "toPorts": [{"ports": [{"port": "8000", "endPort": 8999}]}]},
            {"fromEndpoints": [{"matchLabels": {"ns": "default"}}],
             "toPorts": [{"ports": [{"port": "80", "protocol": "TCP"}],
                          "rules": {"http": [{"method": "GET"}]}}]},
        ],
        "ingressDeny": [
            {"fromEndpoints": [{"matchLabels": {"app": "svc0"}}],
             "toPorts": [{"ports": [{"port": "22", "protocol": "TCP"}]}]},
        ],
        "egress": [
            {"toEntities": ["world"],
             "toPorts": [{"ports": [{"port": "53", "protocol": "UDP"}]}]},
        ],
    })
    return rules


def build_world(n_identities: int = 10_000, n_rules: int = 64,
                ct_capacity: int = 1 << 20,
                row_capacity: Optional[int] = None,
                n_v6: int = 0, device=None) -> World:
    """The 10k-identity benchmark world (BASELINE.md config #3).

    Identities svc0..svcN-1 get /32 pod IPs; the subject endpoint (a
    "db" workload, ep 0) has ``n_rules`` ingress rules allowing slices
    of the identity space on assorted port ranges, CIDR allows, one
    deny, and one L7 redirect — so the compiled tensors exercise every
    verdict class.
    """
    alloc = CachingIdentityAllocator()
    repo = PolicyRepository(alloc)
    db = LabelSet.parse("k8s:app=db")
    alloc.allocate(db)
    world_id = alloc.allocate(LabelSet.parse("reserved:world")).numeric_id

    pod_ips: List[str] = []
    ipcache: Dict[str, int] = {}
    for i in range(n_identities):
        ident = alloc.allocate(LabelSet.parse(f"k8s:app=svc{i}",
                                              "k8s:ns=default"))
        ip = _pod_ip(i + 256)  # skip 10.0.0.x
        pod_ips.append(ip)
        ipcache[ip + "/32"] = ident.numeric_id
    ipcache["0.0.0.0/0"] = world_id

    # dual-stack pods (the wide-path benchmark's v6 sources): same
    # ns=default label space so the broad 5432 allow admits them
    pod_ips6: List[str] = []
    for i in range(n_v6):
        ident = alloc.allocate(LabelSet.parse(f"k8s:app=v6svc{i}",
                                              "k8s:ns=default"))
        ip6 = f"2001:db8::{i + 1:x}"
        pod_ips6.append(ip6)
        ipcache[ip6 + "/128"] = ident.numeric_id
    if n_v6:
        ipcache["::/0"] = world_id

    repo.add_obj(world_rules(n_identities, n_rules))
    pol_db = repo.resolve(db)

    if row_capacity is None:
        row_capacity = 1
        while row_capacity < n_identities + n_v6 + 64:
            row_capacity *= 2
    row_map = IdentityRowMap(capacity=row_capacity)
    for ident in alloc.all_identities():
        row_map.add(ident.numeric_id)
    policies = [pol_db]
    tensors = compile_policy(policies, row_map)
    lpm = compile_lpm({c: row_map.row(i) for c, i in ipcache.items()})
    ep_policy = np.zeros(4096, dtype=np.int32)  # every ep -> db policy
    state = build_state(tensors, lpm, ep_policy, ct_capacity=ct_capacity,
                        device=resolve_device(device))
    return World(state=state, policies=policies, ep_policy=ep_policy,
                 row_map=row_map, ipcache=ipcache, alloc=alloc, repo=repo,
                 tensors=tensors, lpm=lpm, pod_ips=pod_ips,
                 pod_ips6=pod_ips6)


def steady_flow_pool(world: World, n_flows: int,
                     rng: np.random.Generator,
                     denied_frac: float = 0.02) -> np.ndarray:
    """A bounded pool of flows for steady-state benchmarking.

    Returns [n_flows, N_COLS] header rows (SYN) — replaying the pool
    once establishes every allowed flow in CT; subsequent draws from
    the pool are the established 95%+ of real traffic.  ``denied_frac``
    of flows target a denied port (they re-drop every time, the way
    real scans do)."""
    from ..core.packets import (COL_DPORT, COL_DST_IP3, COL_FAMILY,
                                COL_FLAGS, COL_LEN, COL_PROTO, COL_SPORT,
                                COL_SRC_IP3, N_COLS, TCP_SYN)
    import ipaddress

    out = np.zeros((n_flows, N_COLS), dtype=np.uint32)
    ips = np.array([int(ipaddress.IPv4Address(ip))
                    for ip in world.pod_ips], dtype=np.uint32)
    out[:, COL_SRC_IP3] = rng.choice(ips, n_flows)
    out[:, COL_DST_IP3] = int(ipaddress.IPv4Address(world.pod_ips[0]))
    # sports in a dedicated low range so fresh flows (high range) never
    # collide with pool flows
    out[:, COL_SPORT] = 1024 + rng.integers(0, 30000, n_flows,
                                            dtype=np.uint32)
    # 5432 (allowed for every ns=default pod) + 80 (the L7 redirect);
    # NOT 1007 — its rule admits a single service identity, so random
    # sources would mass-drop and flood the event ring
    allowed = np.array([5432, 5432, 5432, 80, 80], dtype=np.uint32)
    out[:, COL_DPORT] = rng.choice(allowed, n_flows)
    denied = rng.random(n_flows) < denied_frac
    out[:, COL_DPORT] = np.where(denied, 443, out[:, COL_DPORT])
    out[:, COL_PROTO] = 6
    out[:, COL_FLAGS] = TCP_SYN
    out[:, COL_LEN] = rng.integers(60, 1500, n_flows, dtype=np.uint32)
    out[:, COL_FAMILY] = 4
    return out


def steady_traffic(pool: np.ndarray, n: int, rng: np.random.Generator,
                   new_frac: float = 0.05) -> np.ndarray:
    """One steady-state batch: draws from the established flow pool
    (ACK data packets) with ``new_frac`` fresh connections (SYN, sport
    in the high range so they are genuinely new flows)."""
    from ..core.packets import (COL_FLAGS, COL_LEN, COL_SPORT, TCP_ACK,
                                TCP_SYN)

    rows = pool[rng.integers(0, len(pool), n)].copy()
    rows[:, COL_FLAGS] = np.where(rows[:, COL_FLAGS] == TCP_SYN, TCP_ACK,
                                  rows[:, COL_FLAGS])
    rows[:, COL_LEN] = rng.integers(60, 1500, n, dtype=np.uint32)
    fresh = rng.random(n) < new_frac
    rows[:, COL_SPORT] = np.where(
        fresh, 40000 + rng.integers(0, 20000, n, dtype=np.uint32),
        rows[:, COL_SPORT])
    rows[:, COL_FLAGS] = np.where(fresh, TCP_SYN, rows[:, COL_FLAGS])
    return rows


def wide_flow_pool(world: World, n_flows: int, rng: np.random.Generator,
                   v6_frac: float = 0.15) -> np.ndarray:
    """A dual-stack steady pool: ``v6_frac`` of the flows ride IPv6
    sources (``build_world(n_v6=...)`` pods, 128-bit addresses through
    the TCAM LPM) — the wide-path benchmark's flow universe."""
    from ..core.packets import (COL_DST_IP0, COL_FAMILY, COL_SRC_IP0,
                                ip_to_words)

    pool = steady_flow_pool(world, n_flows, rng)
    n6 = int(n_flows * v6_frac)
    if n6 and world.pod_ips6:
        idx = rng.choice(n_flows, n6, replace=False)
        v6w = np.array([ip_to_words(ip) for ip in world.pod_ips6],
                       dtype=np.uint32)
        pick = rng.integers(0, len(v6w), n6)
        cols = np.arange(4)
        pool[idx[:, None], COL_SRC_IP0 + cols] = v6w[pick]
        dst6 = np.asarray(ip_to_words("2001:db8::d:b"), dtype=np.uint32)
        pool[idx[:, None], COL_DST_IP0 + cols] = dst6[None, :]
        pool[idx, COL_FAMILY] = 6
    return pool


def wide_traffic(pool: np.ndarray, n: int, rng: np.random.Generator,
                 related_frac: float = 0.03,
                 new_frac: float = 0.05) -> np.ndarray:
    """One wide-path batch: the steady dual-stack mix plus
    ``related_frac`` ICMP destination-unreachable rows about
    established v4 pool flows (FLAG_RELATED, embedded-tuple semantics —
    the path the packed 16 B format cannot carry)."""
    from ..core.packets import COL_FAMILY, COL_FLAGS, FLAG_RELATED

    rows = steady_traffic(pool, n, rng, new_frac=new_frac)
    nrel = int(n * related_frac)
    if nrel and len(pool):
        # errors about v4 AND v6 flows (the renderer emits ICMPv4 or
        # ICMPv6 per the embedded family)
        pick = rng.integers(0, len(pool), nrel)
        idx = rng.choice(n, nrel, replace=False)
        rows[idx] = pool[pick]
        rows[idx, COL_FLAGS] = FLAG_RELATED
    return rows


def bench_traffic(world: World, n: int, rng: np.random.Generator,
                  new_flow_frac: float = 0.05) -> np.ndarray:
    """Benchmark traffic over the world's pod IPs: steady-state mix of
    established flows + a trickle of new connections (iperf-ish)."""
    from ..core.packets import (COL_DIR, COL_DPORT, COL_DST_IP3, COL_EP,
                                COL_FAMILY, COL_FLAGS, COL_LEN, COL_PROTO,
                                COL_SPORT, COL_SRC_IP3, N_COLS, TCP_ACK,
                                TCP_SYN)
    import ipaddress

    out = np.zeros((n, N_COLS), dtype=np.uint32)
    ips = np.array([int(ipaddress.IPv4Address(ip))
                    for ip in world.pod_ips], dtype=np.uint32)
    src = rng.choice(ips, n)
    dst_db = int(ipaddress.IPv4Address(world.pod_ips[0]))
    out[:, COL_SRC_IP3] = src
    out[:, COL_DST_IP3] = dst_db
    out[:, COL_SPORT] = rng.integers(1024, 61000, n, dtype=np.uint32)
    out[:, COL_DPORT] = rng.choice(
        np.array([5432, 5432, 80, 1007, 443, 8080], dtype=np.uint32), n)
    out[:, COL_PROTO] = 6
    is_new = rng.random(n) < new_flow_frac
    out[:, COL_FLAGS] = np.where(is_new, TCP_SYN, TCP_ACK)
    out[:, COL_LEN] = rng.integers(60, 1500, n, dtype=np.uint32)
    out[:, COL_FAMILY] = 4
    out[:, COL_EP] = 0
    out[:, COL_DIR] = 0
    return out


def ct_round_table(key: np.ndarray, settle_round: Optional[int],
                   capacity: int, now: int, rng: np.random.Generator
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """A CT table [capacity, ROW_WORDS] and its fingerprints built around
    one new flow's forward ``key`` (10 u32 words, not in the table), so
    that ``ct_update`` settles its insert in insert round
    ``settle_round``: 0-3 are its candidate rounds (the first free or
    same-fingerprint slots of its window, in window order), 4-19 the
    window's positions 0-15; None leaves it pending after the last round
    (a dropped insert).  The other entries are live flows of other keys
    (unclaimable) and, for rounds 4-19, one expired entry whose
    fingerprint differs from the key's (claimable, never a candidate).
    -> (table, fp), uint32."""
    from ..datapath.conntrack import (KEY_WORDS, N_CAND_INS, N_PROBE,
                                      ROW_WORDS, ST_ESTABLISHED, V_EXPIRES,
                                      V_STATE, _fp_mix_np, _hash_np)

    h = int(_hash_np(key[None])[0])
    kfp = int(_fp_mix_np(np.array([h], np.uint32))[0])
    others = rng.integers(0, 1 << 32, (1 << 14, KEY_WORDS),
                          dtype=np.uint64).astype(np.uint32)
    ofp = _fp_mix_np(_hash_np(others))
    same, diff, dfp = others[ofp == kfp], others[ofp != kfp], ofp[ofp != kfp]
    table = np.zeros((capacity, ROW_WORDS), np.uint32)
    fp = np.zeros(capacity, np.uint32)

    def put(pos, k, f, live):
        s = (h + pos) & (capacity - 1)
        table[s, :KEY_WORDS] = k
        table[s, V_STATE] = ST_ESTABLISHED
        table[s, V_EXPIRES] = now + 100 if live else now - 1
        fp[s] = f

    if settle_round is not None and settle_round < N_CAND_INS:
        # candidates 0..r-1 hold live flows of the key's fingerprint;
        # window position r stays free: candidate r
        for pos in range(settle_round):
            put(pos, same[pos], kfp, True)
        return table, fp
    # no candidate in the window; position r - 4 expired (claimable)
    last = N_PROBE if settle_round is None else settle_round - N_CAND_INS
    for pos in range(N_PROBE):
        put(pos, diff[pos], dfp[pos], pos != last)
    return table, fp
