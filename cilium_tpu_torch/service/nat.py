"""NAT: egress masquerade (SNAT) with per-node port allocation.

Reference: the JAX package's ``service/nat.py`` (itself upstream
``bpf/lib/nat.h`` + ``pkg/maps/nat``).  The port pool IS the table
index: one ``[P, 6]`` u32 table whose slot ``s`` owns node port
``NAT_PORT_MIN + s``.

- egress allocation (:func:`snat_egress`): a CT-style
  write-then-verify claim over an 8-slot window from the tuple hash;
  each claimed slot is a unique node port.  Rows whose reverse CT
  entry exists reply to an inbound connection and keep their source;
  pool exhaustion drops the row (``REASON_NAT_EXHAUSTED`` in the
  datapath step) and counts in ``NATTable.failed``;
- reverse translation on ingress (:func:`snat_reverse`): one gather,
  ``dport - NAT_PORT_MIN`` indexes the table;
- the stateless rewrite (:func:`snat_stage`) without allocation.

Each function sends CUDA tensors to its kernel (``csrc/nat.cu``: K11
``snat_egress``, K12 ``snat_reverse``, K14 ``masq_rewrite``) and CPU
tensors to its ``*_plain`` version.  Tables update in place; u32 words
are int32 bit patterns (``u32.py``), and the plain versions compute in
int64 over ``[0, 2^32)`` so every compare is unsigned.
"""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.packets import (
    COL_DIR,
    COL_DPORT,
    COL_DST_IP3,
    COL_FAMILY,
    COL_PROTO,
    COL_SPORT,
    COL_SRC_IP3,
)
from ..datapath.conntrack import (_first_true, _probe, _require_cpu,
                                  ct_keys_from_headers)
from ..device import resolve_device
from ..u32 import MASK, from_numpy, mul, narrow, widen

# a free claim word of the kernels' write-then-verify rounds
CLAIM_FREE = 0x7FFFFFFF


@dataclass
class NATConfig:
    """Masquerade configuration (node-level).

    ``egress_rules`` is the egress-gateway policy table (reference:
    CiliumEgressGatewayPolicy): (source pod IP, destination CIDR,
    egress IP) triples.  A matching row SNATs via its egress IP, even
    toward destinations the non-masquerade list would exempt."""

    node_ip: str
    # destinations inside these ranges keep the original source
    # (cluster-internal traffic; ipMasqAgent nonMasqueradeCIDRs)
    non_masquerade_cidrs: Tuple[str, ...] = ("10.0.0.0/8",)
    enabled: bool = True
    egress_rules: Tuple[Tuple[str, str, str], ...] = ()

    def compile(self, device=None) -> "NATTensors":
        """-> :class:`NATTensors` on ``device`` (None: the card)."""
        nets = [ipaddress.ip_network(c) for c in self.non_masquerade_cidrs]
        nets = [n for n in nets if n.version == 4]
        k = max(len(nets), 1)
        # an EMPTY exclusion list must match nothing ("masquerade
        # everything"): pad with an unsatisfiable row (dst & 0 ==
        # 0xFFFFFFFF), never a zero row, which matches every address
        net = np.full(k, 0xFFFFFFFF, dtype=np.uint32)
        mask = np.zeros(k, dtype=np.uint32)
        for i, n in enumerate(nets):
            net[i] = int(n.network_address)
            mask[i] = int(n.netmask)
        # egress-gateway table, padded with one unsatisfiable row
        # (src 0 never appears on the wire as a pod source)
        g = max(len(self.egress_rules), 1)
        g_src = np.zeros(g, dtype=np.uint32)
        g_net = np.full(g, 0xFFFFFFFF, dtype=np.uint32)
        g_mask = np.zeros(g, dtype=np.uint32)
        g_ip = np.zeros(g, dtype=np.uint32)
        for i, (src_ip, dst_cidr, eip) in enumerate(self.egress_rules):
            n4 = ipaddress.ip_network(dst_cidr)
            g_src[i] = int(ipaddress.IPv4Address(src_ip))
            g_net[i] = int(n4.network_address)
            g_mask[i] = int(n4.netmask)
            g_ip[i] = int(ipaddress.IPv4Address(eip))
        return NATTensors.from_numpy(
            int(ipaddress.IPv4Address(self.node_ip)), net, mask, g_src,
            g_net, g_mask, g_ip, self.enabled, device)


@dataclass
class NATTensors:
    node_ip: int  # u32 value
    net: torch.Tensor  # [K] non-masquerade networks
    mask: torch.Tensor  # [K]
    egw_src: torch.Tensor  # [G] egress-gateway source pod IPs
    egw_net: torch.Tensor  # [G] destination networks
    egw_mask: torch.Tensor  # [G]
    egw_ip: torch.Tensor  # [G] egress IPs
    enabled: bool

    @staticmethod
    def from_numpy(node_ip, net, mask, egw_src, egw_net, egw_mask, egw_ip,
                   enabled=True, device=None) -> "NATTensors":
        """u32 numpy arrays (the JAX package's leaves) -> tensors on
        ``device`` (None: the card)."""
        device = resolve_device(device)
        return NATTensors(
            node_ip=int(node_ip) & MASK,
            **{k: from_numpy(v, device) for k, v in (
                ("net", net), ("mask", mask), ("egw_src", egw_src),
                ("egw_net", egw_net), ("egw_mask", egw_mask),
                ("egw_ip", egw_ip))},
            enabled=bool(enabled))


# --- the NAT table (per-node port pool) ------------------------------

NAT_PORT_MIN = 32768  # pool = [NAT_PORT_MIN, NAT_PORT_MIN + capacity)
NAT_PROBE = 8  # claim window (linear probes from the tuple hash)
NAT_DEFAULT_CAPACITY = 1 << 14

# NAT entry lifetimes track conntrack's: a mapping that expired under a
# live CT entry would re-port an idle established connection.
# Refreshed on every use in either direction.
NAT_LIFETIME_TCP = 21600  # == conntrack.LIFETIME_TCP
NAT_LIFETIME_NONTCP = 180  # >= conntrack.LIFETIME_NONTCP (60)


def _nat_hash_py(key) -> int:
    """Host FNV-1a identical to :func:`_nat_hash` and to the kernels'
    ``nat_hash``."""
    h = 0x811C9DC5
    for w in key:
        h = ((h ^ (w & 0xFFFFFFFF)) * 0x01000193) & 0xFFFFFFFF
    return h


NAT_ROW_WORDS = 6
NV_SRC = 0  # original source IP
NV_SPORT = 1  # original source port
NV_DST = 2  # destination IP
NV_DP = 3  # dport << 8 | proto
NV_EXPIRES = 4
NV_SNAT_IP = 5  # the IP this mapping rewrote to (0: node_ip)


@dataclass
class NATTable:
    """Slot ``s`` <=> node port ``NAT_PORT_MIN + s``."""

    table: torch.Tensor  # [P, NAT_ROW_WORDS] int32 (u32 words)
    failed: torch.Tensor  # [] int32 (u32): allocation failures
    # [3, P] int32: the kernels' claim words (K11's steps take the three
    # rows in turn, K12 the first), CLAIM_FREE between calls (not part of
    # the state; the plain versions ignore them); made with every table,
    # a copy may share them
    claim: Optional[torch.Tensor] = field(default=None, repr=False,
                                          compare=False)

    def __post_init__(self):
        if self.claim is None:
            self.claim = torch.full((3, self.table.shape[0]), CLAIM_FREE,
                                    dtype=torch.int32,
                                    device=self.table.device)

    @staticmethod
    def create(capacity: int = NAT_DEFAULT_CAPACITY,
               device=None) -> "NATTable":
        if capacity & (capacity - 1):
            raise ValueError("NAT capacity must be a power of two")
        if NAT_PORT_MIN + capacity > 65536:
            raise ValueError("NAT pool exceeds the port space")
        device = resolve_device(device)
        return NATTable(
            table=torch.zeros((capacity, NAT_ROW_WORDS), dtype=torch.int32,
                              device=device),
            failed=torch.zeros((), dtype=torch.int32, device=device))

    @property
    def capacity(self) -> int:
        return self.table.shape[0]


def nat_entries_from_snapshot(table: np.ndarray,
                              limit: int = 1000) -> list:
    """Decode live NAT slots for display (``cilium bpf nat list``):
    original tuple -> allocated node port (= NAT_PORT_MIN + slot)."""
    table = np.asarray(table)
    live = np.nonzero(table[:, NV_EXPIRES] > 0)[0][:limit]
    out = []
    for s in live:
        row = table[s]
        out.append({
            "node_port": int(NAT_PORT_MIN + s),
            "src": str(ipaddress.IPv4Address(int(row[NV_SRC]))),
            "sport": int(row[NV_SPORT]),
            "dst": str(ipaddress.IPv4Address(int(row[NV_DST]))),
            "dport": int(row[NV_DP]) >> 8,
            "proto": int(row[NV_DP]) & 0xFF,
            "expires": int(row[NV_EXPIRES]),
        })
    return out


def nat_live_count(tbl: NATTable, now: int) -> int:
    """Slots whose mapping has not expired at ``now`` (u32 compare)."""
    return int((widen(tbl.table[:, NV_EXPIRES]) >= (int(now) & MASK)).sum())


def _nat_hash(key: torch.Tensor) -> torch.Tensor:
    """FNV-1a over [N, 4] widened key words -> [N] int64 in [0, 2^32)."""
    h = torch.full((key.shape[0],), 0x811C9DC5, dtype=torch.int64,
                   device=key.device)
    for w in range(4):
        h = mul(h ^ key[:, w], 0x01000193)
    return h


def _lifetime(proto: torch.Tensor) -> torch.Tensor:
    return torch.where(proto == 6, NAT_LIFETIME_TCP, NAT_LIFETIME_NONTCP)


def _in_nets(addr: torch.Tensor, net: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """[N] widened addresses inside any of the [K] (net, mask) pairs."""
    return ((addr[:, None] & widen(mask)[None, :])
            == widen(net)[None, :]).any(dim=1)


def _reverse_ct_found(ct, hdr: torch.Tensor, now: int) -> torch.Tensor:
    """[N] bool: the row's reverse CT entry is live (the row replies to
    a connection a remote opened INTO the node)."""
    _fwd, rev = ct_keys_from_headers(hdr)
    return _probe(ct.table, rev, now)[0]


def snat_egress_plain(tbl: NATTable, t: NATTensors, ct, hdr: torch.Tensor,
                      now: int
                      ) -> Tuple[torch.Tensor, NATTable, torch.Tensor]:
    """Egress masquerade with port allocation (plain version): ->
    (rewritten rows, ``tbl`` updated in place, [N] bool drop mask).

    Port-bearing egress-to-world rows (TCP, UDP, SCTP) claim a slot;
    a live mapping of the same tuple anywhere in the window is reused
    and refreshed (scanned first, so an expired earlier slot never
    re-ports a live flow), keeping the IP it was made with.  The claim
    runs ``NAT_PROBE`` steps; per step a contended slot goes to the
    LOWEST batch row, and same-tuple losers adopt the winner's slot
    when they read it back.  Rows whose window holds no claimable slot
    drop and count in ``tbl.failed``."""
    now = int(now) & MASK
    if not t.enabled:
        return hdr, tbl, torch.zeros(hdr.shape[0], dtype=torch.bool,
                                     device=hdr.device)
    dev = hdr.device
    h = widen(hdr)
    src, dst = h[:, COL_SRC_IP3], h[:, COL_DST_IP3]
    sport, dport, proto = h[:, COL_SPORT], h[:, COL_DPORT], h[:, COL_PROTO]
    internal = _in_nets(dst, t.net, t.mask)
    egress = h[:, COL_DIR] == 1
    v4 = h[:, COL_FAMILY] == 4
    r_found = _reverse_ct_found(ct, hdr, now)
    # egress gateway: the first (source pod, destination CIDR) rule
    g_hit = ((src[:, None] == widen(t.egw_src)[None, :])
             & ((dst[:, None] & widen(t.egw_mask)[None, :])
                == widen(t.egw_net)[None, :]))
    gw = g_hit.any(dim=1)
    rewrite_ip = torch.where(gw, widen(t.egw_ip)[_first_true(g_hit)],
                             t.node_ip)
    masq = egress & v4 & (~internal | gw) & ~r_found
    portful = (proto == 6) | (proto == 17) | (proto == 132)
    need = masq & portful

    dp = ((dport << 8) | proto) & MASK
    key = torch.stack([src, sport, dst, dp], dim=1)
    hh = _nat_hash(key)
    expires = (now + _lifetime(proto)) & MASK
    table = widen(tbl.table)
    p = table.shape[0]
    n = hdr.shape[0]

    def key_match(rows):  # [..., NAT_ROW_WORDS] against the row's key
        return (rows[..., :NV_EXPIRES] == key.view(
            (n,) + (1,) * (rows.dim() - 2) + (4,))).all(dim=-1)

    # phase 1: the whole window for a live same-tuple mapping
    win = (hh[:, None] + torch.arange(NAT_PROBE, device=dev)) & (p - 1)
    wrows = table[win]
    live_same = (wrows[..., NV_EXPIRES] >= now) & key_match(wrows)
    have_match = live_same.any(dim=1)
    mslot = torch.gather(win, 1, _first_true(live_same)[:, None])[:, 0]
    stored_ip = table[mslot, NV_SNAT_IP]
    stored_ip = torch.where(stored_ip != 0, stored_ip, t.node_ip)
    rewrite_ip = torch.where(have_match & need, stored_ip, rewrite_ip)
    new_row = torch.stack([src, sport, dst, dp, expires, rewrite_ip], dim=1)
    # refresh (duplicate rows of one flow write the same row)
    refresh = need & have_match
    table[mslot[refresh]] = new_row[refresh]

    # phase 2: the claim loop
    pending = need & ~have_match
    final_slot = torch.where(have_match, mslot, 0)
    ridx = torch.arange(n, device=dev)
    for step in range(NAT_PROBE):
        s = (hh + step) & (p - 1)
        stored = table[s]
        claimable = (stored[:, NV_EXPIRES] < now) | key_match(stored)
        trying = pending & claimable
        owner = torch.full((p,), n, dtype=torch.int64,
                           device=dev).scatter_reduce_(
            0, s[trying], ridx[trying], "amin")
        writer = trying & (owner[s] == ridx)
        table[s[writer]] = new_row[writer]
        won = trying & key_match(table[s])
        final_slot = torch.where(won, s, final_slot)
        pending = pending & ~won

    allocated = need & ~pending
    dropped = need & pending
    out = h.clone()
    out[:, COL_SRC_IP3] = torch.where(masq, rewrite_ip, src)
    out[:, COL_SPORT] = torch.where(allocated, NAT_PORT_MIN + final_slot,
                                    sport)
    tbl.table.copy_(narrow(table))
    tbl.failed.copy_(narrow(widen(tbl.failed) + dropped.sum()))
    return narrow(out), tbl, dropped


def snat_egress(tbl: NATTable, t: NATTensors, ct, hdr: torch.Tensor,
                now: int) -> Tuple[torch.Tensor, NATTable, torch.Tensor]:
    """Egress masquerade with port allocation: see
    :func:`snat_egress_plain`.  CUDA tensors launch K11 (``csrc/nat.cu``),
    reading ``ct`` as it stands on the stream."""
    if hdr.is_cuda and t.enabled:
        from ..kernels import launch_snat_egress

        return launch_snat_egress(tbl, t, ct, hdr, now)
    if not hdr.is_cuda:
        _require_cpu(hdr, "snat_egress")
    return snat_egress_plain(tbl, t, ct, hdr, now)


def snat_reverse_plain(tbl: NATTable, t: NATTensors, hdr: torch.Tensor,
                       now: int) -> Tuple[torch.Tensor, NATTable]:
    """Ingress reverse translation (plain version): a reply to
    ``ip:(NAT_PORT_MIN + s)`` whose source is slot s's recorded
    destination, and whose ``ip`` is the one the mapping rewrote to,
    restores the original (pod IP, pod port) and refreshes the slot's
    expiry; everything else passes through.  Of several rows hitting
    one slot, the highest row's refresh stands (XLA's scatter: the last
    duplicate wins)."""
    now = int(now) & MASK
    if not t.enabled:
        return hdr, tbl
    p = tbl.capacity
    h = widen(hdr)
    src, dst = h[:, COL_SRC_IP3], h[:, COL_DST_IP3]
    sport, dport, proto = h[:, COL_SPORT], h[:, COL_DPORT], h[:, COL_PROTO]
    in_pool = (dport >= NAT_PORT_MIN) & (dport < NAT_PORT_MIN + p)
    cand = torch.where(in_pool, dport - NAT_PORT_MIN, 0)
    row = widen(tbl.table)[cand]
    rdp = ((sport << 8) | proto) & MASK
    row_ip = row[:, NV_SNAT_IP]
    ip_ok = torch.where(row_ip != 0, dst == row_ip, dst == t.node_ip)
    hit = ((h[:, COL_DIR] == 0) & (h[:, COL_FAMILY] == 4) & in_pool & ip_ok
           & (row[:, NV_EXPIRES] >= now) & (row[:, NV_DST] == src)
           & (row[:, NV_DP] == rdp))
    out = h.clone()
    out[:, COL_DST_IP3] = torch.where(hit, row[:, NV_SRC], dst)
    out[:, COL_DPORT] = torch.where(hit, row[:, NV_SPORT], dport)
    rows = torch.nonzero(hit)[:, 0]
    slots = cand[rows]
    last = torch.full((p,), -1, dtype=torch.int64,
                      device=hdr.device).scatter_reduce_(
        0, slots, rows, "amax")
    win = last[slots] == rows
    tbl.table[slots[win], NV_EXPIRES] = narrow(
        (now + _lifetime(proto[rows[win]])) & MASK)
    return narrow(out), tbl


def snat_reverse(tbl: NATTable, t: NATTensors, hdr: torch.Tensor,
                 now: int) -> Tuple[torch.Tensor, NATTable]:
    """Ingress reverse translation: see :func:`snat_reverse_plain`.
    CUDA tensors launch K12 (``csrc/nat.cu``)."""
    if hdr.is_cuda and t.enabled:
        from ..kernels import launch_snat_reverse

        return launch_snat_reverse(tbl, t, hdr, now)
    if not hdr.is_cuda:
        _require_cpu(hdr, "snat_reverse")
    return snat_reverse_plain(tbl, t, hdr, now)


def masq_rewrite_plain(t: NATTensors, hdr: torch.Tensor, ct=None,
                       now: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stateless masquerade (plain version): egress IPv4 rows
    toward no non-masquerade network take ``node_ip`` as their source;
    with ``ct``, rows whose reverse CT entry is live (replies to an
    inbound connection) keep theirs.  -> (rows, [N] bool masq)."""
    h = widen(hdr)
    dst = h[:, COL_DST_IP3]
    masq = ((h[:, COL_DIR] == 1) & (h[:, COL_FAMILY] == 4)
            & ~_in_nets(dst, t.net, t.mask))
    if ct is not None:
        masq = masq & ~_reverse_ct_found(ct, hdr, int(now) & MASK)
    out = h.clone()
    out[:, COL_SRC_IP3] = torch.where(masq, t.node_ip, h[:, COL_SRC_IP3])
    return narrow(out), masq


def masq_rewrite(t: NATTensors, hdr: torch.Tensor, ct=None, now: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stateless masquerade: see :func:`masq_rewrite_plain`.  CUDA
    tensors launch K14 (``csrc/nat.cu``)."""
    if hdr.is_cuda:
        from ..kernels import launch_masq_rewrite

        return launch_masq_rewrite(t, hdr, ct, now)
    _require_cpu(hdr, "masq_rewrite")
    return masq_rewrite_plain(t, hdr, ct, now)


def snat_stage(t: NATTensors, hdr: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masquerade egress IPv4 leaving the cluster: src -> node IP.
    Returns (hdr', masqueraded [N] bool); no CT probe, no port."""
    if not t.enabled:
        return hdr, torch.zeros(hdr.shape[0], dtype=torch.bool,
                                device=hdr.device)
    return masq_rewrite(t, hdr)
