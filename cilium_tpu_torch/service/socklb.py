"""Socket-LB analogue: connect-time service translation, cached per
flow.

Reference: the JAX package's ``service/socklb.py`` (itself upstream
cilium's ``bpf_sock.c`` cgroup hooks): a service VIP translates to a
backend ONCE, at connect time, and an established connection keeps its
backend across backend-set changes.  The "socket" is a flow here: an
open-addressing table keyed by the wire 5-tuple, valued with the
resolved (backend_ip, backend_port).

- **Established path**: a fingerprint window probe (8 slots, full rows
  read for the first two fingerprint candidates), the full-window probe
  for every row when any row's candidates overflow, and the refresh of
  the matched row's expiry;
- **Connect path** (cache misses, at most ``CONNECT_CAP`` a batch): the
  frontend compare + Maglev of ``lb_stage``, the ClientIP affinity pin
  read, then write-then-verify claims of flow slots and affinity pins
  (8 steps each; a contended slot goes to the lowest batch row, a
  same-tuple loser adopts).  Non-service flows cache a negative entry;
  rows whose frontend selects no backend are never cached;
- a batch with more misses than ``CONNECT_CAP`` resolves every miss
  without caching (affinity pins read, not claimed).

:func:`socklb_stage` sends CUDA tensors to K17 (``csrc/socklb.cu``) and
CPU tensors to :func:`socklb_stage_plain`.  The table updates in place;
u32 words are int32 bit patterns, and the plain version computes in
int64 over ``[0, 2^32)`` so every compare is unsigned.
"""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.packets import (
    COL_DPORT,
    COL_DST_IP3,
    COL_FAMILY,
    COL_PROTO,
    COL_SPORT,
    COL_SRC_IP3,
)
# the fingerprint construction is conntrack's, shared so the two tables
# can never silently diverge (key hash -> byte in 1..255, 0 = free)
from ..datapath.conntrack import _first_true, _fp_mix, _require_cpu
from ..device import resolve_device
from ..u32 import MASK, from_numpy, mul, narrow, to_numpy, widen
from . import LBTensors, _lb_hash4, _lb_match4, _lb_select
from .nat import CLAIM_FREE

SOCK_PROBE = 8  # claim/probe window
SOCK_DEFAULT_CAPACITY = 1 << 16
CONNECT_CAP = 1 << 13  # connect-path misses a batch may cache
# full-row reads per packet on the established path; a miss with more
# fingerprint matches sends the batch to the full-window probe
SOCK_CAND = 2

# lifetimes track conntrack's (a cached translation outliving its CT
# entry is harmless; one expiring under a live flow would re-resolve --
# same backend unless the set changed)
LIFETIME_TCP = 21600
LIFETIME_NONTCP = 180

ROW_WORDS = 8
SK_SRC = 0
SK_SPORT = 1
SK_VIP = 2
SK_DP = 3  # dport << 8 | proto
SK_BE_IP = 4
SK_BE_PORT = 5  # NO_BACKEND for cached "not a service" entries
SK_EXPIRES = 6
SK_PAD = 7

NO_BACKEND = 0xFFFFFFFF

# sessionAffinity ClientIP sub-table (reference: the lb4 affinity maps
# keyed {svc, client-ip}): key (client src ip, frontend vip,
# dport << 8 | proto), value the pinned backend and its expiry
AFF_WORDS = 8
AF_SRC = 0
AF_VIP = 1
AF_DP = 2
AF_BE_IP = 3
AF_BE_PORT = 4
AF_EXPIRES = 5
AFF_PROBE = 8
AFF_SALT = 0x5EED_AFF1  # keyed apart from the flow-cache hash


@dataclass
class SockLBTable:
    """The flow cache: ``table`` rows, the 1-byte key fingerprint of
    each slot (0 = free) and the ClientIP affinity pins."""

    table: torch.Tensor  # [P, ROW_WORDS] int32 (u32 words)
    fp: torch.Tensor  # [P]
    aff: torch.Tensor  # [A, AFF_WORDS]
    # [3, P] and [3, A] int32: K17's claim words for the flow slots and
    # the pins (its steps take the three rows in turn), CLAIM_FREE between
    # calls (not part of the state; the plain version ignores them); made
    # with every table, a copy may share them
    claim: Optional[torch.Tensor] = field(default=None, repr=False,
                                          compare=False)
    aclaim: Optional[torch.Tensor] = field(default=None, repr=False,
                                           compare=False)

    def __post_init__(self):
        for name, rows in (("claim", self.table), ("aclaim", self.aff)):
            if getattr(self, name) is None:
                setattr(self, name, torch.full(
                    (3, rows.shape[0]), CLAIM_FREE, dtype=torch.int32,
                    device=rows.device))

    @staticmethod
    def create(capacity: int = SOCK_DEFAULT_CAPACITY,
               aff_capacity: int = None, device=None) -> "SockLBTable":
        if capacity & (capacity - 1):
            raise ValueError("socklb capacity must be a power of two")
        a = aff_capacity if aff_capacity is not None else capacity
        if a & (a - 1):
            raise ValueError("affinity capacity must be a power of two")
        device = resolve_device(device)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=device)

        return SockLBTable(table=zeros(capacity, ROW_WORDS),
                           fp=zeros(capacity), aff=zeros(a, AFF_WORDS))

    @property
    def capacity(self) -> int:
        return self.table.shape[0]

    def prune_affinity(self, valid_backends: set) -> "SockLBTable":
        """Host sweep: expire affinity rows whose pinned backend no
        longer exists in ANY service, over a fetched copy written back
        in place (run on service-set changes; the device path skips the
        per-row membership compare)."""
        a = to_numpy(self.aff).copy()
        live = a[:, AF_EXPIRES] > 0
        if not live.any():
            return self
        packed = ((a[:, AF_BE_IP].astype(np.uint64) << 32)
                  | a[:, AF_BE_PORT].astype(np.uint64))
        valid = np.asarray([(int(ip) << 32) | int(port)
                            for ip, port in valid_backends], dtype=np.uint64)
        a[live & ~np.isin(packed, valid), AF_EXPIRES] = 0
        self.aff.copy_(from_numpy(a, self.aff.device))
        return self


def _hash(words: torch.Tensor) -> torch.Tensor:
    """FNV-1a over [N, 4] widened key words -> [N] int64 in [0, 2^32)."""
    h = torch.full((words.shape[0],), 0x811C9DC5, dtype=torch.int64,
                   device=words.device)
    for w in range(4):
        h = mul(h ^ words[:, w], 0x01000193)
    return h


def _resolve(t: LBTensors, hdr: torch.Tensor):
    """The connect-path resolution of int32 rows: frontend compare +
    Maglev.  -> (is_service [M], no_backend [M], be_ip [M], be_port [M],
    aff_ttl [M]), the words widened.  ``no_backend`` rows matched a
    frontend that selects nothing; ``aff_ttl`` is the matched service's
    ClientIP affinity timeout (0 = off)."""
    svc, hit, is_svc, no_be, be = _lb_select(t, _lb_match4(t, hdr),
                                             _lb_hash4(widen(hdr)))
    aff_ttl = torch.where(hit, widen(t.svc_aff)[svc], 0)
    return (is_svc, no_be, widen(t.backend_ip)[be],
            widen(t.backend_port)[be], aff_ttl)


def _aff_probe(aff: torch.Tensor, src, vip, dp, now: int):
    """Window-probe the widened affinity table for (client, frontend)
    rows: -> (found [M], row [M, AFF_WORDS], hash [M])."""
    ah = _hash(torch.stack([src, vip, dp, torch.full_like(src, AFF_SALT)],
                           dim=1))
    steps = torch.arange(AFF_PROBE, dtype=torch.int64, device=aff.device)
    awin = (ah[:, None] + steps[None, :]) & (aff.shape[0] - 1)
    arows = aff[awin]
    amatch = ((arows[..., AF_SRC] == src[:, None])
              & (arows[..., AF_VIP] == vip[:, None])
              & (arows[..., AF_DP] == dp[:, None])
              & (arows[..., AF_EXPIRES] >= now))
    slot = torch.gather(awin, 1, _first_true(amatch)[:, None])[:, 0]
    return amatch.any(dim=1), aff[slot], ah


def _claim(table, keys, rows, h, pending, now, exp_col, fp=None,
           fp_new=None):
    """The 8-step write-then-verify claim over widened ``table`` in
    place: per step, pending rows whose probe slot is claimable
    (expired, or holding their key) bid their index; the lowest writes
    its row (and fingerprint), and every bidder that reads its key back
    -- the writer or a same-key loser -- is done."""
    n, kw = keys.shape
    mask = table.shape[0] - 1
    ridx = torch.arange(n, device=table.device)
    for step in range(SOCK_PROBE):
        s = (h + step) & mask
        stored = table[s]
        same = (stored[:, :kw] == keys).all(dim=1)
        trying = pending & ((stored[:, exp_col] < now) | same)
        owner = torch.full((table.shape[0],), n, dtype=torch.int64,
                           device=table.device).scatter_reduce_(
            0, s[trying], ridx[trying], "amin")
        writer = trying & (owner[s] == ridx)
        table[s[writer]] = rows[writer]
        if fp is not None:
            fp[s[writer]] = fp_new[writer]
        won = trying & (table[s][:, :kw] == keys).all(dim=1)
        pending = pending & ~won


def socklb_stage_plain(tbl: SockLBTable, t: LBTensors, hdr: torch.Tensor,
                       now: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  SockLBTable]:
    """Flow-cached LB (plain version): -> (hdr', is_service_hit [N] bool,
    no_backend [N] bool, ``tbl`` updated in place).

    The probe reads the table and ``fp`` as they stood at the call; the
    refresh on use lands before the claims (a refreshed row is not
    claimable unless its expiry wrapped past 2^32), and of several rows
    refreshing one slot the highest row's expiry stands (XLA's scatter:
    the last duplicate wins).  The affinity pin read sees the pins
    before this batch's claims.  ``no_backend`` rows (frontend hit,
    nothing to select) are never cached, so backends appearing take
    effect on the next batch."""
    now = int(now) & MASK
    dev = hdr.device
    h64 = widen(hdr)
    n = hdr.shape[0]
    p = tbl.capacity
    src, sport, dst = h64[:, COL_SRC_IP3], h64[:, COL_SPORT], h64[:, COL_DST_IP3]
    dport, proto = h64[:, COL_DPORT], h64[:, COL_PROTO]
    dp = ((dport << 8) | proto) & MASK
    v4 = h64[:, COL_FAMILY] == 4
    key = torch.stack([src, sport, dst, dp], dim=1)
    h = _hash(key)
    table, fp, aff = widen(tbl.table), widen(tbl.fp), widen(tbl.aff)

    # -- established path: the fingerprint-filtered window probe --------
    steps = torch.arange(SOCK_PROBE, dtype=torch.int64, device=dev)
    win = (h[:, None] + steps[None, :]) & (p - 1)
    fmatch = fp[win] == _fp_mix(h)[:, None]

    def row_match(rows):
        return ((rows[..., :4] == key.view(n, *(1,) * (rows.dim() - 2), 4))
                .all(dim=-1) & (rows[..., SK_EXPIRES] >= now))

    i1 = _first_true(fmatch)
    f2 = fmatch & (steps[None, :] != i1[:, None])
    pos = torch.stack([i1, _first_true(f2)], dim=1)
    cand_valid = torch.stack([fmatch.any(dim=1), f2.any(dim=1)], dim=1)
    cand_slots = torch.gather(win, 1, pos)
    cmatch = cand_valid & row_match(table[cand_slots])
    found = cmatch.any(dim=1)
    mslot = torch.gather(cand_slots, 1, _first_true(cmatch)[:, None])[:, 0]
    # a miss with more fingerprint matches than candidates could hide
    # its entry past them: then every row takes the full-window probe
    if bool((~found & (fmatch.sum(dim=1) > SOCK_CAND)).any()):
        match = row_match(table[win])
        found = match.any(dim=1)
        mslot = torch.gather(win, 1, _first_true(match)[:, None])[:, 0]
    cached = found & v4
    c_be_ip, c_be_port = table[mslot, SK_BE_IP], table[mslot, SK_BE_PORT]
    # refresh on use: the highest row refreshing a slot stands
    rows_c = torch.nonzero(cached)[:, 0]
    slots = mslot[rows_c]
    last = torch.full((p,), -1, dtype=torch.int64, device=dev
                      ).scatter_reduce_(0, slots, rows_c, "amax")
    win_c = last[slots] == rows_c
    life = torch.where(proto == 6, LIFETIME_TCP, LIFETIME_NONTCP)
    table[slots[win_c], SK_EXPIRES] = (now + life[rows_c[win_c]]) & MASK

    # -- connect path: the misses in batch order --------------------------
    miss = v4 & ~cached
    idx = torch.nonzero(miss)[:, 0]
    is_svc, no_be, be_ip, be_port, aff_ttl = _resolve(t, hdr[idx])
    a_src, a_vip, a_dp = src[idx], dst[idx], dp[idx]
    # sessionAffinity: a live (client, frontend) pin overrides Maglev
    afound, arow, ah = _aff_probe(aff, a_src, a_vip, a_dp, now)
    use_aff = is_svc & (aff_ttl > 0) & afound
    be_ip = torch.where(use_aff, arow[:, AF_BE_IP], be_ip)
    be_port = torch.where(use_aff, arow[:, AF_BE_PORT], be_port)
    if idx.shape[0] <= CONNECT_CAP:
        be_port = torch.where(is_svc, be_port, NO_BACKEND)
        be_ip = torch.where(is_svc, be_ip, 0)
        ck = key[idx]
        life_c = torch.where((ck[:, 3] & 0xFF) == 6, LIFETIME_TCP,
                             LIFETIME_NONTCP)
        new_row = torch.stack([ck[:, 0], ck[:, 1], ck[:, 2], ck[:, 3],
                               be_ip, be_port, (now + life_c) & MASK,
                               torch.zeros_like(be_ip)], dim=1)
        # no_backend rows never claim a slot
        _claim(table, ck, new_row, h[idx], ~no_be, now, SK_EXPIRES, fp,
               _fp_mix(h[idx]))
        # claim or refresh the pins of affinity service rows (a row
        # whose key lives in the window overwrites it: the refresh)
        a_new = torch.stack([a_src, a_vip, a_dp, be_ip, be_port,
                             (now + aff_ttl) & MASK,
                             torch.zeros_like(a_src),
                             torch.zeros_like(a_src)], dim=1)
        _claim(aff, a_new[:, :3], a_new, ah, is_svc & (aff_ttl > 0), now,
               AF_EXPIRES)
    r_svc = torch.zeros(n, dtype=torch.bool, device=dev)
    r_nobe = torch.zeros(n, dtype=torch.bool, device=dev)
    r_ip = torch.zeros(n, dtype=torch.int64, device=dev)
    r_port = torch.zeros(n, dtype=torch.int64, device=dev)
    r_svc[idx], r_nobe[idx], r_ip[idx], r_port[idx] = (is_svc, no_be, be_ip,
                                                       be_port)

    pos_hit = cached & (c_be_port != NO_BACKEND)
    out = h64.clone()
    out[:, COL_DST_IP3] = torch.where(pos_hit, c_be_ip,
                                      torch.where(r_svc, r_ip, dst))
    out[:, COL_DPORT] = torch.where(pos_hit, c_be_port,
                                    torch.where(r_svc, r_port, dport))
    tbl.table.copy_(narrow(table))
    tbl.fp.copy_(narrow(fp))
    tbl.aff.copy_(narrow(aff))
    return narrow(out), pos_hit | r_svc, r_nobe, tbl


def socklb_stage(tbl: SockLBTable, t: LBTensors, hdr: torch.Tensor,
                 now: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            SockLBTable]:
    """Flow-cached LB: see :func:`socklb_stage_plain`.  CUDA tensors
    launch K17 (``csrc/socklb.cu``)."""
    if hdr.is_cuda:
        from ..kernels import launch_socklb_stage

        return launch_socklb_stage(tbl, t, hdr, now)
    _require_cpu(hdr, "socklb_stage")
    return socklb_stage_plain(tbl, t, hdr, now)


def socklb_entries_from_snapshot(table: np.ndarray, now: int,
                                 limit: int = 1000) -> list:
    """Decode live flow-cache slots for display (``cilium bpf lb list``
    over the sock rev-NAT maps).  Negative entries (cached "not a
    service") report backend=None."""
    table = np.asarray(table)
    live = np.nonzero(table[:, SK_EXPIRES] >= now)[0][:limit]
    out = []
    for s in live:
        row = table[s]
        neg = int(row[SK_BE_PORT]) == NO_BACKEND
        out.append({
            "src": str(ipaddress.IPv4Address(int(row[SK_SRC]))),
            "sport": int(row[SK_SPORT]),
            "vip": str(ipaddress.IPv4Address(int(row[SK_VIP]))),
            "dport": int(row[SK_DP]) >> 8,
            "proto": int(row[SK_DP]) & 0xFF,
            "backend": (None if neg else
                        str(ipaddress.IPv4Address(int(row[SK_BE_IP])))
                        + f":{int(row[SK_BE_PORT])}"),
            "expires": int(row[SK_EXPIRES]),
        })
    return out
