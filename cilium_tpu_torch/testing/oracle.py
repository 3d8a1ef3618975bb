"""Oracle datapath: sequential pure-Python reference semantics.

A copy of the JAX package's ``testing/oracle.py``: the eBPF behaviour
of ``bpf/bpf_lxc.c`` + ``bpf/lib``, implemented with plain dicts so the
port's datapath can be checked packet for packet.  :meth:`step` takes
the wide header rows as a numpy array ``[N, N_COLS]`` (the reference
takes a ``HeaderBatch`` wrapping the same array).

Batch semantics match the device: lookups see the state as of batch
start (snapshot), then updates apply — the device is data-parallel
within a batch, so the oracle must not let packet i's CT insert be
visible to packet i+1 of the same batch.
"""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.packets import (
    COL_DIR,
    COL_DPORT,
    COL_DST_IP0,
    COL_EP,
    COL_FAMILY,
    COL_FLAGS,
    COL_PROTO,
    COL_SPORT,
    COL_SRC_IP0,
    FLAG_RELATED,
    TCP_FIN,
    TCP_RST,
    words_to_ip,
)
from ..datapath.conntrack import (
    CT_ESTABLISHED,
    CT_NEW,
    CT_RELATED,
    CT_REPLY,
    LIFETIME_CLOSE,
    LIFETIME_NONTCP,
    LIFETIME_SYN,
    LIFETIME_TCP,
)
from ..datapath.verdict import (
    EV_DROP,
    EV_TRACE,
    EV_VERDICT,
    REASON_FORWARDED,
    REASON_NO_ENDPOINT,
    REASON_POLICY_DEFAULT_DENY,
    REASON_POLICY_DENY,
)
from ..policy.mapstate import (
    VERDICT_ALLOW,
    VERDICT_DENY,
    VERDICT_REDIRECT,
)
from ..policy.compiler import make_proto_table
from ..policy.resolve import EndpointPolicy


@dataclass
class _CTEntry:
    state: int  # ST_* from conntrack
    expires: int
    proxy: int


@dataclass
class OracleResult:
    verdict: int
    proxy: int
    ct: int
    identity: int  # remote numeric identity
    reason: int
    event: int


class OracleDatapath:
    """Sequential reference of the full verdict pipeline."""

    def __init__(self, ep_policies: Dict[int, EndpointPolicy],
                 ipcache: Dict[str, int]):
        self.ep_policies = ep_policies
        # mutual-auth grants: (subject labels key, remote numeric
        # identity) -> expires (the authmap; see Loader.auth_upsert)
        self.auth: Dict[Tuple[str, int], int] = {}
        self.ipcache: List[Tuple[int, int, int, int]] = []  # ver, net, plen, id
        # host-route fast path: /32 (v4) and /128 (v6) are the longest
        # possible prefixes, so an exact hit always wins LPM — keeps the
        # oracle usable at the 10k-identity scale without changing
        # longest-prefix-match semantics
        self._exact: Dict[Tuple[int, int], int] = {}
        for cidr, ident in ipcache.items():
            net = ipaddress.ip_network(cidr, strict=False)
            host_bits = 32 if net.version == 4 else 128
            if net.prefixlen == host_bits:
                self._exact[(net.version,
                             int(net.network_address))] = ident
            else:
                self.ipcache.append((net.version,
                                     int(net.network_address),
                                     net.prefixlen, ident))
        self._lpm_memo: Dict[str, int] = {}
        self.ct: Dict[tuple, _CTEntry] = {}
        self.proto_table = make_proto_table()

    def lookup_identity(self, ip: str) -> int:
        cached = self._lpm_memo.get(ip)
        if cached is not None:
            return cached
        addr = ipaddress.ip_address(ip)
        n = int(addr)
        exact = self._exact.get((addr.version, n))
        if exact is not None:
            self._lpm_memo[ip] = exact
            return exact
        bits = 32 if addr.version == 4 else 128
        best_len, best_id = -1, 0
        for ver, net, plen, ident in self.ipcache:
            if ver != addr.version:
                continue
            shift = bits - plen
            if plen == 0 or (n >> shift) == (net >> shift):
                if plen > best_len:
                    best_len, best_id = plen, ident
        self._lpm_memo[ip] = best_id
        return best_id

    @staticmethod
    def _tuple(row: np.ndarray) -> tuple:
        proto = int(row[COL_PROTO])
        icmp = proto in (1, 58)
        sport = 0 if icmp else int(row[COL_SPORT])
        dport = 0 if icmp else int(row[COL_DPORT])
        src = tuple(int(x) for x in row[COL_SRC_IP0:COL_SRC_IP0 + 4])
        dst = tuple(int(x) for x in row[COL_DST_IP0:COL_DST_IP0 + 4])
        return (src, dst, sport, dport, proto, int(row[COL_DIR]))

    @staticmethod
    def _rev(t: tuple) -> tuple:
        # reply: swap tuple AND hook direction (ipv4_ct_tuple_reverse)
        return (t[1], t[0], t[3], t[2], t[4], 1 - t[5])

    def step(self, hdr: np.ndarray, now: int,
             pre_drop=None,
             pre_drop_reason=None,
             lb_drop=None, audit=False) -> List[OracleResult]:
        """``pre_drop`` ([N] bool) marks rows the SNAT stage condemned
        (pool exhaustion).  Policy/lxcmap drops keep precedence
        (upstream order: bpf_lxc judges before host SNAT); rows that
        would otherwise forward drop with REASON_NAT_EXHAUSTED and
        neither create nor refresh CT.  ``pre_drop_reason`` ([N]
        uint32, 0 = none) is the generalized per-row form (bandwidth
        manager), same precedence and CT semantics.  ``lb_drop``
        ([N] bool) is the PRE-policy LB no-backend drop
        (REASON_NO_SERVICE): upstream's LB lookup runs before the
        endpoint program, so it wins over policy AND the lxcmap
        gate, and touches no CT state."""
        from ..datapath.verdict import (REASON_AUTH_REQUIRED,
                                        REASON_NAT_EXHAUSTED,
                                        REASON_NO_SERVICE)

        results: List[OracleResult] = []
        updates: List[Tuple[tuple, np.ndarray, bool, int, int]] = []
        # phase 1: lookups against the batch-start snapshot
        for i in range(len(hdr)):
            row = hdr[i]
            dirn = int(row[COL_DIR])
            fam = int(row[COL_FAMILY])
            remote_words = (row[COL_SRC_IP0:COL_SRC_IP0 + 4] if dirn == 0
                            else row[COL_DST_IP0:COL_DST_IP0 + 4])
            ident = self.lookup_identity(words_to_ip(remote_words, fam))

            fwd = self._tuple(row)
            entry = self.ct.get(fwd)
            is_reply = False
            related = bool(int(row[COL_FLAGS]) & FLAG_RELATED)
            if related:
                # ICMP error carrying the embedded original tuple:
                # probe that tuple under BOTH hook directions (the
                # datapath's related rev-key flips only the dir bit)
                if entry is None or entry.expires < now:
                    entry = self.ct.get(fwd[:5] + (1 - fwd[5],))
                if entry is not None and entry.expires >= now:
                    ct_res = CT_RELATED
                else:
                    ct_res, entry = CT_NEW, None
            elif entry is not None and entry.expires >= now:
                ct_res = CT_ESTABLISHED
            else:
                rentry = self.ct.get(self._rev(fwd))
                if rentry is not None and rentry.expires >= now:
                    ct_res, is_reply, entry = CT_REPLY, True, rentry
                else:
                    ct_res, entry = CT_NEW, None

            if lb_drop is not None and bool(lb_drop[i]):
                # LB ran before policy (bpf/lib/lb.h): a frontend hit
                # with no backend drops NO_SERVICE regardless of the
                # policy/lxcmap verdict, creating/refreshing nothing
                results.append(OracleResult(
                    VERDICT_DENY, 0, ct_res, ident,
                    REASON_NO_SERVICE, EV_DROP))
                updates.append((fwd, row, is_reply, CT_NEW, 0, False,
                                related))
                continue
            pol = self.ep_policies.get(int(row[COL_EP]))
            if pol is None:
                # lxcmap miss: unregistered endpoint -> drop, CT
                # untouched (reference: bpf_lxc endpoint lookup
                # failure), even for packets matching a live CT entry
                results.append(OracleResult(
                    VERDICT_DENY, 0, ct_res, ident,
                    REASON_NO_ENDPOINT, EV_DROP))
                updates.append((fwd, row, is_reply, CT_NEW, 0, False,
                                related))
                continue
            proto_idx = int(self.proto_table[int(row[COL_PROTO])])
            p_verdict, p_proxy, p_auth = pol.lookup_full(
                dirn, ident, proto_idx, int(row[COL_DPORT]))
            if ct_res != CT_NEW:
                # a related ICMP error is forwarded, never redirected
                proxy = 0 if ct_res == CT_RELATED else entry.proxy
                verdict = VERDICT_REDIRECT if proxy > 0 else VERDICT_ALLOW
                reason = REASON_FORWARDED
                event = EV_TRACE
            elif p_verdict in (VERDICT_ALLOW, VERDICT_REDIRECT) and (
                    p_auth and self.auth.get(
                        (pol.subject_labels.sorted_key(), ident),
                        0) <= now):
                # policy allows but mutual auth is missing/expired:
                # drop AUTH_REQUIRED, touch nothing (pkg/auth)
                proxy = 0
                verdict = VERDICT_DENY
                reason = REASON_AUTH_REQUIRED
                event = EV_DROP
            elif p_verdict in (VERDICT_ALLOW, VERDICT_REDIRECT):
                proxy = p_proxy if p_verdict == VERDICT_REDIRECT else 0
                verdict = p_verdict
                reason = REASON_FORWARDED
                event = EV_VERDICT
            else:
                proxy = 0
                verdict = p_verdict
                reason = (REASON_POLICY_DENY if p_verdict == VERDICT_DENY
                          else REASON_POLICY_DEFAULT_DENY)
                event = EV_DROP
            # audit first: a row the policy stage would deny is
            # forwarded UNLESS a later stage (NAT exhaustion,
            # bandwidth) really drops it — those stages act on the
            # post-audit allowed set, mirroring the device
            audit_fwd = (audit and ct_res == CT_NEW
                         and reason in (REASON_POLICY_DENY,
                                        REASON_POLICY_DEFAULT_DENY,
                                        REASON_AUTH_REQUIRED))
            if (pre_drop is not None and bool(pre_drop[i])
                    and (reason == REASON_FORWARDED or audit_fwd)):
                verdict, proxy = VERDICT_DENY, 0
                reason, event = REASON_NAT_EXHAUSTED, EV_DROP
                audit_fwd = False
            if (pre_drop_reason is not None
                    and int(pre_drop_reason[i]) != 0
                    and (reason == REASON_FORWARDED or audit_fwd)):
                verdict, proxy = VERDICT_DENY, 0
                reason, event = int(pre_drop_reason[i]), EV_DROP
                audit_fwd = False
            if audit_fwd:
                # policy-audit-mode: forward, CT-create, keep the
                # would-be reason on the verdict event
                verdict, proxy, event = VERDICT_ALLOW, 0, EV_VERDICT
            results.append(OracleResult(verdict, proxy, ct_res, ident,
                                        reason, event))
            allowed = reason == REASON_FORWARDED or audit_fwd
            # a NAT-dropped row must not refresh an existing entry
            # either: CT_NEW + allowed=False touches nothing
            if reason == REASON_NAT_EXHAUSTED or (
                    pre_drop_reason is not None
                    and int(pre_drop_reason[i]) != 0
                    and reason == int(pre_drop_reason[i])):
                ct_res = CT_NEW
            updates.append((fwd, row, is_reply, ct_res, proxy if allowed
                            else 0, allowed, related))
        # phase 2: apply CT updates
        from ..datapath.conntrack import (ST_CLOSING, ST_ESTABLISHED,
                                          ST_SYN_SENT)
        for fwd, row, is_reply, ct_res, proxy, allowed, related in (
                updates):
            if related or ct_res == CT_RELATED:
                continue  # ICMP errors neither create nor refresh
            proto = int(row[COL_PROTO])
            flags = int(row[COL_FLAGS])
            is_tcp = proto == 6
            closing = is_tcp and (flags & (TCP_FIN | TCP_RST)) != 0
            if ct_res == CT_NEW:
                if allowed:
                    st = ST_SYN_SENT if is_tcp else ST_ESTABLISHED
                    life = LIFETIME_SYN if is_tcp else LIFETIME_NONTCP
                    self.ct[fwd] = _CTEntry(st, now + life, proxy)
                continue
            key = self._rev(fwd) if is_reply else fwd
            e = self.ct[key]
            if is_reply and e.state == ST_SYN_SENT:
                e.state = ST_ESTABLISHED
            if closing:
                e.state = ST_CLOSING
            if e.state == ST_CLOSING:
                life = LIFETIME_CLOSE
            elif is_tcp:
                life = (LIFETIME_TCP if e.state >= ST_ESTABLISHED
                        else LIFETIME_SYN)
            else:
                life = LIFETIME_NONTCP
            e.expires = now + life
        return results

    def gc(self, now: int) -> int:
        """Expire entries (ctmap.GC)."""
        dead = [k for k, e in self.ct.items() if e.expires < now]
        for k in dead:
            del self.ct[k]
        return len(dead)
