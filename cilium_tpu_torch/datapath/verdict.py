"""The per-packet verdict pipeline — ``bpf_lxc.c`` as one kernel.

Reference: upstream cilium ``bpf/bpf_lxc.c`` ``handle_xgress``: parse ->
ipcache LPM (``lib/eps.h``) -> ``ct_lookup4`` (``lib/conntrack.h``) ->
``policy_can_access_ingress`` (``lib/policy.h``) -> ``ct_create4`` ->
emit trace/drop/policy-verdict events.

On the card one step is two launches on the current stream:

1. the verdict stage, ``datapath_kernel<PACKED>`` (``csrc/verdict.cu``):
   one thread per packet unpacks the row, walks the LPM, probes
   conntrack, gathers the policy and runs the whole select chain in
   registers, adds its metrics and writes the out row plus what
   ``ct_update`` needs;
2. ``ct_update`` (``conntrack.ct_update``).

JAX threaded the state functionally and donated it; here the step
updates ``state.ct`` and ``state.metrics`` IN PLACE and returns the
same state object.  Policy and ipcache tensors are never written.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.packets import (
    COL_DIR,
    COL_DPORT,
    COL_DST_IP0,
    COL_EP,
    COL_FAMILY,
    COL_FLAGS,
    COL_PROTO,
    COL_SRC_IP0,
    FLAG_RELATED,
    unpack_hdr,
)
from ..device import resolve_device
from ..policy.compiler import (AUTH_SHIFT, PolicyTensors, PROXY_MASK,
                               PROXY_SHIFT, VERDICT_MASK)
from ..policy.mapstate import (
    VERDICT_ALLOW,
    VERDICT_DENY,
    VERDICT_REDIRECT,
)
from ..u32 import as_index, from_numpy, narrow, widen
from .conntrack import (
    CT_NEW,
    CT_RELATED,
    CTTable,
    V_PROXY,
    ct_keys_from_headers,
    ct_l4_from_headers,
    ct_lookup_plain,
    ct_update,
)
from .lpm import DeviceLPM, LPMTensors, lpm_lookup_plain

# Drop reasons (reference: bpf/lib/drop.h DROP_* codes, renumbered).
REASON_FORWARDED = 0
REASON_POLICY_DENY = 1  # explicit deny rule
REASON_POLICY_DEFAULT_DENY = 2  # no rule allowed it (default deny)
REASON_ROUTE_OVERFLOW = 3  # flow-router shard block overflow (RSS queue)
REASON_NO_ENDPOINT = 4  # unregistered endpoint id (lxcmap miss)
REASON_NAT_EXHAUSTED = 5  # SNAT port pool exhausted (DROP_NAT_NO_MAPPING)
REASON_BANDWIDTH = 6  # egress rate limit (bandwidth manager / EDT)
REASON_NO_SERVICE = 7  # service frontend with no backend (DROP_NO_SERVICE)
REASON_AUTH_REQUIRED = 8  # policy allows, mutual auth missing (pkg/auth)
# host-synthesized reasons of the serving and cluster planes; numbered
# here so every decode table names them like any datapath drop
REASON_INGRESS_OVERFLOW = 9
REASON_DISPATCH_TIMEOUT = 10
REASON_RECOVERY_DROP = 11
REASON_CLUSTER_OVERFLOW = 12
N_REASONS = 13

# Event types in the out tensor (monitor vocabulary).
EV_TRACE = 0  # TraceNotify: forwarded established/reply traffic
EV_VERDICT = 1  # PolicyVerdictNotify: NEW connection decision
EV_DROP = 2  # DropNotify

# Out tensor columns.
OUT_VERDICT = 0  # final VERDICT_* code
OUT_PROXY = 1  # proxy port when redirected
OUT_CT = 2  # CT_* lookup result
OUT_ID_ROW = 3  # remote identity row (host maps to numeric id)
OUT_REASON = 4  # drop reason (REASON_*)
OUT_EVENT = 5  # EV_*
N_OUT = 6

MAX_ENDPOINTS = 4096


@dataclass
class DevicePolicy:
    """Compiled policy tensors on a device + endpoint->policy-row map
    (the policymap + lxcmap of the datapath).  int32; ``auth`` holds u32
    expiries as bit patterns."""

    proto_table: torch.Tensor  # [256]
    port_class: torch.Tensor  # [N_PROTO, 65536] -> GLOBAL class
    class_map: torch.Tensor  # [n_pol, n_cls_global] -> LOCAL class
    verdict: torch.Tensor  # [n_pol, 2, n_rows, n_local]
    ep_policy: torch.Tensor  # [MAX_ENDPOINTS] endpoint -> policy row
    auth: torch.Tensor  # [n_pol, n_rows] mutual-auth expiries

    @staticmethod
    def from_tensors(t: PolicyTensors, ep_policy: np.ndarray = None,
                     auth: np.ndarray = None,
                     device=None) -> "DevicePolicy":
        device = resolve_device(device)
        if ep_policy is None:
            # every endpoint id is an lxcmap miss until registered
            ep_policy = np.full(MAX_ENDPOINTS, -1, dtype=np.int32)
        if auth is None:
            auth = np.zeros((t.verdict.shape[0], t.verdict.shape[2]),
                            dtype=np.uint32)

        def i32(a):
            # a copy on every device, the CPU too: the host arrays stay
            # the loader's mirrors, never the published tables
            return torch.from_numpy(
                np.ascontiguousarray(a, dtype=np.int32)).to(device,
                                                            copy=True)

        return DevicePolicy(
            proto_table=i32(t.proto_table), port_class=i32(t.port_class),
            class_map=i32(t.class_map), verdict=i32(t.verdict),
            ep_policy=i32(ep_policy), auth=from_numpy(auth, device))


@dataclass
class DatapathState:
    """Full device datapath state — the BPF-maps bundle."""

    policy: DevicePolicy
    ipcache: DeviceLPM
    ct: CTTable
    metrics: torch.Tensor  # [N_REASONS, 2] int32 (u32): [reason, dir]

    @staticmethod
    def create(policy: DevicePolicy, ipcache: DeviceLPM,
               ct: CTTable) -> "DatapathState":
        return DatapathState(
            policy=policy, ipcache=ipcache, ct=ct,
            metrics=torch.zeros((N_REASONS, 2), dtype=torch.int32,
                                device=ct.table.device))


@dataclass
class CTUpdateInput:
    """What the verdict stage hands ``ct_update`` (per row)."""

    l4: torch.Tensor  # [N, 3] proto, flags, length
    fwd: torch.Tensor  # [N, KEY_WORDS] forward CT key
    result: torch.Tensor  # [N] int32 CT_* after the untouched rewrite
    slot: torch.Tensor  # [N] int32
    is_reply: torch.Tensor  # [N] bool
    do_create: torch.Tensor  # [N] bool
    proxy_port: torch.Tensor  # [N] int32 (u32)


def verdict_stage_plain(state: DatapathState, hdr: torch.Tensor, now: int,
                        valid: Optional[torch.Tensor] = None,
                        pre_drop: Optional[torch.Tensor] = None,
                        pre_drop_reason: Optional[torch.Tensor] = None,
                        lb_drop: Optional[torch.Tensor] = None,
                        audit: bool = False
                        ) -> Tuple[torch.Tensor, CTUpdateInput]:
    """Stages 1-4 and the metrics of :func:`datapath_step` (plain
    version, over any device's tensors — it calls only plain
    versions): -> (out [N, N_OUT] int32, the ``ct_update`` inputs).
    Adds this batch's counts to ``state.metrics`` in place.

    Gathers follow XLA's index rule (a negative index counts from the
    end once, then clamps), so forged endpoint ids, directions and
    ports read the same cells the JAX step reads."""
    pol = state.policy
    dirn = hdr[:, COL_DIR]  # int32 bit patterns, as JAX's astype(int32)
    fam = hdr[:, COL_FAMILY]

    # 1. ipcache: remote IP -> identity row (src for ingress, dst for
    #    egress — reference: lookup_ip4_remote_endpoint on the peer).
    src_words = hdr[:, COL_SRC_IP0:COL_SRC_IP0 + 4]
    dst_words = hdr[:, COL_DST_IP0:COL_DST_IP0 + 4]
    remote = torch.where((dirn == 0)[:, None], src_words, dst_words)
    id_row = lpm_lookup_plain(state.ipcache, remote, fam)

    # 2. conntrack lookup.  RELATED rows (ICMP errors) probe the
    #    original flow's entry; a hit is CT_RELATED — forwarded like
    #    established traffic, never refreshed, never created.
    fwd, rev = ct_keys_from_headers(hdr)
    ct_res, slot, is_reply = ct_lookup_plain(state.ct, fwd, rev, now)
    related_hint = (widen(hdr[:, COL_FLAGS]) & FLAG_RELATED) != 0
    is_related = related_hint & (ct_res != CT_NEW)

    # 3. policy map lookup.  ep_policy row -1 = unregistered endpoint
    #    (the lxcmap-miss sentinel); out-of-range ids are a miss too,
    #    never a clamp onto a boundary row's endpoint.
    ep_col = hdr[:, COL_EP]
    pol_row_raw = pol.ep_policy[as_index(ep_col, pol.ep_policy.shape[0])]
    no_ep = (pol_row_raw < 0) | (widen(ep_col) >= MAX_ENDPOINTS)
    pol_row = torch.clamp(pol_row_raw, min=0)
    proto_idx = pol.proto_table[as_index(hdr[:, COL_PROTO],
                                         pol.proto_table.shape[0])]
    gcls = pol.port_class[as_index(proto_idx, pol.port_class.shape[0]),
                          as_index(hdr[:, COL_DPORT],
                                   pol.port_class.shape[1])]
    n_pol, _, n_rows, n_local = pol.verdict.shape
    prow = as_index(pol_row, n_pol)
    cls = pol.class_map[prow, as_index(gcls, pol.class_map.shape[1])]
    idrow = as_index(id_row, n_rows)
    packed = pol.verdict[prow, as_index(dirn, 2), idrow,
                         as_index(cls, n_local)]
    p_verdict = packed & VERDICT_MASK
    p_proxy = (packed >> PROXY_SHIFT) & PROXY_MASK
    p_auth = ((packed >> AUTH_SHIFT) & 1) != 0

    # 4. final verdict: established/reply bypass policy (reference: the
    #    CT fast path — policy applies to NEW connections only).
    is_new = ct_res == CT_NEW
    ct_proxy = state.ct.table[slot.to(torch.int64), V_PROXY]
    allowed_new = ((p_verdict == VERDICT_ALLOW)
                   | (p_verdict == VERDICT_REDIRECT))
    # no_ep drops even ESTABLISHED traffic
    allowed = (~is_new | allowed_new) & ~no_ep
    # mutual auth: a NEW flow whose winning allow carries the auth bit
    # forwards only with a live authmap entry
    auth_exp = widen(pol.auth[prow, idrow])
    auth_drop = allowed & is_new & p_auth & (auth_exp <= now)
    allowed = allowed & ~auth_drop
    audit_fwd = None
    if audit:
        # policy-audit-mode: would-be policy/auth denials forward
        audit_fwd = is_new & ~allowed & ~no_ep
        allowed = allowed | audit_fwd
    nat_drop = None
    if pre_drop is not None:
        nat_drop = pre_drop & allowed  # policy/no_ep drops win
        allowed = allowed & ~nat_drop
    stage_drop = None
    if pre_drop_reason is not None:
        stage_drop = (pre_drop_reason != 0) & allowed
        allowed = allowed & ~stage_drop
    zero = torch.zeros_like(p_proxy)
    proxy = torch.where(is_new,
                        torch.where(p_verdict == VERDICT_REDIRECT,
                                    p_proxy, zero),
                        ct_proxy)
    # an ICMP error related to a proxied flow is forwarded, not
    # redirected
    proxy = torch.where(is_related, zero, proxy)
    verdict = torch.where(
        allowed,
        torch.where(proxy > 0, VERDICT_REDIRECT, VERDICT_ALLOW),
        torch.where(no_ep, VERDICT_DENY, p_verdict))
    reason_allowed = (allowed if audit_fwd is None
                      else allowed & ~audit_fwd)
    # u32 like JAX's (a pre_drop_reason promotes it to uint32)
    reason = torch.where(
        reason_allowed, REASON_FORWARDED,
        torch.where(no_ep, REASON_NO_ENDPOINT,
                    torch.where(p_verdict == VERDICT_DENY,
                                REASON_POLICY_DENY,
                                REASON_POLICY_DEFAULT_DENY))
    ).to(torch.int64)
    # auth_drop rows carry p_verdict == ALLOW: override both
    verdict = torch.where(auth_drop, VERDICT_DENY, verdict)
    reason = torch.where(auth_drop, REASON_AUTH_REQUIRED, reason)
    proxy = torch.where(auth_drop, zero, proxy)
    if audit_fwd is not None:
        # the ACTION is forward; the reason keeps the would-be decision
        verdict = torch.where(audit_fwd & allowed, VERDICT_ALLOW, verdict)
    if nat_drop is not None:
        verdict = torch.where(nat_drop, VERDICT_DENY, verdict)
        reason = torch.where(nat_drop, REASON_NAT_EXHAUSTED, reason)
        proxy = torch.where(nat_drop, zero, proxy)
    if stage_drop is not None:
        verdict = torch.where(stage_drop, VERDICT_DENY, verdict)
        reason = torch.where(stage_drop, widen(pre_drop_reason), reason)
        proxy = torch.where(stage_drop, zero, proxy)
    if lb_drop is not None:
        # pre-policy: wins over policy/no_ep/NAT/bandwidth reasons
        allowed = allowed & ~lb_drop
        verdict = torch.where(lb_drop, VERDICT_DENY, verdict)
        reason = torch.where(lb_drop, REASON_NO_SERVICE, reason)
        proxy = torch.where(lb_drop, zero, proxy)

    # 5. what ct_update needs (related rows neither create nor refresh;
    #    no_ep and pre-dropped rows touch nothing)
    untouched = is_related | no_ep
    for drop in (nat_drop, stage_drop, lb_drop):
        if drop is not None:
            untouched = untouched | drop
    ctin = CTUpdateInput(
        l4=ct_l4_from_headers(hdr), fwd=fwd,
        result=torch.where(untouched, CT_NEW, ct_res).to(torch.int32),
        slot=slot, is_reply=is_reply,
        do_create=allowed & is_new & ~related_hint,
        proxy_port=proxy.to(torch.int32))

    # 6. metrics (reference: bpf metricsmap per-reason counters): rows
    #    whose reason or direction falls outside the table are dropped,
    #    like XLA's scatter
    d = dirn.to(torch.int64)
    d = torch.where(d < 0, d + 2, d)
    counted = (reason < N_REASONS) & (d >= 0) & (d < 2)
    if valid is not None:
        counted = counted & valid
    m = widen(state.metrics.view(-1)).index_add_(
        0, (reason * 2 + d)[counted],
        torch.ones_like(d)[counted])
    state.metrics.view(-1).copy_(narrow(m))

    event = torch.where(~allowed, EV_DROP,
                        torch.where(is_new, EV_VERDICT, EV_TRACE))
    out = torch.stack([
        verdict.to(torch.int64),
        proxy.to(torch.int64),
        torch.where(is_related, CT_RELATED, ct_res).to(torch.int64),
        id_row.to(torch.int64),
        reason,
        event.to(torch.int64),
    ], dim=1)
    return narrow(out), ctin


def verdict_stage(state: DatapathState, rows: torch.Tensor, now: int,
                  ep: Optional[int] = None, dirn: Optional[int] = None,
                  valid: Optional[torch.Tensor] = None,
                  pre_drop: Optional[torch.Tensor] = None,
                  pre_drop_reason: Optional[torch.Tensor] = None,
                  lb_drop: Optional[torch.Tensor] = None,
                  audit: bool = False
                  ) -> Tuple[torch.Tensor, CTUpdateInput]:
    """The verdict stage over wide rows [N, N_COLS], or packed rows
    [N, 4] when ``ep``/``dirn`` are given.  CUDA tensors launch
    ``datapath_kernel``; CPU tensors take :func:`verdict_stage_plain`
    (after :func:`unpack_hdr` for packed rows)."""
    if rows.is_cuda:
        from ..kernels import launch_datapath

        return launch_datapath(state, rows, now, ep, dirn, valid,
                               pre_drop, pre_drop_reason, lb_drop, audit)
    if rows.device.type != "cpu":
        raise ValueError(f"verdict_stage: no kernel for {rows.device}")
    hdr = rows if ep is None else unpack_hdr(rows, ep, dirn)
    return verdict_stage_plain(state, hdr, now, valid, pre_drop,
                               pre_drop_reason, lb_drop, audit)


def _step(state, rows, now, ep, dirn, valid, pre_drop, pre_drop_reason,
          lb_drop, audit):
    now = int(now) & 0xFFFFFFFF
    out, c = verdict_stage(state, rows, now, ep, dirn, valid, pre_drop,
                           pre_drop_reason, lb_drop, audit)
    ct_update(state.ct, c.l4, c.fwd, c.result, c.slot, c.is_reply,
              c.do_create, c.proxy_port, now, valid=valid)
    return out, state


def datapath_step(state: DatapathState, hdr: torch.Tensor, now: int,
                  valid: Optional[torch.Tensor] = None,
                  pre_drop: Optional[torch.Tensor] = None,
                  pre_drop_reason: Optional[torch.Tensor] = None,
                  lb_drop: Optional[torch.Tensor] = None,
                  audit: bool = False
                  ) -> Tuple[torch.Tensor, DatapathState]:
    """One batched pass of the verdict pipeline over wide header rows
    [N, N_COLS] (int32 bit patterns): -> (out [N, N_OUT], state), the
    state updated in place.

    ``valid`` ([N] bool) masks padding rows: they produce out rows but
    touch neither CT state nor metrics.  ``pre_drop`` ([N] bool) marks
    rows an earlier stage condemned (REASON_NAT_EXHAUSTED);
    ``pre_drop_reason`` ([N] u32, 0 = none) carries per-row REASON_*
    codes — both keep policy/lxcmap precedence and create no CT entry.
    ``lb_drop`` ([N] bool) is a PRE-policy drop (REASON_NO_SERVICE
    whatever policy says).  ``audit``: policy-audit-mode — NEW flows
    the policy stage would deny forward and create CT state, while the
    event keeps the would-be reason."""
    return _step(state, hdr, now, None, None, valid, pre_drop,
                 pre_drop_reason, lb_drop, audit)


def datapath_step_packed(state: DatapathState, packed: torch.Tensor,
                         now: int, ep: int, dirn: int,
                         valid: Optional[torch.Tensor] = None,
                         audit: bool = False
                         ) -> Tuple[torch.Tensor, DatapathState]:
    """The ingest fast path: packed IPv4 rows [N, 4] (16 B/packet, see
    core/packets.py PACKED_*) unpack inside the verdict stage.
    ``ep``/``dirn`` are per-stream scalars, like the per-endpoint tc
    hook in the reference."""
    return _step(state, packed, now, int(ep), int(dirn), valid, None,
                 None, None, audit)


def apply_masquerade(ct: CTTable, nat, hdr: torch.Tensor,
                     now: int) -> torch.Tensor:
    """CONNTRACK-AWARE egress masquerade: egress-to-world sources
    rewrite to the node IP UNLESS the row's reverse CT entry is live --
    that row replies to a connection a remote opened INTO the node and
    keeps its source.  Runs as its own stage before the datapath step,
    so the CT entry of a masqueraded flow carries the post-NAT tuple.
    CUDA tensors launch K14 ``masq_rewrite`` with its CT probe
    (``csrc/nat.cu``)."""
    from ..service.nat import masq_rewrite

    if not nat.enabled:
        return hdr
    return masq_rewrite(nat, hdr, ct, now)[0]


def build_state(policy_tensors: PolicyTensors, lpm_tensors: LPMTensors,
                ep_policy: np.ndarray = None,
                ct_capacity: int = 1 << 20,
                device=None) -> DatapathState:
    """Assemble a fresh device state from host-compiled tensors on
    ``device`` (None: the card)."""
    device = resolve_device(device)
    return DatapathState.create(
        policy=DevicePolicy.from_tensors(policy_tensors, ep_policy,
                                         device=device),
        ipcache=DeviceLPM.from_tensors(lpm_tensors, device),
        ct=CTTable.create(ct_capacity, device=device))
