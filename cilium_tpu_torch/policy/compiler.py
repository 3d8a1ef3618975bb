"""MapState -> dense device tensors (the "policymap" of the TPU datapath).

Reference: upstream cilium ``pkg/maps/policymap`` (the kernel-side
policy map the agent syncs MapState into) and ``bpf/lib/policy.h``'s
lookup.  TPU-first redesign: instead of a sparse hash map probed with
wildcard fallbacks, ALL precedence (deny > redirect > allow > default,
L3-only vs L4 wildcards) is resolved at **compile time** on the host
into a dense verdict tensor, so the device hot path is two gathers:

    class   = port_class[proto_idx, dport]          # [N_PROTO, 65536]
    packed  = verdict[policy_row, dir, id_row, class]

``packed`` (int32) encodes ``verdict | proxy_port << 8``.

Identity axis: numeric identities are remapped to dense rows by
:class:`IdentityRowMap` (row 0 = unknown), with power-of-two capacity
headroom so identity churn patches rows instead of reshaping tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..identity import Identity
from .mapstate import (
    Contribution,
    MapState,
    N_PROTO,
    PROTO_ANY,
    PROTO_ICMP,
    PROTO_OTHER,
    PROTO_SCTP,
    PROTO_TCP,
    PROTO_UDP,
    VERDICT_ALLOW,
    VERDICT_DEFAULT_DENY,
    VERDICT_DENY,
    VERDICT_REDIRECT,
)
from .resolve import EndpointPolicy

VERDICT_MASK = 0xFF
PROXY_SHIFT = 8
PROXY_MASK = 0xFFFF
AUTH_SHIFT = 24  # bit 24: mutual-auth-required (pkg/auth analogue)


def pack_entry(verdict: int, proxy_port: int = 0,
               auth: bool = False) -> int:
    return ((verdict & VERDICT_MASK) | (proxy_port << PROXY_SHIFT)
            | (int(bool(auth)) << AUTH_SHIFT))


def unpack_verdict(packed: np.ndarray) -> np.ndarray:
    return packed & VERDICT_MASK


def unpack_proxy(packed: np.ndarray) -> np.ndarray:
    return (packed >> PROXY_SHIFT) & PROXY_MASK


def unpack_auth(packed: np.ndarray) -> np.ndarray:
    return (packed >> AUTH_SHIFT) & 1


def packed_scatter_order(ms):
    """(contribution, packed value) pairs in SCATTER order.

    Both the full compile and the incremental ``compose_row`` write
    with last-writer-wins scatters, while the oracle's winner is the
    FIRST covering contribution of its precedence class (with
    redirects beating plain allows) — so each class iterates
    REVERSED, and denies go last.  ONE definition so the two tensor
    paths can never desynchronize."""
    out = []
    for c in reversed(ms.contributions):
        if not c.is_deny and not c.redirect:
            out.append((c, pack_entry(VERDICT_ALLOW, auth=c.auth)))
    for c in reversed(ms.contributions):
        if c.redirect and not c.is_deny:
            out.append((c, pack_entry(VERDICT_REDIRECT, c.proxy_port,
                                      auth=c.auth)))
    for c in ms.contributions:
        if c.is_deny:
            out.append((c, pack_entry(VERDICT_DENY)))
    return out


def make_proto_table() -> np.ndarray:
    """IP protocol number -> dense proto index (device lookup table)."""
    t = np.full(256, PROTO_OTHER, dtype=np.int32)
    t[6] = PROTO_TCP
    t[17] = PROTO_UDP
    t[1] = PROTO_ICMP
    t[58] = PROTO_ICMP  # ICMPv6 shares the ICMP class space
    t[132] = PROTO_SCTP
    return t


class IdentityRowMap:
    """Numeric identity <-> dense device row, with capacity headroom.

    Row 0 is pinned to numeric identity 0 (unknown/invalid), so an
    ipcache miss naturally lands on the wildcard-only policy row.
    """

    def __init__(self, capacity: int = 1024):
        import threading

        self.capacity = capacity
        self._num_to_row: Dict[int, int] = {0: 0}
        self._row_to_num = np.zeros(capacity, dtype=np.int64)
        self._next = 1
        self._free: List[int] = []  # recycled rows (identity released)
        # bumped on every mapping mutation: the map object is REUSED
        # across regenerations, so consumers holding decode snapshots
        # (the serving path's per-batch numerics) must key refreshes
        # on (id(map), version), never on object identity alone
        self.version = 0
        # mutation lock: the map is shared between REGENERATION
        # (resolve + compile on API/trigger threads) and live CHURN
        # patch builders (loader table-builder lock) — add/remove
        # are compound (free-list pop / next bump + two stores) and
        # an interleaving could hand ONE row to two identities, the
        # silent-misverdict class ISSUE 10 exists to close.  Reads
        # (row/numeric lookups) stay lock-free: CPython dict/array
        # point reads are GIL-atomic against these locked mutations
        self._mut = threading.Lock()
        # rows_of's sorted (version, keys, rows), rebuilt on a new version
        self._index = None

    def row_occupancy(self) -> Tuple[int, int]:
        # thread-affinity: any
        """(mapped identities, current capacity) — the policy-table
        pressure sample (ISSUE 19).  Capacity grows on demand, so
        the fraction reads headroom-to-next-grow: the moment
        identity churn is about to pay a regeneration.  (Named
        distinctly from the drain-affine arena ``occupancy`` — the
        callgraph's name-match fallback must not bind them.)"""
        with self._mut:
            return len(self._num_to_row), self.capacity

    def add(self, numeric_id: int) -> int:
        with self._mut:
            row = self._num_to_row.get(numeric_id)
            if row is not None:
                return row
            if self._free:
                row = self._free.pop()
            else:
                if self._next >= self.capacity:
                    self._grow()
                row = self._next
                self._next += 1
            self._num_to_row[numeric_id] = row
            self._row_to_num[row] = numeric_id
            self.version += 1
            return row

    def remove(self, numeric_id: int) -> Optional[int]:
        """Recycle a released identity's row (fqdn/identity churn must
        not grow the verdict tensor without bound).  Callers free a
        row ONLY after its tensor contents were reset to defaults and
        no LPM entry references it."""
        with self._mut:
            row = self._num_to_row.pop(numeric_id, None)
            if row is None or row == 0:
                return None
            self._row_to_num[row] = 0
            self._free.append(row)
            self.version += 1
            return row

    def _grow(self) -> None:
        self.capacity *= 2
        grown = np.zeros(self.capacity, dtype=np.int64)
        grown[: len(self._row_to_num)] = self._row_to_num
        self._row_to_num = grown

    def row(self, numeric_id: int) -> int:
        return self._num_to_row.get(numeric_id, 0)

    def rows_of(self, numerics) -> np.ndarray:
        # thread-affinity: any
        """:meth:`row` over an array: numeric identities [N] -> rows [N]
        int64, 0 for an unknown identity.  One sorted-key search a call
        (the sorted keys rebuilt once per mapping version), for the
        per-event consumers (the anomaly scorer)."""
        index = self._index
        if index is None or index[0] != self.version:
            with self._mut:
                keys = np.fromiter(self._num_to_row, np.int64,
                                   len(self._num_to_row))
                rows = np.fromiter(self._num_to_row.values(), np.int64,
                                   len(keys))
                order = np.argsort(keys)
                index = (self.version, keys[order], rows[order])
            self._index = index
        _, keys, rows = index
        nums = np.asarray(numerics, dtype=np.int64)
        pos = np.minimum(np.searchsorted(keys, nums), len(keys) - 1)
        return np.where(keys[pos] == nums, rows[pos], 0)

    def numeric(self, row: int) -> int:
        return int(self._row_to_num[row]) if 0 <= row < self.capacity else 0

    def rows_for(self, ids: Iterable[int]) -> np.ndarray:
        rows = [self._num_to_row[i] for i in ids if i in self._num_to_row]
        return np.asarray(sorted(rows), dtype=np.int32)

    @property
    def n_rows(self) -> int:
        return self._next

    def numeric_array(self) -> np.ndarray:
        """Device-side row -> numeric identity table (for event decode)."""
        return self._row_to_num.copy()


@dataclass
class PolicyTensors:
    """The compiled device policy state (all host-side numpy; the
    datapath uploads them as jax arrays)."""

    proto_table: np.ndarray  # [256] int32: ip proto -> dense proto
    port_class: np.ndarray  # [N_PROTO, 65536] int32: dport -> class
    n_classes: int
    verdict: np.ndarray  # [n_pol, 2, n_rows, n_local_padded] int32
    policy_index: Dict[str, int]  # subject labels key -> policy row
    row_map: IdentityRowMap
    class_intervals: Dict[int, List[Tuple[int, int, int]]] = field(
        default_factory=dict)  # proto -> [(lo, hi_excl, class_id)]
    # per-policy class compaction (r05, SURVEY §7 hard part 3 / HBM
    # audit): GLOBAL classes refine the union of every policy's port
    # boundaries, so their count scales with the number of DISTINCT
    # policies — 128 policies x 10k identities was a 17 GB dense
    # tensor.  Each policy only distinguishes its OWN boundaries, so
    # the verdict tensor's last axis is per-policy LOCAL classes and
    # ``class_map`` [n_pol, n_classes_padded] maps global -> local
    # (one extra tiny gather on device; 32x HBM on that config).
    class_map: Optional[np.ndarray] = None

    def policy_row(self, subject_key: str) -> int:
        return self.policy_index[subject_key]

    # NumPy reference of the device lookup — used by CPU tests and as
    # executable documentation of the gather semantics.
    def lookup_np(self, policy_row: np.ndarray, direction: np.ndarray,
                  id_row: np.ndarray, ip_proto: np.ndarray,
                  dport: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        proto = self.proto_table[ip_proto]
        cls = self.port_class[proto, dport]
        cls = self.class_map[policy_row, cls]
        packed = self.verdict[policy_row, direction, id_row, cls]
        return unpack_verdict(packed), unpack_proxy(packed)

    def hbm_bytes(self) -> int:
        """Device bytes of the compiled policy state (the audit
        number: verdict dominates; class_map/port_class are fixed)."""
        return (self.verdict.nbytes + self.class_map.nbytes
                + self.port_class.nbytes + self.proto_table.nbytes)


def policy_fingerprint(pol: EndpointPolicy) -> tuple:
    """Structural fingerprint of one resolved policy — everything
    that feeds its verdict-tensor slice: subject key, enforcement,
    and every contribution's (proto, port range, verdict class,
    proxy, auth, FROZEN peer set).  Two policies with equal
    fingerprints compile to byte-equal ``verdict[pi]`` slices (given
    the same row map), which is exactly what
    :func:`~..policy.incremental.delta_compile` needs to reuse the
    previous attach's slice instead of repainting it.

    Identity churn is IN the fingerprint (``identities``): an
    identity joining a selector's peer set marks only the policies
    whose selectors changed — the delta-compile partition the r05
    class compaction set up."""

    def ms_fp(ms) -> tuple:
        return (bool(ms.enforcing), tuple(
            (c.proto, c.lo, c.hi, bool(c.is_deny), bool(c.redirect),
             int(c.proxy_port), bool(c.auth),
             None if c.identities is None
             else tuple(sorted(c.identities)))
            for c in ms.contributions))

    return (pol.subject_labels.sorted_key(),
            ms_fp(pol.ingress), ms_fp(pol.egress))


def _collect_boundaries(policies: Sequence[EndpointPolicy]
                        ) -> Dict[int, np.ndarray]:
    """Per-proto sorted boundary sets partitioning [0, 65536)."""
    bounds: Dict[int, set] = {p: {0, 65536} for p in range(N_PROTO)}
    for pol in policies:
        for ms in (pol.ingress, pol.egress):
            for c in ms.contributions:
                protos = (range(N_PROTO) if c.proto == PROTO_ANY
                          else [c.proto])
                for p in protos:
                    bounds[p].add(c.lo)
                    bounds[p].add(c.hi + 1)
    return {p: np.asarray(sorted(x for x in b if 0 <= x <= 65536),
                          dtype=np.int64)
            for p, b in bounds.items()}


@dataclass
class ClassStructure:
    """The class-partition half of a compile — everything EXCEPT the
    verdict paint.  Shared by :func:`compile_policy` and the delta
    path (``policy.incremental.delta_compile``): ONE definition so a
    delta attach can never desynchronize from a full one."""

    port_class: np.ndarray  # [N_PROTO, 65536] global classes
    n_classes: int
    class_intervals: Dict[int, List[Tuple[int, int, int]]]
    class_map: np.ndarray  # [n_pol, n_classes_padded] global -> local
    local_bounds: List[Dict[int, np.ndarray]]
    local_base: List[Dict[int, int]]
    n_local_padded: int


def class_structure(policies: Sequence[EndpointPolicy],
                    class_pad: int = 128) -> ClassStructure:
    """Global + per-policy-local port class partitions."""
    bounds = _collect_boundaries(policies)
    port_class = np.zeros((N_PROTO, 65536), dtype=np.int32)
    class_intervals: Dict[int, List[Tuple[int, int, int]]] = {}
    next_class = 0
    for p in range(N_PROTO):
        b = bounds[p]
        intervals = []
        for lo, hi in zip(b[:-1], b[1:]):
            port_class[p, lo:hi] = next_class
            intervals.append((int(lo), int(hi), next_class))
            next_class += 1
        class_intervals[p] = intervals
    n_classes = next_class
    n_classes_padded = -(-n_classes // class_pad) * class_pad

    # per-policy LOCAL class spaces (see PolicyTensors.class_map): a
    # policy's boundaries partition each proto's port space much more
    # coarsely than the global union; the verdict tensor's last axis
    # is sized to the WIDEST policy, not the union
    local_bounds = [_collect_boundaries([pol]) for pol in policies]
    local_base: List[Dict[int, int]] = []
    n_local_max = 1
    for lb in local_bounds:
        base: Dict[int, int] = {}
        nxt = 0
        for p in range(N_PROTO):
            base[p] = nxt
            nxt += len(lb[p]) - 1
        local_base.append(base)
        n_local_max = max(n_local_max, nxt)
    n_local_padded = -(-n_local_max // class_pad) * class_pad
    class_map = np.zeros((max(len(policies), 1), n_classes_padded),
                         dtype=np.int32)
    for pi, lb in enumerate(local_bounds):
        for p in range(N_PROTO):
            for lo, _hi, g in class_intervals[p]:
                k = int(np.searchsorted(lb[p], lo, side="right")) - 1
                class_map[pi, g] = local_base[pi][p] + k
    return ClassStructure(
        port_class=port_class, n_classes=n_classes,
        class_intervals=class_intervals, class_map=class_map,
        local_bounds=local_bounds, local_base=local_base,
        n_local_padded=n_local_padded)


def paint_policy(pol: EndpointPolicy, pi: int,
                 struct: ClassStructure, row_map: IdentityRowMap,
                 width: Optional[int] = None) -> np.ndarray:
    """One policy's verdict slice [2, n_rows, width] — the per-policy
    half of the compile, shared verbatim by :func:`compile_policy`
    and the delta path.  ``width`` may exceed the structure's
    ``n_local_padded`` (delta reuse into a wider existing tensor: the
    extra padding classes keep the direction default, and the class
    map never addresses them)."""
    lb = struct.local_bounds[pi]
    base = struct.local_base[pi]
    width = struct.n_local_padded if width is None else width
    out = np.zeros((2, row_map.capacity, width), dtype=np.int32)

    def classes_for(proto: int, lo: int, hi: int) -> np.ndarray:
        # contribution bounds are local boundaries by construction
        k0 = int(np.searchsorted(lb[proto], lo, side="right")) - 1
        k1 = int(np.searchsorted(lb[proto], hi, side="right")) - 1
        return np.arange(base[proto] + k0, base[proto] + k1 + 1)

    for di, ms in ((0, pol.ingress), (1, pol.egress)):
        default = (pack_entry(VERDICT_DEFAULT_DENY) if ms.enforcing
                   else pack_entry(VERDICT_ALLOW))
        out[di, :, :] = default
        for c, val in packed_scatter_order(ms):
            protos = (range(N_PROTO) if c.proto == PROTO_ANY
                      else [c.proto])
            cls = np.unique(np.concatenate(
                [classes_for(p, c.lo, c.hi) for p in protos]))
            if c.identities is None:
                out[di][:, cls] = val
            else:
                rows = row_map.rows_for(c.identities)
                if rows.size:
                    out[di][np.ix_(rows, cls)] = val
    return out


def ensure_identity_rows(policies: Sequence[EndpointPolicy],
                         row_map: IdentityRowMap) -> None:
    """Every identity referenced by any contribution gets a row."""
    for pol in policies:
        for ms in (pol.ingress, pol.egress):
            for c in ms.contributions:
                if c.identities:
                    for i in c.identities:
                        row_map.add(i)


def compile_policy(
    policies: Sequence[EndpointPolicy],
    row_map: IdentityRowMap,
    class_pad: int = 128,
) -> PolicyTensors:
    """Compile resolved endpoint policies into dense device tensors.

    O(contributions x touched-rows) via vectorized numpy scatters; the
    10k-identity benchmark set compiles in milliseconds.
    """
    ensure_identity_rows(policies, row_map)
    struct = class_structure(policies, class_pad)

    verdict = np.zeros((len(policies), 2, row_map.capacity,
                        struct.n_local_padded), dtype=np.int32)
    policy_index: Dict[str, int] = {}
    for pi, pol in enumerate(policies):
        policy_index[pol.subject_labels.sorted_key()] = pi
        verdict[pi] = paint_policy(pol, pi, struct, row_map)

    return PolicyTensors(
        proto_table=make_proto_table(),
        port_class=struct.port_class,
        n_classes=struct.n_classes,
        verdict=verdict,
        policy_index=policy_index,
        row_map=row_map,
        class_intervals=struct.class_intervals,
        class_map=struct.class_map,
    )
