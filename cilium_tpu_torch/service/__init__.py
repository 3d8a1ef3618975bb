"""The node's service plane: the service load balancer (frontends,
Maglev backend selection, the DNAT rewrite; ``socklb.py`` caches the
selection per flow) and egress NAT (``nat.py``).

Reference: the JAX package's ``service/__init__.py`` (itself upstream
``pkg/service`` + ``pkg/loadbalancer`` + ``bpf/lib/lb.h``): k8s Services
become frontend (VIP:port/proto) -> backend sets, selected by Maglev
consistent hashing and DNAT'd before the policy pipeline.

- the Maglev permutation of each service fills on the host (the classic
  offset/skip fill over a prime table size, default 16381 like
  upstream's ``--bpf-lb-maglev-table-size``); a service whose backends
  did not change keeps its filled row across recompiles;
- frontends compile to compare tensors, backends to a flat table, on
  an explicit device (:class:`LBTensors`, :class:`LBTensors6`);
- selection is ``maglev[svc, flow_hash % m]``, then the DNAT rewrite.

:func:`lb_stage` and :func:`lb6_stage` send CUDA tensors to their
kernels (``csrc/lb.cu``: K15 ``lb_stage_kernel``, K16
``lb6_stage_kernel``) and CPU tensors to their ``*_plain`` versions.
u32 words are int32 bit patterns (``u32.py``); the hash and the slot
are taken on the widened (unsigned) value.

Consistent-hashing property (the reason Maglev exists): removing one
backend reassigns only ~1/B of flows.
"""

from __future__ import annotations

import ipaddress
import math
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.packets import (
    COL_DPORT,
    COL_DST_IP0,
    COL_DST_IP3,
    COL_FAMILY,
    COL_PROTO,
    COL_SPORT,
    COL_SRC_IP0,
    COL_SRC_IP3,
    ip_to_words,
)
from ..datapath.conntrack import _first_true, _require_cpu
from ..device import resolve_device
from ..u32 import from_numpy, mul, widen

M_DEFAULT = 16381  # prime; upstream --bpf-lb-maglev-table-size default


def _fnv1a64(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h = ((h ^ b) * 0x100000001B3) & ((1 << 64) - 1)
    return h


def maglev_table(backend_keys: Sequence[str], m: int = M_DEFAULT,
                 weights: Optional[Sequence[int]] = None) -> np.ndarray:
    """The classic Maglev population: each backend walks its own
    permutation (offset + j*skip mod m) claiming free slots round-
    robin until the table is full.  [m] int32 of backend indices;
    all -1 when there are no backends.

    ``weights`` (Maglev paper §3.4 / upstream's weighted
    ``bpf-lb-maglev``): per sweep, a backend claims a slot only while
    its claim count is at or below its quota ``filled * w_i / sum(w)``
    -- slot share converges to w/sum(w) for ANY weight magnitudes.
    Weight 0 backends take no slots (drained).  The fill walks Python
    ints and lists (the same sequence of claims as a numpy walk, several
    times faster at m = 16381)."""
    n = len(backend_keys)
    if n == 0:
        return np.full(m, -1, dtype=np.int32)
    w = [1] * n if weights is None else [int(x) for x in weights]
    if len(w) != n:
        raise ValueError("weights length != backends length")
    if any(x < 0 for x in w):
        raise ValueError("negative backend weight")
    if not any(w):
        return np.full(m, -1, dtype=np.int32)  # all drained
    skips = []
    cursor = []  # each backend's next permutation slot
    for key in backend_keys:
        kb = key.encode()
        cursor.append(_fnv1a64(kb) % m)
        skips.append(_fnv1a64(kb + b"skip") % (m - 1) + 1)
    live = [i for i in range(n) if w[i]]
    if len(live) == 1 and math.gcd(skips[live[0]], m) == 1:
        # one backend takes turns alone: its permutation visits every
        # slot, so it claims them all
        return np.full(m, live[0], dtype=np.int32)
    table = [-1] * m
    claims = [0] * n
    total_w = sum(w)
    filled = 0
    # every sweep makes progress: if no backend were behind quota,
    # summing claims[i]*total_w > filled*w[i] over i gives the
    # contradiction filled*total_w > filled*total_w
    while filled < m:
        for i in range(n):
            if w[i] == 0 or claims[i] * total_w > filled * w[i]:
                continue  # at/above quota this sweep
            # advance backend i's permutation to its next free slot
            slot, skip = cursor[i], skips[i]
            while table[slot] >= 0:
                slot += skip
                if slot >= m:
                    slot -= m
            table[slot] = i
            slot += skip
            cursor[i] = slot - m if slot >= m else slot
            claims[i] += 1
            filled += 1
            if filled == m:
                break
    return np.asarray(table, dtype=np.int32)


@dataclass(frozen=True)
class Backend:
    ip: str
    port: int
    weight: int = 1  # weighted Maglev fill turns (0 = drained)

    @property
    def key(self) -> str:
        return f"{self.ip}:{self.port}"


@dataclass
class Service:
    name: str
    frontend_ip: str
    frontend_port: int
    protocol: int = 6  # TCP
    backends: List[Backend] = field(default_factory=list)
    # frontend class, for display + scope bookkeeping (reference:
    # pkg/loadbalancer SVCType): ClusterIP | NodePort | ExternalIP |
    # LoadBalancer | LocalRedirect
    kind: str = "ClusterIP"
    # sessionAffinity: ClientIP timeout in seconds (0 = disabled)
    affinity_timeout: int = 0

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "frontend": f"{self.frontend_ip}:{self.frontend_port}",
            "protocol": self.protocol,
            "kind": self.kind,
            "backends": [{"ip": b.ip, "port": b.port,
                          "weight": b.weight} for b in self.backends],
            **({"sessionAffinityTimeout": self.affinity_timeout}
               if self.affinity_timeout else {}),
        }


@dataclass
class LBTensors:
    """The compiled v4 frontends on one device (int32 bit patterns).
    ``index`` is :func:`lb4_index` of the frontends, which K15 probes;
    the plain version ignores it."""

    svc_ip: torch.Tensor  # [S] frontend v4 address
    svc_port: torch.Tensor  # [S]
    svc_proto: torch.Tensor  # [S]
    maglev: torch.Tensor  # [S, m] int32 -> backend table row (-1 none)
    backend_ip: torch.Tensor  # [B]
    backend_port: torch.Tensor  # [B]
    svc_aff: torch.Tensor  # [S] ClientIP affinity TTL (0 = off)
    index: torch.Tensor  # [2^k > S, 4] int32: a key, its lowest frontend
    m: int

    @staticmethod
    def from_numpy(svc_ip, svc_port, svc_proto, maglev, backend_ip,
                   backend_port, svc_aff, m: int, device=None) -> "LBTensors":
        """numpy arrays (the JAX package's leaves) -> tensors on
        ``device`` (None: the card), with the frontends' index."""
        device = resolve_device(device)
        index = lb4_index(svc_ip, svc_port, svc_proto)
        return LBTensors(*(from_numpy(a, device) for a in (
            svc_ip, svc_port, svc_proto, maglev, backend_ip, backend_port,
            svc_aff, index)), m=int(m))


@dataclass
class LBTensors6:
    """The compiled v6 frontends (dual-stack services; reference: lb6
    maps).  Word layout matches the header tensor's 4-word big-endian
    IP columns.  ``index`` is :func:`lb6_index` of the frontends, which
    K16 probes; the plain version ignores it."""

    svc_ip: torch.Tensor  # [S, 4] frontend v6 words
    svc_port: torch.Tensor  # [S]
    svc_proto: torch.Tensor  # [S]
    maglev: torch.Tensor  # [S, m]
    backend_ip: torch.Tensor  # [B, 4]
    backend_port: torch.Tensor  # [B]
    index: torch.Tensor  # [2^k > S] int32: lowest frontend of a key, -1
    m: int

    @staticmethod
    def from_numpy(svc_ip, svc_port, svc_proto, maglev, backend_ip,
                   backend_port, m: int, device=None) -> "LBTensors6":
        """numpy arrays (the JAX package's leaves) -> tensors on
        ``device`` (None: the card), with the frontends' index."""
        device = resolve_device(device)
        index = lb6_index(svc_ip, svc_port, svc_proto)
        return LBTensors6(*(from_numpy(a, device) for a in (
            svc_ip, svc_port, svc_proto, maglev, backend_ip,
            backend_port, index)), m=int(m))


def lb6_index_hash(keys: np.ndarray) -> np.ndarray:
    """[K, 6] u32 frontend keys (address words, port, protocol) -> their
    u32 slot hashes (u32 wrapping).  A copy of ``csrc/lb.cuh``
    ``lb6_index_hash``, the one source of the constants: the kernel probes
    from the slot this puts a frontend in."""
    k = np.asarray(keys, np.uint32)
    h = np.zeros(len(k), np.uint32)
    for col, c in enumerate((0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35,
                             0x27D4EB2F, 0x165667B1, 1)):
        h ^= k[:, col] * np.uint32(c)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x7FEB352D)
    return h ^ (h >> np.uint32(15))


def lb6_index(svc_ip, svc_port, svc_proto) -> np.ndarray:
    """The v6 frontends' open-addressing index: [cap] int32, cap the
    least power of two at least 2 S (and 2), each slot -1 or the LOWEST
    frontend of one key (address words, port, protocol), placed by
    linear probing from its :func:`lb6_index_hash` slot.  Half the slots
    stay empty, so every probe ends; the lowest index of a key is the
    reference's argmax over an [N, S] compare."""
    keys = np.concatenate([np.asarray(svc_ip, np.uint32).reshape(-1, 4),
                           np.asarray(svc_port, np.uint32)[:, None],
                           np.asarray(svc_proto, np.uint32)[:, None]], 1)
    cap = 1 << max(1, (2 * len(keys) - 1).bit_length())
    index = np.full(cap, -1, np.int32)
    home = lb6_index_hash(keys) & np.uint32(cap - 1)
    seen = set()
    for q, key in enumerate(map(bytes, keys)):
        if key in seen:
            continue  # a higher name on a key already indexed
        seen.add(key)
        h = int(home[q])
        while index[h] >= 0:
            h = (h + 1) & (cap - 1)
        index[h] = q
    return index


def lb4_index(svc_ip, svc_port, svc_proto) -> np.ndarray:
    """The v4 frontends' index, which K15 probes (``csrc/lb.cuh``
    ``lb_find4``): [cap, 4] int32, a slot of :func:`lb6_index`'s
    placement each, its key (address, port, protocol) and the LOWEST
    frontend of that key, or zeros and -1 where it is empty.  A key
    hashes as a v6 key whose address is 0, 0, 0 and the v4 address
    (:func:`lb6_index_hash`: one source of the constants)."""
    ip = np.asarray(svc_ip, np.uint32).reshape(-1)
    port = np.asarray(svc_port, np.uint32).reshape(-1)
    proto = np.asarray(svc_proto, np.uint32).reshape(-1)
    words = np.zeros((len(ip), 4), np.uint32)
    words[:, 3] = ip
    front = lb6_index(words, port, proto)
    index = np.zeros((len(front), 4), np.uint32)
    index[:, 3] = 0xFFFFFFFF  # -1: empty
    held = front >= 0
    index[held] = np.stack([ip[front[held]], port[front[held]],
                            proto[front[held]],
                            front[held].astype(np.uint32)], 1)
    return index.view(np.int32)


def _split_hostport(s: str) -> Tuple[str, int]:
    """"ip:port" / "[v6]:port" / "v6:port" -> (ip, port)."""
    if s.startswith("["):
        host, _, port = s[1:].partition("]:")
        return host, int(port)
    host, _, port = s.rpartition(":")
    return host, int(port)


def _is_v6(ip: str) -> bool:
    return ":" in ip


class ServiceManager:
    """The service registry + compiler (pkg/service analogue); the
    compiled tensors live on ``device`` (None: the card)."""

    def __init__(self, m: int = M_DEFAULT, device=None):
        self._lock = threading.Lock()
        self._services: Dict[str, Service] = {}
        self.m = m
        self.device = resolve_device(device)
        self._tensors: Optional[LBTensors] = None
        self._tensors6 = None  # LBTensors6 | False ("no v6") | None
        self._version = 0  # bumps on any upsert/delete (see .version)
        # (backend keys, weights) -> filled Maglev row, kept across
        # compiles while some service uses the backend set
        self._maglev: Dict[tuple, np.ndarray] = {}

    def upsert(self, name: str, frontend: str, backends: Sequence[str],
               protocol: int = 6,
               weights: Optional[Sequence[int]] = None,
               kind: str = "ClusterIP",
               affinity_timeout: int = 0) -> Service:
        """``frontend``/``backends`` are "ip:port" strings;
        ``weights`` (optional, parallel to ``backends``) drive the
        weighted Maglev fill.  A service may carry ZERO backends: its
        frontend still compiles, and matching traffic DROPS with
        ``REASON_NO_SERVICE`` (upstream DROP_NO_SERVICE)."""
        fip, fport = _split_hostport(frontend)
        if weights is not None and len(weights) != len(backends):
            raise ValueError("weights length != backends length")
        bes = []
        for i, b in enumerate(backends):
            bip, bport = _split_hostport(b)
            bes.append(Backend(bip, bport,
                               weight=(int(weights[i])
                                       if weights is not None else 1)))
        svc = Service(name=name, frontend_ip=fip,
                      frontend_port=int(fport), protocol=protocol,
                      kind=kind, affinity_timeout=int(affinity_timeout),
                      backends=bes)
        with self._lock:
            self._services[name] = svc
            self._tensors = None
            self._tensors6 = None
            self._version += 1
        return svc

    def delete(self, name: str) -> bool:
        with self._lock:
            gone = self._services.pop(name, None) is not None
            if gone:
                self._tensors = None
                self._tensors6 = None
                self._version += 1
        return gone

    @property
    def version(self) -> int:
        """Monotone change counter -- consumers holding derived state
        (the daemon's ClientIP affinity prune) compare against it."""
        with self._lock:
            return self._version

    def backend_set(self) -> set:
        """The live (ip, port) v4 backend universe, for affinity
        pruning."""
        with self._lock:
            return {(int(ipaddress.IPv4Address(b.ip)), b.port)
                    for s in self._services.values()
                    for b in s.backends if not _is_v6(b.ip)}

    @property
    def any_affinity(self) -> bool:
        """True when any installed service pins ClientIP affinity --
        gates the daemon's prune sweep."""
        with self._lock:
            return any(s.affinity_timeout
                       for s in self._services.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._services)

    def get(self, name: str) -> Optional[Service]:
        with self._lock:
            return self._services.get(name)

    def list(self) -> List[Service]:
        with self._lock:
            return [self._services[k]
                    for k in sorted(self._services)]

    def tensors(self) -> LBTensors:
        with self._lock:
            if self._tensors is None:
                self._tensors = self._compile()
            return self._tensors

    def tensors6(self) -> Optional[LBTensors6]:
        """Compiled V6 frontends, or None when no service carries a
        v6 frontend (an all-v4 cluster skips the v6 pass)."""
        with self._lock:
            if self._tensors6 is None:
                self._tensors6 = self._compile6()
            return self._tensors6 or None

    def _fill(self, bes: List[Backend], base: int) -> np.ndarray:
        """One service's Maglev row over the table rows from ``base``."""
        key = (tuple(be.key for be in bes), tuple(be.weight for be in bes))
        local = self._maglev.get(key)
        if local is None:
            local = self._maglev[key] = maglev_table(list(key[0]), self.m,
                                                     weights=key[1])
        return np.where(local >= 0, local + base, -1)

    def _prune_maglev(self) -> None:
        """Drop the kept rows of backend sets no service uses."""
        used = set()
        for svc in self._services.values():
            for v6 in (False, True):
                bes = [be for be in svc.backends if _is_v6(be.ip) == v6]
                used.add((tuple(be.key for be in bes),
                          tuple(be.weight for be in bes)))
        self._maglev = {k: v for k, v in self._maglev.items() if k in used}

    def _compile_family(self, v6: bool):
        """-> (services, frontend words [S, 4], port, proto, aff,
        maglev [S, m], backend words [B, 4], backend port), S >= 1 for
        the v4 family (one all-miss row when empty)."""
        self._prune_maglev()
        svcs = [self._services[k] for k in sorted(self._services)
                if _is_v6(self._services[k].frontend_ip) == v6]
        s = len(svcs) if v6 else max(len(svcs), 1)
        svc_ip = np.zeros((s, 4), dtype=np.uint32)
        svc_port = np.zeros(s, dtype=np.uint32)
        svc_proto = np.zeros(s, dtype=np.uint32)
        svc_aff = np.zeros(s, dtype=np.uint32)
        maglev = np.full((s, self.m), -1, dtype=np.int32)
        b_ip: List[Tuple[int, int, int, int]] = []
        b_port: List[int] = []
        for i, svc in enumerate(svcs):
            svc_ip[i] = ip_to_words(svc.frontend_ip)
            svc_port[i] = svc.frontend_port
            svc_proto[i] = svc.protocol
            svc_aff[i] = svc.affinity_timeout
            base = len(b_ip)
            # family consistency: a frontend DNATs only to backends of
            # its own family (k8s dual-stack slices are per-family)
            bes = [be for be in svc.backends if _is_v6(be.ip) == v6]
            for be in bes:
                b_ip.append(ip_to_words(be.ip))
                b_port.append(be.port)
            maglev[i] = self._fill(bes, base)
        if not b_ip:
            b_ip, b_port = [(0, 0, 0, 0)], [0]
        return (svcs, svc_ip, svc_port, svc_proto, svc_aff, maglev,
                np.asarray(b_ip, dtype=np.uint32),
                np.asarray(b_port, dtype=np.uint32))

    def _compile6(self):
        (svcs, svc_ip, svc_port, svc_proto, _aff, maglev, b_ip,
         b_port) = self._compile_family(v6=True)
        if not svcs:
            return False  # cached "no v6" marker (None = stale)
        return LBTensors6.from_numpy(svc_ip, svc_port, svc_proto, maglev,
                                     b_ip, b_port, self.m, self.device)

    def _compile(self) -> LBTensors:
        (_svcs, svc_ip, svc_port, svc_proto, svc_aff, maglev, b_ip,
         b_port) = self._compile_family(v6=False)
        return LBTensors.from_numpy(svc_ip[:, 3], svc_port, svc_proto,
                                    maglev, b_ip[:, 3], b_port, svc_aff,
                                    self.m, self.device)


# --- the device stages ------------------------------------------------


def _lb_hash4(h: torch.Tensor) -> torch.Tensor:
    """The v4 flow hash over widened rows (the dst side is the VIP, so
    src ip/port dominate; the same flow always takes the same slot)."""
    return (mul(h[:, COL_SRC_IP3], 0x9E3779B1)
            ^ mul(h[:, COL_SPORT], 0x85EBCA6B)
            ^ mul(h[:, COL_DST_IP3], 0xC2B2AE35)
            ^ h[:, COL_DPORT] ^ h[:, COL_PROTO])


def _lb_hash6(h: torch.Tensor) -> torch.Tensor:
    return (mul(h[:, COL_SRC_IP0], 0x9E3779B1)
            ^ mul(h[:, COL_SRC_IP0 + 1], 0x85EBCA6B)
            ^ mul(h[:, COL_SRC_IP0 + 2], 0xC2B2AE35)
            ^ mul(h[:, COL_SRC_IP3], 0x27D4EB2F)
            ^ mul(h[:, COL_SPORT], 0x165667B1)
            ^ h[:, COL_DST_IP3] ^ h[:, COL_DPORT] ^ h[:, COL_PROTO])


def _lb_select(t, hit_s: torch.Tensor, flow_hash: torch.Tensor):
    """The lowest matching frontend of each row and its Maglev pick:
    -> (svc [N], hit [N], have_backend [N], no_backend [N], backend
    row [N], clamped to 0 where there is none)."""
    svc = _first_true(hit_s)
    hit = hit_s.any(dim=1)
    be = t.maglev[svc, flow_hash % t.m]
    return (svc, hit, hit & (be >= 0), hit & (be < 0),
            be.clamp(min=0).to(torch.int64))


def _lb_match4(t: LBTensors, hdr: torch.Tensor) -> torch.Tensor:
    """[N, S] frontend hits of v4 rows (int32 bit patterns compare
    equal iff their u32 words do)."""
    return ((hdr[:, COL_DST_IP3, None] == t.svc_ip[None, :])
            & (hdr[:, COL_DPORT, None] == t.svc_port[None, :])
            & (hdr[:, COL_PROTO, None] == t.svc_proto[None, :])
            & (hdr[:, COL_FAMILY] == 4)[:, None])


def lb_stage_plain(t: LBTensors, hdr: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched frontend match + Maglev select + DNAT rewrite (plain
    version).  -> (hdr', have_backend [N] bool, no_backend [N] bool);
    hdr' has dst ip/port rewritten to the selected backend for hits.
    The lowest matching frontend wins (two names may share a VIP:port).
    ``no_backend`` marks rows whose dst matched a frontend that selects
    nothing -- upstream drops these with DROP_NO_SERVICE."""
    h = widen(hdr)
    _svc, _hit, have, no_be, be = _lb_select(t, _lb_match4(t, hdr),
                                             _lb_hash4(h))
    out = hdr.clone()
    out[:, COL_DST_IP3] = torch.where(have, t.backend_ip[be],
                                      hdr[:, COL_DST_IP3])
    out[:, COL_DPORT] = torch.where(have, t.backend_port[be],
                                    hdr[:, COL_DPORT])
    return out, have, no_be


def lb_stage(t: LBTensors, hdr: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """See :func:`lb_stage_plain`.  CUDA tensors launch K15
    (``csrc/lb.cu``)."""
    if hdr.is_cuda:
        from ..kernels import launch_lb_stage

        return launch_lb_stage(t, hdr)
    _require_cpu(hdr, "lb_stage")
    return lb_stage_plain(t, hdr)


def lb6_stage_plain(t: LBTensors6, hdr: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The v6 frontend pass (plain version): 4-word dst compare +
    Maglev + DNAT; v4 rows pass untouched.  Composes after the v4
    socket-LB stage in the daemon (v6 services ride this per-packet
    path, not the flow cache)."""
    dstw = hdr[:, COL_DST_IP0:COL_DST_IP0 + 4]
    hit_s = ((dstw[:, None, :] == t.svc_ip[None, :, :]).all(dim=-1)
             & (hdr[:, COL_DPORT, None] == t.svc_port[None, :])
             & (hdr[:, COL_PROTO, None] == t.svc_proto[None, :])
             & (hdr[:, COL_FAMILY] == 6)[:, None])
    _svc, _hit, have, no_be, be = _lb_select(t, hit_s, _lb_hash6(widen(hdr)))
    out = hdr.clone()
    out[:, COL_DST_IP0:COL_DST_IP0 + 4] = torch.where(
        have[:, None], t.backend_ip[be], dstw)
    out[:, COL_DPORT] = torch.where(have, t.backend_port[be],
                                    hdr[:, COL_DPORT])
    return out, have, no_be


def lb6_stage(t: LBTensors6, hdr: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """See :func:`lb6_stage_plain`.  CUDA tensors launch K16
    (``csrc/lb.cu``)."""
    if hdr.is_cuda:
        from ..kernels import launch_lb6_stage

        return launch_lb6_stage(t, hdr)
    _require_cpu(hdr, "lb6_stage")
    return lb6_stage_plain(t, hdr)

