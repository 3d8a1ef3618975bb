"""Longest-prefix-match as gather tables (the ipcache LPM map).

Reference: upstream cilium's ipcache is a kernel ``LPM_TRIE`` BPF map
(``bpf/lib/eps.h`` ``lookup_ip4_remote_endpoint`` /
``pkg/maps/ipcache``).  The host compiles all prefixes into a
DIR-16-8-8 multibit table so the device lookup is **three gathers**
with no data-dependent control flow:

    a = l1[ip >> 16]           # [65536]
    b = a>=0 ? a : l2[-a-1, (ip >> 8) & 0xFF]
    c = b>=0 ? b : l3[-b-1, ip & 0xFF]

Non-negative entries are values (identity rows); negative entries are
``-(block+1)`` pointers into the next level.  IPv6 uses a masked-compare
TCAM over the (typically small) v6 prefix set; on the card a v6 address
probes :func:`lpm6_index`, an exact hash index of that TCAM built with
the tables, once for each distinct mask.

The host compiler (:func:`compile_lpm`, :func:`lpm_upsert`,
:class:`LPMUndo`) is a copy of the JAX package's; :class:`LPMEntries`
indexes the loader's entry mirror.  On the card the
lookup is ``lpm_v4`` / ``lpm_v6`` in ``csrc/lpm.cuh``: the datapath
kernel calls them inline, and :func:`lpm_lookup` launches them alone
(``csrc/lpm.cu``).
"""

from __future__ import annotations

import ipaddress
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..u32 import as_index, widen

# nominal prefix budget for the map-pressure occupancy fraction
# (ISSUE 19): the DIR-16-8-8 tables grow on demand, but operators
# need a headroom signal like upstream's fixed-size ipcache map —
# this is the declared comfortable ceiling the pressure monitor and
# the map-headroom SLO measure against
LPM_NOMINAL_CAPACITY = 1 << 16


@dataclass
class LPMTensors:
    """Compiled device LPM state (host numpy; uploaded by the loader)."""

    l1: np.ndarray  # [65536] int32
    l2: np.ndarray  # [n_l2, 256] int32
    l3: np.ndarray  # [n_l3, 256] int32
    v6_net: np.ndarray  # [K, 4] uint32
    v6_mask: np.ndarray  # [K, 4] uint32
    v6_value: np.ndarray  # [K] int32
    v6_plen: np.ndarray  # [K] int32
    default: int = 0


def compile_lpm(entries: Dict[str, int], default: int = 0,
                block_pad: int = 8) -> LPMTensors:
    """Compile {cidr_string: value} into DIR-16-8-8 tables.

    Values must be >= 0 (they share sign space with block pointers).
    Longest prefix wins, implemented by painting shortest-first.
    """
    v4: List[Tuple[int, int, int]] = []  # (plen, net, value)
    v6: List[Tuple[int, int, int]] = []
    for cidr, value in entries.items():
        if value < 0:
            raise ValueError(f"LPM value must be >= 0, got {value}")
        net = ipaddress.ip_network(cidr, strict=False)
        if net.version == 4:
            v4.append((net.prefixlen, int(net.network_address), value))
        else:
            v6.append((net.prefixlen, int(net.network_address), value))
    v4.sort(key=lambda t: t[0])

    l1 = np.full(1 << 16, default, dtype=np.int32)
    l2_blocks: List[np.ndarray] = []
    l3_blocks: List[np.ndarray] = []

    def l2_block_for(hi16: int) -> np.ndarray:
        cur = l1[hi16]
        if cur < 0:
            return l2_blocks[-cur - 1]
        blk = np.full(256, cur, dtype=np.int32)  # inherit shorter prefix
        l2_blocks.append(blk)
        l1[hi16] = -len(l2_blocks)
        return blk

    def l3_block_for(blk2: np.ndarray, mid8: int) -> np.ndarray:
        cur = blk2[mid8]
        if cur < 0:
            return l3_blocks[-cur - 1]
        blk = np.full(256, cur, dtype=np.int32)
        l3_blocks.append(blk)
        blk2[mid8] = -len(l3_blocks)
        return blk

    # Shortest-first processing means child blocks never exist when a
    # shorter prefix paints its range (blocks are only created by the
    # longer prefixes processed later), so painting never has to
    # descend into existing blocks — plain range writes suffice.
    for plen, net, value in v4:
        if plen <= 16:
            lo = net >> 16
            l1[lo:lo + (1 << (16 - plen))] = value
        elif plen <= 24:
            blk2 = l2_block_for(net >> 16)
            lo = (net >> 8) & 0xFF
            blk2[lo:lo + (1 << (24 - plen))] = value
        else:
            blk2 = l2_block_for(net >> 16)
            blk3 = l3_block_for(blk2, (net >> 8) & 0xFF)
            lo = net & 0xFF
            blk3[lo:lo + (1 << (32 - plen))] = value

    v6.sort(key=lambda t: t[0])
    k = max(len(v6), 1)
    v6_net = np.zeros((k, 4), dtype=np.uint32)
    v6_mask = np.zeros((k, 4), dtype=np.uint32)
    v6_value = np.full(k, default, dtype=np.int32)
    v6_plen = np.full(k, -1, dtype=np.int32)
    for i, (plen, net, value) in enumerate(v6):
        mask = ((1 << plen) - 1) << (128 - plen) if plen else 0
        for w in range(4):
            sh = 96 - 32 * w
            v6_net[i, w] = (net >> sh) & 0xFFFFFFFF
            v6_mask[i, w] = (mask >> sh) & 0xFFFFFFFF
        v6_value[i] = value
        v6_plen[i] = plen

    def pad_blocks(blocks: List[np.ndarray]) -> np.ndarray:
        n = -(-max(len(blocks), 1) // block_pad) * block_pad
        out = np.full((n, 256), default, dtype=np.int32)
        for i, b in enumerate(blocks):
            out[i] = b
        return out

    return LPMTensors(
        l1=l1,
        l2=pad_blocks(l2_blocks),
        l3=pad_blocks(l3_blocks),
        v6_net=v6_net,
        v6_mask=v6_mask,
        v6_value=v6_value,
        v6_plen=v6_plen,
        default=default,
    )


def lpm6_index_hash(words: np.ndarray, group: np.ndarray) -> np.ndarray:
    """[K, 4] u32 masked address words and [K] group numbers -> their
    u32 slot hashes (u32 wrapping).  A copy of ``csrc/lpm.cuh``
    ``lpm6_index_hash``, the one source of the constants: the kernel
    probes from the slot this puts an entry in."""
    k = np.asarray(words, np.uint32).reshape(-1, 4)
    h = np.asarray(group, np.uint32) * np.uint32(0x165667B1)
    for col, c in enumerate((0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35,
                             0x27D4EB2F)):
        h ^= k[:, col] * np.uint32(c)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x7FEB352D)
    return h ^ (h >> np.uint32(15))


LPM6_FREE = -1  # the group word of an empty index slot


def lpm6_index(v6_net, v6_mask, v6_value, v6_plen
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The v6 TCAM's exact index, which the kernels probe in place of
    its [N, K] scan.  -> (groups, slots):

    - ``groups`` [G, 8] int32: each distinct mask of the entries that
      can win (``plen >= 0``, no ``net`` bit outside the mask), its 4
      words, the largest ``plen`` among its entries and 3 zero words, in
      descending order of that ``plen``;
    - ``slots`` [cap, 8] int32, cap the least power of two at least
      twice the keys (and 2): each slot empty (group word
      :data:`LPM6_FREE`) or one key (group, ``net``) as its ``net``
      words, its group, then the entry of the largest ``plen`` with that
      key (the lowest index among ties), its ``plen`` and its value;
      placed by linear probing from its :func:`lpm6_index_hash` slot.

    A v6 address probes each group with ``ip & mask`` and keeps the
    largest ``plen`` found, the lowest entry on a tie: the reference's
    argmax, the first entry of the longest matching prefix.  Half the
    slots stay empty, so every probe ends."""
    net = np.asarray(v6_net, np.uint32).reshape(-1, 4)
    mask = np.asarray(v6_mask, np.uint32).reshape(-1, 4)
    value = np.asarray(v6_value, np.int32).reshape(-1)
    plen = np.asarray(v6_plen, np.int32).reshape(-1)
    live = np.flatnonzero((plen >= 0) & ~(net & ~mask).any(axis=1))
    masks, inv = np.unique(mask[live], axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    top = np.full(len(masks), -1, np.int32)
    np.maximum.at(top, inv, plen[live])
    order = np.argsort(-top.astype(np.int64), kind="stable")
    rank = np.empty(len(masks), np.int64)
    rank[order] = np.arange(len(masks))
    groups = np.zeros((len(masks), 8), np.int32)
    groups[:, :4] = masks[order].view(np.int32)
    groups[:, 4] = top[order]
    # each key's entry: the largest plen, then the lowest index
    gid = rank[inv]
    k = net[live]
    o = np.lexsort((live, -plen[live].astype(np.int64), k[:, 3], k[:, 2],
                    k[:, 1], k[:, 0], gid))
    first = np.ones(len(o), bool)
    first[1:] = ((gid[o][1:] != gid[o][:-1])
                 | (k[o][1:] != k[o][:-1]).any(axis=1))
    win, wgid = live[o][first], gid[o][first]
    cap = 1 << max(1, (2 * len(win) - 1).bit_length())
    slots = np.zeros((cap, 8), np.int32)
    slots[:, 4] = LPM6_FREE
    rows = np.concatenate([net[win].view(np.int32), wgid[:, None],
                           win[:, None], plen[win, None], value[win, None]],
                          axis=1).astype(np.int32)
    # linear probing, every pending key a step a round: the first key
    # to reach a free slot takes it, the rest move on past it
    pos = (lpm6_index_hash(net[win], wgid) & np.uint32(cap - 1)).astype(
        np.int64)
    pending = np.arange(len(win))
    while len(pending):
        at = pos[pending]
        free = slots[at, 4] == LPM6_FREE
        taken, first_at = np.unique(at[free], return_index=True)
        who = pending[free][first_at]
        slots[taken] = rows[who]
        pending = np.setdiff1d(pending, who, assume_unique=True)
        pos[pending] = (pos[pending] + 1) & (cap - 1)
    return groups, slots


def lpm_used_blocks(t: LPMTensors) -> Tuple[int, int]:
    """(n_l2_used, n_l3_used) — block-pad headroom is what makes
    incremental upserts possible without reshaping device tensors."""
    # pointers encode block b as -(b+1): the used count is determined
    # by the MOST NEGATIVE pointer
    n_l2 = int(-(t.l1[t.l1 < 0]).min()) if (t.l1 < 0).any() else 0
    n_l3 = int(-(t.l2[t.l2 < 0]).min()) if (t.l2 < 0).any() else 0
    return n_l2, n_l3


def lpm_upsert(t: LPMTensors, cidr: str,
               value: int) -> Optional[List[tuple]]:
    """Insert/overwrite one HOST ROUTE (/32) in place.

    Returns the device patch list [(field, index, payload), ...] —
    ``("l1", slot, scalar)`` / ``("l2"|"l3", block, row[256])``,
    ordered children-first so a step between patch applications never
    follows a pointer into an unwritten block — or None when the entry
    needs a full recompile+upload of the LPM tensors (still never a
    policy recompile).

    ONLY /32s patch in place: the compiled tables store no per-slot
    prefix lengths, so painting a shorter prefix's range could
    overwrite longer (more-specific) sibling values and break
    longest-prefix-match — those go down the rebuild path.  A /32 is
    always the most specific, and identity churn (pod IPs, fqdn IPs)
    is host routes, so the hot path is covered.

    This is the ipcache analogue of a BPF LPM-map update: one map
    entry changes, nothing re-attaches.
    """
    if value < 0:
        raise ValueError(f"LPM value must be >= 0, got {value}")
    net = ipaddress.ip_network(cidr, strict=False)
    if net.version != 4 or net.prefixlen != 32:
        return None  # rebuild path (v6 TCAM swap / non-host-route)
    addr = int(net.network_address)
    n_l2, n_l3 = lpm_used_blocks(t)
    hi16, mid8, lo8 = addr >> 16, (addr >> 8) & 0xFF, addr & 0xFF

    # Plan the whole insert BEFORE mutating anything: a partial
    # mutation followed by a None return would leak a block per failed
    # upsert and make correctness depend on the caller discarding the
    # host mirror.
    cur1 = int(t.l1[hi16])
    l1_created = cur1 >= 0
    blk2 = n_l2 if l1_created else -cur1 - 1
    # a freshly-created l2 block inherits cur1 everywhere, so its
    # mid8 slot is cur1 (a leaf >= 0) and an l3 block is needed too
    cur2 = cur1 if l1_created else int(t.l2[blk2, mid8])
    l2_changed = cur2 >= 0
    if l1_created and n_l2 >= t.l2.shape[0]:
        return None  # l2 padding exhausted
    if l2_changed and n_l3 >= t.l3.shape[0]:
        return None  # l3 padding exhausted

    if l1_created:
        t.l2[blk2, :] = cur1  # inherit the shorter prefix's value
        t.l1[hi16] = -(blk2 + 1)
    if l2_changed:
        blk3 = n_l3
        t.l3[blk3, :] = cur2
        t.l2[blk2, mid8] = -(blk3 + 1)
    else:
        blk3 = -cur2 - 1

    t.l3[blk3, lo8] = value
    patches: List[tuple] = [("l3", blk3, t.l3[blk3].copy())]
    if l2_changed or l1_created:
        patches.append(("l2", blk2, t.l2[blk2].copy()))
    if l1_created:
        patches.append(("l1", hi16, np.int32(-(blk2 + 1))))
    return patches


class LPMEntries(Mapping):
    """The programmed ipcache prefixes, cidr -> value (the loader's host
    mirror), with the IPv4 ones indexed by (prefix length, network) so
    that the longest prefix covering an address is 33 lookups rather
    than a parse of every entry (``delete_ipcache`` asks on every /32
    withdraw, and parsing 10k cidrs holds the interpreter lock for as
    long as it takes).

    A read-only mapping whose only mutators are ``__setitem__`` and
    ``pop``, both of which keep the index in step.

    Among equal prefixes spelled differently, the first in insertion
    order wins, as a scan of ``items()`` would find it."""

    def __init__(self, entries=()):
        self._entries: Dict[str, int] = {}
        # (length, network) -> {cidr: None}, in insertion order
        self._v4: Dict[Tuple[int, int], Dict[str, None]] = {}
        for cidr, value in dict(entries).items():
            self[cidr] = value

    @staticmethod
    def _key(cidr: str) -> Optional[Tuple[int, int]]:
        net = ipaddress.ip_network(cidr, strict=False)
        if net.version != 4:
            return None
        return net.prefixlen, int(net.network_address)

    def __getitem__(self, cidr: str) -> int:
        return self._entries[cidr]

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __setitem__(self, cidr: str, value: int) -> None:
        if cidr not in self._entries:
            key = self._key(cidr)
            if key is not None:
                self._v4.setdefault(key, {})[cidr] = None
        self._entries[cidr] = value

    def pop(self, cidr: str, *default):
        if cidr in self._entries:
            key = self._key(cidr)
            if key is not None:
                spellings = self._v4[key]
                del spellings[cidr]
                if not spellings:
                    del self._v4[key]
        return self._entries.pop(cidr, *default)

    def longest_v4_cover(self, addr: int) -> Optional[int]:
        """The value of the longest IPv4 prefix covering ``addr``, or
        None when none does."""
        for plen in range(32, -1, -1):
            net = addr & (0xFFFFFFFF ^ ((1 << (32 - plen)) - 1))
            spellings = self._v4.get((plen, net))
            if spellings:
                return self[next(iter(spellings))]
        return None


class LPMUndo:
    """Rollback snapshot for ONE :func:`lpm_upsert` against the host
    mirror: a build that fails AFTER the mirror upsert but BEFORE the
    generation flip (the ``churn.*`` fault sites) must leave the mirror
    exactly as published, or the next rebuild would resurrect an entry
    the datapath never served.

    Snapshots the same (l1 slot, l2 block, l3 block) the upsert's plan
    derives — the derivation here MUST mirror ``lpm_upsert``'s; both
    live in this file so they cannot drift apart silently."""

    def __init__(self, t: LPMTensors, cidr: str):
        self.cells: List[tuple] = []  # ("l1"|"l2"|"l3", idx, payload)
        net = ipaddress.ip_network(cidr, strict=False)
        if net.version != 4 or net.prefixlen != 32:
            return  # rebuild path: the mirror object is REPLACED,
            # not mutated — nothing to snapshot
        addr = int(net.network_address)
        n_l2, n_l3 = lpm_used_blocks(t)
        hi16, mid8 = addr >> 16, (addr >> 8) & 0xFF
        cur1 = int(t.l1[hi16])
        blk2 = n_l2 if cur1 >= 0 else -cur1 - 1
        cur2 = cur1 if cur1 >= 0 else int(t.l2[blk2, mid8])
        blk3 = n_l3 if cur2 >= 0 else -cur2 - 1
        self.cells.append(("l1", hi16, np.int32(cur1)))
        if blk2 < t.l2.shape[0]:
            self.cells.append(("l2", blk2, t.l2[blk2].copy()))
        if blk3 < t.l3.shape[0]:
            self.cells.append(("l3", blk3, t.l3[blk3].copy()))

    def restore(self, t: LPMTensors) -> None:
        for field, idx, payload in self.cells:
            getattr(t, field)[idx] = payload


def lookup_v4(t_l1: torch.Tensor, t_l2: torch.Tensor, t_l3: torch.Tensor,
              ip: torch.Tensor) -> torch.Tensor:
    """Batched IPv4 LPM: [N] u32 -> [N] int32 values.  Three gathers
    (plain version)."""
    ip = widen(ip)
    a = t_l1[ip >> 16]
    b = torch.where(a < 0, t_l2[as_index(torch.clamp(-a - 1, min=0),
                                         t_l2.shape[0]),
                                (ip >> 8) & 0xFF], a)
    return torch.where(b < 0, t_l3[as_index(torch.clamp(-b - 1, min=0),
                                            t_l3.shape[0]),
                                   ip & 0xFF], b)


def lookup_v6(v6_net: torch.Tensor, v6_mask: torch.Tensor,
              v6_value: torch.Tensor, v6_plen: torch.Tensor,
              ip_words: torch.Tensor, default: int) -> torch.Tensor:
    """Batched IPv6 TCAM LPM: [N, 4] u32 words -> [N] int32 values
    (plain version).  Ties in prefix length take the first entry."""
    # [N, K, 4]: (ip & mask) == net per word (bit patterns compare
    # equal whatever their sign)
    masked = ip_words[:, None, :] & v6_mask[None, :, :]
    hit = torch.all(masked == v6_net[None, :, :], dim=-1)  # [N, K]
    score = torch.where(hit, v6_plen[None, :], -1)
    best = torch.argmax(score, dim=-1)
    found = torch.gather(score, 1, best[:, None])[:, 0] >= 0
    return torch.where(found, v6_value[best],
                       torch.tensor(default, dtype=torch.int32,
                                    device=ip_words.device))


def lpm_lookup_plain(t: "DeviceLPM", ip_words: torch.Tensor,
                     family: torch.Tensor) -> torch.Tensor:
    """Family-dispatched lookup over the [N, 4] IP word tensor (plain
    version)."""
    v4 = lookup_v4(t.l1, t.l2, t.l3, ip_words[:, 3])
    v6 = lookup_v6(t.v6_net, t.v6_mask, t.v6_value, t.v6_plen,
                   ip_words, t.default)
    return torch.where(family == 4, v4, v6)


def lpm_lookup(t: "DeviceLPM", ip_words: torch.Tensor,
               family: torch.Tensor) -> torch.Tensor:
    """Family-dispatched lookup: [N, 4] words, [N] family -> [N] int32
    identity rows.  CUDA tensors launch the ``lpm_lookup`` kernel; CPU
    tensors take :func:`lpm_lookup_plain`."""
    if ip_words.is_cuda:
        from ..kernels import launch_lpm_lookup

        return launch_lpm_lookup(t, ip_words, family)
    if ip_words.device.type != "cpu":
        raise ValueError(f"lpm_lookup: no kernel for {ip_words.device}")
    return lpm_lookup_plain(t, ip_words, family)


@dataclass
class DeviceLPM:
    """LPM tensors living on a device (int32; the v6 words are u32 bit
    patterns).  ``v6_groups`` and ``v6_index`` are :func:`lpm6_index` of
    the v6 arrays, which the kernels probe; the plain version ignores
    them.  Only :meth:`from_tensors` builds one, so the index always
    matches its TCAM (a v6 change rebuilds the LPM; the v4 patches touch
    ``l1``-``l3`` alone)."""

    l1: torch.Tensor  # [65536]
    l2: torch.Tensor  # [n_l2, 256]
    l3: torch.Tensor  # [n_l3, 256]
    v6_net: torch.Tensor  # [K, 4]
    v6_mask: torch.Tensor  # [K, 4]
    v6_value: torch.Tensor  # [K]
    v6_plen: torch.Tensor  # [K]
    default: int
    v6_groups: torch.Tensor  # [G, 8] a distinct mask, its largest plen
    v6_index: torch.Tensor  # [2^k, 8] net, group, entry, plen, value

    @staticmethod
    def from_tensors(t: LPMTensors, device=None) -> "DeviceLPM":
        from ..device import resolve_device
        from ..u32 import from_numpy

        device = resolve_device(device)

        def i32(a):
            # a copy on every device, the CPU too: the host arrays stay
            # the loader's mirrors, never the published tables
            return torch.from_numpy(
                np.ascontiguousarray(a, dtype=np.int32)).to(device,
                                                            copy=True)

        groups, index = lpm6_index(t.v6_net, t.v6_mask, t.v6_value,
                                   t.v6_plen)
        return DeviceLPM(
            l1=i32(t.l1), l2=i32(t.l2), l3=i32(t.l3),
            v6_net=from_numpy(t.v6_net, device),
            v6_mask=from_numpy(t.v6_mask, device),
            v6_value=i32(t.v6_value), v6_plen=i32(t.v6_plen),
            default=int(t.default), v6_groups=i32(groups),
            v6_index=i32(index))
