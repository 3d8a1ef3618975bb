"""Connection tracking: fixed-capacity open-addressing hash in HBM.

Reference: upstream cilium ``bpf/lib/conntrack.h`` (``ct_lookup4/6``,
``ct_create4/6``, TCP state handling, per-proto lifetimes) and
``pkg/maps/ctmap``.  The kernel's per-packet hash probe becomes a
**batched** probe — every packet in the header tensor probes
concurrently; inserts use a write-then-verify claim (write the whole
row, re-read the key, check who won) instead of a CAS loop.  Key and
value words live in ONE row of one table so an insert is a single row
write — no torn entries between concurrent claimants of the same slot.

Static shapes: capacity is fixed at construction (power of two); a full
probe window drops new inserts (counted in ``dropped``) rather than
reallocating.  Expired entries are lookup misses immediately and their
slots are reclaimable by inserts.

Deliberate divergences from eBPF, shared with the JAX package:
duplicate tuples in one batch collapse to one entry whose counters are
the highest batch row's; per-flow packet and byte counters are u32 words
and wrap at 2^32.

On the card: ``ct_lookup`` launches ``ct_lookup_kernel`` and
``ct_update`` the ``ct_update`` launch sequence (``csrc/conntrack.cu``);
the datapath kernel probes inline through the same device functions
(``csrc/conntrack.cuh``).  JAX donated the table; here ``ct_update``
updates ``table``, ``fp`` and ``dropped`` IN PLACE on the current
stream, so a caller that keeps a reference sees the new contents.
The plain versions below (``*_plain``) run for CPU tensors and are the
kernels' yardstick on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.packets import (
    COL_DIR,
    COL_DPORT,
    COL_DST_IP0,
    COL_FLAGS,
    COL_LEN,
    COL_PROTO,
    COL_SPORT,
    COL_SRC_IP0,
    FLAG_RELATED,
    TCP_FIN,
    TCP_RST,
    normalize_ports,
)
from ..device import resolve_device
from ..u32 import MASK, mul, narrow, widen

# Lookup results (reference: bpf/lib/common.h CT_* codes).
CT_NEW = 0
CT_ESTABLISHED = 1
CT_REPLY = 2
CT_RELATED = 3

# Entry states stored in the table.
ST_FREE = 0
ST_SYN_SENT = 1  # open, no reply seen yet
ST_ESTABLISHED = 2
ST_CLOSING = 3  # FIN/RST seen

# Lifetimes in seconds (reference: bpf CT_CONNECTION_LIFETIME_TCP/
# NONTCP, CT_SYN_TIMEOUT, CT_CLOSE_TIMEOUT defaults).
LIFETIME_TCP = 21600
LIFETIME_NONTCP = 60
LIFETIME_SYN = 60
LIFETIME_CLOSE = 10

KEY_WORDS = 10  # src[4] dst[4] ports proto
N_PROBE = 16  # linear probe window
N_CAND = 4  # full rows fetched per fingerprint-filtered probe
N_CAND_INS = 4  # claim attempts against fingerprint-filtered slots
N_ROUNDS = N_CAND_INS + N_PROBE  # ct_update's insert rounds

# value columns (offsets within the combined row, after the key words)
V_STATE = KEY_WORDS + 0
V_EXPIRES = KEY_WORDS + 1
V_TX_PKTS = KEY_WORDS + 2
V_RX_PKTS = KEY_WORDS + 3
V_TX_BYTES = KEY_WORDS + 4
V_RX_BYTES = KEY_WORDS + 5
V_PROXY = KEY_WORDS + 6  # proxy redirect port (reference: proxy_redirect)
ROW_WORDS = KEY_WORDS + 7

# the header columns ct_update reads, in the order of its ``l4`` input
L4_COLS = (COL_PROTO, COL_FLAGS, COL_LEN)


@dataclass
class CTTable:
    """Device CT state.

    ``fp`` is a per-slot 1-byte key fingerprint (0 = free slot) kept in
    its own array: probes read the 16-slot fingerprint window first and
    fetch full 68 B rows only for the few fingerprint-matching
    candidates.  The fingerprint is a pure function of the stored key
    (``_fp_mix`` of the slot hash), so snapshots stay placement-free
    and restores recompute it."""

    table: torch.Tensor  # [C, ROW_WORDS] int32 (u32 words)
    fp: torch.Tensor  # [C] int32 — key fingerprint per slot, 0 = free
    dropped: torch.Tensor  # [] int32 (u32) — failed inserts
    # [2, C] int32: the ct_update kernel's claim words, all -1 between
    # calls (not part of the state); made with a table on the card, or
    # by the kernel's first call on a table built by hand
    claim: Optional[torch.Tensor] = field(default=None, repr=False,
                                          compare=False)

    @staticmethod
    def create(capacity: int = 1 << 20, device=None) -> "CTTable":
        assert capacity & (capacity - 1) == 0, "capacity must be 2^k"
        device = resolve_device(device)
        return CTTable(
            table=torch.zeros((capacity, ROW_WORDS), dtype=torch.int32,
                              device=device),
            fp=torch.zeros((capacity,), dtype=torch.int32, device=device),
            dropped=torch.zeros((), dtype=torch.int32, device=device),
            claim=(torch.full((2, capacity), -1, dtype=torch.int32,
                              device=device)
                   if device.type == "cuda" else None))

    @property
    def capacity(self) -> int:
        return self.table.shape[0]


def ct_keys_from_headers(hdr: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Header tensor [N, N_COLS] -> (forward, reverse) CT keys [N, 10].

    The key carries the hook direction like the reference's
    ``TUPLE_F_OUT``/``TUPLE_F_IN`` (word 9 = proto | dir << 8), so an
    egress-created entry never satisfies an ingress lookup of the same
    5-tuple on another endpoint.  The reverse (reply) key flips both
    the tuple AND the direction bit.  ICMP zeroes the port word so echo
    request/reply share a tuple modulo the swap.  RELATED rows (ICMP
    errors carrying the embedded original tuple) flip only the
    direction bit in the reverse key."""
    h = widen(hdr)
    src = h[:, COL_SRC_IP0:COL_SRC_IP0 + 4]
    dst = h[:, COL_DST_IP0:COL_DST_IP0 + 4]
    proto = h[:, COL_PROTO]
    dirn = h[:, COL_DIR]
    sport, dport = normalize_ports(torch, proto, h[:, COL_SPORT],
                                   h[:, COL_DPORT])
    fwd_ports = (sport << 16) | dport
    rev_ports = (dport << 16) | sport
    fwd_pd = proto | (dirn << 8)
    rev_pd = proto | ((1 - dirn) << 8)
    fwd = torch.cat([src, dst, fwd_ports[:, None], fwd_pd[:, None]], 1)
    rev = torch.cat([dst, src, rev_ports[:, None], rev_pd[:, None]], 1)
    related = ((h[:, COL_FLAGS] & FLAG_RELATED) != 0)[:, None]
    rev_rel = torch.cat([src, dst, fwd_ports[:, None], rev_pd[:, None]], 1)
    rev = torch.where(related, rev_rel, rev)
    return narrow(fwd), narrow(rev)


def ct_l4_from_headers(hdr: torch.Tensor) -> torch.Tensor:
    """Header tensor -> the [N, 3] (proto, flags, length) columns
    :func:`ct_update` reads (the packed path never builds the wide
    header, so ct_update takes just these)."""
    return hdr[:, list(L4_COLS)].contiguous()


def _hash(keys: torch.Tensor) -> torch.Tensor:
    """FNV-1a over the key words + murmur3 finalizer:
    [N, KEY_WORDS] u32 -> [N] int64 in [0, 2^32).

    The finalizer is load-bearing: word-FNV's low product bits depend
    ONLY on low input bits, and the ports word packs sport into the
    HIGH half — without avalanche, home slots collapse and probe
    windows chain to overflow at a few percent occupancy."""
    k = widen(keys)
    h = torch.full((keys.shape[0],), 0x811C9DC5, dtype=torch.int64,
                   device=keys.device)
    for w in range(KEY_WORDS):
        h = mul(h ^ k[:, w], 0x01000193)
    h = h ^ (h >> 16)
    h = mul(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _fp_mix(h: torch.Tensor) -> torch.Tensor:
    """Key hash -> fingerprint byte in 1..255 (0 is the free marker):
    the murmur3 finalizer over ``h``, top byte (the slot index consumes
    the LOW bits)."""
    g = h ^ (h >> 16)
    g = mul(g, 0x85EBCA6B)
    g = g ^ (g >> 13)
    g = mul(g, 0xC2B2AE35)
    return (g >> 24) % 255 + 1


def _window(capacity: int, h: torch.Tensor) -> torch.Tensor:
    steps = torch.arange(N_PROBE, dtype=torch.int64, device=h.device)
    return (h[:, None] + steps[None, :]) & (capacity - 1)


def _live_match(rows: torch.Tensor, keys: torch.Tensor,
                now: int) -> torch.Tensor:
    """[N, W, ROW_WORDS] rows vs [N, KEY_WORDS] keys -> [N, W] live
    key matches (expired entries never match)."""
    live = ((rows[:, :, V_STATE] != ST_FREE)
            & (widen(rows[:, :, V_EXPIRES]) >= now))
    return live & torch.all(rows[:, :, :KEY_WORDS] == keys[:, None, :],
                            dim=2)


def _first_true(match: torch.Tensor) -> torch.Tensor:
    """Index of the first True per row (0 when none)."""
    return torch.argmax(match.to(torch.int8), dim=1)


def _probe(table: torch.Tensor, keys: torch.Tensor, now: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe the whole window for each key: -> (found [N] bool, slot [N]
    int32).  Expired entries don't match."""
    c = table.shape[0]
    if c & (c - 1):
        raise ValueError(f"CT probe needs 2^k capacity, got {c}")
    slots = _window(c, _hash(keys))
    match = _live_match(table[slots], keys, now)
    found = match.any(dim=1)
    slot = torch.gather(slots, 1, _first_true(match)[:, None])[:, 0]
    return found, torch.where(found, slot, 0).to(torch.int32)


def _fp_window(fp: torch.Tensor, keys: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each key's fingerprint window: -> (slots [N, N_PROBE] int64,
    window fingerprints [N, N_PROBE], key fingerprint [N])."""
    h = _hash(keys)
    slots = _window(fp.shape[0], h)
    return slots, fp[slots].to(torch.int64), _fp_mix(h)


def _first_k(mask: torch.Tensor, k: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """First ``k`` True positions per row of [N, N_PROBE] ``mask`` in
    window order: -> (positions [N, k] int64, valid [N, k] bool)."""
    steps = torch.arange(N_PROBE, dtype=torch.int64, device=mask.device)
    rank = torch.where(mask, steps[None, :], N_PROBE)
    order = torch.sort(rank, dim=1).values[:, :k]
    return torch.clamp(order, max=N_PROBE - 1), order < N_PROBE


def _probe_fp(table: torch.Tensor, fp: torch.Tensor, keys: torch.Tensor,
              now: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fingerprint-filtered probe: -> (found, slot, overflow).

    Full rows are read for only the first ``N_CAND`` fingerprint
    matches of the window.  A miss with more than ``N_CAND`` matches is
    flagged ``overflow``: the true entry could hide past the candidate
    budget, and the caller reruns the full-window probe for that row."""
    slots, win_fp, key_fp = _fp_window(fp, keys)
    fmatch = win_fp == key_fp[:, None]
    pos, cand_valid = _first_k(fmatch, N_CAND)
    cand_slots = torch.gather(slots, 1, pos)
    match = cand_valid & _live_match(table[cand_slots], keys, now)
    found = match.any(dim=1)
    slot = torch.gather(cand_slots, 1, _first_true(match)[:, None])[:, 0]
    overflow = ~found & (fmatch.sum(dim=1) > N_CAND)
    return found, torch.where(found, slot, 0).to(torch.int32), overflow


def ct_lookup_plain(ct: CTTable, fwd: torch.Tensor, rev: torch.Tensor,
                    now: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched ``ct_lookup4`` (plain version): -> (result [N] int32 in
    CT_*, slot [N] int32, is_reply [N] bool); ``slot`` is valid only
    where result != CT_NEW.

    Fingerprint-filtered probes, and the exact full-window probe for
    the rows whose candidates overflowed.  JAX reruns the whole batch
    under ``lax.cond`` instead; the two agree row for row because a
    live slot's fingerprint is a function of its stored key, so for a
    row that did not overflow the fast and the full probe find the
    same first live match."""
    f_found, f_slot, f_ovf = _probe_fp(ct.table, ct.fp, fwd, now)
    r_found, r_slot, r_ovf = _probe_fp(ct.table, ct.fp, rev, now)
    ovf = f_ovf | r_ovf
    if bool(ovf.any()):
        ff, fs = _probe(ct.table, fwd, now)
        rf, rs = _probe(ct.table, rev, now)
        f_found = torch.where(ovf, ff, f_found)
        f_slot = torch.where(ovf, fs, f_slot)
        r_found = torch.where(ovf, rf, r_found)
        r_slot = torch.where(ovf, rs, r_slot)
    is_reply = ~f_found & r_found
    slot = torch.where(f_found, f_slot, r_slot)
    result = torch.where(f_found, CT_ESTABLISHED,
                         torch.where(is_reply, CT_REPLY, CT_NEW))
    return result.to(torch.int32), slot, is_reply


def ct_lookup(ct: CTTable, fwd: torch.Tensor, rev: torch.Tensor,
              now: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched ``ct_lookup4``: see :func:`ct_lookup_plain`.  CUDA
    tensors launch ``ct_lookup_kernel``."""
    if fwd.is_cuda:
        from ..kernels import launch_ct_lookup

        return launch_ct_lookup(ct, fwd, rev, now)
    _require_cpu(fwd, "ct_lookup")
    return ct_lookup_plain(ct, fwd, rev, now)


def _require_cpu(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"{what}: no kernel for {t.device}")


def _add_u32(flat: torch.Tensor, idx: torch.Tensor,
             amount: torch.Tensor) -> None:
    """flat[idx] += amount, u32 wrapping, duplicates summed."""
    if idx.numel() == 0:
        return
    uniq, inv = torch.unique(idx, return_inverse=True)
    total = torch.zeros(uniq.shape[0], dtype=torch.int64,
                        device=idx.device).index_add_(0, inv, amount)
    flat[uniq] = narrow(widen(flat[uniq]) + total)


def ct_update_plain(ct: CTTable, l4: torch.Tensor, fwd: torch.Tensor,
                    result: torch.Tensor, slot: torch.Tensor,
                    is_reply: torch.Tensor, do_create: torch.Tensor,
                    proxy_port: torch.Tensor, now: int,
                    valid: Optional[torch.Tensor] = None,
                    stats: Optional[dict] = None) -> CTTable:
    """Refresh hit entries, apply the TCP state machine, insert NEW
    (plain version; updates ``ct`` in place and returns it).

    ``l4`` is [N, 3] (proto, flags, length).  ``do_create`` marks NEW
    packets whose policy verdict allowed them (reference: ``ct_create4``
    runs on the allow path only).  ``valid`` masks out padding rows;
    invalid rows touch nothing.  A ``stats`` dict gets ``pending`` (the
    rows pending entering each of the ``N_ROUNDS`` insert rounds, then
    the rows dropped: the kernel's ``counts``) and ``rounds`` (the
    rounds entered with a row pending)."""
    table, fp = ct.table, ct.fp
    n = fwd.shape[0]
    dev = fwd.device
    l4w = widen(l4)
    proto, flags, length = l4w[:, 0], l4w[:, 1], l4w[:, 2]
    is_tcp = proto == 6
    closing = is_tcp & ((flags & (TCP_FIN | TCP_RST)) != 0)

    rows_idx = torch.arange(n, dtype=torch.int64, device=dev)
    claim = torch.full((ct.capacity,), -1, dtype=torch.int64, device=dev)

    # --- refresh existing entries (hits) -------------------------------
    # State transitions are MONOTONE upgrades (SYN_SENT < ESTABLISHED <
    # CLOSING), so concurrent refreshes of one slot combine with max;
    # expiry is then recomputed from the POST-max state.  The rows of a
    # slot agree on it unless a forged protocol number (> 255) aliases
    # the key's proto|dir word; the highest row's value stands then, as
    # XLA's scatter leaves it on the reference.
    hit = result != CT_NEW
    if valid is not None:
        hit = hit & valid
    hslot = torch.where(hit, slot, 0).to(torch.int64)
    old_state = widen(table[hslot, V_STATE])
    new_state = torch.where(is_reply & (old_state == ST_SYN_SENT),
                            ST_ESTABLISHED, old_state)
    new_state = torch.where(closing, ST_CLOSING, new_state)
    hs = hslot[hit]
    state = widen(table[:, V_STATE])
    state.scatter_reduce_(0, hs, new_state[hit], "amax")
    table[:, V_STATE] = narrow(state)
    final_state = state[hslot]
    lifetime = torch.where(
        final_state == ST_CLOSING, LIFETIME_CLOSE,
        torch.where(is_tcp,
                    torch.where(final_state >= ST_ESTABLISHED,
                                LIFETIME_TCP, LIFETIME_SYN),
                    LIFETIME_NONTCP))
    claim.scatter_reduce_(0, hs, rows_idx[hit], "amax")
    last = hit & (claim[hslot] == rows_idx)
    table[hslot[last], V_EXPIRES] = narrow(now + lifetime[last])
    claim[hs] = -1
    pkt_col = torch.where(is_reply, V_RX_PKTS, V_TX_PKTS)[hit]
    byte_col = torch.where(is_reply, V_RX_BYTES, V_TX_BYTES)[hit]
    flat = table.view(-1)
    _add_u32(flat, hs * ROW_WORDS + pkt_col,
             torch.ones_like(hs))
    _add_u32(flat, hs * ROW_WORDS + byte_col, length[hit])

    # --- insert NEW entries (write-then-verify claim) ------------------
    pending = do_create & (result == CT_NEW)
    if valid is not None:
        pending = pending & valid
    init_state = torch.where(is_tcp, ST_SYN_SENT, ST_ESTABLISHED)
    init_life = torch.where(is_tcp, LIFETIME_SYN, LIFETIME_NONTCP)
    zero = torch.zeros_like(length)
    new_row = narrow(torch.cat([
        widen(fwd),
        torch.stack([init_state, now + init_life, torch.ones_like(length),
                     zero, length, zero, widen(proxy_port)], dim=1),
    ], dim=1))  # [N, ROW_WORDS]

    # candidate positions come from the fingerprint window BEFORE any
    # claim of this batch
    slots_w, win_fp, key_fp = _fp_window(fp, fwd)

    def _claim(pending, s, also_try=None):
        # one lockstep round: rows judge their slot against the table as
        # it stood before the round; of the rows trying one slot the
        # highest batch row writes (XLA's scatter order); every row whose
        # key the slot then holds has won
        stored = table[s]
        claimable = ((stored[:, V_STATE] == ST_FREE)
                     | (widen(stored[:, V_EXPIRES]) < now)
                     | torch.all(stored[:, :KEY_WORDS] == fwd, dim=1))
        trying = pending & claimable
        if also_try is not None:
            trying = trying & also_try
        ts = s[trying]
        claim.scatter_reduce_(0, ts, rows_idx[trying], "amax")
        writer = trying & (claim[s] == rows_idx)
        table[s[writer]] = new_row[writer]
        claim[ts] = -1
        won = trying & torch.all(table[s, :KEY_WORDS] == fwd, dim=1)
        fp[s[won]] = key_fp[won].to(torch.int32)
        return pending & ~won

    # fast path: claim among fingerprint-filtered candidates only —
    # free slots (fp 0) and same-fingerprint slots
    cand_mask = (win_fp == 0) | (win_fp == key_fp[:, None])
    pos, cand_valid = _first_k(cand_mask, N_CAND_INS)
    cand_slots = torch.gather(slots_w, 1, pos)
    counts = []
    for k in range(N_CAND_INS):
        if stats is not None:
            counts.append(int(pending.sum()))
        pending = _claim(pending, cand_slots[:, k], cand_valid[:, k])
    # exact fallback: the full window, in order (a no-op for rows no
    # longer pending, so it runs whenever any row still is)
    if bool(pending.any()):
        for step in range(N_PROBE):
            if stats is not None:
                counts.append(int(pending.sum()))
            pending = _claim(pending, slots_w[:, step])
    ct.dropped.copy_(narrow(widen(ct.dropped) + pending.sum()))
    if stats is not None:
        counts += [0] * (N_ROUNDS - len(counts)) + [int(pending.sum())]
        stats.update(pending=counts, rounds=sum(c > 0 for c in counts[:-1]))
    return ct


def ct_update(ct: CTTable, l4: torch.Tensor, fwd: torch.Tensor,
              result: torch.Tensor, slot: torch.Tensor,
              is_reply: torch.Tensor, do_create: torch.Tensor,
              proxy_port: torch.Tensor, now: int,
              valid: Optional[torch.Tensor] = None) -> CTTable:
    """Refresh hits and insert allowed NEW flows, in place: see
    :func:`ct_update_plain`.  CUDA tensors launch the one cooperative
    ``ct_update`` kernel (``csrc/conntrack.cu``)."""
    if fwd.is_cuda:
        from ..kernels import launch_ct_update

        return launch_ct_update(ct, l4, fwd, result, slot, is_reply,
                                do_create, proxy_port, now, valid)
    _require_cpu(fwd, "ct_update")
    return ct_update_plain(ct, l4, fwd, result, slot, is_reply, do_create,
                           proxy_port, now, valid)


def ct_gc_plain(ct: CTTable, now: int) -> torch.Tensor:
    """Age out expired entries in place (reference: pkg/maps/ctmap.GC
    interval sweep; plain version).  A live slot whose expiry is before
    ``now`` (u32 compare) gets state ``ST_FREE`` and fingerprint 0.
    Returns the eviction count as a 0-d tensor."""
    state = ct.table[:, V_STATE]
    expired = (state != ST_FREE) & (widen(ct.table[:, V_EXPIRES])
                                     < (int(now) & MASK))
    ct.table[:, V_STATE] = torch.where(expired, ST_FREE, state)
    ct.fp.masked_fill_(expired, 0)
    return expired.sum()


def ct_gc(ct: CTTable, now: int) -> torch.Tensor:
    """The CT aging sweep, in place: see :func:`ct_gc_plain`.  CUDA
    tensors launch the ``ct_gc`` kernel; the count stays on the card
    until the caller reads it."""
    if ct.table.is_cuda:
        from ..kernels import launch_ct_gc

        return launch_ct_gc(ct, now)
    _require_cpu(ct.table, "ct_gc")
    return ct_gc_plain(ct, now)


_STATE_NAMES = {ST_SYN_SENT: "SYN_SENT", ST_ESTABLISHED: "ESTABLISHED",
                ST_CLOSING: "CLOSING"}


def _hash_np(keys: np.ndarray) -> np.ndarray:
    """Host-side hash identical to :func:`_hash` (for re-placement)."""
    keys = keys.astype(np.uint32)
    h = np.full(keys.shape[0], 0x811C9DC5, dtype=np.uint32)
    with np.errstate(over="ignore"):
        for w in range(KEY_WORDS):
            h = (h ^ keys[:, w]) * np.uint32(0x01000193)
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def _fp_mix_np(h: np.ndarray) -> np.ndarray:
    """Host mirror of :func:`_fp_mix`."""
    with np.errstate(over="ignore"):
        g = h ^ (h >> np.uint32(16))
        g = g * np.uint32(0x85EBCA6B)
        g = g ^ (g >> np.uint32(13))
        g = g * np.uint32(0xC2B2AE35)
    return (g >> np.uint32(24)) % np.uint32(255) + np.uint32(1)


def ct_fp_from_table(table: np.ndarray) -> np.ndarray:
    """Recompute the per-slot fingerprint array from a placed table.

    The fingerprint is derived state (a pure function of each live
    slot's key), so restores rebuild it instead of persisting it."""
    table = np.asarray(table, dtype=np.uint32)
    fp = np.zeros(table.shape[0], dtype=np.uint32)
    live = table[:, V_STATE] != ST_FREE
    if live.any():
        fp[live] = _fp_mix_np(_hash_np(table[live, :KEY_WORDS]))
    return fp


def ct_rows_from_table(table: np.ndarray) -> np.ndarray:
    """Live rows of a (hashed) CT table -> dense [n, ROW_WORDS] array.

    The dense form is the portable snapshot format: it carries no slot
    placement, so it can be restored into a table of ANY capacity (or
    into the interpreter backend's dict)."""
    table = np.asarray(table)
    return table[table[:, V_STATE] != ST_FREE].copy()


def ct_table_from_rows(rows: np.ndarray,
                       capacity: int) -> Tuple[np.ndarray, int]:
    """Rebuild a hashed CT table from dense snapshot rows.

    Re-places every entry with the same FNV hash + linear probe the
    device uses, so a snapshot taken at one capacity (or from the
    interpreter oracle) restores correctly into another.  Returns
    ``(table, n_dropped)``: entries that cannot be placed within the
    probe window are dropped and counted — seed ``CTTable.dropped``
    with the count so restore-time map pressure shows in metrics like
    live-insert pressure does."""
    assert capacity & (capacity - 1) == 0, "capacity must be 2^k"
    table = np.zeros((capacity, ROW_WORDS), dtype=np.uint32)
    rows = np.asarray(rows, dtype=np.uint32)
    if rows.size == 0:
        return table, 0
    mask = np.uint32(capacity - 1)
    hs = _hash_np(rows[:, :KEY_WORDS])
    # vectorized placement: per probe step, every still-pending row
    # bids for its slot; the first bidder (original row order) of each
    # free slot wins — restart restores of ~1M flows stay sub-second
    pending = np.arange(len(rows))
    for step in range(N_PROBE):
        if not len(pending):
            break
        slots = (hs[pending] + np.uint32(step)) & mask
        free = table[slots, V_STATE] == ST_FREE
        order = np.argsort(slots, kind="stable")
        s_sorted = slots[order]
        first = np.ones(len(order), dtype=bool)
        first[1:] = s_sorted[1:] != s_sorted[:-1]
        win = np.zeros(len(pending), dtype=bool)
        win[order] = first
        place = free & win
        table[slots[place]] = rows[pending[place]]
        pending = pending[~place]
    return table, len(pending)


def ct_entries_from_snapshot(table: np.ndarray,
                             limit: int = 1000) -> list:
    """Decode live CT rows for display (`cilium bpf ct list`)."""
    from ..core.packets import words_to_ip

    table = np.asarray(table)
    live = np.nonzero(table[:, V_STATE] != ST_FREE)[0][:limit]
    out = []
    for i in live:
        row = table[i]
        proto = int(row[9]) & 0xFF
        dirn = (int(row[9]) >> 8) & 1
        fam = 4 if not row[0:3].any() else 6
        out.append({
            "src": words_to_ip(row[0:4], fam),
            "dst": words_to_ip(row[4:8], fam),
            "sport": int(row[8]) >> 16,
            "dport": int(row[8]) & 0xFFFF,
            "proto": proto,
            "dir": "ingress" if dirn == 0 else "egress",
            "state": _STATE_NAMES.get(int(row[V_STATE]),
                                      str(int(row[V_STATE]))),
            "expires": int(row[V_EXPIRES]),
            "tx_packets": int(row[V_TX_PKTS]),
            "rx_packets": int(row[V_RX_PKTS]),
            "tx_bytes": int(row[V_TX_BYTES]),
            "rx_bytes": int(row[V_RX_BYTES]),
            "proxy_port": int(row[V_PROXY]),
        })
    return out
