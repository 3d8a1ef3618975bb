#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's serving step, serving daemon and L7 proxy
plane on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel of ``cilium_tpu_torch/csrc`` from the checkout's
   sources, one ``nvcc`` per source, all at once;
3. kernel parity at full size: each kernel against its plain PyTorch
   version on the same CUDA tensors, bit-exact (every output is an
   integer): LPM over 2^18 v4+v6 addresses, a CT lookup and a
   ct_update on a 2^20 table filled to about half (duplicate tuples,
   window contention, counters near 2^32), ring_append with overflow,
   the CT aging sweep and occupancy count on a half-full 2^20 table
   whose expiries straddle 2^31 and ``now``, ring_gather on lapped
   and unlapped 2^18 rings at several rungs, and the L7 verdict at
   BASELINE.md config #4 (192 literal and 16 prefix HTTP rules, 4096
   requests a batch; ``bench.py`` ``bench_l7``'s world), where
   ``L7Proxy.handle_http`` on the card must also equal the same call on
   a CPU proxy (verdicts and counters), and requests/s through it are
   timed;
4. the slice at full size: the 10k-identity world (BASELINE.md config
   #3), ``TorchLoader(device="cuda")`` through 8 ``serve_packed``
   batches of 2^18, 2 wide ``serve`` batches with IPv6 and ICMP errors
   and 1 ``step``.  The same sequence through the plain versions on the
   card must give equal ring rows, out rows, metrics, CT table and drop
   count.  Then the verdict kernel, packed and wide with every optional
   channel, against its plain version on that state;
5. timings: each kernel's device time at the main path's shapes (calls
   run back to back behind a spin kernel, so no host enqueue falls in
   the window) beside its plain version's and its bound; then where a
   steady ``serve_packed`` batch spends its time (torch.profiler), and
   what staging a batch costs from pinned memory;
6. the superbatch: one ``serve_superbatch`` of K = 4 packed steps of
   2^16 (the last all-false) against four sequential ``serve_packed``
   calls: ring rows, cursor, metrics, CT table and drop count equal;
7. the daemon at full width: BASELINE.md config #3 built through the
   ``Daemon`` API (10k identities and their /32s, the world's rules
   with its L7 HTTP rule, the ``db`` endpoint), ``start()``, then
   ``start_serving(ingress=True, packed=True, superbatch_k=4)``; a
   producer thread submits 2^21 packets of steady traffic and
   ``stop_serving()`` returns the ledger, which must be exact, with no
   event lost; the port-80 flows REDIRECT into the L7 plane, whose
   ledger (redirected = allowed + denied + shed + failed) must be
   exact; the per-reason metrics must equal those of the same rows
   through ``TorchLoader.serve_packed`` in fixed batches; the ct-gc and
   map-pressure controllers must have run;
8. the redirect overhead (``bench.py`` ``bench_l7_redirect``'s shape):
   two daemons on the card, an L4 allow on port 80 and the same port
   with an HTTP GET rule, fresh-sport SYN batches of 1024, six a leg,
   legs paired three times in alternating order;
9. the FQDN flip: the config #3 world plus a DNS L7 rule and
   ``toFQDNs`` egress (``tests/test_l7plane.py`` ``RULES_DNS``), served
   through ``submit``: probes to an unresolved IP drop, a DNS batch is
   allowed by the L7 workers, the resolver's answer mints an FQDN
   identity (a full regeneration of the 10k-identity world, timed),
   and the next probes are allowed.

The kernel launch counts are read per path (the slice of phase 4, the
daemon of phase 7, the L7 paths of phases 3, 8 and 9), each zeroed
just before its path runs.  The line
before the last is one JSON object describing every kernel of the main
paths; the last line is the device record.  Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N = 1 << 18  # the serving batch (bench.py's packed bucket)
CT_CAPACITY = 1 << 20
RING_CAPACITY = 1 << 18
SLICE_RING_CAPACITY = 1 << 21  # holds every event of the slice's 11 batches
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
# the guide's 67 TFLOP/s float32 is 132 SMs x 128 lanes x 2 (FMA) x
# 1.98 GHz; Hopper has 64 INT32 lanes per SM, so integer work peaks at
INT32_OPS_PER_S = 132 * 64 * 1.98e9


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def max_abs_err(got, want, what) -> int:
    """Max |got - want| over integer tensors (bit patterns as u32);
    anything but 0 fails the smoke."""
    import torch

    g = got.to(torch.int64) & 0xFFFFFFFF
    w = want.to(torch.int64) & 0xFFFFFFFF
    check(g.shape == w.shape, f"{what}: shape {tuple(g.shape)} vs "
          f"{tuple(w.shape)}")
    err = int((g - w).abs().max().item()) if g.numel() else 0
    check(err == 0, f"{what}: kernel differs from its plain version "
          f"(max abs err {err}, {int((g != w).sum())} cells)")
    return err


SPIN_MS = 200.0  # how far the host may run ahead of a timed window
_CYCLES_PER_MS = []


def _spin_cycles(ms) -> int:
    """GPU clock cycles that ``torch.cuda._sleep`` needs to spin ``ms``
    (calibrated once by CUDA events)."""
    import torch

    if not _CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        torch.cuda.synchronize()
        _CYCLES_PER_MS.append(10 ** 7 / start.elapsed_time(end))
    return int(ms * _CYCLES_PER_MS[0])


def device_ms(fn, reps, fresh=None) -> float:
    """Time of one call of ``fn`` on the card: the mean over ``reps``
    calls run back to back between two CUDA events.  The calls queue
    behind a spin kernel, so the card runs them without waiting for the
    host and no host enqueue time falls in the window (a call that
    syncs, as a plain version may, is timed with its waits).  A call
    that mutates its inputs gets ``fresh()`` ones, made before the
    window; one untimed call first loads the kernel's module."""
    import torch

    inputs = [fresh() if fresh else None for _ in range(reps + 1)]

    def call(x):
        return fn(x) if fresh else fn()

    call(inputs[0])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin = _spin_cycles(SPIN_MS)
    torch.cuda.synchronize()
    torch.cuda._sleep(spin)
    start.record()
    for x in inputs[1:]:
        call(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved, int_ops):
    """Least time the card could take: bytes over HBM rate or integer
    operations over the INT32 rate, whichever is larger."""
    tb = bytes_moved / HBM_BYTES_PER_S * 1e3
    to = int_ops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# -- inputs -----------------------------------------------------------


def random_keys(rng, n, protos=(6, 17, 1)):
    import numpy as np
    from cilium_tpu_torch.datapath.conntrack import KEY_WORDS

    keys = rng.integers(0, 1 << 32, (n, KEY_WORDS), dtype=np.uint64)
    keys = keys.astype(np.uint32)
    keys[:, 9] = rng.choice(np.array(protos, np.uint32), n) | (
        rng.integers(0, 2, n, dtype=np.uint32) << 8)
    return keys


def half_full_table(rng, now):
    """A 2^20 CT table holding ~2^19 entries placed by the device hash,
    some expired, with counters near 2^32 on a slice of them."""
    import numpy as np
    from cilium_tpu_torch.datapath import conntrack as ct

    n = CT_CAPACITY // 2
    rows = np.zeros((n, ct.ROW_WORDS), np.uint32)
    rows[:, :ct.KEY_WORDS] = random_keys(rng, n)
    rows[:, ct.V_STATE] = rng.integers(1, 4, n)
    rows[:, ct.V_EXPIRES] = np.where(rng.random(n) < 0.1, now - 5,
                                     now + 100)
    rows[:, ct.V_TX_PKTS:ct.V_RX_BYTES + 1] = rng.integers(
        0, 1 << 20, (n, 4))
    near = rng.random(n) < 0.05
    rows[near, ct.V_TX_BYTES] = 0xFFFFFFFF - rng.integers(0, 3000,
                                                          int(near.sum()))
    rows[:, ct.V_PROXY] = rng.choice(np.array([0, 0, 0, 10000], np.uint32),
                                     n)
    table, dropped = ct.ct_table_from_rows(rows, CT_CAPACITY)
    return table, ct.ct_fp_from_table(table), rows


def crowded_keys(rng, n_regions=64, width=8):
    """New keys whose home slots pile into a few 8-slot regions, so
    their inserts contend for one window and run the full rounds."""
    import numpy as np
    from cilium_tpu_torch.datapath.conntrack import _hash_np

    homes = rng.integers(0, CT_CAPACITY, n_regions) & ~(width - 1)
    keys = random_keys(rng, 1 << 23)
    home = _hash_np(keys) & (CT_CAPACITY - 1)
    hit = np.isin(home & ~np.uint32(width - 1), homes.astype(np.uint32))
    return keys[hit]


# -- phases -----------------------------------------------------------


def phase_lpm(torch, rng, world, kernels):
    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import ip_to_words
    from cilium_tpu_torch.datapath.lpm import (DeviceLPM, lpm_lookup,
                                               lpm_lookup_plain)

    t = DeviceLPM.from_tensors(world.lpm, "cuda")
    words = np.zeros((N, 4), np.uint32)
    fam = np.full(N, 4, np.uint32)
    pods = np.array([ip_to_words(ip)[3] for ip in world.pod_ips],
                    np.uint32)
    words[:, 3] = np.where(rng.random(N) < 0.7, rng.choice(pods, N),
                           rng.integers(0, 1 << 32, N, dtype=np.uint64))
    v6 = rng.random(N) < 0.2
    pods6 = np.array([ip_to_words(ip) for ip in world.pod_ips6], np.uint32)
    words[v6] = pods6[rng.integers(0, len(pods6), int(v6.sum()))]
    miss6 = v6 & (rng.random(N) < 0.3)
    words[miss6, 0] = 0x20020000  # outside 2001:db8::/32: ::/0 only
    fam[v6] = 6
    w, f = u32.from_numpy(words, "cuda"), u32.from_numpy(fam, "cuda")
    got = lpm_lookup(t, w, f)
    want = lpm_lookup_plain(t, w, f)
    err = max_abs_err(got, want, "lpm_lookup")
    kernels["lpm_lookup"]["max_abs_err"] = err
    kernels["lpm_lookup"]["ms"] = device_ms(lambda: lpm_lookup(t, w, f), 20)
    kernels["lpm_lookup"]["plain_ms"] = device_ms(
        lambda: lpm_lookup_plain(t, w, f), 3)
    levels = 1 + int((t.l1[(w[:, 3].to(torch.int64) & 0xFFFFFFFF) >> 16]
                      < 0).sum())
    kernels["lpm_lookup"]["bytes"] = (N * (16 + 4 + 4) + 4 * levels
                                      + t.v6_net.numel() * 9)
    kernels["lpm_lookup"]["ops"] = N * 12 + int(v6.sum()) * (
        t.v6_net.shape[0] * 14)
    print(f"parity lpm_lookup: {N} addresses ({int(v6.sum())} v6), "
          f"bit-exact")


def phase_ct(torch, rng, kernels):
    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.datapath import conntrack as ct

    now = 10_000
    table, fp, rows = half_full_table(rng, now)
    # lookups: 40% present forward keys, 20% their reverse (swapped
    # halves and direction), 40% misses, plus a fingerprint-overflow trap
    live = rows[rng.integers(0, len(rows), N)]
    keys = random_keys(rng, N)
    pick = rng.random(N)
    fwd = np.where((pick < 0.4)[:, None], live[:, :ct.KEY_WORDS], keys)
    rev = fwd.copy()
    rev[:, 0:4], rev[:, 4:8] = fwd[:, 4:8], fwd[:, 0:4]
    rev[:, 9] ^= 1 << 8
    swap = (pick >= 0.4) & (pick < 0.6)
    fwd[swap], rev[swap] = rev[swap], live[swap, :ct.KEY_WORDS]
    trap = fwd[0]
    h = int(ct._hash_np(trap[None])[0])
    for pos in range(ct.N_CAND + 2):
        s = (h + pos) & (CT_CAPACITY - 1)
        table[s] = 0
        table[s, :ct.KEY_WORDS] = trap
        table[s, ct.V_STATE] = ct.ST_ESTABLISHED
        table[s, ct.V_EXPIRES] = now - 1 if pos <= ct.N_CAND else now + 9
    fp = ct.ct_fp_from_table(table)
    cti = ct.CTTable(table=u32.from_numpy(table, "cuda"),
                     fp=u32.from_numpy(fp, "cuda"),
                     dropped=torch.zeros((), dtype=torch.int32,
                                         device="cuda"))
    tf, tr = u32.from_numpy(fwd, "cuda"), u32.from_numpy(rev, "cuda")
    got = ct.ct_lookup(cti, tf, tr, now)
    want = ct.ct_lookup_plain(cti, tf, tr, now)
    err = max(max_abs_err(g, w, f"ct_lookup[{i}]")
              for i, (g, w) in enumerate(zip(got, want)))
    check(int(got[0][0]) == ct.CT_ESTABLISHED,
          "ct_lookup: the overflow trap was not found")
    hits = int((got[0] != ct.CT_NEW).sum())
    kernels["ct_lookup"].update(
        max_abs_err=err,
        ms=device_ms(lambda: ct.ct_lookup(cti, tf, tr, now), 20),
        plain_ms=device_ms(lambda: ct.ct_lookup_plain(cti, tf, tr, now), 3),
        bytes=N * (80 + 9) + N * 2 * 64 + hits * 68,
        ops=N * 2 * (10 * 4 + 12 + 16 * 3))
    print(f"parity ct_lookup: {N} keys on a {CT_CAPACITY} table "
          f"({int((table[:, ct.V_STATE] != 0).sum())} live), {hits} hits, "
          f"bit-exact")

    # ct_update: refreshes (state machine, replies, counters near 2^32),
    # new flows with duplicate tuples, crowded windows, masked rows
    res, slot, rep = (t.clone() for t in got)
    crowd = crowded_keys(rng)
    n_crowd = min(len(crowd), N // 8)
    new = np.where((pick >= 0.6)[:, None], keys, fwd)
    new[-n_crowd:] = crowd[:n_crowd]
    dup_src = rng.integers(N // 2, N - n_crowd, N // 16)
    dup_dst = rng.integers(N // 2, N - n_crowd, N // 16)
    new[dup_dst] = new[dup_src]
    tn = u32.from_numpy(new, "cuda")
    res, slot, rep = ct.ct_lookup_plain(cti, tn, tr, now)
    l4 = np.zeros((N, 3), np.uint32)
    l4[:, 0] = new[:, 9] & 0xFF
    l4[:, 1] = rng.choice(np.array([0x10, 0x11, 0x14, 0x02, 0], np.uint32),
                          N)
    l4[:, 2] = rng.integers(40, 9000, N)
    do_create = torch.from_numpy(rng.random(N) < 0.9).cuda()
    valid = torch.from_numpy(rng.random(N) < 0.97).cuda()
    proxy = u32.from_numpy(rng.choice(np.array([0, 10000], np.uint32), N),
                           "cuda")
    tl4 = u32.from_numpy(l4, "cuda")
    base = (cti.table.clone(), cti.fp.clone(), cti.dropped.clone())
    kc = ct.CTTable(*(t.clone() for t in base))
    pc = ct.CTTable(*(t.clone() for t in base))
    args = (tl4, tn, res, slot, rep, do_create, proxy, now)
    ct.ct_update(kc, *args, valid=valid)
    ct.ct_update_plain(pc, *args, valid=valid)
    err = max(max_abs_err(kc.table, pc.table, "ct_update table"),
              max_abs_err(kc.fp, pc.fp, "ct_update fp"),
              max_abs_err(kc.dropped, pc.dropped, "ct_update dropped"))
    check(bool((kc.claim == -1).all()),
          "ct_update left claim words set (they must be -1 between calls)")
    inserted = int(((pc.table[:, ct.V_STATE] != 0)
                    & (base[0][:, ct.V_STATE] == 0)).sum())
    print(f"parity ct_update: {N} rows, {int((res != 0).sum())} hits, "
          f"{inserted} inserts, {n_crowd} crowded keys, "
          f"{len(dup_src)} duplicated tuples, dropped "
          f"{int(pc.dropped)}, bit-exact")
    kernels["ct_update"]["max_abs_err"] = err


def phase_ring(torch, rng, kernels):
    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.monitor import ring as rg

    out = rng.integers(0, 1 << 32, (N, 6), dtype=np.uint64).astype(
        np.uint32)
    out[:, 5] = rng.choice(np.array([0, 0, 1, 2], np.uint32), N)
    out[:, 1] = rng.choice(np.array([0, 10000, 10001, 3], np.uint32), N)
    tout = u32.from_numpy(out, "cuda")
    valid = torch.from_numpy(rng.random(N) < 0.95).cuda()
    ports = u32.from_numpy(np.array([10000, 10001], np.uint32), "cuda")
    err = 0
    for cap, cursor, ts in ((1 << 15, (0xFFFFFF00, 7), 1024),
                            (RING_CAPACITY, (0, 0), 0)):
        rings = [rg.EventRing.create(cap, "cuda") for _ in range(2)]
        for r in rings:
            r.cursor.copy_(u32.from_numpy(np.array(cursor, np.uint32),
                                          "cuda"))
        rg.ring_append(rings[0], tout, 4097, ts, valid, ports)
        rg.ring_append_plain(rings[1], tout, 4097, ts, valid, ports)
        err = max(err, max_abs_err(rings[0].buf, rings[1].buf, "ring buf"),
                  max_abs_err(rings[0].cursor, rings[1].cursor,
                              "ring cursor"))
        got = rg.ring_drain(rings[0], np.array([10000, 10001]))
        kept = got[1] - cursor[0] - (cursor[1] << 32)
        print(f"parity ring_append: capacity {cap}, {kept} kept, {got[2]} "
              f"overwritten, bit-exact")
    kernels["ring_append"]["max_abs_err"] = err


def phase_maint(torch, rng, kernels):
    """The CT aging sweep and the occupancy count against their plain
    versions on a half-full 2^20 table whose expiries straddle 2^31 and
    ``now`` (an unsigned compare: a signed one gets them wrong)."""
    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.datapath import conntrack as ct
    from cilium_tpu_torch.datapath.loader import (_ct_occupied,
                                                  _ct_occupied_plain)

    now = (1 << 31) + 1000
    table, fp, _rows = half_full_table(rng, now)
    live = table[:, ct.V_STATE] != ct.ST_FREE
    edges = np.array([(1 << 31) - 1, 1 << 31, (1 << 31) + 1, now - 1, now,
                      now + 1, 0xFFFFFFFF, 5, now + 100], np.uint32)
    table[live, ct.V_EXPIRES] = rng.choice(edges, int(live.sum()))
    expired = int((live & (table[:, ct.V_EXPIRES] < now)).sum())
    base = ct.CTTable(table=u32.from_numpy(table, "cuda"),
                      fp=u32.from_numpy(fp, "cuda"),
                      dropped=torch.zeros((), dtype=torch.int32,
                                          device="cuda"))

    def fresh():
        return ct.CTTable(base.table.clone(), base.fp.clone(),
                          base.dropped.clone())

    occ_k = int(_ct_occupied(base.fp).sum())
    occ_p = int(_ct_occupied_plain(base.fp))
    check(occ_k == occ_p == int((fp != 0).sum()),
          f"ct_occupied: kernel {occ_k}, plain {occ_p}, host "
          f"{int((fp != 0).sum())}")
    kc, pc = fresh(), fresh()
    n_k = int(ct.ct_gc(kc, now).sum())
    n_p = int(ct.ct_gc_plain(pc, now))
    check(n_k == n_p == expired, f"ct_gc: kernel evicted {n_k}, plain "
          f"{n_p}, host {expired}")
    err = max(max_abs_err(kc.table, pc.table, "ct_gc table"),
              max_abs_err(kc.fp, pc.fp, "ct_gc fp"),
              max_abs_err(kc.dropped, pc.dropped, "ct_gc dropped"))
    kernels["ct_gc"]["max_abs_err"] = err
    kernels["ct_occupied"]["max_abs_err"] = abs(occ_k - occ_p)
    print(f"parity ct_gc: {CT_CAPACITY} slots, {int(live.sum())} live, "
          f"{expired} expired at now={now}, bit-exact")
    print(f"parity ct_occupied: {occ_k} occupied of {CT_CAPACITY}, "
          f"bit-exact")
    kernels["ct_gc"].update(
        ms=device_ms(lambda w: ct.ct_gc(w, now), 20, fresh),
        plain_ms=device_ms(lambda w: ct.ct_gc_plain(w, now), 3, fresh),
        # every slot's state word, each live slot's expiry, and the
        # state and fingerprint of each expired slot written back
        bytes=CT_CAPACITY * 4 + int(live.sum()) * 4 + expired * 8 + 4,
        ops=CT_CAPACITY * 4)
    kernels["ct_occupied"].update(
        ms=device_ms(lambda: _ct_occupied(base.fp), 20),
        plain_ms=device_ms(lambda: _ct_occupied_plain(base.fp), 3),
        library_ms=device_ms(lambda: torch.count_nonzero(base.fp), 20),
        bytes=CT_CAPACITY * 4 + 4, ops=CT_CAPACITY * 2)


def random_ring_words(rng, n, empty_frac=0.03):
    """Event-ring words: real event rows with some EMPTY slots."""
    import numpy as np

    w = rng.integers(0, 1 << 32, (n, 2), dtype=np.uint64).astype(np.uint32)
    w[:, 0] &= ~np.uint32(0x18)
    w[rng.random(n) < empty_frac] = 0xFFFFFFFF
    return w


def phase_gather(torch, rng, kernels):
    """ring_gather against its plain version on lapped and unlapped
    2^18 rings at several rungs; then windows through the card's drainer
    (gather or full copy, pinned copy, event) against the CPU drainer."""
    import numpy as np
    from cilium_tpu_torch import convert, u32
    from cilium_tpu_torch.monitor import ring as rg

    cap = RING_CAPACITY
    words = random_ring_words(rng, cap)
    buf = u32.from_numpy(words, "cuda")
    err = 0
    for start in (0, int(rng.integers(1, cap))):
        for rung in (64, 1 << 12, 1 << 16, cap):
            got = rg.ring_gather(buf, [start], rung, cap)
            want = rg.ring_gather_plain(buf, [start], rung, cap)
            err = max(err, max_abs_err(got, want,
                                       f"ring_gather start {start} rung "
                                       f"{rung}"))
    kernels["ring_gather"]["max_abs_err"] = err
    print(f"parity ring_gather: {cap} slots, unlapped and lapped, rungs "
          f"64 .. {cap}, bit-exact")
    for total, gather in ((100_000, True), (3 * cap + 12345, True),
                          (100_000, False)):
        cur = np.array([total & 0xFFFFFFFF, total >> 32], np.uint32)
        w = words.copy()
        if total < cap:
            w[total:] = 0xFFFFFFFF
        results = []
        for dev in ("cuda", "cpu"):
            d = rg.AsyncRingDrainer(cap, gather=gather, device=dev)
            win, _fresh = d.swap_window(
                convert.event_ring_from_numpy(w, cur, dev))
            rows, _shards, appended, lost = win.fetch()
            results.append((win.rung, win.d2h_bytes, appended, lost, rows))
        (rk, bk, ak, lk, rows_k), (rp, bp, ap, lp, rows_p) = results
        check((rk, bk, ak, lk) == (rp, bp, ap, lp)
              and np.array_equal(rows_k, rows_p),
              f"drainer window of {total}: card and CPU differ")
        print(f"parity drain window ({'gather' if gather else 'full copy'}"
              f"): {total} appended, rung {rk}, "
              f"{bk} bytes to the host, {len(rows_k)} rows, lost {lk}, "
              f"equal to the CPU drainer")


def time_gather(torch, rng, kernels, rung):
    """ring_gather's times at the rung the daemon's windows used."""
    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.monitor import ring as rg

    cap = RING_CAPACITY
    buf = u32.from_numpy(random_ring_words(rng, cap), "cuda")
    start = [int(rng.integers(0, cap))]
    kernels["ring_gather"].update(
        ms=device_ms(lambda: rg.ring_gather(buf, start, rung, cap), 20),
        plain_ms=device_ms(
            lambda: rg.ring_gather_plain(buf, start, rung, cap), 3),
        bytes=rung * 8 * 2, ops=rung * 4, rung=rung)
    print(f"timing ring_gather at rung {rung}")


L7_PORT = 10000
L7_BATCH = 4096  # requests a handle_http call (bench.py bench_l7)


def l7_world(rng, n_exact=192, n_prefix=16):
    """BASELINE.md config #4 as ``bench.py`` ``bench_l7`` builds it: 192
    literal HTTP rules and 16 ``/static/{i}/.*`` prefix rules on one
    listener, and a batch of 4096 requests (70% literal hits, 15%
    prefix hits, 15% denied)."""
    from cilium_tpu_torch.policy.api import L7Rules

    rules = [{"method": ("GET", "POST", "PUT", "DELETE")[i % 4],
              "path": f"/api/v{i % 3}/resource{i}"} for i in range(n_exact)]
    rules += [{"method": "GET", "path": f"/static/{i}/.*"}
              for i in range(n_prefix)]
    pol = type("P", (), {"redirects": [
        (L7_PORT, "bench", L7Rules.from_dict({"http": rules}))]})()
    reqs = []
    for _ in range(L7_BATCH):
        r = rng.random()
        if r < 0.70:
            i = int(rng.integers(0, n_exact))
            reqs.append({"method": ("GET", "POST", "PUT", "DELETE")[i % 4],
                         "path": f"/api/v{i % 3}/resource{i}",
                         "host": "db.svc"})
        elif r < 0.85:
            i = int(rng.integers(0, n_prefix))
            reqs.append({"method": "GET", "path": f"/static/{i}/app.js",
                         "host": "db.svc"})
        else:
            reqs.append({"method": "DELETE", "path": "/etc/passwd",
                         "host": "db.svc"})
    return pol, reqs


def phase_l7(torch, rng, kernels, report):
    """K9 against its plain version on the card at config #4, the
    card's proxy against a CPU proxy, and requests/s through
    ``handle_http`` on the card; returns that loop's launch counts."""
    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts
    from cilium_tpu_torch.proxy import L7Proxy
    from cilium_tpu_torch.proxy.featurize import (featurize_http,
                                                  path_prefix_hashes)
    from cilium_tpu_torch.proxy.l7policy import (compile_l7, l7_verdict,
                                                 l7_verdict_plain,
                                                 prefix_columns)

    pol, reqs = l7_world(rng)
    t = compile_l7(pol.redirects)
    rows, raw = featurize_http(reqs, L7_PORT)
    pref = path_prefix_hashes([r["path"] for r in raw], t.prefix_lengths)
    rules_d, rows_d, pref_d = (u32.from_numpy(a, "cuda")
                               for a in (t.rules, rows, pref))
    lens_d = u32.from_numpy(np.asarray(t.prefix_lengths), "cuda")
    cols_d = prefix_columns(rules_d, lens_d)
    got = l7_verdict(rules_d, rows_d, pref_d, lens_d, rule_cols=cols_d)
    want = l7_verdict_plain(rules_d, rows_d, pref_d, lens_d)
    err = max_abs_err(got.to(torch.int32), want.to(torch.int32),
                      "l7_verdict")
    # without the prefix tensor (prefix rows then match nothing)
    err = max(err, max_abs_err(l7_verdict(rules_d, rows_d).to(torch.int32),
                               l7_verdict_plain(rules_d, rows_d).to(
                                   torch.int32), "l7_verdict, no pref"))
    n_rules, k = t.rules.shape[0], len(t.prefix_lengths)
    kernels["l7_verdict"].update(
        max_abs_err=err,
        ms=device_ms(lambda: l7_verdict(rules_d, rows_d, pref_d, lens_d,
                                        rule_cols=cols_d), 20),
        plain_ms=device_ms(lambda: l7_verdict_plain(rules_d, rows_d,
                                                    pref_d, lens_d), 3),
        # each request row, its prefix hashes and its verdict once; the
        # rules and their prefix columns once
        bytes=L7_BATCH * (32 + 8 * k + 1) + n_rules * (28 + 8),
        ops=L7_BATCH * n_rules * 16)
    print(f"parity l7_verdict: {L7_BATCH} requests x {n_rules} rules "
          f"({t.n_prefix} prefix, K={k}), {int(want.sum())} admitted on "
          f"the card, bit-exact")

    proxies = [L7Proxy(), L7Proxy(device="cpu")]
    for px in proxies:
        px.update([pol])
    v_card, v_cpu = (px.handle_http(L7_PORT, reqs) for px in proxies)
    counters = ("requests_total", "requests_denied",
                "host_fallback_checked", "host_fallback_allowed")
    check(np.array_equal(v_card, v_cpu)
          and all(getattr(proxies[0], c) == getattr(proxies[1], c)
                  for c in counters),
          "L7Proxy on the card differs from L7Proxy on the CPU")
    print(f"l7 proxy: handle_http on the card equals the CPU proxy: "
          f"{int(v_card.sum())} of {L7_BATCH} forwarded, "
          f"{proxies[0].requests_denied} denied, host fallback "
          f"{proxies[0].host_fallback_checked} checked")
    card = proxies[0]
    iters = 24
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(iters):
        card.handle_http(L7_PORT, reqs)
    dt = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    check(launches["l7_verdict"] == iters,
          f"l7: {launches['l7_verdict']} K9 launches for {iters} calls")
    rps = L7_BATCH * iters / dt
    print(f"l7 requests/s through handle_http on the card: {rps:.0f} "
          f"({iters} calls of {L7_BATCH}, host clock, {dt:.3f} s)")
    report["l7"] = {"requests_per_s": rps, "iters": iters,
                    "batch": L7_BATCH, "rules": n_rules,
                    "prefix_rules": t.n_prefix, "k": k,
                    "admitted": int(v_card.sum()),
                    "host_fallback_checked":
                        proxies[0].host_fallback_checked}
    return launches


def phase_superbatch(torch, rng, world, report):
    """One packed superbatch (K = 4 steps of 2^16, the third partly
    masked, the last all-false) against four sequential serve_packed
    calls with the same batch ids, both through the kernels."""
    import numpy as np
    from cilium_tpu_torch.core.packets import pack_rows
    from cilium_tpu_torch.datapath.loader import TorchLoader
    from cilium_tpu_torch.monitor.ring import EventRing, ring_drain
    from cilium_tpu_torch.testing import fixtures as fx

    k_steps, bucket = 4, 1 << 16
    pool = fx.steady_flow_pool(world, bucket, rng)
    steps = [pool] + [fx.steady_traffic(pool, bucket, rng)
                      for _ in range(k_steps - 1)]
    packed = np.stack([pack_rows(h) for h in steps])
    valid = np.ones((k_steps, bucket), bool)
    valid[k_steps - 2] = rng.random(bucket) < 0.9
    valid[k_steps - 1] = False
    zeros = np.zeros(k_steps, np.uint32)
    proxy = np.array([10000], np.uint32)
    loaders = [TorchLoader(ct_capacity=CT_CAPACITY, device="cuda")
               for _ in range(2)]
    rings = [EventRing.create(RING_CAPACITY, "cuda") for _ in range(2)]
    for l in loaders:
        l.attach(world.policies, world.ipcache, {0: 0}, world.row_map)
    rings[0], _ = loaders[0].serve_superbatch(
        rings[0], packed, 2000, 8190, eps=zeros, dirns=zeros, valid=valid,
        proxy_ports=proxy, packed=True)
    for k in range(k_steps):
        rings[1], _ = loaders[1].serve_packed(
            rings[1], packed[k], 2000, 8190 + k, 0, 0, valid=valid[k],
            proxy_ports=proxy)
    torch.cuda.synchronize()
    max_abs_err(rings[0].buf, rings[1].buf, "superbatch ring buf")
    max_abs_err(rings[0].cursor, rings[1].cursor, "superbatch cursor")
    for a, b, what in ((loaders[0].state.metrics, loaders[1].state.metrics,
                        "metrics"),
                       (loaders[0].state.ct.table, loaders[1].state.ct.table,
                        "CT table"),
                       (loaders[0].state.ct.fp, loaders[1].state.ct.fp,
                        "CT fp"),
                       (loaders[0].state.ct.dropped,
                        loaders[1].state.ct.dropped, "dropped")):
        max_abs_err(a, b, f"superbatch {what}")
    rows, total, lost = ring_drain(rings[0], proxy)
    batches = set(np.unique(rows[:, -1]).tolist())
    check(total > 0 and (8190 + k_steps - 1) & 0x1FFF not in batches,
          f"superbatch: events {total}, batch ids {sorted(batches)}")
    print(f"superbatch: K={k_steps} x {bucket} packed (last step "
          f"all-false) equals 4 serve_packed: {total} events, lost {lost}, "
          f"metrics {loaders[0].metrics().sum(axis=0).tolist()}")
    report["superbatch"] = {"events": total, "k": k_steps,
                            "bucket": bucket}


class StageClock:
    """Host-clock times of the serving stages inside a daemon session,
    on the daemon's own threads: each stage's callable is replaced on
    its owner by a wrapper that records every call's wall time (a
    ``perf_counter`` pair and a list append, ~1 us a call).  The
    stages overlap across threads (producer, drain loop, event worker),
    so each thread's share of the session is read on its own."""

    # stage -> the thread that runs it
    THREADS = {"submit: queue copy in": "producer",
               "batcher: dequeue + eligibility + pack": "drain",
               "dispatch: serve_superbatch / serve_batch, all": "drain",
               "loader: staging copy + K steps enqueued": "drain",
               "drain tick: cursor read (waits for the card), K6 gather, "
               "copy start": "drain",
               "event join, all": "worker",
               "event join: unpack + decode_ring_rows + publish": "worker",
               "event join: L7Plane.ingest": "worker",
               "l7 task: request source + parse + K9 + fallback": "l7"}

    def __init__(self):
        import threading

        self.times = {name: [] for name in self.THREADS}
        self._depth = threading.local()

    def wrap(self, owner, attr, name, skip_none=False):
        """Replace ``owner.attr`` by a timed wrapper.  A call made
        inside another call of the same stage (the batcher's K-batch
        assembly falls back to the single one) counts once, in the
        outer call; with ``skip_none`` a call that returns None (an
        idle poll of the batcher) is not recorded."""
        fn = getattr(owner, attr)
        times, depth = self.times[name], self._depth

        def timed(*args, **kwargs):
            outer = not getattr(depth, name, 0)
            setattr(depth, name, getattr(depth, name, 0) + 1)
            t0 = time.perf_counter()
            r = None
            try:
                r = fn(*args, **kwargs)
                return r
            finally:
                setattr(depth, name, getattr(depth, name) - 1)
                if outer and not (skip_none and r is None):
                    times.append((time.perf_counter() - t0) * 1e3)

        setattr(owner, attr, timed)

    def before_start(self, d):
        """Wrap what start_serving hands to its threads as bound
        methods (the worker's join) and what the daemon reaches through
        itself or its loader."""
        self.wrap(d, "submit", "submit: queue copy in")
        for attr in ("serve_superbatch", "serve_batch"):
            self.wrap(d, attr,
                      "dispatch: serve_superbatch / serve_batch, all")
        for attr in ("serve_superbatch", "serve_packed"):
            self.wrap(d.loader, attr,
                      "loader: staging copy + K steps enqueued")
        self.wrap(d, "_event_join", "event join, all")
        self.wrap(d, "_emit_ring_rows",
                  "event join: unpack + decode_ring_rows + publish")

    def after_start(self, d):
        """Wrap the session's batcher and drainer, which start_serving
        builds (before the first submit, so no call escapes)."""
        s = d._serving
        for attr in ("assemble_super", "assemble"):
            self.wrap(s["runtime"].batcher, attr,
                      "batcher: dequeue + eligibility + pack",
                      skip_none=True)
        self.wrap(s["drainer"], "swap_window",
                  "drain tick: cursor read (waits for the card), K6 "
                  "gather, copy start")
        # the session's L7 plane: its ingest, and the handler its pool
        # calls (the plane is dropped at stop, so nothing to unwrap)
        self.wrap(d._l7plane, "ingest", "event join: L7Plane.ingest")
        self.wrap(d._l7plane.pool, "_handle_fn",
                  "l7 task: request source + parse + K9 + fallback")

    def unwrap(self, d):
        for owner, attrs in ((d, ("submit", "serve_superbatch",
                                  "serve_batch", "_event_join",
                                  "_emit_ring_rows")),
                             (d.loader, ("serve_superbatch",
                                         "serve_packed"))):
            for attr in attrs:
                delattr(owner, attr)

    def summary(self, seconds):
        out = {}
        for name, v in self.times.items():
            out[name] = {"thread": self.THREADS[name], "calls": len(v),
                         "median_ms": statistics.median(v) if v else None,
                         "total_ms": sum(v),
                         "share": sum(v) / 1e3 / seconds}
        return out


def phase_daemon(torch, rng, world, report):
    """BASELINE.md config #3 through the daemon's own API, served
    through its ingress front end; returns (launches, rung)."""
    import threading

    import numpy as np
    from cilium_tpu_torch.agent import Daemon, DaemonConfig
    from cilium_tpu_torch.core.packets import (COL_DST_IP3, COL_EP,
                                               ip_to_words, pack_rows)
    from cilium_tpu_torch.datapath.loader import TorchLoader
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts
    from cilium_tpu_torch.labels import LabelSet
    from cilium_tpu_torch.monitor.ring import EventRing, _gather_rung
    from cilium_tpu_torch.testing import fixtures as fx

    db_ip = "10.0.0.5"
    cfg = DaemonConfig(ct_capacity=CT_CAPACITY, serving_packed_ingest=True,
                       serving_superbatch_k=4,
                       serving_queue_depth=1 << 19, ct_gc_interval=0.5,
                       map_pressure_interval=0.5)
    t0 = time.monotonic()
    d = Daemon(cfg)
    # the remote identities and their /32s, all before start() and
    # before any endpoint: the allocator hook only clears the cache
    for i, ip in enumerate(world.pod_ips):
        ident = d.allocator.allocate(
            LabelSet.parse(f"k8s:app=svc{i}", "k8s:ns=default"))
        d.ipcache.upsert(ip + "/32", ident.numeric_id, source="k8s")
    d.policy_import(fx.world_rules(len(world.pod_ips), 64))
    db = d.add_endpoint("db", (db_ip,), ["k8s:app=db"])
    t_build = time.monotonic() - t0
    print(f"daemon: {len(world.pod_ips)} identities, "
          f"{d.endpoints.regenerations} regenerations, built through the "
          f"API in {t_build:.1f} s")

    bucket = d.config.serving_bucket_ladder[-1]
    per = (1 << 21) // 8  # a pool of SYNs, then 7 steady draws from it
    pool = fx.steady_flow_pool(world, per, rng)
    rows = np.concatenate([pool] + [fx.steady_traffic(pool, per, rng)
                                    for _ in range(7)])
    rows[:, COL_EP] = db.id
    rows[:, COL_DST_IP3] = ip_to_words(db_ip)[3]
    chunk = 4 * bucket
    depth = d.config.serving_queue_depth

    def serve(rows, clock=None):
        """One serving session: a producer thread submits ``rows`` in
        chunks of four top buckets, holding back while the rows
        admitted but not yet verdicted would leave no room for a chunk
        (a closed loop: nothing sheds), then stop_serving().  A
        :class:`StageClock` times the stages on the daemon's threads.
        Returns (stop_serving's result, seconds from the first
        submit)."""
        if clock is not None:
            clock.before_start(d)
        d.start_serving(ring_capacity=RING_CAPACITY, ingress=True,
                        packed=True, superbatch_k=4)
        if clock is not None:
            clock.after_start(d)

        def produce():
            off = 0
            while off < len(rows):
                st = d.serving_stats()
                if st["admitted"] - st["verdicts"] > depth - chunk:
                    time.sleep(0.0002)
                    continue
                off += d.submit(rows[off:off + chunk])

        t0 = time.monotonic()
        producer = threading.Thread(target=produce, name="smoke-producer")
        producer.start()
        producer.join(timeout=600)
        check(not producer.is_alive(), "daemon: the producer did not finish")
        out = d.stop_serving()
        if clock is not None:
            clock.unwrap(d)
        return out, time.monotonic() - t0

    reset_launch_counts()
    d.start()
    out, t_serve = serve(rows)
    launches = {k: v.launches for k, v in KERNELS.items()}
    fe = out["front-end"]
    ft = fe["fault-tolerance"]
    check(fe["submitted"] == fe["verdicts"] + fe["shed"]
          + ft["recovery-dropped"], f"daemon: ledger broken: {fe}")
    check(fe["verdicts"] == len(rows) and ft["recovery-dropped"] == 0,
          f"daemon: {fe['verdicts']} verdicts of {len(rows)}")
    check(out["lost"] == 0 and out["events"] > 0,
          f"daemon: {out['events']} events, {out['lost']} lost")
    for name in ("datapath_packed", "ct_update", "ring_append",
                 "ring_gather", "ct_gc", "ct_occupied", "l7_verdict"):
        check(launches[name] > 0, f"daemon: {name} never launched")
    l7 = out["l7"]
    check(l7["ledger-exact"] and l7["redirected"] == l7["l7-allowed"]
          + l7["l7-denied"] + l7["l7-shed"] + l7["l7-failed"]
          and l7["redirected"] > 0 and l7["l7-allowed"] > 0,
          f"daemon: L7 ledger broken: {l7}")
    # the controllers (they run at start() and every 0.5 s)
    st = d.controllers.statuses()
    check(st["ct-gc"].success_count >= 1
          and st["map-pressure"].success_count >= 1
          and d.pressure.last is not None,
          f"daemon: controllers did not run: {st}")
    sample = d.pressure.last
    print(f"daemon ledger: submitted {fe['submitted']} = verdicts "
          f"{fe['verdicts']} + shed {fe['shed']} + recovery-dropped "
          f"{ft['recovery-dropped']}")
    print(f"daemon events: {out['windows']} windows, {out['events']} "
          f"events, lost {out['lost']}; dispatches "
          f"{fe['dispatch']['dispatches']} for {fe['batches']} batches "
          f"({fe['dispatch']['superbatches']} superbatches)")
    print(f"daemon verdicts/s: {len(rows) / t_serve:.0f} ({len(rows)} "
          f"packets submit -> stop_serving in {t_serve:.3f} s, host clock)")
    print(f"daemon launches: {json.dumps(launches)}")
    print(f"daemon L7 plane: redirected {l7['redirected']} = allowed "
          f"{l7['l7-allowed']} + denied {l7['l7-denied']} + shed "
          f"{l7['l7-shed']} + failed {l7['l7-failed']}; "
          f"{l7['tasks-submitted']} tasks ({l7['queue-overflows']} "
          f"overflows), {l7['tasks-done']} handled by "
          f"{l7['workers']} workers, parse lag p50 "
          f"{l7['parse-lag-us']['p50']:.0f} us")
    print(f"daemon controllers: ct-gc ran {st['ct-gc'].success_count} "
          f"times (evicted {d.ct_gc_evicted}), map-pressure "
          f"{st['map-pressure'].success_count} times; "
          f"last sample ct {sample['ct']}, lpm {sample['lpm']}, policy "
          f"{sample['policy']}")

    # the same rows through TorchLoader.serve_packed in fixed batches,
    # on the tables the daemon compiled (forward-only traffic: the
    # per-reason counts do not depend on batch boundaries)
    m_daemon = d.loader.metrics()
    fl = TorchLoader(ct_capacity=CT_CAPACITY)
    fl.attach([d.repo.resolve(LabelSet.parse("k8s:app=db"))],
              d.ipcache.to_identity_map(), {db.id: 0}, d.endpoints.row_map)
    fring = EventRing.create(RING_CAPACITY)
    for b in range(0, len(rows), per):
        fring, _ = fl.serve_packed(fring, pack_rows(rows[b:b + per]), 1,
                                   b // per, db.id, 0)
    m_fixed = fl.metrics()
    check(np.array_equal(m_daemon, m_fixed),
          f"daemon: metrics {m_daemon.tolist()} differ from the fixed-batch "
          f"run {m_fixed.tolist()}")
    print(f"daemon metrics equal the fixed-batch serve_packed run: "
          f"{m_daemon.sum(axis=0).tolist()} by direction, "
          f"{int(m_daemon[0].sum())} forwarded")
    # a second session of steady traffic (every flow now established)
    # with the stages timed on the daemon's own threads
    clock = StageClock()
    out_st, t_st = serve(rows[per:], clock)
    fe_st = out_st["front-end"]
    check(fe_st["verdicts"] == len(rows) - per and fe_st["shed"] == 0
          and out_st["lost"] == 0 and out_st["l7"]["ledger-exact"],
          f"daemon: the timed session lost rows or events: {fe_st}, "
          f"{out_st['l7']}")
    stages = clock.summary(t_st)
    n_super = fe_st["dispatch"]["superbatches"]
    print(f"daemon timed session: {len(rows) - per} packets in "
          f"{t_st:.3f} s ({(len(rows) - per) / t_st:.0f} verdicts/s), "
          f"{n_super} superbatches, {out_st['windows']} windows; stages "
          f"on the daemon's threads (calls, median ms, total ms, share "
          f"of the session):")
    for name, v in stages.items():
        med = "-" if v["median_ms"] is None else f"{v['median_ms']:.3f}"
        print(f"  [{v['thread']}] {name}: {v['calls']}, {med}, "
              f"{v['total_ms']:.3f}, {v['share']:.1%}")
    # a third session under the profiler (device activity only): how
    # busy the card is while the daemon serves steady traffic
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out2, t_prof = serve(rows[per:])
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith("Activity Buffer"))
    by_name = {e.key: e.self_device_time_total / 1e3
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0}
    fe2 = out2["front-end"]
    print(f"daemon profiled session: {len(rows) - per} packets in "
          f"{t_prof:.3f} s ({(len(rows) - per) / t_prof:.0f} verdicts/s "
          f"under the tracer), {fe2['dispatch']['dispatches']} dispatches; "
          f"device busy {busy_us / 1e3:.3f} ms ({busy_us / 1e6 / t_prof:.1%}"
          f"), idle {1 - busy_us / 1e6 / t_prof:.1%}")
    # a final sweep far in the future evicts every occupied slot
    occ = d.loader.map_pressure(1)["ct"]["occupied"]
    evicted = d.loader.gc(1 << 30)
    left = d.loader.map_pressure(1 << 30)["ct"]["occupied"]
    check(evicted == occ > 0 and left == 0,
          f"daemon: gc evicted {evicted} of {occ} occupied, {left} left")
    print(f"daemon: a sweep at now=2^30 evicts all {evicted} occupied CT "
          f"slots")
    d.shutdown()
    rung = _gather_rung(-(-out["events"] // max(out["windows"], 1)),
                        RING_CAPACITY)
    report["daemon"] = {
        "build_s": t_build, "serve_s": t_serve, "packets": len(rows),
        "verdicts_per_s": len(rows) / t_serve, "front_end": fe,
        "windows": out["windows"], "events": out["events"],
        "lost": out["lost"], "event_plane": out["event-plane"],
        "l7": l7, "launches": launches, "pressure_sample": sample,
        "evicted_at_end": evicted, "metrics": m_daemon.tolist(),
        "stages": {"seconds": t_st, "packets": len(rows) - per,
                   "front_end": fe_st, "l7": out_st["l7"],
                   "by_stage": stages},
        "profiled": {"seconds": t_prof, "packets": len(rows) - per,
                     "device_busy_ms": busy_us / 1e3,
                     "front_end": fe2, "event_plane": out2["event-plane"],
                     "device_ms_by_name": by_name}}
    return launches, rung


def syn_rows(src, dst, sport0, n, dport, ep, dirn, proto=6):
    """``n`` SYN header rows from ``src`` to ``dst``, each a new flow
    (sports ``sport0`` .. ``sport0 + n - 1``)."""
    import numpy as np
    from cilium_tpu_torch.core import packets as pk

    rows = np.zeros((n, pk.N_COLS), np.uint32)
    rows[:, pk.COL_SRC_IP3] = pk.ip_to_words(src)[3]
    rows[:, pk.COL_DST_IP3] = pk.ip_to_words(dst)[3]
    check(0 < sport0 and sport0 + n <= 1 << 16, f"sports {sport0} + {n}")
    rows[:, pk.COL_SPORT] = sport0 + np.arange(n)
    rows[:, pk.COL_DPORT] = dport
    rows[:, pk.COL_PROTO] = proto
    rows[:, pk.COL_FLAGS] = pk.TCP_SYN
    rows[:, pk.COL_LEN] = 64
    rows[:, pk.COL_FAMILY] = 4
    rows[:, pk.COL_EP] = ep
    rows[:, pk.COL_DIR] = dirn
    return rows


def wait_for(pred, what, timeout=120.0):
    t0 = time.monotonic()
    while not pred():
        check(time.monotonic() - t0 < timeout, f"timed out waiting for {what}")
        time.sleep(0.002)


def phase_l7_redirect(torch, report):
    """``bench.py`` ``bench_l7_redirect`` on the card: two daemons, an L4
    allow on port 80 and the same port with an HTTP GET rule; every row
    a new flow, so every candidate row REDIRECTs into the L7 plane and
    the candidate leg's clock includes the pool draining it.  Returns
    the launch counts of the legs."""
    import statistics as st

    from cilium_tpu_torch.agent import Daemon, DaemonConfig
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts

    batch, iters, reps = 1024, 6, 3

    def build(with_l7):
        d = Daemon(DaemonConfig(ct_capacity=1 << 16,
                                serving_bucket_ladder=(batch,),
                                serving_queue_depth=1 << 14))
        d.add_endpoint("web", ("10.0.1.1",), ["k8s:app=web"])
        db = d.add_endpoint("db", ("10.0.2.1",), ["k8s:app=db"])
        tp = {"ports": [{"port": "80", "protocol": "TCP"}]}
        if with_l7:
            tp["rules"] = {"http": [{"method": "GET"}]}
        d.policy_import([{
            "endpointSelector": {"matchLabels": {"app": "db"}},
            "ingress": [{"fromEndpoints": [{"matchLabels": {"app": "web"}}],
                         "toPorts": [tp]}]}])
        d.start_serving(ring_capacity=1 << 13, trace_sample=0,
                        drain_every=1)
        return d, db.id

    legs = {"base": build(False), "redir": build(True)}
    sent = {"base": 0, "redir": 0}

    def rows_for(key):
        d, ep = legs[key]
        r = syn_rows("10.0.1.1", "10.0.2.1", 1024 + sent[key], batch, 80,
                     ep, 0)
        sent[key] += batch
        return r

    for key in legs:  # warm each daemon's path
        legs[key][0].serve_batch(rows_for(key))

    def leg(key):
        d = legs[key][0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            d.serve_batch(rows_for(key))
        if key == "redir":
            # the candidate pays its detour in full: every redirect the
            # drain ticks have handed over (all but the last batch's,
            # whose tick comes with the next dispatch) ingested and
            # handled by the pool
            want, pool = sent[key] - batch, d._l7plane.pool
            wait_for(lambda: pool.stats()["redirected"] >= want
                     and pool.pending == 0, "the redirect leg's pool")
        return batch * iters / (time.perf_counter() - t0)

    reset_launch_counts()
    pairs, best = [], {"base": 0.0, "redir": 0.0}
    for rep in range(reps):
        order = ["base", "redir"] if rep % 2 == 0 else ["redir", "base"]
        res = {k: leg(k) for k in order}
        pairs.append(res["redir"] / res["base"])
        for k in res:
            best[k] = max(best[k], res[k])
    launches = {name: k.launches for name, k in KERNELS.items()}
    outs = {k: legs[k][0].stop_serving() for k in legs}
    for k in legs:
        legs[k][0].shutdown()
    l7 = outs["redir"]["l7"]
    check(l7["ledger-exact"] and l7["redirected"] == sent["redir"]
          == l7["l7-allowed"] + l7["l7-shed"],
          f"redirect phase: {sent['redir']} rows sent, L7 ledger {l7}")
    check("l7" not in outs["base"] or outs["base"]["l7"]["redirected"] == 0,
          f"redirect phase: the L4 leg redirected: {outs['base'].get('l7')}")
    print(f"l7 redirect overhead: paired ratios (redirect / L4) "
          f"{[round(x, 4) for x in pairs]}, median "
          f"{st.median(pairs):.4f}; best legs {best['base']:.0f} vs "
          f"{best['redir']:.0f} packets/s ({iters} x {batch} a leg); "
          f"plane: {l7['l7-allowed']} allowed, {l7['l7-shed']} shed of "
          f"{l7['redirected']} redirected")
    report["l7_redirect"] = {"pairs": pairs, "ratio_median":
                             st.median(pairs), "best_pps": best,
                             "batch": batch, "iters": iters, "l7": l7}
    return launches


RULES_DNS = [{
    "endpointSelector": {"matchLabels": {"app": "client"}},
    "egress": [
        {"toEntities": ["world"],
         "toPorts": [{"ports": [{"port": "53", "protocol": "UDP"}],
                      "rules": {"dns": [
                          {"matchName": "example.com"},
                          {"matchPattern": "*.corp.io"}]}}]},
        {"toFQDNs": ["example.com"],
         "toPorts": [{"ports": [{"port": "443", "protocol": "TCP"}]}]},
        {"toFQDNs": ["*.corp.io"],
         "toPorts": [{"ports": [{"port": "8443", "protocol": "TCP"}]}]},
    ],
}]


def phase_fqdn(torch, world, report):
    """The DNS-answer -> FQDN identity loop on the card, in the config
    #3 world: probes drop, a DNS batch is allowed, its answer mints an
    identity (a full regeneration, timed), the next probes are allowed.
    Returns the launch counts of the session."""
    import numpy as np

    from cilium_tpu_torch.agent import Daemon, DaemonConfig
    from cilium_tpu_torch.core.packets import COL_DPORT, COL_SPORT
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts
    from cilium_tpu_torch.labels import LabelSet
    from cilium_tpu_torch.policy.mapstate import VERDICT_ALLOW
    from cilium_tpu_torch.testing import fixtures as fx

    client_ip, answer_ip = "10.0.0.9", "93.184.216.34"
    d = Daemon(DaemonConfig(ct_capacity=CT_CAPACITY,
                            serving_bucket_ladder=(64, 1024),
                            map_pressure_interval=0.0))
    for i, ip in enumerate(world.pod_ips):
        ident = d.allocator.allocate(
            LabelSet.parse(f"k8s:app=svc{i}", "k8s:ns=default"))
        d.ipcache.upsert(ip + "/32", ident.numeric_id, source="k8s")
    d.policy_import(fx.world_rules(len(world.pod_ips), 64) + RULES_DNS)
    d.add_endpoint("db", ("10.0.0.5",), ["k8s:app=db"])
    client = d.add_endpoint("client", (client_ip,), ["k8s:app=client"])
    d.l7_request_source = lambda port, kind, task: ["example.com"] * task.rows
    d.l7_dns_resolver = lambda q: ([answer_ip], 300)
    regen = []
    trig = d.endpoints._regen_trigger
    inner = trig._fn

    def timed_regen():
        t0 = time.perf_counter()
        inner()
        regen.append(time.perf_counter() - t0)

    trig._fn = timed_regen
    got = []
    d.monitor.register("smoke", got.append)
    d.start()
    reset_launch_counts()
    d.start_serving(ring_capacity=RING_CAPACITY, ingress=True, drain_every=1)

    def probe_verdicts(lo, n):
        out = {}
        for b in list(got):
            m = ((b.hdr[:, COL_DPORT] == 443) & (b.hdr[:, COL_SPORT] >= lo)
                 & (b.hdr[:, COL_SPORT] < lo + n))
            for sp, v in zip(b.hdr[m, COL_SPORT].tolist(),
                             b.verdict[m].tolist()):
                out[sp] = v
        return out

    n = 64
    d.submit(syn_rows(client_ip, answer_ip, 49000, n, 443, client.id, 1))
    wait_for(lambda: len(probe_verdicts(49000, n)) == n, "the first probes")
    pre = set(probe_verdicts(49000, n).values())
    check(VERDICT_ALLOW not in pre, f"fqdn: probes allowed before the "
          f"mint: {pre}")
    attaches, n_regen = d.loader.attach_count, len(regen)
    t0 = time.perf_counter()
    d.submit(syn_rows(client_ip, "8.8.8.8", 20000, n, 53, client.id, 1,
                      proto=17))
    wait_for(lambda: d.loader.attach_count > attaches
             and d._l7plane.pool.pending == 0, "the mint's regeneration")
    t_flip = time.perf_counter() - t0
    d.submit(syn_rows(client_ip, answer_ip, 50000, n, 443, client.id, 1))
    wait_for(lambda: len(probe_verdicts(50000, n)) == n, "the second probes")
    post = set(probe_verdicts(50000, n).values())
    check(post == {VERDICT_ALLOW}, f"fqdn: probes after the mint: {post}")
    out = d.stop_serving()
    launches = {name: k.launches for name, k in KERNELS.items()}
    l7 = out["l7"]
    entries = d.fqdn.entries()
    d.shutdown()
    check(l7["ledger-exact"] and l7["l7-allowed"] == n
          and l7["dns-answers"] >= 1 and [e["ip"] for e in entries]
          == [answer_ip], f"fqdn: L7 ledger {l7}, fqdn entries {entries}")
    mint_regen = regen[n_regen:]
    print(f"fqdn flip: probes {sorted(pre)} before the mint, {sorted(post)} "
          f"after; the DNS batch to the flipped tables took {t_flip:.3f} s "
          f"(host clock), of which {len(mint_regen)} full regeneration(s) "
          f"of the 10k-identity world: "
          f"{', '.join(f'{x:.3f}' for x in mint_regen)} s")
    report["fqdn"] = {"regeneration_s": mint_regen, "dns_to_flip_s": t_flip,
                      "l7": l7, "launches": launches}
    return launches


def plain_serve(state, ring, rows, now, batch_id, ep=None, dirn=None,
                proxy_ports=None, trace_sample=1024, valid=None):
    """One serving step through the plain versions only (the yardstick
    path on the card)."""
    from cilium_tpu_torch.core.packets import unpack_hdr
    from cilium_tpu_torch.datapath.conntrack import ct_update_plain
    from cilium_tpu_torch.datapath.verdict import verdict_stage_plain
    from cilium_tpu_torch.monitor.ring import ring_append_plain

    hdr = rows if ep is None else unpack_hdr(rows, ep, dirn)
    out, c = verdict_stage_plain(state, hdr, now, valid=valid)
    ct_update_plain(state.ct, c.l4, c.fwd, c.result, c.slot, c.is_reply,
                    c.do_create, c.proxy_port, now, valid)
    if ring is not None:
        ring_append_plain(ring, out, batch_id, trace_sample, valid,
                          proxy_ports)
    return out


def warm_up(torch, state, packed, wide):
    """One untimed serving step, packed and wide, on a scratch CT table
    and ring beside ``state``: loads every library and kernel module of
    the main path before a timed window."""
    import copy

    from cilium_tpu_torch import u32
    from cilium_tpu_torch.datapath.conntrack import CTTable
    from cilium_tpu_torch.monitor.ring import (EventRing, serve_step,
                                               serve_step_packed)

    s = copy.copy(state)
    s.ct = CTTable.create(CT_CAPACITY, "cuda")
    s.metrics = state.metrics.clone()
    ring = EventRing.create(RING_CAPACITY, "cuda")
    s, ring = serve_step_packed(s, ring, u32.from_numpy(packed, "cuda"), 1,
                                0, 0, 0)
    serve_step(s, ring, u32.from_numpy(wide, "cuda"), 1, 1)
    torch.cuda.synchronize()


def phase_slice(torch, rng, world, kernels, report):
    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import pack_rows
    from cilium_tpu_torch.datapath.loader import TorchLoader
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts
    from cilium_tpu_torch.monitor.ring import EventRing, ring_drain
    from cilium_tpu_torch.testing import fixtures as fx

    proxy_np = np.array([10000], np.uint32)
    pool = fx.steady_flow_pool(world, N, rng)
    packed_batches = []
    for b in range(8):
        hdr = pool if b == 0 else fx.steady_traffic(pool, N, rng)
        if b == 5:
            hdr = fx.bench_traffic(world, N, rng)
        packed_batches.append(pack_rows(hdr))
    clock = [1000 + b for b in range(6)] + [1000 + 70, 1000 + 71]
    wpool = fx.wide_flow_pool(world, 1 << 16, rng)
    wide_batches = [fx.wide_traffic(wpool, N, rng) for _ in range(2)]
    step_batch = fx.bench_traffic(world, N, rng)

    eps = {0: 0}
    kl = TorchLoader(ct_capacity=CT_CAPACITY, device="cuda")
    kl.attach(world.policies, world.ipcache, eps, world.row_map)
    warm_up(torch, kl.state, packed_batches[0], wide_batches[0])
    ring = EventRing.create(SLICE_RING_CAPACITY, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.monotonic()
    for b, packed in enumerate(packed_batches):
        ring, _ = kl.serve_packed(ring, packed, clock[b], b, 0, 0,
                                  proxy_ports=proxy_np)
    torch.cuda.synchronize()
    t_packed = time.monotonic() - t0
    for b, hdr in enumerate(wide_batches):
        ring, _ = kl.serve(ring, hdr, 1072 + b, 8 + b, proxy_ports=proxy_np)
    out_step, _ = kl.step(step_batch, 1075)
    torch.cuda.synchronize()
    t_all = time.monotonic() - t0
    launches = {k: v.launches for k, v in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    n_all = N * (len(packed_batches) + len(wide_batches) + 1)
    print(f"slice: 10k identities, {len(world.pod_ips6)} v6 pods, CT "
          f"{CT_CAPACITY}, batches of {N}")
    print(f"slice verdicts/s: packed {len(packed_batches) * N / t_packed:.0f}"
          f" (8 serve_packed from host arrays, warmed), all "
          f"{n_all / t_all:.0f} "
          f"({n_all} packets in {t_all:.3f} s)")
    print(f"slice launches: {json.dumps(launches)}")
    print(f"slice max_memory_allocated: {peak} bytes")
    report["slice"] = {"packed_verdicts_per_s": len(packed_batches) * N
                       / t_packed, "verdicts_per_s": n_all / t_all,
                       "seconds": t_all, "packets": n_all,
                       "max_memory_allocated": peak, "launches": launches}

    # the same sequence through the plain versions on the card
    pl = TorchLoader(ct_capacity=CT_CAPACITY, device="cuda")
    pl.attach(world.policies, world.ipcache, eps, world.row_map)
    pring = EventRing.create(SLICE_RING_CAPACITY, "cuda")
    pp = u32.from_numpy(proxy_np, "cuda")
    for b, packed in enumerate(packed_batches):
        plain_serve(pl.state, pring, u32.from_numpy(packed, "cuda"),
                    clock[b], b, 0, 0, proxy_ports=pp)
    for b, hdr in enumerate(wide_batches):
        plain_serve(pl.state, pring, u32.from_numpy(hdr, "cuda"), 1072 + b,
                    8 + b, proxy_ports=pp)
    out_plain = plain_serve(pl.state, None,
                            u32.from_numpy(step_batch, "cuda"), 1075, 0)
    got, want = ring_drain(ring, proxy_np), ring_drain(pring, proxy_np)
    check(np.array_equal(got[0], want[0]) and got[1:] == want[1:],
          "slice: ring rows differ from the plain path")
    check(np.array_equal(out_step, u32.to_numpy(out_plain)),
          "slice: step out rows differ from the plain path")
    max_abs_err(kl.state.metrics, pl.state.metrics, "slice metrics")
    max_abs_err(kl.state.ct.table, pl.state.ct.table, "slice CT table")
    max_abs_err(kl.state.ct.fp, pl.state.ct.fp, "slice CT fp")
    max_abs_err(kl.state.ct.dropped, pl.state.ct.dropped, "slice dropped")
    m = kl.metrics()
    live = int((kl.state.ct.table[:, 10] != 0).sum())
    check(got[1] > 0 and m.sum() == n_all, "slice: no events or counts")
    check(np.isin(out_step[:, 0], [0, 1, 2, 3]).all()
          and np.isin(out_step[:, 5], [0, 1, 2]).all(),
          "slice: step verdict/event codes out of range")
    print(f"slice equals the plain path: {got[1]} events ({got[2]} "
          f"overwritten), metrics {m.sum(axis=0).tolist()} by direction, "
          f"{live} CT entries, dropped {int(kl.state.ct.dropped)}")
    report["slice"].update(events=got[1], ct_live=live,
                           metrics=m.tolist())
    for name in ("datapath_packed", "datapath_wide", "ct_update",
                 "ring_append"):
        kernels[name]["launches"] = launches[name]
        check(launches[name] > 0, f"slice: {name} never launched")
    for name in ("lpm_lookup", "ct_lookup"):
        kernels[name]["launches"] = launches[name]
    return kl, packed_batches, wide_batches[-1], clock[-1]


def phase_verdict_and_timing(torch, rng, kl, packed_np, wide_np, now,
                             kernels):
    """The verdict kernel against its plain version on the slice's
    state (packed; wide with every channel and audit), then the main
    path's kernels timed at its shapes."""
    import copy

    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import unpack_hdr
    from cilium_tpu_torch.datapath import conntrack as ct
    from cilium_tpu_torch.datapath.verdict import (verdict_stage,
                                                   verdict_stage_plain)
    from cilium_tpu_torch.monitor import ring as rg

    def fork(state):
        s = copy.copy(state)
        s.metrics = state.metrics.clone()
        return s

    packed = u32.from_numpy(packed_np, "cuda")
    wide = wide_np.copy()
    wide[:64, 14] = rng.choice(np.array([5, 5000, 0xFFFFFFFF], np.uint32),
                               64)  # forged / unregistered endpoints
    wide[64:96, 15] = 2
    wide = u32.from_numpy(wide, "cuda")
    ch = dict(valid=torch.from_numpy(rng.random(N) < 0.9).cuda(),
              pre_drop=torch.from_numpy(rng.random(N) < 0.05).cuda(),
              pre_drop_reason=u32.from_numpy(
                  np.where(rng.random(N) < 0.05, 6, 0), "cuda"),
              lb_drop=torch.from_numpy(rng.random(N) < 0.02).cuda())
    cases = {"datapath_packed": (packed, dict(ep=0, dirn=0), {}),
             "datapath_wide": (wide, {}, dict(ch, audit=True))}
    ctins = {}
    for name, (rows, scal, opts) in cases.items():
        sk, sp = fork(kl.state), fork(kl.state)
        out_k, cin_k = verdict_stage(sk, rows, now, **scal, **opts)
        hdr = unpack_hdr(rows, **scal) if scal else rows
        out_p, cin_p = verdict_stage_plain(sp, hdr, now, **opts)
        err = max_abs_err(out_k, out_p, f"{name} out")
        for f in ("l4", "fwd", "result", "slot", "is_reply", "do_create",
                  "proxy_port"):
            err = max(err, max_abs_err(getattr(cin_k, f), getattr(cin_p, f),
                                       f"{name} {f}"))
        err = max(err, max_abs_err(sk.metrics, sp.metrics,
                                   f"{name} metrics"))
        kernels[name]["max_abs_err"] = err
        ctins[name] = (out_k, cin_k)
        hits = int((out_k[:, 2] != 0).sum())
        n_v6 = int((hdr[:, 13] != 4).sum())
        row_b = 16 if scal else 64
        # rows in, out rows written, two fingerprint windows and eight
        # table gathers a packet, the candidate row of each CT hit, the
        # v6 TCAM once, the optional channels.  The ct_update hand-off
        # (fwd key, l4, result, slot, flags, proxy: 66 B a packet) is
        # left out: it exists only because the port splits the step
        # that XLA ran as one program
        kernels[name]["bytes"] = (
            N * (row_b + 24 + 2 * 64 + 8 * 4)
            + hits * 68 + kl.state.ipcache.v6_net.numel() * 9
            + (0 if scal else N * 7))
        kernels[name]["ops"] = (N * (2 * (10 * 4 + 12 + 16 * 3) + 120)
                                + n_v6 * kl.state.ipcache.v6_net.shape[0]
                                * 14)
        print(f"parity {name}: {N} rows ({n_v6} v6, {hits} CT hits"
              f"{', every channel + audit' if opts else ''}), bit-exact")
        s_t = fork(kl.state)  # only its metrics change, by atomic adds
        kernels[name]["ms"] = device_ms(
            lambda: verdict_stage(s_t, rows, now, **scal, **opts), 20)
        kernels[name]["plain_ms"] = device_ms(
            lambda: verdict_stage_plain(
                s_t, unpack_hdr(rows, **scal) if scal else rows, now,
                **opts), 3)

    # ct_update and ring_append at the packed batch's shapes
    out_k, c = ctins["datapath_packed"]
    base = kl.state.ct

    def fresh_ct():
        return ct.CTTable(base.table.clone(), base.fp.clone(),
                          base.dropped.clone(), torch.full_like(base.claim,
                                                                -1))

    args = (c.l4, c.fwd, c.result, c.slot, c.is_reply, c.do_create,
            c.proxy_port, now)
    kernels["ct_update"]["ms"] = device_ms(
        lambda w: ct.ct_update(w, *args), 20, fresh_ct)
    kernels["ct_update"]["plain_ms"] = device_ms(
        lambda w: ct.ct_update_plain(w, *args), 3, fresh_ct)
    work = fresh_ct()
    ct.ct_update_plain(work, *args)
    # what ct_update must move: per row the words that decide its fate
    # (result, do_create; no valid mask here), per hit its slot, reply
    # flag and l4 words, and the 32 B sectors holding state, expiry and
    # the four counters (words 10-15) of each refreshed slot, read and
    # written; per pending insert its key, proto, length and proxy port
    # and its fingerprint window; per new entry its row and fingerprint
    hit = c.result != 0
    hs = torch.unique(c.slot[hit]).to(torch.int64)
    sectors = torch.unique(torch.cat([(hs * 68 + 40) // 32,
                                      (hs * 68 + 63) // 32])).numel()
    inserted = int(((work.table[:, 10] != 0)
                    & (base.table[:, 10] == 0)).sum())
    pend = int((c.do_create & ~hit).sum())
    kernels["ct_update"]["bytes"] = (
        N * (4 + 1) + int(hit.sum()) * (4 + 1 + 12) + sectors * 32 * 2
        + pend * (40 + 8 + 4 + 64) + inserted * (68 + 4) + 4)
    kernels["ct_update"]["ops"] = N * 40 + pend * (10 * 4 + 20 * 30)
    ports = u32.from_numpy(np.array([10000], np.uint32), "cuda")
    kernels["ring_append"]["ms"] = device_ms(
        lambda r: rg.ring_append(r, out_k, 7, 1024, None, ports), 20,
        lambda: rg.EventRing.create(RING_CAPACITY, "cuda"))
    kernels["ring_append"]["plain_ms"] = device_ms(
        lambda r: rg.ring_append_plain(r, out_k, 7, 1024, None, ports), 3,
        lambda: rg.EventRing.create(RING_CAPACITY, "cuda"))
    kept = int(((out_k[:, 5] != 0)
                | (torch.arange(N, device="cuda") % 1024 == 0)).sum())
    kernels["ring_append"]["bytes"] = N * 24 + kept * 8 + 16
    kernels["ring_append"]["ops"] = N * 30


def phase_breakdown(torch, kl, packed_batches, now, report):
    """Where a serve_packed batch spends its time: the host-to-device
    staging alone on the host clock (``u32.from_numpy``, then the
    loader's one copy from pageable and from pinned memory), steady
    batches from pageable arrays and from pinned arena slots, then a
    profiled window of steady batches (device kernel time over the
    window's wall time)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from cilium_tpu_torch import u32
    from cilium_tpu_torch.monitor.ring import EventRing
    from cilium_tpu_torch.serving.batcher import BucketArena

    arena = BucketArena(len(packed_batches) + 1, pin=True)
    pinned = []
    for packed in packed_batches:
        slot = arena.slot(packed.shape[0], packed.shape[1])
        slot[:] = packed
        pinned.append(slot)

    def staging_ms(stage, arrays):
        times = []
        for a in arrays:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            stage(a)
            torch.cuda.synchronize()
            times.append((time.monotonic() - t0) * 1e3)
        return statistics.median(times)

    staging = staging_ms(lambda a: u32.from_numpy(a, "cuda"),
                         packed_batches)
    staging_pageable = staging_ms(kl._to_device, packed_batches)
    staging_pinned = staging_ms(kl._to_device, pinned)
    ring = EventRing.create(SLICE_RING_CAPACITY, "cuda")
    proxy = np.array([10000], np.uint32)

    def serve_ms(arrays):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for b, packed in enumerate(arrays):
            kl.serve_packed(ring, packed, now + b, b, 0, 0,
                            proxy_ports=proxy)
        torch.cuda.synchronize()
        return (time.monotonic() - t0) * 1e3 / len(arrays)

    per_batch = serve_ms(packed_batches)
    per_batch_pinned = serve_ms(pinned)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for b, packed in enumerate(pinned):
            kl.serve_packed(ring, packed, now + b, b, 0, 0,
                            proxy_ports=proxy)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    # device-side events only: a CPU op's device time repeats its
    # kernels', and "Activity Buffer Request" is the tracer's own work
    device = {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.key.startswith("Activity Buffer")
                and e.self_device_time_total > 0):
            device[e.key] = e.self_device_time_total
    busy = sum(device.values())
    stages = {"h2d copy": ("Memcpy",), "datapath_kernel": ("void datapath",),
              "ct_update": ("ct_", "Memset"), "ring_append": ("ring_",)}
    n = len(packed_batches)
    per_stage = {st: sum(v for k, v in device.items()
                         if k.startswith(prefixes)) / n / 1e3
                 for st, prefixes in stages.items()}
    print(f"breakdown: serve_packed {per_batch:.3f} ms a batch from "
          f"pageable arrays, {per_batch_pinned:.3f} ms from pinned arena "
          f"slots (host clock, {n} steady batches); staging the packed "
          f"rows alone: u32.from_numpy {staging:.3f} ms, one copy from "
          f"pageable {staging_pageable:.3f} ms, from pinned "
          f"{staging_pinned:.3f} ms")
    if busy:
        print(f"breakdown: profiled window {wall_us / 1e3:.3f} ms, device "
              f"busy {busy / 1e3:.3f} ms ({busy / wall_us:.1%}), idle "
              f"{1 - busy / wall_us:.1%}; device ms a batch: "
              + ", ".join(f"{k} {v:.4f}" for k, v in per_stage.items()))
    else:
        print("breakdown: the profiler recorded no device time")
    report["breakdown"] = {
        "serve_packed_ms_per_batch": per_batch,
        "serve_packed_pinned_ms_per_batch": per_batch_pinned,
        "staging_ms": staging,
        "staging_pageable_ms": staging_pageable,
        "staging_pinned_ms": staging_pinned,
        "profiled_wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_ms_per_batch_by_stage": per_stage,
        "device_time_ms_by_name": {k: v / 1e3 for k, v in device.items()}}


def main() -> int:
    if not (ROOT / "cilium_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout (cilium_tpu_torch/ is "
              "missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    report = {}
    try:
        # -- 1. device ----------------------------------------------------
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        kind = torch.cuda.get_device_name(0)
        print(f"device: {kind}, count {torch.cuda.device_count()}, torch "
              f"{torch.__version__}, cuda {torch.version.cuda}")
        report["device"] = {"nvidia_smi": smi, "kind": kind}

        # -- 2. build -----------------------------------------------------
        from cilium_tpu_torch.kernels import KERNELS
        from cilium_tpu_torch.kernels import build as kbuild

        t0 = time.monotonic()
        for name, s in kbuild.build().items():
            print(f"build {name}.cu: {s:.1f} s")
        report["build_s"] = time.monotonic() - t0
        print(f"build: {report['build_s']:.1f} s")
        report["ptxas"] = {
            n: (kbuild.BUILD_DIR / f"{n}.log").read_text()
            for n in kbuild.SOURCES
            if (kbuild.BUILD_DIR / f"{n}.log").exists()}

        kernels = {
            name: {"name": name, "route": "cuda",
                   "source": f"cilium_tpu_torch/csrc/{k.source}.cu",
                   "replaces": k.replaces, "launches": 0,
                   "library_ms": None}
            for name, k in KERNELS.items()}

        # -- 3. kernel parity at full size --------------------------------
        from cilium_tpu_torch.testing.fixtures import build_world

        rng = np.random.default_rng(20261017)
        t0 = time.monotonic()
        world = build_world(10_000, 64, ct_capacity=1 << 4, n_v6=256,
                            device="cpu")
        print(f"world: 10k identities, 64 rules, 256 v6 pods, built in "
              f"{time.monotonic() - t0:.1f} s")
        phase_lpm(torch, rng, world, kernels)
        phase_ct(torch, rng, kernels)
        phase_ring(torch, rng, kernels)
        phase_maint(torch, rng, kernels)
        phase_gather(torch, rng, kernels)
        l7_launches = phase_l7(torch, rng, kernels, report)

        # -- 4. the slice at full size ------------------------------------
        kl, packed_all, wide_np, now = phase_slice(torch, rng, world,
                                                   kernels, report)
        by_path = {"slice": report["slice"]["launches"], "l7": l7_launches}

        # -- 5. timings (and the verdict kernel's parity) ------------------
        phase_verdict_and_timing(torch, rng, kl, packed_all[-1], wide_np,
                                 now, kernels)
        phase_breakdown(torch, kl, packed_all[1:5], now, report)
        del kl

        # -- 6. the superbatch ----------------------------------------------
        phase_superbatch(torch, rng, world, report)

        # -- 7. the daemon at full width -------------------------------------
        by_path["daemon"], rung = phase_daemon(torch, rng, world, report)
        time_gather(torch, rng, kernels, rung)

        # -- 8. the redirect overhead ---------------------------------------
        by_path["l7_redirect"] = phase_l7_redirect(torch, report)

        # -- 9. the FQDN flip -------------------------------------------------
        by_path["fqdn"] = phase_fqdn(torch, world, report)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    on_path, launchers = [], []
    for name, k in kernels.items():
        k["bound_ms"], k["bound_by"] = bound(k.pop("bytes"), k.pop("ops"))
        # launches: the daemon path's count where the kernel runs there,
        # else the slice path's (each path's counts zeroed before it ran)
        k["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
        k["launches"] = by_path["daemon"][name] or by_path["slice"][name]
        lib = ("" if k["library_ms"] is None
               else f", library {k['library_ms']:.4f} ms")
        print(f"kernel {name}: {k['launches']} launches on the main path "
              f"({k['launches_by_path']}), {k['ms']:.4f} ms (plain "
              f"{k['plain_ms']:.3f} ms{lib}, bound {k['bound_ms']:.4f} ms "
              f"by {k['bound_by']}), max abs err {k['max_abs_err']}")
        (on_path if k["launches"] else launchers).append(k)
    report["kernels"] = on_path
    report["standalone_launchers"] = launchers
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(smi)
    print(json.dumps({"kernels": on_path}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
