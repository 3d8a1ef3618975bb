#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's serving step, serving daemon, L7 proxy
plane, live table churn, offline egress path, service load balancer,
anomaly scorer, its trainer, sharded serving, the policy control plane
(the connectivity test, the delta attach, mutual authentication) and
the Hubble flow plane over a pcap replay, and the scenario engine with
the flow analytics on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel of ``cilium_tpu_torch/csrc`` from the checkout's
   sources, one ``nvcc`` per source, all at once;
3. kernel parity at full size: each kernel against its plain PyTorch
   version on the same CUDA tensors, bit-exact (every output is an
   integer): LPM over 2^18 v4+v6 addresses, a CT lookup and a
   ct_update on a 2^20 table filled to about half (duplicate tuples,
   window contention, counters near 2^32), ring_append with overflow
   (one kernel a call: ``testing.capture.ops_a_call``),
   the CT aging sweep and occupancy count on a half-full 2^20 table
   whose expiries straddle 2^31 and ``now`` (each one kernel a call, no
   memset), ring_gather on lapped
   and unlapped 2^18 rings at several rungs, the in-place table
   update ``dus`` at config #3's table shapes (a verdict row, an auth
   column, l1/l2/l3 payloads, starts the start rule moves; timed at
   three of them beside a slice ``copy_``), and the
   L7 verdict at
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
   channel and audit, and packed with audit, against its plain version
   on that state;
5. timings: each kernel's device time at the main path's shapes (calls
   run back to back behind a spin kernel, so no host enqueue falls in
   the window) beside its plain version's and its bound (K5 also at
   the daemon's 2^16 rows); then where a
   steady ``serve_packed`` batch spends its time (torch.profiler), and
   what staging a batch costs from pinned memory; then K1/K1s and
   K4/K4s at each main path's shape (the trainer's 4096 wide rows, the
   redirect phase's 1024 new flows, the daemon's 2^16 bucket, the
   slice's 2^18 batch, a 2^16 and a 2^18
   bucket routed to 8 shards; a SYN and a steady batch): one kernel a
   call each, K4 against its plain version, the insert rounds K4 ran
   (its pending counts, equal to the plain version's), and their times;
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
   map-pressure controllers must have run; the flow analytics (on by
   default) must have aggregated events with an exact batch ledger;
   K9's rows a launch (its row
   counter over its launches), and K9 timed at that shape against the
   daemon's rule table; the steady traffic with the flow analytics on
   and off in turns (on, off, off, on: verdicts/s, the event-join
   worker's share, ``FlowAnalytics.drain``'s share and median ms on
   that worker, the batches the duty governor dropped); K7 and K8 on
   the daemon's own CT and K6 at the
   rung its windows used (one kernel a call each; K6 beside one
   ``torch.index_select`` of the same rows);
8. the redirect overhead (``bench.py`` ``bench_l7_redirect``'s shape):
   two daemons on the card, an L4 allow on port 80 and the same port
   with an HTTP GET rule, fresh-sport SYN batches of 1024, six a leg,
   legs paired three times in alternating order; each leg ends with a
   drain tick, so the redirect leg waits only on windows already handed
   to the event plane, whose queue holds a whole leg
   (``scripts/chip_redirect_repeat.py`` runs this phase N times);
9. the FQDN flip: the config #3 world plus a DNS L7 rule and
   ``toFQDNs`` egress (``tests/test_l7plane.py`` ``RULES_DNS``), served
   through ``submit``: probes to an unresolved IP drop, a DNS batch is
   allowed by the L7 workers, the resolver's answer mints an FQDN
   identity (in-place table patches, timed from the DNS batch to the
   flip; no attach, no regeneration), and the next probes are allowed;
10. identity and ipcache churn: config #3's daemon serves phase 7's
   traffic (a warm-up, then base / churn / churn / base sessions)
   while a churn thread runs ``IdentityChurnScenario`` at 200 ops/s
   through the patch paths: SYNs from the churn slots, a 64th of the
   rows, never see a slot's old and new verdicts in one batch and,
   without churn, see its published one; the ledgers stay exact, no
   attach and no regeneration happen, and afterwards the patched
   tables equal a full attach of the same world;
11. the offline egress path: config #3's world with masquerade to a
   node IP (the default 2^14-port pool, non-masquerade 10.0.0.0/8), 128
   client pods, an egress-gateway policy on one namespace and egress
   limits on the other's 64 pods, driven through
   ``Daemon.process_batch`` (SNAT K11 -> bandwidth K13 -> K1/K4 ->
   reverse NAT K12) in 8 batches of 2^16 rows 60 s apart: fresh TCP and
   UDP flows to the world, repeats of live flows, replies to the
   allocated node and gateway ports, cluster-internal rows.  Every
   reply translates back to its pod tuple, no two flows share a node
   port, the pool's failures equal the NAT_EXHAUSTED rows, each limited
   pod's bucket ledger holds, UDP mappings expire; then a short
   exhaustion leg at ``NatExhaustionScenario``'s shape; K13, one kernel
   a call, equals its plain version on the path's own inputs and is
   timed there.  Phase 3 holds K11-K14 against their plain versions at
   these shapes (collision windows, duplicates, a pool run dry, a clock
   crossing 2^32; K14 with and without its CT probe, also on reverse
   entries behind more than N_CAND of their fingerprint, windows that
   wrap the CT's end, a clock within 150 of 2^32, no and four
   non-masquerade networks, rows off a 16-byte boundary, n = 0 and 1),
   and times K14 both ways;
12. the service path: phase 11's daemon with 4096 ClusterIP services (2
   backends each among the world's pods, Maglev tables of 16381 slots,
   256 dual-stack over its v6 pods, a 16th with ClientIP affinity, 16
   with no backend) installed through ``ServiceWatcher``, and a pod
   whose policy denies all but port 9, driven through
   ``Daemon.process_batch`` (socket-LB K17 and the v6 pass K16 ahead of
   phase 11's stages): a warm-up, 8 batches of 2^16 rows 10 s apart
   (4096 new flows each, the rest repeats), a backend leaving every
   other service after the fourth, then a burst of 12288 new flows.
   Every service row lands on a backend of its own service, cached
   flows keep theirs across the change, new ones follow the new Maglev
   tables, pins to the backend that left are pruned, NO_SERVICE drops
   equal the rows to frontends with no backend (the denied pod's too),
   the burst caches nothing, and K17, K16 and K13 equal their plain
   versions on the main path's own inputs (K16 and K13 one kernel a
   call, timed there).  Phase 3 holds K15-K17 against their plain
   versions at full width (2^16 rows, 4096 frontends; K17 over a
   threaded sequence on 2^16 and 2^20 caches: connect batches, a
   steady batch, a burst, a forced fingerprint overflow, a backend
   change, affinity expiry, clocks across 2^32);
13. the anomaly scorer: (a) ``fit_novelty_from_world`` on the card over
   config #3's tables and ``save_model`` to ``chiprun_out/``; (b)
   ``score_capture`` over 2^18 rows of ``synth_labeled_traffic``, 4096
   a batch, against the same replay through the plain versions on a
   copy of the state: out rows, CT table and metrics bit-exact, scores
   within tolerance (the AUC is printed as information: the supervised
   half is untrained); (c) config #3's daemon armed with that checkpoint
   (``DaemonConfig.anomaly_model_path``) serving 2^20 packets, one in 16
   from ``PortScanScenario``, through ``submit``: the ledger exact, no
   event lost, ``lost["anomaly"]`` 0, every published event scored, and
   a captured batch scored the same by the plain versions; (d) steady
   sessions without and with the scorer in turns: the scoring tax, the
   scorer's ms a window and its share of the event-join worker.
   Phase 3 holds K18 ``flow_features`` and K19 ``anomaly_score`` against
   their plain versions at full width (2^18 rows served through K1/K4,
   V = 16384, D = 32, H = 64, the novelty fitted, id_row past V) and at
   the trainer's 4096 rows, times and bounds both at both sizes, holds
   K18 to one kernel a call and prints K19's identical shares;
14. the trainer: (a) ``train`` at config #3 from label-initialised
   params at the reference's defaults (200 steps of 4096, lr 3e-3): the
   loss falls below 0.6x its first value, nothing non-finite, the first
   8 steps equal an earlier run's to the bit and a replay through the
   plain versions within tolerance, the held-out AUC above 0.9, steps/s,
   the host stages of a step and a profiled window's device share;
   (b) ``evaluate_real_dataset`` on ``tests/data/golden_cic.{pcap,csv}``
   at the reference test's arguments (AUC above 0.85); (c)
   ``train_and_evaluate`` at its defaults (1024 identities, 150 steps
   of 4096, exfil held out), the checkpoint saved to ``chiprun_out/``,
   reloaded and re-scored through K19; (d) ``train(mesh=make_mesh(8))``,
   the data-parallel step (K20s/K21s), from (a)'s params, start state
   and seed: the same loss and AUC bounds, its first 8 losses within
   tolerance of (a)'s, steps/s and a profiled window's device share.
   Phase 3 holds K20 ``anomaly_train_fwd``, K21 ``anomaly_train_bwd``
   and K22 ``adam_update`` against their plain versions at B = 4096, V =
   16384 (one identity on half the rows, id_row past V and negative;
   adam from a mid-training state and from a count of INT_MAX - 1,
   which saturates, one kernel a call; K21's d_embed bit-exact with
   ``embed_grad_sorted_plain``, its sort against a stable sort, its
   kernels a call counted and split by pass), and K20s/K21s over 8
   shards of that batch against their plain versions and against 8
   unsharded launches on the blocks and their mean;
15. sharded serving over 8 shards on the card: (a) the sharded verdict,
   CT-update and ring-append kernels (K1s/K4s/K5s: one launch sequence
   for all shards) against the plain per-shard loop on the card, packed
   and wide, at 2^19 routed rows (8 blocks of 2^16 from a 2^18 bucket)
   on a half-full 2^20 CT, one batch skewed so that one shard overflows
   on the host: out rows, CT, metrics, ring and cursors bit-exact, and
   one sharded sequence equal to 8 unsharded K1/K4/K5 calls on the
   shards' slices; K1s with audit on, packed and wide; then each timed
   beside its plain version and bound, K5s one kernel a call;
   (b) phase 7's daemon with ``start_serving(mesh=8)`` serving 2^21
   packets of phase 7's traffic, then 2^16 wide rows: ledgers exact, no
   event lost, the route overflow equal to its metric and to its DROP
   events, the metrics equal to the fixed-batch run, the host stages
   and the card's idle share, then K6 over 8 shards at the rung its
   windows used; (c) the sharded demotion under injected
   faults: the replies of flows established sharded forward after it;
16. the connectivity test (BASELINE.md config #1, a 2-pod world by
   nature): ``testing.connectivity.run_connectivity_tests`` on a daemon
   on the card, pods through the Pod watcher, each scenario's policy a
   CNP: every probe of the 8 scenarios ok, the re-attaches delta
   attaches, the mutual-auth probe dropped AUTH_REQUIRED and then
   forwarded; K1, K4, K5, K9 and K10 launches and the wall time;
17. the delta attach at config #3 (phase 7's world plus a ``web``
   endpoint: 2 policies) beside a daemon built with
   ``policy_delta_compile=False``: an edit of db's rules while the
   delta daemon serves phase 7's traffic (one delta attach, one policy
   repainted, ledgers exact), then an edit that moves a port boundary;
   after each the five policy tables equal the full daemon's bit for
   bit; host ms of the delta against the full attach; K10 at a whole
   policy's slice against its plain version, timed (profiler and
   events) beside ``Tensor.copy_`` with its bound;
18. mutual authentication at config #3 (``auth_ttl`` 20 s): 2^16 SYNs
   from 2048 live identities through ``process_batch`` to an
   auth-required port of db all drop AUTH_REQUIRED, each pair is
   granted once (one K10 launch a grant), the retry forwards every row;
   past the TTL and ``auth_gc``, fresh SYNs drop again while the
   established flows forward; the auth table equals a full attach's
   projection bit for bit; K10 at an auth cell timed beside ``copy_``;
19. BASELINE.md config #2, the three-four parser over a 1k-flow pcap
   replay with flow export: (a) 1024 TCP flows between config #3's
   world pods and db (768 allowed, 192 that policy drops, 64 to the L7
   port; 64 from IPv6 pods), 8 packets each, written by ``write_pcap``
   and read back by ``read_pcap``, whose native parse must equal the
   Python parse bit for bit (and on the golden CIC capture); (b) a
   config #3 daemon with Hubble on (the default) and ``export_path``
   replays it through ``submit`` in rounds (packet k of every flow,
   then k + 1), then the golden capture through ``submit`` and through
   ``process_batch``: every published event is one Observer flow and
   one exported line whose verdict, reason, addresses, ports, reply
   flag and proxy port equal its event row's (as a multiset), every
   flow survives ``encode_flow``/``decode_flow``, the ledgers are exact;
   (c) the replay again under ``monitor_aggregation="medium"``, through
   ``submit`` and ``process_batch``: the monitor publishes exactly the
   rows a numpy copy of the filter keeps; (d) a daemon with
   ``policy_audit_mode`` replays it: every event's verdict and reason
   equal the plain versions' over the same rounds, each policy-dropped
   flow forwards on its first packet with its reason, the metrics are
   equal; (e) wall time from the first submit to the last exported
   line, flows exported/s, ``Observer.get_flows(number=1000)`` ms, phase
   7's traffic with Hubble on and off in turns (verdicts/s, the
   event-join worker's share by ``StageClock``), and the native and the
   Python parse in packets/s over a 2^21-packet capture;
20. the scenario engine (``bench.py`` ``bench_scenarios``'s drive): the
   seven registered scenarios at seed 31 and their own sizes, each on a
   fresh ``scenario_daemon(sc, map_pressure_interval=0.25)`` through
   ``run_scenario`` (six on the serving leg, ``nat_exhaustion`` on the
   offline one), and ``elephant_mice`` again with ``trace_sample=1``:
   every criterion holds, the front-end, L7 and flow-analytics ledgers
   are exact, and the rank-0 elephant is among ``flows_aggregate(top=8)``
   's top talkers; one line a run (its metrics, the analytics stats and
   the drop-spike incidents) and the phase's wall.

Phases 7, 14 (a) and 15 (b) print K1's and K4's rows a launch.  The
kernel launch counts are read per path (the slice of phase 4, the
daemon of phase 7, the L7 paths of phases 3, 8 and 9, the churn of
phase 10, the egress path of phase 11, the service path of phase 12,
the armed daemon's first session in phase 13, the 200-step ``train``
runs of phase 14 (a) and (d), the sharded daemon's two sessions of
phase 15, the connectivity run of phase 16, the edited session and
the second edit of phase 17, the grant pass and its retry of phase
18, the replays of phase 19 (b), the scenario runs of phase 20), each
zeroed just before its path runs.  The line before the last is one JSON object describing every
kernel (the standalone launchers with 0 launches and ``"standalone":
true``); the last line is the device record.  Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import ipaddress
import json
import statistics
import subprocess
import sys
import threading
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
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor cores, published
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores, published


class SmokeFailure(Exception):
    pass


class ProfilerShort(SmokeFailure):
    """torch.profiler came back short from a window twice."""


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


def audited_rows(out) -> int:
    """Rows of a verdict stage's ``out`` (a tensor or a numpy array) that
    audit mode forwarded with a policy drop's reason."""
    from cilium_tpu_torch.datapath.verdict import (
        OUT_REASON, OUT_VERDICT, REASON_POLICY_DEFAULT_DENY,
        REASON_POLICY_DENY)
    from cilium_tpu_torch.policy.mapstate import VERDICT_ALLOW

    reason = out[:, OUT_REASON]
    return int(((out[:, OUT_VERDICT] == VERDICT_ALLOW)
                & ((reason == REASON_POLICY_DENY)
                   | (reason == REASON_POLICY_DEFAULT_DENY))).sum())


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


def bound(bytes_moved, int_ops, flop_ms=0.0):
    """Least time the card could take: bytes over HBM rate or the
    operations (integer operations over the INT32 rate, plus
    ``flop_ms`` of float operations at their type's peak), whichever is
    larger."""
    tb = bytes_moved / HBM_BYTES_PER_S * 1e3
    to = int_ops / INT32_OPS_PER_S * 1e3 + flop_ms
    return (tb, "bytes") if tb >= to else (to, "operations")


ROW_COUNTED = ("datapath_packed", "datapath_wide", "ct_update",
               "datapath_packed_sharded", "datapath_wide_sharded",
               "ct_update_sharded")


def rows_a_launch(label, report_part):
    """K1's and K4's rows a launch on the path just run (their launchers
    count rows; the counts were zeroed before the path), printed and
    kept in ``report_part``."""
    from cilium_tpu_torch.kernels import KERNELS

    got = {n: KERNELS[n].rows / KERNELS[n].launches for n in ROW_COUNTED
           if KERNELS[n].launches}
    print(f"{label}: rows a launch: "
          + ", ".join(f"{n} {v:.0f}" for n, v in got.items()))
    report_part["rows_a_launch"] = got
    return got


def claim_steps(launcher, tail_at, *args):
    """The claim steps one call of K11's or K17's ``launcher`` ran on
    ``args`` (its ``scratch`` counts, whose word ``tail_at`` is 1 + the
    step from which one block finished): (steps with a row pending, that
    step or None, the counts)."""
    sc = {}
    launcher(*args, scratch=sc)
    counts = sc["counts"].cpu().tolist()
    steps = sum(1 for c in counts[:8] if c)
    tail = counts[tail_at]
    return steps, (tail - 1 if tail else None), counts


def one_kernel_a_call(prepare, kernel, what):
    """Check that one call of ``prepare()`` puts one kernel, named
    ``kernel``, on the stream (``testing.capture.ops_a_call``); -> its
    mangled name."""
    from cilium_tpu_torch.testing.capture import ops_a_call

    ops = ops_a_call(prepare)
    check(list(ops.values()) == [1] and kernel in next(iter(ops)),
          f"{what}: a call put {ops} on the stream, not one {kernel}")
    return next(iter(ops))


def stage_inputs(d, rows, now):
    """The inputs K13 (``Daemon._bw_police``), K16 (``lb6_stage``) and
    K12 (``TorchLoader.reverse_nat``) take in one ``d.process_batch(rows,
    now)``: ((bandwidth state before, rows, now, rates) or None, (v6 LB
    tensors, rows) or None, (NAT table before, NAT tensors, rows, now)
    or None); the tensors are copies."""
    import cilium_tpu_torch.service as svc
    from cilium_tpu_torch.datapath.bandwidth import BandwidthState
    from cilium_tpu_torch.service.nat import NATTable

    got13, got16, got12 = [], [], []
    police, lb6, rev = d._bw_police, svc.lb6_stage, d.loader.reverse_nat

    def spy13(hdr, now):
        got13.append((BandwidthState(d._bw.tokens.clone(),
                                     d._bw.last.clone()),
                      hdr.clone(), now, d._bw_rates))
        return police(hdr, now)

    def spy16(t, hdr):
        got16.append((t, hdr.clone()))
        return lb6(t, hdr)

    def spy12(t, hdr, now):
        tbl = d.loader._nat_table()
        got12.append((NATTable(tbl.table.clone(), tbl.failed.clone()), t,
                      d.loader._to_device(hdr).clone(), now))
        return rev(t, hdr, now)

    d._bw_police, svc.lb6_stage, d.loader.reverse_nat = spy13, spy16, spy12
    try:
        d.process_batch(rows, now=now)
    finally:
        d._bw_police, svc.lb6_stage, d.loader.reverse_nat = police, lb6, rev
    return tuple(g[0] if g else None for g in (got13, got16, got12))


def k12_on(label, tbl, t, hdr, now):
    """K12 on a path's own inputs (``stage_inputs``), each call on a copy
    of the pool: bit-exact with its plain version (rows, table), one
    kernel a call, the claim words free after the call; -> {ms, rows,
    hits}."""
    import functools

    from cilium_tpu_torch.service import nat

    def fresh():
        return nat.NATTable(tbl.table.clone(), tbl.failed.clone())

    tabs = [fresh(), fresh()]
    got = nat.snat_reverse(tabs[0], t, hdr, now)
    want = nat.snat_reverse_plain(tabs[1], t, hdr, now)
    for g, w, what in ((got[0], want[0], "rows"),
                       (tabs[0].table, tabs[1].table, "table")):
        max_abs_err(g, w, f"{label}: snat_reverse {what} on the main "
                    f"path's inputs")
    check(bool((tabs[0].claim == nat.CLAIM_FREE).all()),
          f"{label}: snat_reverse left a claim word set")
    one_kernel_a_call(lambda: functools.partial(
        nat.snat_reverse, fresh(), t, hdr, now), "snat_reverse_kernel",
        f"{label}: snat_reverse")
    ms = device_ms(lambda tb: nat.snat_reverse(tb, t, hdr, now), 20, fresh)
    res = {"ms": ms, "rows": int(hdr.shape[0]),
           "hits": int((got[0] != hdr).any(1).sum())}
    print(f"{label}: K12 on the main path's inputs ({res['rows']} rows, "
          f"{res['hits']} restored): bit-exact with its plain version, one "
          f"kernel, its claim words free after the call, {ms:.4f} ms")
    return res


def k13_on(label, state, hdr, now, rates):
    """K13 on a path's own inputs (``stage_inputs``), each call on a
    copy of the buckets: bit-exact with its plain version (reasons,
    tokens, last), one kernel a call, its two sums zero after the call;
    -> {ms, rows, dropped}."""
    import functools

    import torch
    from cilium_tpu_torch.datapath import bandwidth as bw
    from cilium_tpu_torch.kernels import launch_bw_stage

    def fresh():
        return bw.BandwidthState(state.tokens.clone(), state.last.clone())

    sts, sc = [fresh(), fresh()], {}
    got = launch_bw_stage(sts[0], hdr, now, rates, scratch=sc)
    want = bw.bw_stage_plain(sts[1], hdr, now, rates)
    for g, w, what in ((got, want, "reasons"),
                       (sts[0].tokens, sts[1].tokens, "tokens"),
                       (sts[0].last, sts[1].last, "last")):
        max_abs_err(g, w, f"{label}: bw_stage {what} on the main path's "
                    f"inputs")
    check(bool((sc["sums"] == 0).all()), f"{label}: bw_stage left its "
          f"sums non-zero")
    one_kernel_a_call(lambda: functools.partial(
        bw.bw_stage, fresh(), hdr, now, rates), "bw_stage_kernel",
        f"{label}: bw_stage")
    ms = device_ms(lambda st: bw.bw_stage(st, hdr, now, rates), 20, fresh)
    res = {"ms": ms, "rows": int(hdr.shape[0]),
           "dropped": int((got != 0).sum())}
    print(f"{label}: K13 on the main path's inputs ({res['rows']} rows, "
          f"{res['dropped']} dropped): bit-exact with its plain version, "
          f"one kernel, its sums zero after the call, {ms:.4f} ms")
    return res


def k16_on(label, t, hdr):
    """K16 on a path's own inputs (``stage_inputs``): bit-exact with its
    plain version (rows, both masks), one kernel a call; -> {ms, rows,
    v6_rows}."""
    import functools

    from cilium_tpu_torch.core.packets import COL_FAMILY
    from cilium_tpu_torch.service import lb6_stage, lb6_stage_plain

    for g, w, what in zip(lb6_stage(t, hdr), lb6_stage_plain(t, hdr),
                          ("rows", "have", "no_backend")):
        max_abs_err(g, w, f"{label}: lb6_stage {what} on the main path's "
                    f"inputs")
    one_kernel_a_call(lambda: functools.partial(lb6_stage, t, hdr),
                      "lb6_stage_kernel", f"{label}: lb6_stage")
    ms = device_ms(lambda: lb6_stage(t, hdr), 20)
    res = {"ms": ms, "rows": int(hdr.shape[0]),
           "v6_rows": int((hdr[:, COL_FAMILY] == 6).sum())}
    print(f"{label}: K16 on the main path's inputs ({res['rows']} rows, "
          f"{res['v6_rows']} v6, {t.svc_port.shape[0]} v6 frontends): "
          f"bit-exact with its plain version, one kernel, {ms:.4f} ms")
    return res


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


def lpm_rows(rng, n, v4_pods, v6_pods, v6_frac=0.2, miss_frac=0.3,
             misses=None):
    """[n, 4] u32 address words and [n] families of phase 1's mix: v4
    rows 70% on ``v4_pods`` (u32), the rest random; a ``v6_frac`` share
    v6 rows on ``v6_pods`` ([P, 4] u32 words), of which ``miss_frac``
    are made misses by ``misses(rng, words)`` (default: outside
    2001:db8::/32, so that only ::/0 holds them)."""
    import numpy as np

    words = np.zeros((n, 4), np.uint32)
    fam = np.full(n, 4, np.uint32)
    words[:, 3] = np.where(rng.random(n) < 0.7, rng.choice(v4_pods, n),
                           rng.integers(0, 1 << 32, n, dtype=np.uint64))
    v6 = rng.random(n) < v6_frac
    words[v6] = v6_pods[rng.integers(0, len(v6_pods), int(v6.sum()))]
    miss = v6 & (rng.random(n) < miss_frac)
    if misses is None:
        words[miss, 0] = 0x20020000
    else:
        words[miss] = misses(rng, words[miss])
    fam[v6] = 6
    return words, fam


def big_tcam(world):
    """Config #3's v4 entries with a larger dual-stack TCAM: 16 /48s
    (2001:db8:k::/48), 64 /64s inside them, 4096 /128 pods inside those
    and ::/0: four prefix lengths, 4177 v6 entries.  -> (entries, the
    pods' [4096, 4] words, a miss maker: a third of the misses inside a
    /64 only, a third inside a /48 only, a third outside every prefix
    but ::/0)."""
    import numpy as np

    def words(a):
        return [(a >> s) & 0xFFFFFFFF for s in (96, 64, 32, 0)]

    ent = {c: v for c, v in world.ipcache.items() if ":" not in c}
    base = 0x20010DB8 << 96
    nets48 = [base | (k << 80) for k in range(16)]
    nets64 = [nets48[j % 16] | ((j // 16 + 1) << 64) for j in range(64)]
    pods = [nets64[i % 64] | (i + 1) for i in range(4096)]
    for v, (nets, plen) in enumerate(((nets48, 48), (nets64, 64),
                                      (pods, 128))):
        for i, a in enumerate(nets):
            ent[f"{ipaddress.IPv6Address(a)}/{plen}"] = 1000 * (v + 1) + i
    ent["::/0"] = world.ipcache["::/0"]
    n64 = np.array([words(a) for a in nets64], np.uint32)
    n48 = np.array([words(a) for a in nets48], np.uint32)

    def misses(rng, w):
        w = w.copy()
        pick = rng.integers(0, 3, len(w))
        a = pick == 0  # a /64's, off every pod (pods have word 2 zero)
        w[a] = n64[rng.integers(0, 64, int(a.sum()))]
        w[a, 2] = rng.integers(1, 1 << 32, int(a.sum()), dtype=np.uint64)
        w[a, 3] = rng.integers(0, 1 << 32, int(a.sum()), dtype=np.uint64)
        b = pick == 1  # a /48's, on a /64 no entry has
        w[b] = n48[rng.integers(0, 16, int(b.sum()))]
        w[b, 1] |= 0xFFFF
        w[b, 2:] = rng.integers(0, 1 << 32, (int(b.sum()), 2),
                                dtype=np.uint64)
        w[pick == 2, 0] = 0x20020000
        return w

    return ent, np.array([words(a) for a in pods], np.uint32), misses


def lpm6_probes(t, words, fam) -> int:
    """The index probes that the rows of (``words``, ``fam``) other than
    v4 make in ``lpm_v6`` (``csrc/lpm.cuh``): a group a probe, in the
    index's order, while no shorter group is ruled out (host copies of
    ``t``'s index)."""
    import numpy as np
    from cilium_tpu_torch import u32

    groups = t.v6_groups.cpu().numpy()
    slots = t.v6_index.cpu().numpy()
    w6 = np.ascontiguousarray(u32.to_numpy(words)[u32.to_numpy(fam) != 4])
    best = np.full(len(w6), -1, np.int64)
    probes = 0
    for g, grp in enumerate(groups):
        on = best <= grp[4]
        probes += int(on.sum())
        held = slots[slots[:, 4] == g]
        plen = {s[:4].tobytes(): int(s[6]) for s in held}
        keys = w6[on] & grp[:4].view(np.uint32)
        best[on] = np.maximum(best[on], [plen.get(k.tobytes(), -1)
                                         for k in keys])
    return probes


def lpm_bound(torch, t, w, f):
    """(bytes, ops) of K2 on (``w``, ``f``): each row's 16 B of words, 4
    B of family and 4 B out; a v4 row's levels (4 B each); a v6 row's
    probes, a 32 B index slot each (the index read at most once); per
    row a few compares and selects, per probe its hash and key
    compare."""
    v4 = f == 4
    ip = w[:, 3].to(torch.int64) & 0xFFFFFFFF
    a = t.l1[ip >> 16]
    l2 = v4 & (a < 0)
    l3 = l2 & (t.l2[(-a - 1).clamp(min=0), (ip >> 8) & 0xFF] < 0)
    levels = int(v4.sum()) + int(l2.sum()) + int(l3.sum())
    probes = lpm6_probes(t, w, f)
    return (w.shape[0] * 24 + 4 * levels
            + min(32 * probes, t.v6_index.numel() * 4),
            w.shape[0] * 12 + probes * 24)


def lpm_plain_chunked(t, w, f):
    """``lpm_lookup_plain`` a slice of rows at a time: its [N, K, 4]
    compare at 2^18 x 4177 entries would take ~17 GB."""
    import torch
    from cilium_tpu_torch.datapath.lpm import lpm_lookup_plain

    step = max(1, (1 << 26) // max(1, t.v6_net.shape[0]))
    return torch.cat([lpm_lookup_plain(t, w[i:i + step], f[i:i + step])
                      for i in range(0, w.shape[0], step)])


def phase_lpm(torch, rng, world, kernels):
    """K2 against its plain version on phase 1's inputs (2^18 addresses,
    20% v6, 30% of those off every /128) and on a larger TCAM
    (:func:`big_tcam`, its own generator: the later phases' inputs do
    not move), one kernel a call; its index's host build time at both
    sizes."""
    import functools

    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import ip_to_words
    from cilium_tpu_torch.datapath.lpm import (DeviceLPM, compile_lpm,
                                               lpm_lookup, lpm_lookup_plain)

    t = DeviceLPM.from_tensors(world.lpm, "cuda")
    t0 = time.perf_counter()  # again: the first build set up the card
    DeviceLPM.from_tensors(world.lpm, "cuda")
    build_ms = {world.lpm.v6_net.shape[0]: (time.perf_counter() - t0) * 1e3}
    pods = np.array([ip_to_words(ip)[3] for ip in world.pod_ips],
                    np.uint32)
    pods6 = np.array([ip_to_words(ip) for ip in world.pod_ips6], np.uint32)
    words, fam = lpm_rows(rng, N, pods, pods6)
    w, f = u32.from_numpy(words, "cuda"), u32.from_numpy(fam, "cuda")
    got = lpm_lookup(t, w, f)
    want = lpm_lookup_plain(t, w, f)
    err = max_abs_err(got, want, "lpm_lookup")
    one_kernel_a_call(lambda: functools.partial(lpm_lookup, t, w, f),
                      "lpm_lookup_kernel", "lpm_lookup")
    k = kernels["lpm_lookup"]
    k["max_abs_err"] = err
    k["ms"] = device_ms(lambda: lpm_lookup(t, w, f), 20)
    k["plain_ms"] = device_ms(lambda: lpm_lookup_plain(t, w, f), 3)
    k["bytes"], k["ops"] = lpm_bound(torch, t, w, f)
    k["v6_probes"] = lpm6_probes(t, w, f)
    print(f"parity lpm_lookup: {N} addresses ({int((fam == 6).sum())} v6, "
          f"{k['v6_probes']} index probes), bit-exact, one kernel a call")

    # the larger TCAM: 4177 v6 entries, four prefix lengths
    ent, pods_big, misses = big_tcam(world)
    lt = compile_lpm(ent)
    t0 = time.perf_counter()
    tb = DeviceLPM.from_tensors(lt, "cuda")
    build_ms[lt.v6_net.shape[0]] = (time.perf_counter() - t0) * 1e3
    wb, fb = (u32.from_numpy(a, "cuda") for a in lpm_rows(
        np.random.default_rng(20261017 + 2), N, pods, pods_big,
        misses=misses))
    err = max(err, max_abs_err(lpm_lookup(tb, wb, fb),
                               lpm_plain_chunked(tb, wb, fb),
                               "lpm_lookup, the larger TCAM"))
    k["max_abs_err"] = err
    b, o = lpm_bound(torch, tb, wb, fb)
    k["big_tcam"] = {"v6_entries": lt.v6_net.shape[0],
                     "groups": tb.v6_groups.shape[0],
                     "v6_probes": lpm6_probes(tb, wb, fb),
                     "ms": device_ms(lambda: lpm_lookup(tb, wb, fb), 20),
                     "bound_ms": bound(b, o)[0]}
    k["index_build_ms"] = build_ms
    print(f"lpm_lookup on the larger TCAM ({lt.v6_net.shape[0]} v6 "
          f"entries, {tb.v6_groups.shape[0]} masks): "
          f"{k['big_tcam']['ms']:.4f} ms, bit-exact; DeviceLPM.from_tensors "
          f"(with the index) host ms by v6 entries: {build_ms}")


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
    import functools

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
    # the kernel's rows a thread follow the batch: 2 at N, 1 at the
    # daemon's 2^16 bucket and at l7_redirect's 1024-row batches
    for n in (N, 1 << 16, 1024):
        for cap, cursor, ts in ((1 << 15, (0xFFFFFF00, 7), 1024),
                                (RING_CAPACITY, (0, 0), 0)):
            rings = [rg.EventRing.create(cap, "cuda") for _ in range(2)]
            for r in rings:
                r.cursor.copy_(u32.from_numpy(np.array(cursor, np.uint32),
                                              "cuda"))
            rg.ring_append(rings[0], tout[:n], 4097, ts, valid[:n], ports)
            rg.ring_append_plain(rings[1], tout[:n], 4097, ts, valid[:n],
                                 ports)
            err = max(err,
                      max_abs_err(rings[0].buf, rings[1].buf, "ring buf"),
                      max_abs_err(rings[0].cursor, rings[1].cursor,
                                  "ring cursor"))
            got = rg.ring_drain(rings[0], np.array([10000, 10001]))
            kept = got[1] - cursor[0] - (cursor[1] << 32)
            print(f"parity ring_append: {n} rows, capacity {cap}, {kept} "
                  f"kept, {got[2]} overwritten, bit-exact")
    kernels["ring_append"]["max_abs_err"] = err
    name = one_kernel_a_call(lambda: functools.partial(
        rg.ring_append, rg.EventRing.create(RING_CAPACITY, "cuda"), tout,
        4097, 1024, valid, ports), "ring_append_kernel", "ring_append")
    print(f"ring_append: one kernel a call ({name})")


def ct_gc_bytes(fp, expired):
    """The least bytes K7 moves on a CT whose fingerprints are ``fp``
    (host u32 array; 0 = free) when it evicts ``expired`` slots: every
    fingerprint, each 32 B sector that holds a live slot's state and
    expiry (words 10-11 of its 68 B row: bytes 40-47, two sectors for one
    row in eight), the state and fingerprint of each evicted slot written
    back and the count."""
    import numpy as np

    live = np.flatnonzero(fp != 0).astype(np.int64)
    sectors = np.union1d((live * 68 + 40) // 32, (live * 68 + 47) // 32)
    return len(fp) * 4 + len(sectors) * 32 + expired * 8 + 4


def phase_maint(torch, rng, kernels):
    """The CT aging sweep and the occupancy count against their plain
    versions on a half-full 2^20 table whose expiries straddle 2^31 and
    ``now`` (an unsigned compare: a signed one gets them wrong); the
    sweep is one kernel a call."""
    import functools

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
    name = one_kernel_a_call(lambda: functools.partial(
        ct.ct_gc, fresh(), now), "ct_gc_kernel", "ct_gc")
    print(f"ct_gc: one kernel a call ({name})")
    name = one_kernel_a_call(lambda: functools.partial(
        _ct_occupied, base.fp), "ct_occupied_kernel", "ct_occupied")
    print(f"ct_occupied: one kernel a call, no memset ({name})")
    kernels["ct_gc"].update(
        ms=device_ms(lambda w: ct.ct_gc(w, now), 20, fresh),
        plain_ms=device_ms(lambda w: ct.ct_gc_plain(w, now), 3, fresh),
        bytes=ct_gc_bytes(fp, expired), ops=CT_CAPACITY * 4)
    kernels["ct_occupied"].update(
        ms=device_ms(lambda: _ct_occupied(base.fp), 20),
        plain_ms=device_ms(lambda: _ct_occupied_plain(base.fp), 3),
        library_ms=device_ms(lambda: torch.count_nonzero(base.fp), 20),
        bytes=CT_CAPACITY * 4 + 4, ops=CT_CAPACITY * 2)


def phase_dus(torch, rng, world, kernels, report):
    """K10 ``dus`` against its plain version at config #3's table shapes
    (a loader attached to the 10k-identity world): an identity's
    verdict rows and auth column, an l1 cell, l2 and l3 block rows, and
    starts past the edge or negative, which the start rule moves.  Then
    K10 timed at the verdict row, the auth column and an l3 row, each
    beside the slice ``copy_`` of the same update, in turns."""
    import numpy as np
    from cilium_tpu_torch.datapath.loader import (TorchLoader, _dus,
                                                  _dus_plain, _dus_runs,
                                                  _dus_starts)

    kl = TorchLoader(ct_capacity=1 << 4, device="cuda")
    kl.attach(world.policies, world.ipcache, {0: 0}, world.row_map)
    pol, lpm = kl.state.policy, kl.state.ipcache
    n_pol, _, n_rows, n_local = pol.verdict.shape

    def rand(*shape):
        return torch.from_numpy(rng.integers(
            -2**31, 2**31, shape, dtype=np.int64).astype(np.int32)).cuda()

    row = n_rows // 4 + 1
    cases = [
        ("verdict row", pol.verdict, rand(n_pol, 2, 1, n_local),
         (0, 0, row, 0)),
        ("auth column", pol.auth, rand(n_pol, 1), (0, row)),
        ("l1 cell", lpm.l1, rand(1), (0x0A09,)),
        ("l2 row", lpm.l2, rand(1, 256), (lpm.l2.shape[0] - 1, 0)),
        ("l3 row", lpm.l3, rand(1, 256), (lpm.l3.shape[0] // 2, 0)),
        ("verdict row, starts past the edge", pol.verdict,
         rand(n_pol, 2, 1, n_local), (3, 9, n_rows + 100, 7)),
        ("l3 rows, negative starts", lpm.l3, rand(2, 256), (-1, -300)),
    ]
    err = 0
    for what, dst, upd, starts in cases:
        got, want = dst.clone(), dst.clone()
        _dus(got, upd, starts)
        _dus_plain(want, upd, starts)
        err = max(err, max_abs_err(got, want, f"dus {what}"))
    print(f"parity dus: {len(cases)} updates into config #3's tables "
          f"(verdict {tuple(pol.verdict.shape)}, auth "
          f"{tuple(pol.auth.shape)}, l2 {tuple(lpm.l2.shape)}, l3 "
          f"{tuple(lpm.l3.shape)}), bit-exact")
    # timed at the patch paths' three shapes, each beside the library's
    # slice copy_, in turns (kernel, copy_, copy_, kernel)
    times = {}
    for what, dst, upd, starts in (cases[0], cases[1], cases[4]):
        dst = dst.clone()
        idx = tuple(slice(a, a + u) for a, u in zip(
            _dus_starts(dst.shape, upd.shape, starts), upd.shape))
        t = [device_ms(lambda: _dus(dst, upd, starts), 20),
             device_ms(lambda: dst[idx].copy_(upd), 20),
             device_ms(lambda: dst[idx].copy_(upd), 20),
             device_ms(lambda: _dus(dst, upd, starts), 20)]
        r = _dus_runs(dst.shape, upd.shape, starts)
        times[what] = {"update": list(upd.shape), "table": list(dst.shape),
                       "runs": r.counts[0] * r.counts[1] * r.counts[2],
                       "run_words": r.run, "ms": (t[0] + t[3]) / 2,
                       "copy_ms": (t[1] + t[2]) / 2, "turns": t}
        print(f"dus {what}: {times[what]['runs']} runs of {r.run} words; "
              f"K10 {t[0]:.4f} / {t[3]:.4f} ms, slice copy_ {t[1]:.4f} / "
              f"{t[2]:.4f} ms")
    report["dus"] = times
    v_row = cases[0][2]
    dst, starts = cases[0][1].clone(), cases[0][3]
    kernels["dus"].update(
        max_abs_err=err, ms=times["verdict row"]["ms"],
        plain_ms=device_ms(lambda: _dus_plain(dst, v_row, starts), 20),
        library_ms=times["verdict row"]["copy_ms"],
        # the update read once and written once; no arithmetic on it
        bytes=2 * v_row.numel() * 4, ops=0)


# -- the egress stages (K11-K14) ---------------------------------------

EGRESS_N = 1 << 16  # phase 11's process_batch rows
NAT_POOL = 1 << 14  # the default pool (NAT_DEFAULT_CAPACITY)


def nat_case(torch, rng, now, n_inbound=8192):
    """Full-size NAT inputs on the card: a pool of NAT_POOL slots, a 2^20
    CT table holding ``n_inbound`` live inbound connections, the
    gateway rule table phase 11's policy compiles to (one rule for each
    of 64 pods, with overlapping rules ahead and behind:
    ``gateway_rules``), and EGRESS_N rows (a crafted collision window,
    the pods' replies to the inbound connections, mixed traffic with
    repeats)."""
    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.datapath import conntrack as ct
    from cilium_tpu_torch.service import nat
    from cilium_tpu_torch.testing import egress as eg

    pods = eg.pod_ips(256)
    inbound, replies = eg.inbound_pairs(rng, n_inbound, pods)
    table, fp = eg.inbound_ct(inbound, now, CT_CAPACITY)
    cti = ct.CTTable(table=u32.from_numpy(table, "cuda"),
                     fp=u32.from_numpy(fp, "cuda"),
                     dropped=torch.zeros((), dtype=torch.int32,
                                         device="cuda"))
    t = nat.NATConfig(node_ip=eg.NODE_IP, egress_rules=eg.gateway_rules(
        pods)).compile("cuda")
    home = int(rng.integers(0, NAT_POOL))
    n_rep = EGRESS_N // 16
    rows = np.concatenate([
        eg.colliding_rows(12, NAT_POOL, home), replies[:n_rep],
        eg.egress_rows(rng, EGRESS_N - n_rep - 12, pods, sports=16384)])
    return t, cti, rows, pods


MASQ_EXCLUSIONS = ("10.0.0.0/8", "172.16.0.0/12", "192.168.0.0/16",
                   "100.64.0.0/10")


def masq_edge_cases(rng):
    """K14's edge inputs at phase 11's shapes (EGRESS_N rows, a CT of
    CT_CAPACITY slots), in numpy: {case: (non-masquerade CIDRs, rows,
    (CT table, fingerprints), now)}.  "overflow": 4096 of the pods'
    replies among egress rows (some toward 172.16.0.0/12 and
    100.64.0.0/10), their connections' entries crowded by
    ``testing.egress.crowded_ct`` (most behind N_CAND + 1 or more live
    entries of their fingerprint, so the probe takes its full-window
    fallback; some expired, some absent); "wrap": 64 connections whose
    windows wrap the CT's end (``wrap_inbound``), each reply 16 times;
    "clock_2^32": overflow's rows on a CT made at 2^32 - 1100 and probed
    at 2^32 - 150 (its live entries expire at 2^32 - 100); "no_exclusions"
    and "four_exclusions": overflow's case with no non-masquerade network
    (one unsatisfiable pad row) and with MASQ_EXCLUSIONS."""
    import numpy as np
    from cilium_tpu_torch.core.packets import COL_DST_IP3
    from cilium_tpu_torch.testing import egress as eg

    pods = eg.pod_ips(256)
    default = ("10.0.0.0/8",)
    inbound, replies = eg.inbound_pairs(rng, 4096, pods)
    mix = eg.egress_rows(rng, EGRESS_N - len(replies), pods, sports=16384)
    mix[::7, COL_DST_IP3] = eg.ip("172.16.5.5")
    mix[::11, COL_DST_IP3] = eg.ip("100.64.1.1")
    rows = np.concatenate([replies, mix])[rng.permutation(EGRESS_N)]
    now, late = 1000, (1 << 32) - 150
    crowd = eg.crowded_ct(rng, inbound, now, CT_CAPACITY)
    wrap_in = eg.wrap_inbound(rng, 64, pods, CT_CAPACITY)
    wrap_rows = np.concatenate([np.repeat(eg.replies_to(wrap_in), 16, 0),
                                mix[:EGRESS_N - 1024]])
    return {
        "overflow": (default, rows, crowd, now),
        "wrap": (default, wrap_rows, eg.crowded_ct(
            rng, wrap_in, now, CT_CAPACITY, crowded=0.1), now),
        "clock_2^32": (default, rows, eg.crowded_ct(
            rng, inbound, late - 950, CT_CAPACITY), late),
        "no_exclusions": ((), rows, crowd, now),
        "four_exclusions": (MASQ_EXCLUSIONS, rows, crowd, now)}


def masq_card_case(torch, cidrs, rows, table_fp, offset=0):
    """One of ``masq_edge_cases`` on the card: (NAT tensors, CT, rows);
    ``offset`` > 0 puts the rows ``offset`` words past a 16-byte
    boundary (a view into a larger buffer)."""
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.datapath import conntrack as ct
    from cilium_tpu_torch.service import nat
    from cilium_tpu_torch.testing import egress as eg

    t = nat.NATConfig(node_ip=eg.NODE_IP,
                      non_masquerade_cidrs=cidrs).compile("cuda")
    cti = ct.CTTable(table=u32.from_numpy(table_fp[0], "cuda"),
                     fp=u32.from_numpy(table_fp[1], "cuda"),
                     dropped=torch.zeros((), dtype=torch.int32,
                                         device="cuda"))
    hdr = u32.from_numpy(rows, "cuda")
    if offset:
        buf = torch.empty(hdr.numel() + offset, dtype=hdr.dtype,
                          device="cuda")
        buf[offset:] = hdr.reshape(-1)
        hdr = buf[offset:].view(hdr.shape)
    return t, cti, hdr


CT_PROBE_OPS = 100  # reverse key, its hash, 16 fingerprint compares


def snat_reverse_bytes(rows, out, pool):
    """The least bytes K12 moves for replies ``rows`` that it rewrote to
    ``out`` (tensors) over a pool of ``pool`` slots: every row read and
    written (64 B each), the 24 B slot of each ingress v4 row in the
    pool, and one expiry written for each slot a reply hit."""
    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import (COL_DIR, COL_DPORT,
                                               COL_FAMILY)
    from cilium_tpu_torch.service.nat import NAT_PORT_MIN

    r, o = u32.to_numpy(rows), u32.to_numpy(out)
    need = ((r[:, COL_DIR] == 0) & (r[:, COL_FAMILY] == 4)
            & (r[:, COL_DPORT] >= NAT_PORT_MIN)
            & (r[:, COL_DPORT] < NAT_PORT_MIN + pool))
    hit = (r != o).any(1)
    return (len(r) * 128 + int(need.sum()) * 24
            + len(np.unique(r[hit, COL_DPORT])) * 4)


def egress_counts(rows, t, found, k11):
    """The least bytes and integer operations K11 (``k11``) or K14 must
    move and do for ``rows``: every row read and written (64 B each)
    and its mask byte, 40 ops; for each masquerade candidate the
    reverse-CT probe, its fingerprint window (64 B) and CT_PROBE_OPS,
    and the CT key (40 B) of each of the ``found`` candidates whose
    reverse entry is live.  K11 also reads the gateway rule table once
    (16 B a rule) and tries, for each egress v4 row, the rules up to its
    first match (3 ops a rule); it hashes each candidate (8 ops) and,
    for each port-bearing one, scans its 8-slot NAT window (192 B, 40
    ops) and writes one slot (24 B, 20 ops)."""
    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import (COL_DIR, COL_DST_IP3,
                                               COL_FAMILY, COL_PROTO,
                                               COL_SRC_IP3)

    src, dst = rows[:, COL_SRC_IP3], rows[:, COL_DST_IP3]
    out4 = (rows[:, COL_DIR] == 1) & (rows[:, COL_FAMILY] == 4)
    internal = ((dst[:, None] & u32.to_numpy(t.mask))
                == u32.to_numpy(t.net)).any(1)
    nb, ops = len(rows) * 129 + found * 40, len(rows) * 40
    if not k11:
        n_cand = int((out4 & ~internal).sum())
        return nb + n_cand * 64, ops + n_cand * CT_PROBE_OPS
    hit = ((src[:, None] == u32.to_numpy(t.egw_src))
           & ((dst[:, None] & u32.to_numpy(t.egw_mask))
              == u32.to_numpy(t.egw_net)))
    g = hit.shape[1]
    tried = np.where(hit.any(1), hit.argmax(1) + 1, g)
    cand = out4 & (hit.any(1) | ~internal)
    need = cand & np.isin(rows[:, COL_PROTO], [6, 17, 132])
    n_cand, n_need = int(cand.sum()), int(need.sum())
    return (nb + g * 16 + n_cand * 64 + n_need * (192 + 24),
            ops + 3 * int(tried[out4].sum())
            + n_cand * (CT_PROBE_OPS + 8) + n_need * 60)


def phase_egress_kernels(torch, rng, kernels):
    """K11-K14 against their plain versions at phase 11's shapes (2^16
    rows, a 2^14-slot pool, a 2^20 CT): crafted collision windows,
    repeats of one flow in a batch, a pool run dry by one batch, replies
    (some to the wrong IP or with a forged protocol word), a clock
    crossing 2^32; each kernel and its plain version fed clones of the
    same state.  K11, K12 and K13 are one kernel a call."""
    import functools

    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import COL_DIR, COL_FAMILY
    from cilium_tpu_torch.datapath import bandwidth as bw
    from cilium_tpu_torch.service import nat
    from cilium_tpu_torch.testing import egress as eg

    def clone(tbl):
        return nat.NATTable(tbl.table.clone(), tbl.failed.clone())

    errs = {k: 0 for k in ("snat_egress", "snat_reverse", "bw_stage",
                           "masq_rewrite")}
    timed = None
    for now in (1000, (1 << 32) - 150):
        t, cti, rows, pods = nat_case(torch, rng, now)
        tabs = [nat.NATTable.create(NAT_POOL, "cuda") for _ in range(2)]
        for step in range(3):
            t_now = (now + 90 * step) & 0xFFFFFFFF
            hdr = u32.from_numpy(rows, "cuda")
            before = clone(tabs[0])
            got = nat.snat_egress(tabs[0], t, cti, hdr, t_now)
            want = nat.snat_egress_plain(tabs[1], t, cti, hdr, t_now)
            e = max(max_abs_err(got[0], want[0], "snat_egress rows"),
                    max_abs_err(got[2], want[2], "snat_egress drop"),
                    max_abs_err(tabs[0].table, tabs[1].table,
                                "snat_egress table"),
                    max_abs_err(tabs[0].failed, tabs[1].failed,
                                "snat_egress failed"))
            errs["snat_egress"] = max(errs["snat_egress"], e)
            if step == 1 and timed is None:
                # timed on a table the first batch filled
                timed = (before, t, cti, hdr, t_now, rows)
            out = u32.to_numpy(got[0])
            rep = u32.from_numpy(eg.reply_rows(rng, out, EGRESS_N), "cuda")
            g = nat.snat_reverse(tabs[0], t, rep, t_now + 1)
            w = nat.snat_reverse_plain(tabs[1], t, rep, t_now + 1)
            errs["snat_reverse"] = max(
                errs["snat_reverse"],
                max_abs_err(g[0], w[0], "snat_reverse rows"),
                max_abs_err(tabs[0].table, tabs[1].table,
                            "snat_reverse table"))
            restored = int((g[0][:, 7] != rep[:, 7]).sum())
            print(f"parity snat_egress/snat_reverse: now={t_now}, "
                  f"{len(rows)} rows, {int(got[2].sum())} dropped (failed "
                  f"{int(tabs[0].failed) & 0xFFFFFFFF}), "
                  f"{nat.nat_live_count(tabs[0], t_now)} of {NAT_POOL} "
                  f"slots live, {restored} replies restored, bit-exact")
            rows = np.concatenate([rows[::2], eg.egress_rows(
                rng, len(rows) - len(rows[::2]), pods, sports=16384)])
        for ct_arg in (cti, None):
            g = nat.masq_rewrite(t, hdr, ct_arg, t_now)
            w = nat.masq_rewrite_plain(t, hdr, ct_arg, t_now)
            errs["masq_rewrite"] = max(
                errs["masq_rewrite"],
                max_abs_err(g[0], w[0], "masq_rewrite rows"),
                max_abs_err(g[1], w[1], "masq_rewrite mask"))

    # K14 on its edges, with and without the probe: reverse entries past
    # the fingerprint candidates, windows wrapping the CT's end, a clock
    # near 2^32, no and four exclusions, rows off a 16-byte boundary,
    # n = 0 and 1
    edges = masq_edge_cases(rng)
    runs = [(name, *c, 0) for name, c in edges.items()]
    runs.append(("unaligned", *edges["overflow"], 1))
    o_rows = edges["overflow"][1]
    first = int(np.flatnonzero((o_rows[:, COL_DIR] == 1)
                               & (o_rows[:, COL_FAMILY] == 4))[0])
    runs.append(("n1", *edges["overflow"][:1], o_rows[first:first + 1],
                 *edges["overflow"][2:], 0))
    runs.append(("n0", *edges["overflow"][:1], edges["overflow"][1][:0],
                 *edges["overflow"][2:], 0))
    kept = {}
    for name, cidrs, m_rows, table_fp, m_now, offset in runs:
        t_m, ct_m, hdr_m = masq_card_case(torch, cidrs, m_rows, table_fp,
                                          offset)
        for ct_arg in (ct_m, None):
            g = nat.masq_rewrite(t_m, hdr_m, ct_arg, m_now)
            w = nat.masq_rewrite_plain(t_m, hdr_m, ct_arg, m_now)
            errs["masq_rewrite"] = max(
                errs["masq_rewrite"],
                max_abs_err(g[0], w[0], f"masq_rewrite {name} rows"),
                max_abs_err(g[1], w[1], f"masq_rewrite {name} mask"))
            kept[name] = kept.get(name, 0) + (1 if ct_arg is None
                                              else -1) * int(w[1].sum())
    print(f"parity masq_rewrite edges: rows kept by the probe {kept}, "
          f"bit-exact with and without it")

    # K13 over the 4096 buckets: 64 limited endpoints among 256
    eps = list(range(1, 257)) + [5000]
    limits = {e: int(x) for e, x in zip(
        range(1, 65), rng.integers(100_000, 2_000_000, 64))}
    limits[2] = 0x7FFFFFFF
    rates = u32.from_numpy(bw.rates_array(limits), "cuda")
    states = [bw.BandwidthState.create("cuda") for _ in range(2)]
    policed = 0
    for now in (10, 10, 11, 4000, (1 << 32) - 1, 3):
        hdr_bw = u32.from_numpy(eg.bw_rows(rng, EGRESS_N, eps), "cuda")
        g = bw.bw_stage(states[0], hdr_bw, now, rates)
        w = bw.bw_stage_plain(states[1], hdr_bw, now, rates)
        policed += int((g != 0).sum())
        errs["bw_stage"] = max(
            errs["bw_stage"], max_abs_err(g, w, "bw_stage reasons"),
            max_abs_err(states[0].tokens, states[1].tokens,
                        "bw_stage tokens"),
            max_abs_err(states[0].last, states[1].last, "bw_stage last"))
    print(f"parity bw_stage: {EGRESS_N} rows of {len(eps)} endpoints, "
          f"{len(limits)} limited, clocks 10..2^32-1..3, {policed} rows "
          f"dropped in 6 batches, bit-exact")

    # times at phase 11's shapes, each call on a clone of the state
    before, t, cti, hdr, t_now, rows = timed
    # the candidates whose reverse CT entry is live: masqueraded without
    # the probe, kept with it
    found = int((nat.masq_rewrite_plain(t, hdr, None, t_now)[1]
                 & ~nat.masq_rewrite_plain(t, hdr, cti, t_now)[1]).sum())
    nb, ops = egress_counts(rows, t, found, k11=True)
    one_kernel_a_call(lambda: functools.partial(
        nat.snat_egress, clone(before), t, cti, hdr, t_now),
        "snat_egress_kernel", "snat_egress")
    kernels["snat_egress"].update(
        max_abs_err=errs["snat_egress"],
        ms=device_ms(lambda tb: nat.snat_egress(tb, t, cti, hdr, t_now),
                     20, lambda: clone(before)),
        plain_ms=device_ms(lambda tb: nat.snat_egress_plain(
            tb, t, cti, hdr, t_now), 3, lambda: clone(before)),
        bytes=nb, ops=ops)
    out = u32.to_numpy(nat.snat_egress(clone(before), t, cti, hdr,
                                       t_now)[0])
    rep = u32.from_numpy(eg.reply_rows(rng, out, EGRESS_N), "cuda")
    after = clone(before)
    nat.snat_egress(after, t, cti, hdr, t_now)
    one_kernel_a_call(lambda: functools.partial(
        nat.snat_reverse, clone(after), t, rep, t_now),
        "snat_reverse_kernel", "snat_reverse")
    kernels["snat_reverse"].update(
        max_abs_err=errs["snat_reverse"],
        ms=device_ms(lambda tb: nat.snat_reverse(tb, t, rep, t_now), 20,
                     lambda: clone(after)),
        plain_ms=device_ms(lambda tb: nat.snat_reverse_plain(
            tb, t, rep, t_now), 3, lambda: clone(after)),
        bytes=snat_reverse_bytes(rep, nat.snat_reverse_plain(
            clone(after), t, rep, t_now)[0], NAT_POOL),
        ops=EGRESS_N * 40)
    nb, ops = egress_counts(rows, t, found, k11=False)
    for ct_arg in (cti, None):
        one_kernel_a_call(lambda: functools.partial(
            nat.masq_rewrite, t, hdr, ct_arg, t_now), "masq_kernel",
            "masq_rewrite")
    kernels["masq_rewrite"].update(
        max_abs_err=errs["masq_rewrite"],
        ms=device_ms(lambda: nat.masq_rewrite(t, hdr, cti, t_now), 20),
        plain_ms=device_ms(lambda: nat.masq_rewrite_plain(
            t, hdr, cti, t_now), 3),
        bytes=nb, ops=ops)
    # snat_stage's call, without the probe: bounded by the rows alone
    kernels["masq_rewrite"]["no_probe"] = {
        "ms": device_ms(lambda: nat.masq_rewrite(t, hdr), 20),
        "plain_ms": device_ms(lambda: nat.masq_rewrite_plain(t, hdr), 3),
        "bound_ms": bound(len(rows) * 129, len(rows) * 40)[0]}
    print(f"masq_rewrite without the CT probe: "
          f"{kernels['masq_rewrite']['no_probe']}")

    def fresh_bw():
        return bw.BandwidthState(states[0].tokens.clone(),
                                 states[0].last.clone())

    one_kernel_a_call(lambda: functools.partial(
        bw.bw_stage, fresh_bw(), hdr_bw, 5, rates), "bw_stage_kernel",
        "bw_stage")
    kernels["bw_stage"].update(
        max_abs_err=errs["bw_stage"],
        ms=device_ms(lambda s: bw.bw_stage(s, hdr_bw, 5, rates), 20,
                     fresh_bw),
        plain_ms=device_ms(lambda s: bw.bw_stage_plain(s, hdr_bw, 5, rates),
                           3, fresh_bw),
        # the five words a row needs lie in both 32 B sectors of its 64 B
        # row (bytes 12-15, 32-35, 48-63): the whole row, and its reason
        # (4 B); rates, tokens read and written for every bucket
        bytes=EGRESS_N * 68 + 4096 * 12 + 8,
        ops=EGRESS_N * 30 + 4096 * 20)


# -- the service LB stages (K15-K17) -------------------------------------

N_SERVICES = 4096  # bench.py bench_socket_lb_scaling's top point
N_V6_SERVICES = 256  # dual-stack frontends over the world's v6 pods
LB_N = 1 << 16  # rows a batch (phase 12's process_batch batch)
N_LB_CLIENTS = 128


def service_world(world):
    """The service world of phases 3 and 12 as k8s objects
    (``testing/services.py``): N_SERVICES ClusterIP services with 2
    backends each among the world's pod IPs, the first N_V6_SERVICES
    dual-stack over its v6 pods, a 16th with ClientIP affinity, the last
    16 with no backend."""
    from cilium_tpu_torch.testing import services as sv

    return sv.k8s_objects(world.pod_ips, world.pod_ips6, n=N_SERVICES,
                          n_v6=N_V6_SERVICES)


def lb_hits(rows, t, v6):
    """The rows of ``rows`` (of the family ``v6`` names) that match a
    frontend of ``t`` (host copies of its frontends)."""
    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import (COL_DPORT, COL_DST_IP0,
                                               COL_FAMILY, COL_PROTO)

    ip = u32.to_numpy(t.svc_ip).reshape(len(u32.to_numpy(t.svc_port)), -1)
    fe = np.concatenate([ip, u32.to_numpy(t.svc_port)[:, None],
                         u32.to_numpy(t.svc_proto)[:, None]], 1)
    cols = list(range(COL_DST_IP0 + (0 if v6 else 3), COL_DST_IP0 + 4))
    key = rows[:, cols + [COL_DPORT, COL_PROTO]]
    known = set(map(bytes, np.ascontiguousarray(fe)))
    fam = rows[:, COL_FAMILY] == (6 if v6 else 4)
    hit = np.array([bytes(k) in known for k in np.ascontiguousarray(key)])
    return int((hit & fam).sum())


def socklb_live(tbl, rows, now):
    """[N] bool: the flow of each of ``rows`` has a live entry in the
    socket-LB cache ``tbl`` at ``now``."""
    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import (COL_DPORT, COL_DST_IP3,
                                               COL_PROTO, COL_SPORT,
                                               COL_SRC_IP3)
    from cilium_tpu_torch.service.socklb import SK_EXPIRES

    table = u32.to_numpy(tbl.table)
    live = table[table[:, SK_EXPIRES] >= now][:, :4]
    known = {bytes(k) for k in np.ascontiguousarray(live)}
    key = np.stack([rows[:, COL_SRC_IP3], rows[:, COL_SPORT],
                    rows[:, COL_DST_IP3],
                    (rows[:, COL_DPORT] << 8) | rows[:, COL_PROTO]], 1)
    return np.array([bytes(k) in known for k in np.ascontiguousarray(key)],
                    bool)


def socklb_misses(tbl, rows, now):
    """v4 rows of ``rows`` whose flow has no live entry in ``tbl`` at
    ``now`` (the connect path's rows)."""
    from cilium_tpu_torch.core.packets import COL_FAMILY

    return int(((rows[:, COL_FAMILY] == 4) & ~socklb_live(tbl, rows,
                                                           now)).sum())


def socklb_counts(rows, n_miss, n_frontends):
    """The least bytes and integer operations K17 must move and do for
    ``rows`` with ``n_miss`` connect-path rows against ``n_frontends``
    v4 frontends: every row read and written (128 B) and its two masks,
    40 ops (key, FNV hash, fingerprint); for each v4 row its 8-word
    fingerprint window (32 B) and one 32 B table row with 8 compares,
    and an expiry written; the frontends read once (12 B, 3 ops each,
    to index them); for each miss one probe of that index, the Maglev
    and backend gathers (12 B) and a 32 B flow row written."""
    from cilium_tpu_torch.core.packets import COL_FAMILY

    v4 = int((rows[:, COL_FAMILY] == 4).sum())
    return (len(rows) * 130 + v4 * 68 + n_frontends * 12
            + n_miss * (12 + 32 + 4),
            len(rows) * 40 + v4 * 16 + 3 * n_frontends + n_miss * 44)


def phase_lb_kernels(torch, rng, world, kernels, report):
    """K15-K17 against their plain versions at full width: the service
    world of ``service_world`` (4096 v4 frontends, Maglev tables of
    16381 slots: [4096, 16381] int32, 268 MB), LB_N rows with half to
    VIPs; K16 over the 256 v6 frontends; K17 over ``socklb_steps``'s
    threaded sequence on the daemon's default 2^16-slot cache and on
    bench_socket_lb's 2^20, the flow table, fingerprints and pins
    compared word for word after every batch; K15, K16 and K17 are one
    kernel a call.
    Returns the ServiceManager, for phase 12 to take over with its filled
    Maglev rows."""
    import functools

    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import COL_FAMILY
    from cilium_tpu_torch.k8s.watchers import ServiceWatcher
    from cilium_tpu_torch.service import (ServiceManager, lb6_stage,
                                          lb6_stage_plain, lb_stage,
                                          lb_stage_plain)
    from cilium_tpu_torch.service import socklb as sl
    from cilium_tpu_torch.testing import services as sv

    t0 = time.monotonic()
    mgr = ServiceManager(device="cuda")
    objs = service_world(world)
    sv.install(ServiceWatcher(mgr), objs)
    t_watch = time.monotonic() - t0
    t, t6 = mgr.tensors(), mgr.tensors6()
    torch.cuda.synchronize()
    t_compile = time.monotonic() - t0 - t_watch
    # the filled Maglev rows the manager keeps on the host for the next
    # compile
    kept = sum(v.nbytes for v in mgr._maglev.values())
    print(f"lb world: {len(mgr)} frontends ({N_SERVICES} v4, "
          f"{t6.svc_ip.shape[0]} v6) through ServiceWatcher in "
          f"{t_watch:.1f} s, Maglev [{t.maglev.shape[0]}, {t.m}] compiled "
          f"and uploaded in {t_compile:.1f} s (host); "
          f"{len(mgr._maglev)} filled rows kept, {kept / 2**20:.1f} MiB "
          f"of host memory")
    clients = (0x0A000000 + rng.choice(1 << 16, N_LB_CLIENTS,
                                       replace=False)).astype(np.uint32)
    others = np.array([int(ipaddress.IPv4Address(ip))
                       for ip in world.pod_ips[:2048]], np.uint32)

    def clone(tbl):
        return sl.SockLBTable(tbl.table.clone(), tbl.fp.clone(),
                              tbl.aff.clone())

    # K15, K16: the per-packet stages
    for name, kern, plain, tt, v6 in (
            ("lb_stage", lb_stage, lb_stage_plain, t, False),
            ("lb6_stage", lb6_stage, lb6_stage_plain, t6, True)):
        rows = sv.rows(rng, LB_N, N_SERVICES, clients, others,
                       vip_frac=0.0 if v6 else 0.5,
                       v6_frac=0.5 if v6 else 0.0,
                       n_v6=N_V6_SERVICES if v6 else 0)
        rows[::5, 3] |= 0x80000000  # sources above 2^31
        hdr = u32.from_numpy(rows, "cuda")
        err = max(max_abs_err(g, w, f"{name} {what}") for g, w, what in zip(
            kern(tt, hdr), plain(tt, hdr), ("rows", "have", "no_backend")))
        hits = lb_hits(rows, tt, v6)
        one_kernel_a_call(lambda: functools.partial(kern, tt, hdr),
                          f"{name}_kernel", name)
        s = tt.svc_port.shape[0]
        if v6:
            # rows read and written, two masks; the frontends read once;
            # a Maglev entry and a backend read for each hit
            moved = LB_N * 130 + (s + hits) * 24
            # the frontends indexed in one pass (a compare a word), one
            # probe of that index a row; the hash, select and rewrite
            ops = 6 * s + 24 * LB_N
        else:
            v4 = int((rows[:, COL_FAMILY] == 4).sum())
            # rows read and written, two masks; a v4 row's 16 B index
            # slot (the index read at most once); a hit's Maglev sector
            # and backend
            moved = (LB_N * 130 + min(v4, tt.index.shape[0]) * 16
                     + hits * (32 + 8))
            # a probe a v4 row (its hash and key compare); the hash,
            # select and rewrite
            ops = 16 * v4 + 24 * LB_N
        kernels[name].update(
            max_abs_err=err, ms=device_ms(lambda: kern(tt, hdr), 20),
            plain_ms=device_ms(lambda: plain(tt, hdr), 3), bytes=moved,
            ops=ops)
        print(f"parity {name}: {LB_N} rows against {s} frontends, "
              f"{hits} hits, bit-exact, one kernel a call")

    # K17: the threaded sequence on two cache sizes
    errs, timed, seq = 0, {}, {}
    for cap in (1 << 16, 1 << 20):
        tabs = [sl.SockLBTable.create(cap, device="cuda")]
        tabs.append(clone(tabs[0]))
        steps = sv.socklb_steps(rng, N_SERVICES, clients, others, LB_N,
                                connect=sl.CONNECT_CAP, n_connect=4,
                                n_v6=N_V6_SERVICES)
        for label, rows, now, ovf in steps:
            if label == "backend-change":
                # a backend leaves 64 services; pins to it are pruned
                for i in range(0, 128, 2):
                    s = mgr.get(f"default/svc{i}:{sv.port_proto(i)[0]}")
                    mgr.upsert(s.name, f"{s.frontend_ip}:{s.frontend_port}",
                               [b.key for b in s.backends[1:]],
                               protocol=s.protocol,
                               affinity_timeout=s.affinity_timeout)
                for tb in tabs:
                    tb.prune_affinity(mgr.backend_set())
            if ovf >= 0:
                fp = sv.force_overflow(u32.to_numpy(tabs[0].fp), rows[ovf])
                for tb in tabs:
                    tb.fp.copy_(u32.from_numpy(fp, "cuda"))
            hdr = u32.from_numpy(rows, "cuda")
            tt = mgr.tensors()
            if cap == 1 << 16 and label in ("connect", "steady"):
                timed[label] = (clone(tabs[0]), tt, hdr, now, rows)
            before = clone(tabs[0])
            got = sl.socklb_stage(tabs[0], tt, hdr, now)
            want = sl.socklb_stage_plain(tabs[1], tt, hdr, now)
            for g, w, what in zip(got[:3] + (tabs[0].table, tabs[0].fp,
                                             tabs[0].aff),
                                  want[:3] + (tabs[1].table, tabs[1].fp,
                                              tabs[1].aff),
                                  ("rows", "svc_hit", "no_backend", "table",
                                   "fp", "aff")):
                errs = max(errs, max_abs_err(g, w, f"socklb_stage {label} "
                                             f"(2^{cap.bit_length() - 1}) "
                                             f"{what}"))
            n_miss = socklb_misses(before, rows, now)
            seq[f"{label}/{cap}"] = {
                "rows": len(rows), "misses": n_miss,
                "svc_hit": int(got[1].sum()),
                "no_backend": int(got[2].sum()),
                "occupied": int((tabs[0].fp != 0).sum()),
                "pins_live": int((u32.widen(tabs[0].aff[:, sl.AF_EXPIRES])
                                  >= now).sum())}
            print(f"parity socklb_stage 2^{cap.bit_length() - 1}: {label} "
                  f"now={now}, {len(rows)} rows, {n_miss} misses, "
                  f"{seq[f'{label}/{cap}']['svc_hit']} service hits, "
                  f"{seq[f'{label}/{cap}']['occupied']} slots occupied, "
                  f"bit-exact")
    # times on the steady batch of the 2^16 cache, each call on a clone
    base, tt, hdr, now, rows = timed["steady"]
    missed = (rows[:, COL_FAMILY] == 4) & ~socklb_live(base, rows, now)
    n_miss = int(missed.sum())
    nb, ops = socklb_counts(rows, n_miss, tt.svc_port.shape[0])
    one_kernel_a_call(lambda: functools.partial(
        sl.socklb_stage, clone(base), tt, hdr, now), "socklb_kernel",
        "socklb_stage")
    kernels["socklb_stage"].update(
        max_abs_err=errs,
        ms=device_ms(lambda tb: sl.socklb_stage(tb, tt, hdr, now), 20,
                     lambda: clone(base)),
        plain_ms=device_ms(lambda tb: sl.socklb_stage_plain(
            tb, tt, hdr, now), 3, lambda: clone(base)),
        bytes=nb, ops=ops)
    # where K17's time goes: its launches' device times on the steady
    # batch and on the last connect batch (8192 new flows), and the
    # claim steps its one kernel ran
    from torch.profiler import ProfilerActivity, profile

    from cilium_tpu_torch.kernels import launch_socklb_stage

    split = {}
    for label, (b0, tt, hdr, now, rows) in timed.items():
        sl.socklb_stage(clone(b0), tt, hdr, now)
        tb = clone(b0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sl.socklb_stage(tb, tt, hdr, now)
            torch.cuda.synchronize()
        split[label] = {}
        for e in prof.key_averages():
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or e.self_device_time_total <= 0):
                continue
            key = e.key.replace("(anonymous namespace)::", "")
            key = ("claim-word fills" if "Fill" in key else
                   key.split("(")[0].split("<")[0].split("::")[-1].strip())
            split[label][key] = (split[label].get(key, 0.0)
                                 + e.self_device_time_total)
        steps, tail, counts = claim_steps(launch_socklb_stage, 10,
                                          clone(b0), tt, hdr, now)
        split[label]["claim_steps"] = steps
        split[label]["tail_from_step"] = tail
        split[label]["counts"] = counts
        print(f"socklb_stage {label} batch ({len(rows)} rows, "
              f"{socklb_misses(b0, rows, now)} misses), device us by "
              f"launch: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in split[label].items()
                                      if isinstance(v, float))
              + f"; claim steps run {steps}, one block from step {tail}, "
              f"pending entering each step {counts[:8]}")
    report["lb_kernels"] = {"watch_s": t_watch, "compile_s": t_compile,
                            "kept_maglev_bytes": kept,
                            "socklb_sequence": seq,
                            "steady_misses": n_miss,
                            "socklb_device_us": split}
    del t, t6, timed, base
    return mgr


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


def gather_index(torch, starts, rung, cap):
    """The [n_shards * rung] ring rows a gather reads, on the card: the
    index ``torch.index_select`` takes for K6's library time."""
    st = torch.tensor(starts, dtype=torch.int64, device="cuda")
    idx = (st[:, None] + torch.arange(rung, device="cuda")[None, :]) & (
        cap - 1)
    return (idx + (torch.arange(len(starts), device="cuda")
                   * cap)[:, None]).reshape(-1)


def time_gather(torch, rng, kernels, rung):
    """ring_gather's times at the rung the daemon's windows used, one
    kernel a call, beside one ``torch.index_select`` of the same rows
    (its index built once, not timed)."""
    import functools

    from cilium_tpu_torch import u32
    from cilium_tpu_torch.monitor import ring as rg

    cap = RING_CAPACITY
    buf = u32.from_numpy(random_ring_words(rng, cap), "cuda")
    start = [int(rng.integers(0, cap))]
    name = one_kernel_a_call(lambda: functools.partial(
        rg.ring_gather, buf, start, rung, cap), "ring_gather_kernel",
        "ring_gather")
    idx = gather_index(torch, start, rung, cap)
    max_abs_err(rg.ring_gather(buf, start, rung, cap),
                torch.index_select(buf, 0, idx), "ring_gather against "
                "index_select")
    kernels["ring_gather"].update(
        ms=device_ms(lambda: rg.ring_gather(buf, start, rung, cap), 20),
        plain_ms=device_ms(
            lambda: rg.ring_gather_plain(buf, start, rung, cap), 3),
        library_ms=device_ms(lambda: torch.index_select(buf, 0, idx), 20),
        bytes=rung * 8 * 2, ops=rung * 4, rung=rung)
    print(f"timing ring_gather at rung {rung} from slot {start[0]}: one "
          f"kernel a call ({name})")


def time_gather_sharded(torch, rng, kernels, rung):
    """ring_gather at the sharded drainer's shape: SHARDS rings of
    RING_CAPACITY, ``rung`` rows a shard from starts even and odd by
    turns; bit-exact with its plain version, one kernel a call; -> ms."""
    import functools

    from cilium_tpu_torch import u32
    from cilium_tpu_torch.monitor import ring as rg

    cap = RING_CAPACITY
    buf = u32.from_numpy(random_ring_words(rng, SHARDS * cap), "cuda")
    starts = [int(rng.integers(0, cap // 2)) * 2 + (s & 1)
              for s in range(SHARDS)]
    max_abs_err(rg.ring_gather(buf, starts, rung, cap),
                rg.ring_gather_plain(buf, starts, rung, cap),
                f"ring_gather over {SHARDS} shards at rung {rung}")
    one_kernel_a_call(lambda: functools.partial(
        rg.ring_gather, buf, starts, rung, cap), "ring_gather_kernel",
        "ring_gather, sharded")
    ms = device_ms(lambda: rg.ring_gather(buf, starts, rung, cap), 20)
    kernels["ring_gather"]["path_ms"] = {"sharded": ms}
    kernels["ring_gather"]["sharded_rung"] = rung
    print(f"timing ring_gather over {SHARDS} shards at rung {rung} (phase "
          f"15's windows): bit-exact, one kernel a call, {ms:.4f} ms")


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

    def __init__(self, threads=None):
        """``threads``: stage -> thread for another set of stages than
        the serving session's (THREADS)."""
        import threading

        self.threads = threads or self.THREADS
        self.times = {name: [] for name in self.threads}
        self._depth = threading.local()

    def wrap(self, owner, attr, name, skip_none=False, thread=None):
        """Replace ``owner.attr`` by a timed wrapper.  A call made
        inside another call of the same stage (the batcher's K-batch
        assembly falls back to the single one) counts once, in the
        outer call; with ``skip_none`` a call that returns None (an
        idle poll of the batcher) is not recorded, and with ``thread``
        only calls on threads whose name starts with it are."""
        import threading

        fn = getattr(owner, attr)
        times, depth = self.times[name], self._depth

        def timed(*args, **kwargs):
            if thread is not None and not (
                    threading.current_thread().name.startswith(thread)):
                return fn(*args, **kwargs)
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
            out[name] = {"thread": self.threads[name], "calls": len(v),
                         "median_ms": statistics.median(v) if v else None,
                         "total_ms": sum(v),
                         "share": sum(v) / 1e3 / seconds}
        return out


DB_IP = "10.0.0.5"
DB_IP6 = "fd00::5"  # db's address for config #2's IPv6 flows


def config3_world(d, world, extra_rules=(), v6_pods=0):
    """BASELINE.md config #3 into daemon ``d`` through its own API: the
    remote identities and their /32s, the world's rules (with its L7
    HTTP rule) and ``extra_rules`` in one import, the ``db`` endpoint.
    With ``v6_pods``, the first that many of the world's IPv6 pods too
    (their identities in the namespace and /128s, as ``build_world``
    gives them) and db gets ``DB_IP6`` beside ``DB_IP``.  Returns the db
    endpoint."""
    from cilium_tpu_torch.labels import LabelSet
    from cilium_tpu_torch.testing import fixtures as fx

    # the remote identities and their /32s, all before start() and
    # before any endpoint: the allocator hook only clears the cache
    for i, ip in enumerate(world.pod_ips):
        ident = d.allocator.allocate(
            LabelSet.parse(f"k8s:app=svc{i}", "k8s:ns=default"))
        d.ipcache.upsert(ip + "/32", ident.numeric_id, source="k8s")
    for i, ip in enumerate(world.pod_ips6[:v6_pods]):
        ident = d.allocator.allocate(
            LabelSet.parse(f"k8s:app=v6svc{i}", "k8s:ns=default"))
        d.ipcache.upsert(ip + "/128", ident.numeric_id, source="k8s")
    d.policy_import(fx.world_rules(len(world.pod_ips), 64)
                    + list(extra_rules))
    return d.add_endpoint("db", (DB_IP, DB_IP6) if v6_pods else (DB_IP,),
                          ["k8s:app=db"])


def config3_daemon(world, rng, v6_pods=0, **config):
    """BASELINE.md config #3 through the daemon's own API (phase 7's
    world: the remote identities and their /32s, the world's rules with
    its L7 HTTP rule, the ``db`` endpoint; ``v6_pods`` as
    :func:`config3_world`) and 2^21 rows of steady traffic into db: a
    pool of SYNs, then 7 steady draws from it.  ``config`` adds
    DaemonConfig knobs.  Returns (daemon, db endpoint, rows)."""
    import numpy as np
    from cilium_tpu_torch.agent import Daemon, DaemonConfig
    from cilium_tpu_torch.core.packets import (COL_DST_IP3, COL_EP,
                                               ip_to_words)
    from cilium_tpu_torch.testing import fixtures as fx

    cfg = DaemonConfig(**{
        "ct_capacity": CT_CAPACITY, "serving_packed_ingest": True,
        "serving_superbatch_k": 4, "serving_queue_depth": 1 << 19,
        "ct_gc_interval": 0.5, "map_pressure_interval": 0.5, **config})
    d = Daemon(cfg)
    db = config3_world(d, world, v6_pods=v6_pods)
    per = (1 << 21) // 8
    pool = fx.steady_flow_pool(world, per, rng)
    rows = np.concatenate([pool] + [fx.steady_traffic(pool, per, rng)
                                    for _ in range(7)])
    rows[:, COL_EP] = db.id
    rows[:, COL_DST_IP3] = ip_to_words(DB_IP)[3]
    return d, db, rows


def fixed_batch_metrics(d, db, rows):
    """The per-reason metrics of ``rows`` (db's steady traffic) through
    ``TorchLoader.serve_packed`` in 8 fixed batches on the tables daemon
    ``d`` compiled: the daemon's yardstick for forward-only traffic,
    whose per-reason counts do not depend on batch boundaries."""
    from cilium_tpu_torch.core.packets import pack_rows
    from cilium_tpu_torch.datapath.loader import TorchLoader
    from cilium_tpu_torch.labels import LabelSet
    from cilium_tpu_torch.monitor.ring import EventRing

    per = len(rows) // 8
    fl = TorchLoader(ct_capacity=CT_CAPACITY)
    fl.attach([d.repo.resolve(LabelSet.parse("k8s:app=db"))],
              d.ipcache.to_identity_map(), {db.id: 0}, d.endpoints.row_map)
    fring = EventRing.create(RING_CAPACITY)
    for b in range(0, len(rows), per):
        fring, _ = fl.serve_packed(fring, pack_rows(rows[b:b + per]), 1,
                                   b // per, db.id, 0)
    return fl.metrics()


def serve_session(d, rows, clock=None, during=None, mesh=None):
    """One serving session of ``d`` (ingress, packed, K = 4): a producer
    thread submits ``rows`` in chunks of four top buckets, holding back
    while the rows admitted but not yet verdicted would leave no room
    for a chunk (a closed loop: nothing sheds), then stop_serving().  A
    :class:`StageClock` times the stages on the daemon's threads;
    ``during`` is entered around the producer (the churn thread);
    ``mesh`` serves sharded over that many shards (phase 15).
    Returns (stop_serving's result, seconds from the first submit)."""
    import contextlib
    import threading

    chunk = 4 * d.config.serving_bucket_ladder[-1]
    depth = d.config.serving_queue_depth
    if clock is not None:
        clock.before_start(d)
    d.start_serving(ring_capacity=RING_CAPACITY, ingress=True,
                    packed=True, superbatch_k=4, mesh=mesh)
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

    with during if during is not None else contextlib.nullcontext():
        t0 = time.monotonic()
        producer = threading.Thread(target=produce, name="smoke-producer")
        producer.start()
        producer.join(timeout=600)
        check(not producer.is_alive(), "daemon: the producer did not finish")
    out = d.stop_serving()
    if clock is not None:
        clock.unwrap(d)
    return out, time.monotonic() - t0


def time_k9_at_daemon_shape(torch, d, rows, launches):
    """K9 as the daemon's L7 plane launched it: its rows a launch (the
    kernel's row counter over its launches), timed at that many
    requests (GET and POST) against the daemon's own compiled rule table
    (config #3's one HTTP rule).  -> {rows, launches, rows a launch, ms, rules}."""
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.proxy.featurize import (featurize_http,
                                                  path_prefix_hashes)
    from cilium_tpu_torch.proxy.l7policy import l7_verdict

    per = rows / max(launches, 1)
    n_req = max(1, round(per))
    b = d.proxy._bundle
    reqs = [{"method": "GET" if i % 2 else "POST", "path": f"/v{i}",
             "host": "db"} for i in range(n_req)]
    feat, raw = featurize_http(reqs, 80)
    q = u32.from_numpy(feat, "cuda")
    p = None
    if b.tensors.n_prefix:
        p = u32.from_numpy(path_prefix_hashes(
            [r["path"] for r in raw], b.tensors.prefix_lengths), "cuda")
    ms = device_ms(lambda: l7_verdict(b.rules, q, p, b.lens,
                                      rule_cols=b.cols), 20)
    n_rules = int(b.tensors.rules.shape[0])
    k = len(b.tensors.prefix_lengths)
    # phase_l7's count: each request row, its prefix hashes and verdict
    # once, the rules and their prefix columns once
    b_ms, b_by = bound(n_req * (32 + 8 * k + 1) + n_rules * (28 + 8),
                       n_req * n_rules * 16)
    print(f"daemon K9: {launches} launches took {rows} rows, {per:.2f} "
          f"a launch; K9 at {n_req} requests x {n_rules} rule(s) "
          f"(config #3's table): {ms:.4f} ms, bound {b_ms:.3g} ms by "
          f"{b_by}")
    return {"rows": rows, "launches": launches, "rows_per_launch": per,
            "timed_rows": n_req, "rules": n_rules, "ms": ms,
            "bound_ms": b_ms}


def phase_daemon(torch, rng, world, report):
    """BASELINE.md config #3 through the daemon's own API, served
    through its ingress front end; returns (launches, rung)."""
    import numpy as np
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts
    from cilium_tpu_torch.monitor.ring import _gather_rung

    t0 = time.monotonic()
    d, db, rows = config3_daemon(world, rng)
    t_build = time.monotonic() - t0
    print(f"daemon: {len(world.pod_ips)} identities, "
          f"{d.endpoints.regenerations} regenerations, built through the "
          f"API in {t_build:.1f} s")
    per = len(rows) // 8

    def serve(rows, clock=None):
        return serve_session(d, rows, clock)

    reset_launch_counts()
    d.start()
    out, t_serve = serve(rows)
    launches = {k: v.launches for k, v in KERNELS.items()}
    k9_rows = KERNELS["l7_verdict"].rows
    report["daemon_rows"] = {}
    rows_a_launch("daemon", report["daemon_rows"])
    fe = out["front-end"]
    ft = fe["fault-tolerance"]
    check(fe["submitted"] == fe["verdicts"] + fe["shed"]
          + ft["recovery-dropped"], f"daemon: ledger broken: {fe}")
    check(fe["verdicts"] == len(rows) and ft["recovery-dropped"] == 0,
          f"daemon: {fe['verdicts']} verdicts of {len(rows)}")
    check(out["lost"] == 0 and out["events"] > 0,
          f"daemon: {out['events']} events, {out['lost']} lost")
    # the flow analytics are on by default: every event was offered,
    # and the card's joined batches were read (the duty governor may
    # cut every one of this session's 2^16-event batches part way, so
    # none need count as ingested whole)
    a7 = analytics_ledger(d, "daemon")
    check(a7["enabled"] and a7["batches-submitted"] > 0
          and a7["packets-seen"] > 0,
          f"daemon: the flow analytics aggregated nothing: {a7}")
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
    ev7 = out["event-plane"]
    check(ev7["windows-dropped"] == 0,
          f"daemon: the event plane dropped windows: {ev7}")
    print(f"daemon events: {out['windows']} windows, {out['events']} "
          f"events, lost {out['lost']}, {ev7['windows-dropped']} windows "
          f"dropped (join lag p99 {ev7['join-lag-us']['p99']:.0f} us); "
          f"dispatches "
          f"{fe['dispatch']['dispatches']} for {fe['batches']} batches "
          f"({fe['dispatch']['superbatches']} superbatches)")
    print(f"daemon verdicts/s: {len(rows) / t_serve:.0f} ({len(rows)} "
          f"packets submit -> stop_serving in {t_serve:.3f} s, host clock)")
    print(f"daemon flow analytics: batches submitted "
          f"{a7['batches-submitted']} = ingested {a7['batches-ingested']} "
          f"+ dropped {a7['batches-dropped']}; {a7['packets-seen']} "
          f"packets aggregated, {a7['windows-closed']} windows closed")
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
    k9 = time_k9_at_daemon_shape(torch, d, k9_rows,
                                 launches["l7_verdict"])

    # the same rows through TorchLoader.serve_packed in fixed batches,
    # on the tables the daemon compiled (forward-only traffic: the
    # per-reason counts do not depend on batch boundaries)
    m_daemon = d.loader.metrics()
    m_fixed = fixed_batch_metrics(d, db, rows)
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
    # the flow analytics on and off in turns, on the same traffic
    turns7 = analytics_turns(d, rows)
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
    k7 = time_gc_on_daemon(torch, d)
    k8 = time_occupied_on_daemon(torch, d)
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
        "l7": l7, "launches": launches, "k9": k9,
        "pressure_sample": sample, "k7_daemon_table": k7,
        "k8_daemon_table": k8,
        "evicted_at_end": evicted, "metrics": m_daemon.tolist(),
        "analytics": a7, "analytics_turns": turns7,
        "stages": {"seconds": t_st, "packets": len(rows) - per,
                   "front_end": fe_st, "l7": out_st["l7"],
                   "by_stage": stages},
        "profiled": {"seconds": t_prof, "packets": len(rows) - per,
                     "device_busy_ms": busy_us / 1e3,
                     "front_end": fe2, "event_plane": out2["event-plane"],
                     "device_ms_by_name": by_name}}
    return launches, rung


def time_gc_on_daemon(torch, d):
    """K7 on the daemon's own CT at a sweep (its clock now), each call on
    a copy: bit-exact with its plain version (table, fingerprints,
    count), one kernel a call; -> {ms, occupied, evicted, now}."""
    import functools

    from cilium_tpu_torch.datapath import conntrack as ct

    base, now = d.loader.state.ct, d._now()

    def fresh():
        return ct.CTTable(base.table.clone(), base.fp.clone(),
                          base.dropped.clone())

    tabs = [fresh(), fresh()]
    n_k = ct.ct_gc(tabs[0], now)
    n_p = ct.ct_gc_plain(tabs[1], now)
    max_abs_err(n_k.reshape(-1), n_p.reshape(-1).to(n_k.dtype),
                "daemon: ct_gc count on its own table")
    max_abs_err(tabs[0].table, tabs[1].table, "daemon: ct_gc table")
    max_abs_err(tabs[0].fp, tabs[1].fp, "daemon: ct_gc fp")
    one_kernel_a_call(lambda: functools.partial(ct.ct_gc, fresh(), now),
                      "ct_gc_kernel", "daemon: ct_gc")
    ms = device_ms(lambda w: ct.ct_gc(w, now), 20, fresh)
    res = {"ms": ms, "occupied": int((base.fp != 0).sum()),
           "evicted": int(n_k.sum()), "now": now}
    print(f"daemon: K7 on its own CT ({res['occupied']} of "
          f"{base.fp.shape[0]} slots occupied, {res['evicted']} expired at "
          f"now={now}): bit-exact with its plain version, one kernel, "
          f"{ms:.4f} ms")
    return res


def time_occupied_on_daemon(torch, d):
    """K8 on the daemon's own fingerprints, as its map-pressure
    controller samples them: equal to its plain version, one kernel a
    call and no memset; -> {ms, occupied}."""
    import functools

    from cilium_tpu_torch.datapath.loader import (_ct_occupied,
                                                  _ct_occupied_plain)

    fp = d.loader.state.ct.fp
    got, want = int(_ct_occupied(fp).sum()), int(_ct_occupied_plain(fp))
    check(got == want, f"daemon: ct_occupied {got}, plain {want}")
    one_kernel_a_call(lambda: functools.partial(_ct_occupied, fp),
                      "ct_occupied_kernel", "daemon: ct_occupied")
    ms = device_ms(lambda: _ct_occupied(fp), 20)
    print(f"daemon: K8 on its own CT ({got} of {fp.shape[0]} slots "
          f"occupied): equal to its plain version, one kernel, "
          f"{ms:.4f} ms")
    return {"ms": ms, "occupied": got}


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
    """Poll ``pred`` until it holds; past ``timeout`` fail, naming
    ``what`` (a string, or a callable that describes the state then)."""
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 >= timeout:
            raise SmokeFailure(f"timed out waiting for "
                               f"{what() if callable(what) else what}")
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
        # a leg dispatches its batches back to back with no runtime to
        # pace it: the event plane's window queue holds a whole leg's
        # windows (the default 4 dropped one when the join worker
        # lagged, ROADMAP C5)
        d = Daemon(DaemonConfig(ct_capacity=1 << 16,
                                serving_bucket_ladder=(batch,),
                                serving_queue_depth=1 << 14,
                                serving_window_queue_depth=iters + 2))
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
        # serve_batch hands a window to the event plane only at the
        # next dispatch: tick now, so every row sent is submitted (no
        # runtime runs here, so no idle tick comes by itself).  Both
        # legs pay the tick
        s = d._serving
        handover.append((key, s["seq"] - s["last_tick"],
                         s["eventplane"].stats()["windows-pending"]))
        d._serving_event_idle_tick()
        if key == "redir":
            # the candidate pays its detour in full: every redirect
            # ingested and handled by the pool.  The wait depends only
            # on windows already submitted; a window the event plane
            # dropped fails here, not at the timeout
            want, pool = sent[key], d._l7plane.pool
            ep = s["eventplane"]
            wait_for(lambda: (pool.stats()["redirected"] >= want
                              and pool.pending == 0)
                     or ep.stats()["windows-dropped"] > 0,
                     lambda: f"the redirect leg's pool ({want} rows "
                     f"sent; the plane's stats {d._l7plane.stats()}; "
                     f"the event plane's {ep.stats()})")
            check(ep.stats()["windows-dropped"] == 0,
                  f"redirect phase: the event plane dropped a window: "
                  f"{ep.stats()}")
        return batch * iters / (time.perf_counter() - t0)

    reset_launch_counts()
    pairs, best = [], {"base": 0.0, "redir": 0.0}
    # per leg: batches not yet handed to the event plane, and windows
    # still queued or joining, when the leg's last dispatch returned
    handover = []
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
    evp = {k: {f: outs[k]["event-plane"][f]
               for f in ("windows-submitted", "windows-dropped",
                         "queue-overflows", "join-lag-us")}
           for k in legs}
    print(f"l7 redirect hand-over at each leg's end (leg, batches not "
          f"yet submitted, windows pending): {handover}; event planes "
          f"{evp}")
    report["l7_redirect"] = {"pairs": pairs, "ratio_median":
                             st.median(pairs), "best_pps": best,
                             "batch": batch, "iters": iters, "l7": l7,
                             "handover": handover, "event_planes": evp}
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
    identity (in-place patches, timed to the flip; no attach, no
    regeneration), the next probes are allowed.  Returns the launch
    counts of the session."""
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
    tables0 = d.loader.table_stats()
    t0 = time.perf_counter()
    d.submit(syn_rows(client_ip, "8.8.8.8", 20000, n, 53, client.id, 1,
                      proto=17))
    # the mint publishes two patches: its verdict row, then its /32
    wait_for(lambda: d.loader.table_stats()["patches"]
             >= tables0["patches"] + 2 and d._l7plane.pool.pending == 0,
             "the mint's patches")
    t_flip = time.perf_counter() - t0
    tables1 = d.loader.table_stats()
    check(d.loader.attach_count == attaches and len(regen) == n_regen,
          f"fqdn: the mint re-attached ({d.loader.attach_count - attaches}"
          f" attaches, {len(regen) - n_regen} regenerations)")
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
    check(launches["dus"] > 0, "fqdn: the mint never launched dus")
    n_patches = tables1["patches"] - tables0["patches"]
    print(f"fqdn flip: probes {sorted(pre)} before the mint, {sorted(post)} "
          f"after; mint to flip {t_flip:.4f} s (host clock, DNS batch "
          f"submit to the patched tables), {n_patches} patches (generation "
          f"{tables0['generation']} -> {tables1['generation']}), "
          f"{launches['dus']} dus launches, no attach, no regeneration")
    report["fqdn"] = {"dns_to_flip_s": t_flip, "tables_before": tables0,
                      "tables_after": tables1, "l7": l7,
                      "launches": launches}
    return launches


def churn_tables(loader):
    """A loader's published tables on the host: verdict, auth, the LPM
    and its entry mirror."""
    p, l = loader.state.policy, loader.state.ipcache
    return {k: t.cpu() for k, t in (("verdict", p.verdict), ("auth", p.auth),
                                    ("l1", l.l1), ("l2", l.l2),
                                    ("l3", l.l3))}


def phase_churn(torch, rng, world, report):
    """Identity and ipcache churn at full width: config #3's daemon
    serves the phase 7 traffic in a warm-up session, then four sessions,
    base / churn / churn / base; in the churn sessions a churn thread runs
    ``IdentityChurnScenario`` at 200 ops/s (a mint is patch_identity +
    patch_ipcache, a withdraw delete_ipcache + patch_identity), every
    op on the patch path.  A 64th of the steady rows are fresh SYNs from
    the churn slots to db:5432, which the world's ns=default rule admits
    from a live slot's identity and which drop from a dead slot's
    address, so their verdicts follow the patches in serve order: every
    such row yields one event, no batch mixes a slot's allowed and
    dropped rows, and in the sessions without churn each slot's rows
    all carry the verdict (and identity) of its published state.  The
    ledgers stay exact, no attach and no regeneration happen, and
    afterwards the patched tables equal a full attach of the same world
    (verdict and auth bit for bit, the LPM by lookups over every
    programmed prefix and its neighbours).  Returns the launch counts
    of the churn sessions."""
    import contextlib
    import threading

    import numpy as np
    from cilium_tpu_torch.convert import lpm_probe_ips
    from cilium_tpu_torch.core import packets as pk
    from cilium_tpu_torch.datapath.conntrack import CT_NEW
    from cilium_tpu_torch.datapath.loader import TorchLoader
    from cilium_tpu_torch.datapath.lpm import lookup_v4
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts
    from cilium_tpu_torch.labels import LabelSet
    from cilium_tpu_torch.monitor.api import MSG_DROP
    from cilium_tpu_torch.serving.stats import LatencyHistogram
    from cilium_tpu_torch.testing.workloads import IdentityChurnScenario

    t0 = time.monotonic()
    d, db, rows = config3_daemon(world, rng)
    d.start()
    print(f"churn: config #3 daemon built in {time.monotonic() - t0:.1f} s")
    sc = IdentityChurnScenario(seed=20261017, n_slots=16, rate_hz=200.0)
    ops, live, op_s = iter(sc.iter_ops()), {}, []

    # the slot probes: a 64th of the steady rows (after the SYN pool)
    # become SYNs from the churn slots to db:5432; each session gives
    # them fresh sports so that policy, not CT, decides every one
    n_probe = len(rows) // 64
    at = np.sort(rng.choice(np.arange(len(rows) // 8, len(rows)), n_probe,
                            replace=False))
    slot_of = rng.integers(0, sc.n_slots, n_probe)
    slot_words = np.array([pk.ip_to_words(sc.slot_ip(s))[3]
                           for s in range(sc.n_slots)], np.uint32)
    rank = np.zeros(n_probe, np.int64)
    for s in range(sc.n_slots):
        rank[slot_of == s] = np.arange(int((slot_of == s).sum()))
    span = int(rank.max()) + 1
    check(1024 + 5 * span <= 1 << 16, f"churn: {span} sports a slot")
    rows[at] = 0
    rows[at, pk.COL_SRC_IP3] = slot_words[slot_of]
    rows[at, pk.COL_DST_IP3] = pk.ip_to_words(DB_IP)[3]
    rows[at, pk.COL_DPORT] = 5432
    rows[at, pk.COL_PROTO] = 6
    rows[at, pk.COL_FLAGS] = pk.TCP_SYN
    rows[at, pk.COL_LEN] = 64
    rows[at, pk.COL_FAMILY] = 4
    rows[at, pk.COL_EP] = db.id
    probes = []  # (src word, dropped, identity, ct state, batch) per leg
    mixed = []  # (leg, slot word) of a batch with both verdicts

    def watch(batch):
        """Monitor consumer (the event worker): the slot probes' events
        of one device batch."""
        h = batch.hdr
        m = (np.isin(h[:, pk.COL_SRC_IP3], slot_words)
             & (h[:, pk.COL_FAMILY] == 4) & (h[:, pk.COL_DPORT] == 5432))
        if not m.any():
            return
        src, drop = h[m, pk.COL_SRC_IP3], batch.msg_type[m] == MSG_DROP
        for w in np.unique(src):
            k = drop[src == w]
            if k.any() and not k.all():
                mixed.append((len(probes), int(w)))
        probes[-1].append((src, drop, batch.identity[m], batch.ct_state[m]))

    def check_probes(leg, churned):
        """Every probe of the session gave one event of a new flow; in a
        session without churn each slot's rows carry its published
        verdict: allowed with the live identity, or dropped."""
        got = probes[-1]
        src, drop, ident, ct = (np.concatenate([g[i] for g in got])
                                if got else np.zeros(0, np.uint32)
                                for i in range(4))
        check(len(src) == n_probe and (ct == CT_NEW).all(),
              f"churn: the {leg} session gave {len(src)} probe events of "
              f"{n_probe}, {int((ct != CT_NEW).sum())} not new")
        check(not mixed, f"churn: a batch mixed a slot's verdicts: {mixed}")
        if not churned:
            for s in range(sc.n_slots):
                k = src == slot_words[s]
                if s in live:
                    ok = ((~drop[k]).all()
                          and (ident[k] == live[s].numeric_id).all())
                else:
                    ok = drop[k].all()
                check(ok,f"churn: the {leg} session served slot {s} "
                      f"({'live' if s in live else 'dead'}) "
                      f"{int(drop[k].sum())} drops of {int(k.sum())}")
        return int((~drop).sum()), int(drop.sum())

    d.monitor.register("smoke-churn", watch)

    @contextlib.contextmanager
    def churning():
        """The churn thread, on the scenario's clock, for as long as the
        producer runs; each op timed from its start to its last
        publish (op to visible)."""
        stop = threading.Event()
        errors = []

        def drive():
            try:
                t_next = time.monotonic()
                while not stop.is_set():
                    op = next(ops)
                    t = time.perf_counter()
                    sc.apply(d, op, live)
                    op_s.append(time.perf_counter() - t)
                    t_next += sc.interval_s
                    time.sleep(max(0.0, t_next - time.monotonic()))
            except Exception as e:  # noqa: BLE001 -- reported below
                errors.append(e)

        churner = threading.Thread(target=drive, name="smoke-churn")
        churner.start()
        try:
            yield
        finally:
            stop.set()
            churner.join(timeout=120)
        check(not churner.is_alive() and not errors,
              f"churn: the churn thread failed: {errors}")

    attaches, regens = d.loader.attach_count, d.endpoints.regenerations
    tables0 = d.loader.table_stats()
    stall0 = list(d.loader.tables.swap_stall.buckets)
    visible0 = list(d.loader.tables.update_visible.buckets)
    rates, launches, churn_s = {"warm-up": [], "base": [], "churn": []}, \
        None, 0.0
    # a warm-up session first: the SYN pool's flows then stand in CT,
    # so the four sessions compared serve the same steady traffic
    probe_counts = {"warm-up": [], "base": [], "churn": []}
    for i, leg in enumerate(("warm-up", "base", "churn", "churn", "base")):
        rows[at, pk.COL_SPORT] = 1024 + i * span + rank
        probes.append([])
        if leg == "churn" and launches is None:
            reset_launch_counts()
        out, t = serve_session(d, rows, during=(
            churning() if leg == "churn" else None))
        if leg == "churn" and launches is None:
            launches = {k: v.launches for k, v in KERNELS.items()}
        fe, ft = out["front-end"], out["front-end"]["fault-tolerance"]
        check(fe["submitted"] == fe["verdicts"] + fe["shed"]
              + ft["recovery-dropped"] and fe["verdicts"] == len(rows)
              and out["lost"] == 0 and out["l7"]["ledger-exact"],
              f"churn: the {leg} session's ledgers: {fe}, lost "
              f"{out['lost']}, l7 {out['l7']}")
        rates[leg].append(len(rows) / t)
        probe_counts[leg].append(check_probes(leg, leg == "churn"))
        if leg == "churn":
            churn_s += t
    check(probe_counts["warm-up"] == [(0, n_probe)]
          and all(a > 0 and b > 0 for a, b in probe_counts["churn"]),
          f"churn: probes (allowed, dropped) a session {probe_counts}")
    tables1 = d.loader.table_stats()
    check(d.loader.attach_count == attaches
          and d.endpoints.regenerations == regens,
          f"churn: {d.loader.attach_count - attaches} attaches and "
          f"{d.endpoints.regenerations - regens} regenerations under churn")
    n_ops = len(op_s)
    check(n_ops > 0 and tables1["patches"] > tables0["patches"]
          and launches["dus"] > 0,
          f"churn: {n_ops} ops, {tables1['patches']} patches, launches "
          f"{launches}")

    def delta(hist, before):
        h = LatencyHistogram()
        h.buckets = [a - b for a, b in zip(hist.buckets, before)]
        h.count, h.max_us = sum(h.buckets), hist.max_us
        return h.snapshot()

    stall = delta(d.loader.tables.swap_stall, stall0)
    visible = delta(d.loader.tables.update_visible, visible0)
    op_ms = np.percentile(np.array(op_s) * 1e3, [50, 99])
    # the patched tables against a full attach of the same world: the
    # db policy resolved afresh, the daemon's ipcache and row map
    d.repo.invalidate_cache()
    fl = TorchLoader(ct_capacity=1 << 4, device=d.loader.device)
    fl.attach([d.repo.resolve(LabelSet.parse("k8s:app=db"))],
              d.ipcache.to_identity_map(), {db.id: 0}, d.endpoints.row_map)
    got, want = churn_tables(d.loader), churn_tables(fl)
    for k in ("verdict", "auth"):
        check(torch.equal(got[k], want[k]),
              f"churn: the patched {k} differs from a full attach")
    check(d.loader._lpm_entries == fl._lpm_entries,
          "churn: the ipcache mirror differs from a full attach")
    ips = torch.from_numpy(lpm_probe_ips(fl._lpm_entries).view(np.int32))
    hits = [lookup_v4(t["l1"], t["l2"], t["l3"], ips) for t in (got, want)]
    check(torch.equal(hits[0], hits[1]),
          f"churn: LPM lookups differ from a full attach at "
          f"{int((hits[0] != hits[1]).sum())} of {len(ips)} probes")
    d.shutdown()
    base, churn = (float(np.median(rates[k])) for k in ("base", "churn"))
    print(f"churn: {n_ops} ops ({n_ops / churn_s:.1f}/s of the "
          f"{sc.rate_hz:.0f}/s asked) over {sc.n_slots} "
          f"slots during 2 sessions of {len(rows)} packets; "
          f"{tables1['patches'] - tables0['patches']} patches, generation "
          f"{tables0['generation']} -> {tables1['generation']}, "
          f"{launches['dus']} dus launches; no attach, no regeneration")
    print(f"churn: op to visible p50 {op_ms[0]:.3f} ms, p99 "
          f"{op_ms[1]:.3f} ms (host clock); per publish update-visible "
          f"p50 {visible['p50']:.1f} us, p99 {visible['p99']:.1f} us, "
          f"swap stall p99 {stall['p99']:.1f} us")
    print(f"churn: daemon verdicts/s without churn "
          f"{', '.join(f'{x:.0f}' for x in rates['base'])}, with churn "
          f"{', '.join(f'{x:.0f}' for x in rates['churn'])} (sessions "
          f"base, churn, churn, base); churn/base medians "
          f"{churn / base:.4f}")
    print(f"churn: {n_probe} slot probes a session, (allowed, dropped) "
          f"{probe_counts}; no batch mixed a slot's verdicts, and "
          f"without churn every slot served its published verdict")
    print(f"churn: the patched tables equal a full attach of the same "
          f"world (verdict {tuple(got['verdict'].shape)} and auth bit for "
          f"bit, LPM over {len(ips)} probes, "
          f"{len(fl._lpm_entries)} prefixes)")
    report["churn"] = {
        "ops": n_ops, "rate_hz": sc.rate_hz, "ops_per_s": n_ops / churn_s,
        "slots": sc.n_slots,
        "packets": len(rows), "verdicts_per_s": rates,
        "churn_over_base": churn / base,
        "op_to_visible_ms": {"p50": op_ms[0], "p99": op_ms[1]},
        "update_visible_us": visible, "swap_stall_us": stall,
        "tables_before": tables0, "tables_after": tables1,
        "probes": {"per_session": n_probe, "allowed_dropped": probe_counts},
        "launches": launches}
    return launches


N_CLIENTS = 128  # client pods, two namespaces of 64
EGRESS_BATCHES = 8
FRESH = 1280  # new flows a batch
CLIENT_RULE = {"endpointSelector": {"matchLabels": {"app": "client"}},
               "egress": [{"toEntities": ["world"]},
                          {"toEndpoints": [{}]}]}


def egress_daemon(world, rng):
    """Config #3's world (config3_world) with masquerade to a node IP,
    the default pool and the default non-masquerade 10.0.0.0/8, plus 128
    client pods (team-a and team-b, 64 each) whose rule lets them reach
    the world and the cluster; an egress-gateway policy on team-b toward
    93.184.0.0/16, and per-pod egress limits on team-a's 64.  Returns
    (daemon, clients, rates)."""
    from cilium_tpu_torch.agent import Daemon, DaemonConfig
    from cilium_tpu_torch.labels import LabelSet
    from cilium_tpu_torch.testing import egress as eg

    d = Daemon(DaemonConfig(ct_capacity=CT_CAPACITY, masquerade=True,
                            node_ip=eg.NODE_IP))
    config3_world(d, world, extra_rules=[CLIENT_RULE])
    clients = [d.endpoints.add(
        f"client{i}", (f"10.250.{i // 200}.{i % 200 + 1}",),
        LabelSet.parse("k8s:app=client",
                       f"k8s:ns={'team-a' if i < 64 else 'team-b'}"),
        defer_regen=True) for i in range(N_CLIENTS)]
    d.endpoints.regenerate()
    d.add_egress_gateway("team-b", {"matchLabels": {"ns": "team-b"}},
                         ["93.184.0.0/16"], eg.EGRESS_IP)
    # a team-a pod sends ~6 B a batch row (~400 KB a 2^16-row batch):
    # limits of 1.5-3 B a row keep about half of it
    rates = {}
    for ep in clients[:64]:
        rates[ep.id] = int(rng.integers(EGRESS_N * 3 // 2, EGRESS_N * 3))
        d.set_bandwidth(ep.id, rates[ep.id])
    return d, clients, rates


def egress_batch(rng, clients, flows, b, prev):
    """One 2^16-row batch of phase 11 and the new flows it opens:
    FRESH new TCP/UDP flows from the clients to the world; repeats of
    the flows opened in this batch or the one before (so a flow lives
    two batches, and its UDP mapping then expires); replies to the node
    and gateway ports the previous batch allocated; the rest
    cluster-internal, client to client.  ``flows`` is [F, N_COLS]
    (pre-NAT rows); ``prev`` (rows, events) of the previous batch."""
    import numpy as np
    from cilium_tpu_torch.core.packets import (COL_DIR, COL_DPORT,
                                               COL_DST_IP3, COL_EP,
                                               COL_FAMILY, COL_FLAGS,
                                               COL_LEN, COL_PROTO,
                                               COL_SPORT, COL_SRC_IP3,
                                               N_COLS, TCP_ACK, TCP_SYN)
    from cilium_tpu_torch.service.nat import NAT_PORT_MIN
    from cilium_tpu_torch.testing import egress as eg

    ids = np.array([c.id for c in clients], np.uint32)
    ips = np.array([eg.ip(c.ips[0]) for c in clients], np.uint32)
    pick = rng.integers(0, len(clients), FRESH)
    new = np.zeros((FRESH, N_COLS), np.uint32)
    new[:, COL_SRC_IP3], new[:, COL_EP] = ips[pick], ids[pick]
    # team-b's flows toward 93.184/16 take the gateway
    new[:, COL_DST_IP3] = np.where(
        rng.random(FRESH) < 0.5, eg.ip("93.184.0.0") + rng.integers(
            1, 1 << 16, FRESH), eg.ip("151.101.0.0") + rng.integers(
            1, 1 << 16, FRESH))
    new[:, COL_SPORT] = 20000 + (b * FRESH + np.arange(FRESH)) % 40000
    new[:, COL_DPORT] = rng.choice(np.array([443, 53, 123], np.uint32),
                                   FRESH)
    new[:, COL_PROTO] = np.where(rng.random(FRESH) < 0.6, 6, 17)
    new[:, COL_FLAGS] = TCP_SYN
    new[:, COL_LEN] = rng.integers(60, 1500, FRESH)
    new[:, COL_FAMILY], new[:, COL_DIR] = 4, 1
    live = np.concatenate([flows, new])
    n_rep, n_reply = EGRESS_N // 2, EGRESS_N // 4
    rep = live[rng.integers(0, len(live), n_rep)].copy()
    rep[:, COL_FLAGS] = TCP_ACK
    rep[:, COL_LEN] = rng.integers(60, 1500, n_rep)
    parts = [new, rep]
    if prev is not None:
        rows_p, ev = prev
        ok = np.flatnonzero((rows_p[:, COL_DIR] == 1) & (ev.reason == 0)
                            & (ev.hdr[:, COL_SRC_IP3]
                               != rows_p[:, COL_SRC_IP3])
                            & (ev.hdr[:, COL_SPORT] >= NAT_PORT_MIN)
                            & np.isin(rows_p[:, COL_PROTO], [6, 17]))
        sel = rng.choice(ok, n_reply)
        out = ev.hdr[sel]
        reply = out.copy()
        reply[:, COL_SRC_IP3], reply[:, COL_DST_IP3] = (out[:, COL_DST_IP3],
                                                        out[:, COL_SRC_IP3])
        reply[:, COL_SPORT], reply[:, COL_DPORT] = (out[:, COL_DPORT],
                                                    out[:, COL_SPORT])
        reply[:, COL_FLAGS], reply[:, COL_DIR] = TCP_ACK, 0
        parts.append(reply)
        want = (rows_p[sel, COL_SRC_IP3], rows_p[sel, COL_SPORT])
    else:
        want = None
    n_int = EGRESS_N - sum(len(p) for p in parts)
    a, c = rng.integers(0, len(clients), n_int), rng.integers(
        0, len(clients), n_int)
    internal = np.zeros((n_int, N_COLS), np.uint32)
    internal[:, COL_SRC_IP3], internal[:, COL_EP] = ips[a], ids[a]
    internal[:, COL_DST_IP3] = ips[c]
    internal[:, COL_SPORT] = rng.integers(1024, 65535, n_int)
    internal[:, COL_DPORT], internal[:, COL_PROTO] = 8080, 6
    internal[:, COL_FLAGS] = TCP_SYN
    internal[:, COL_LEN] = rng.integers(60, 1500, n_int)
    internal[:, COL_FAMILY], internal[:, COL_DIR] = 4, 1
    parts.append(internal)
    rows = np.concatenate(parts)
    return rows, new, want


def phase_egress(torch, rng, world, report):
    """The offline egress path at full width: config #3's world with
    masquerade, an egress gateway and bandwidth limits
    (``egress_daemon``), driven through ``Daemon.process_batch`` in
    EGRESS_BATCHES batches of 2^16 rows 60 s apart (``egress_batch``),
    then a short exhaustion leg at ``NatExhaustionScenario``'s shape.
    Returns the main leg's launch counts."""
    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.agent import Daemon, DaemonConfig
    from cilium_tpu_torch.core.packets import (COL_DIR, COL_DPORT,
                                               COL_DST_IP3, COL_EP, COL_LEN,
                                               COL_PROTO, COL_SPORT,
                                               COL_SRC_IP3, N_COLS)
    from cilium_tpu_torch.datapath.verdict import (REASON_BANDWIDTH,
                                                   REASON_NAT_EXHAUSTED)
    from cilium_tpu_torch.kernels import (KERNELS, launch_snat_egress,
                                          reset_launch_counts)
    from cilium_tpu_torch.service import nat
    from cilium_tpu_torch.testing import egress as eg
    from cilium_tpu_torch.testing.workloads import (NatExhaustionScenario,
                                                    run_scenario)

    t0 = time.monotonic()
    d, clients, rates = egress_daemon(world, rng)
    t_build = time.monotonic() - t0
    print(f"egress: config #3 ({len(world.pod_ips)} identities) with "
          f"{len(clients)} client pods, masquerade to {eg.NODE_IP}, "
          f"gateway {eg.EGRESS_IP} for team-b, {len(rates)} limited pods; "
          f"{d.endpoints.regenerations} regenerations, built in "
          f"{t_build:.1f} s")
    stages = ((d.loader, "masquerade", "snat (K11)"),
              (d, "_bw_police", "bandwidth (K13)"),
              (d.loader, "step", "datapath step (K1, K4)"),
              (d.loader, "reverse_nat", "reverse NAT (K12)"),
              (d, "_finish_batch", "decode + publish"))
    clock = StageClock({name: "caller" for _o, _a, name in stages})
    for obj, attr, name in stages:
        clock.wrap(obj, attr, name)
    flows = np.zeros((0, N_COLS), np.uint32)
    prev, nat_drops, pb_s = None, 0, 0.0
    kept, avail = {e: 0 for e in rates}, {e: 0 for e in rates}
    n_replies = n_restored = 0
    now = 100
    reset_launch_counts()
    for b in range(EGRESS_BATCHES):
        rows, new, want = egress_batch(rng, clients, flows, b, prev)
        tokens = u32.to_numpy(d._bw.tokens).astype(np.int64)
        last = int(u32.to_numpy(d._bw.last))
        t1 = time.perf_counter()
        ev = d.process_batch(rows, now=now)
        pb_s += time.perf_counter() - t1
        check(len(ev) == len(rows), f"egress: {len(ev)} events for "
              f"{len(rows)} rows")
        nat_drops += int((ev.reason == REASON_NAT_EXHAUSTED).sum())
        # every reply to an allocated port gets its pod tuple back
        if want is not None:
            sl = slice(FRESH + EGRESS_N // 2, FRESH + 3 * EGRESS_N // 4)
            got = ev.hdr[sl]
            ok = (got[:, COL_DST_IP3] == want[0]) & (got[:, COL_DPORT]
                                                      == want[1])
            n_replies += len(got)
            n_restored += int(ok.sum())
            check(bool(ok.all()), f"egress: {int((~ok).sum())} replies of "
                  f"{len(got)} not translated back in batch {b}")
        # distinct pre-NAT flows never share a (rewrite IP, node port)
        alloc = ((rows[:, COL_DIR] == 1) & (ev.reason == 0)
                 & (ev.hdr[:, COL_SRC_IP3] != rows[:, COL_SRC_IP3])
                 & (ev.hdr[:, COL_SPORT] >= nat.NAT_PORT_MIN))
        post = ev.hdr[alloc][:, [COL_SRC_IP3, COL_SPORT]]
        pre = rows[alloc][:, [COL_SRC_IP3, COL_SPORT, COL_DST_IP3,
                              COL_DPORT, COL_PROTO]]
        pairs = np.unique(np.concatenate([post, pre], axis=1), axis=0)
        check(len(np.unique(pairs[:, :2], axis=0)) == len(pairs),
              f"egress: two flows share a node port in batch {b}")
        # the bucket ledger of every limited pod: exact where no row of
        # the pod dropped for NAT exhaustion, bounded where one did
        dt = min((now - last) & 0xFFFFFFFF, 1)
        after = u32.to_numpy(d._bw.tokens).astype(np.int64)
        eg_rows = rows[:, COL_DIR] == 1
        for e, r in rates.items():
            mine = eg_rows & (rows[:, COL_EP] == e)
            av = min(int(tokens[e]) + r * dt, r)
            fwd = int(rows[mine & (ev.reason == 0), COL_LEN].sum())
            lost = int(rows[mine & (ev.reason == REASON_NAT_EXHAUSTED),
                            COL_LEN].sum())
            lo, hi = max(av - fwd - lost, 0), max(av - fwd, 0)
            check(lo <= int(after[e]) <= hi,
                  f"egress: bucket of pod {e} holds {int(after[e])}, "
                  f"available {av}, forwarded {fwd}, NAT-dropped {lost}")
            kept[e] += fwd
            avail[e] += av
        flows = new
        prev = (rows, ev)
        now += 60
    launches = {k: v.launches for k, v in KERNELS.items()}
    for name in ("snat_egress", "snat_reverse", "bw_stage", "datapath_wide",
                 "ct_update"):
        check(launches[name] > 0, f"egress: {name} never launched")
    end = now - 60
    st = d.status()["nat"]
    table = d.loader.nat_snapshot()
    exp = table[:, nat.NV_EXPIRES]
    live = exp >= end
    expired = int(((exp > 0) & ~live).sum())
    keys = table[live][:, :nat.NV_EXPIRES]
    check(len(np.unique(keys, axis=0)) == int(live.sum()),
          "egress: two live slots hold one flow")
    check(st["alloc-failed"] == nat_drops,
          f"egress: failed {st['alloc-failed']} but {nat_drops} rows "
          f"dropped NAT_EXHAUSTED")
    check(expired > 0, "egress: no UDP mapping expired in the run")
    occupancy = st["live"] / st["capacity"]
    sum_kept, sum_avail = sum(kept.values()), sum(avail.values())
    # proportional policing keeps each batch's bytes near the budget (a
    # per-flow hash, not a byte-exact cut): over 64 pods and 8 batches
    # the kept bytes stay within 10% above the tokens available
    check(sum_kept <= 1.10 * sum_avail,
          f"egress: limited pods forwarded {sum_kept} bytes of "
          f"{sum_avail} available")
    m = d.loader.metrics()
    check(int(m[REASON_BANDWIDTH].sum()) > 0, "egress: nothing was policed")
    rows_total = EGRESS_BATCHES * EGRESS_N
    check(int(m.sum()) == rows_total, f"egress: metrics count {m.sum()} "
          f"of {rows_total} rows")
    stages_s = {k: sum(v) / 1e3 for k, v in clock.times.items()}
    # the rest: the rows' copy to the card and back, Python between
    stages_s["other"] = pb_s - sum(stages_s.values())
    print(f"egress: {EGRESS_BATCHES} batches of {EGRESS_N} rows through "
          f"process_batch in {pb_s:.3f} s ({rows_total / pb_s:.0f} rows/s, "
          f"host clock); stages (host s, share): " + ", ".join(
              f"{k} {v:.4f} {v / pb_s:.1%}" for k, v in stages_s.items()))
    print(f"egress: pool {st['live']} of {st['capacity']} live "
          f"({occupancy:.1%}), {expired} expired mappings, "
          f"{st['alloc-failed']} failures = {nat_drops} NAT_EXHAUSTED rows")
    print(f"egress: {n_restored} of {n_replies} replies translated back; "
          f"limited pods forwarded {sum_kept} of {sum_avail} bytes "
          f"available ({sum_kept / sum_avail:.3f}); "
          f"{int(m[REASON_BANDWIDTH].sum())} rows dropped BANDWIDTH")
    print(f"egress launches: {json.dumps(launches)}")
    # K11 at the main path's own inputs: the next batch against the
    # pool as the run left it, the CT as the loader published it and
    # the daemon's compiled gateway table, kernel and plain version each
    # on a clone of the pool (after the launch counts were read)
    rows, _new, _want = egress_batch(rng, clients, flows, EGRESS_BATCHES,
                                     prev)
    hdr = u32.from_numpy(rows, "cuda")
    live_ct = d.loader.state.ct

    def pool():
        base = d.loader.nat_state
        return nat.NATTable(base.table.clone(), base.failed.clone())

    tabs = [pool(), pool()]
    got = nat.snat_egress(tabs[0], d.nat, live_ct, hdr, now)
    want = nat.snat_egress_plain(tabs[1], d.nat, live_ct, hdr, now)
    for g, w, what in ((got[0], want[0], "rows"), (got[2], want[2], "drop"),
                       (tabs[0].table, tabs[1].table, "table"),
                       (tabs[0].failed, tabs[1].failed, "failed")):
        max_abs_err(g, w, f"egress: snat_egress {what} on the main "
                    f"path's inputs")
    n_rules = int(d.nat.egw_src.shape[0])
    k11_ms = device_ms(lambda tb: nat.snat_egress(
        tb, d.nat, live_ct, hdr, now), 20, pool)
    k11_steps, k11_tail, k11_counts = claim_steps(
        launch_snat_egress, 9, pool(), d.nat, live_ct, hdr, now)
    print(f"egress: K11 on the main path's inputs ({EGRESS_N} rows, "
          f"{n_rules} gateway rules, the live pool and CT): bit-exact "
          f"with its plain version, {k11_ms:.4f} ms; claim steps with a "
          f"row pending {k11_steps}, one block from step {k11_tail}, rows "
          f"pending entering each step {k11_counts[:8]}, failed "
          f"{k11_counts[8]}")
    # that batch under the profiler (device activity only): how busy
    # the card is while process_batch runs
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        d.process_batch(rows, now=now)
        t_prof = time.perf_counter() - t1
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith("Activity Buffer"))
    print(f"egress profiled batch: {EGRESS_N} rows in {t_prof * 1e3:.3f} "
          f"ms, device busy {busy_us / 1e3:.3f} ms "
          f"({busy_us / 1e6 / t_prof:.1%}), idle "
          f"{1 - busy_us / 1e6 / t_prof:.1%}")
    # K13 at the main path's own inputs: the next batch's rows as SNAT
    # leaves them, against the live buckets
    rows, _new, _want = egress_batch(rng, clients, flows,
                                     EGRESS_BATCHES + 1, prev)
    bw_in, _lb6_in, rev_in = stage_inputs(d, rows, now + 60)
    k13_path, k12_path = k13_on("egress", *bw_in), k12_on("egress",
                                                            *rev_in)
    d.shutdown()

    # the exhaustion leg: NatExhaustionScenario's shape on the card
    sc = NatExhaustionScenario(seed=3)
    dx = Daemon(DaemonConfig(**sc.daemon_overrides))
    res = run_scenario(dx, sc)
    check(res["passed"], f"egress: nat_exhaustion failed: {res}")
    print(f"egress exhaustion leg: {res['metrics']['submitted']} rows, "
          f"{res['metrics']['nat_failures']} NAT failures, drops by reason "
          f"{res['metrics']['drops_by_reason']}, ledger exact "
          f"{res['metrics']['ledger_exact']}")
    dx.shutdown()
    report["egress"] = {
        "build_s": t_build, "batches": EGRESS_BATCHES, "rows": rows_total,
        "process_batch_s": pb_s, "rows_per_s": rows_total / pb_s,
        "stages_s": stages_s, "nat": st, "occupancy": occupancy,
        "expired": expired, "replies": n_replies,
        "bandwidth": {"kept": sum_kept, "available": sum_avail},
        "launches": launches, "exhaustion": res["metrics"],
        "k11_main_path": {"gateway_rules": n_rules, "ms": k11_ms,
                          "claim_steps": k11_steps,
                          "tail_from_step": k11_tail,
                          "counts": k11_counts},
        "k13_main_path": k13_path, "k12_main_path": k12_path,
        "profiled": {"seconds": t_prof, "device_busy_ms": busy_us / 1e3}}
    return launches


SVC_BATCHES = 8
SVC_FRESH = 4096  # new flows a batch
SVC_BURST = 12288  # new flows of the burst batch: over CONNECT_CAP
SVC_CHANGE_AFTER = 4  # a backend leaves half the services after batch 4
LOCKED_RULE = {"endpointSelector": {"matchLabels": {"app": "locked"}},
               "egress": [{"toPorts": [{"ports": [{"port": "9",
                                                   "protocol": "TCP"}]}]}]}


def phase_service(torch, rng, world, mgr, report):
    """The service path at full width: phase 11's daemon (config #3 with
    masquerade, 128 client pods, a gateway and limits) with the service
    world of ``service_world`` installed through ``ServiceWatcher``,
    and a ``locked`` pod whose policy denies all but port 9.  A warm-up
    batch of SVC_FRESH new flows, then SVC_BATCHES batches of LB_N rows
    10 s apart through ``Daemon.process_batch``: SVC_FRESH new flows
    (half to VIPs, a tenth v6, the rest to pods) and 64 of the locked
    pod's, the rest repeating established flows; after batch
    SVC_CHANGE_AFTER a backend leaves every other service; then a burst
    batch of SVC_BURST new flows.  The daemon takes phase 3's
    ServiceManager ``mgr`` of the same world, whose filled Maglev rows
    spare a second fill; the watcher installs the world into it anew
    (which also undoes phase 3's backend change).  Returns the launch
    counts."""
    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import (COL_DPORT, COL_DST_IP0,
                                               COL_DST_IP3, COL_EP,
                                               COL_FAMILY, COL_PROTO,
                                               COL_SPORT, COL_SRC_IP3,
                                               ip_to_words)
    from cilium_tpu_torch.datapath.verdict import REASON_NO_SERVICE
    from cilium_tpu_torch.k8s.watchers import ServiceWatcher
    from cilium_tpu_torch.kernels import (KERNELS, launch_socklb_stage,
                                          reset_launch_counts)
    from cilium_tpu_torch.service import socklb as sl
    from cilium_tpu_torch.testing import egress as eg
    from cilium_tpu_torch.testing import services as sv

    t0 = time.monotonic()
    d, clients, _rates = egress_daemon(world, rng)
    d.policy_import([LOCKED_RULE])
    locked = d.add_endpoint("locked", ("10.250.9.1",), ["k8s:app=locked"])
    d.services = mgr
    objs = service_world(world)
    watcher = ServiceWatcher(d.services, node_ip=eg.NODE_IP)
    sv.install(watcher, objs)
    t_watch = time.monotonic() - t0
    d.services.tensors()
    d.services.tensors6()
    t_build = time.monotonic() - t0
    print(f"service: phase 11's daemon with {len(d.services)} frontends "
          f"through ServiceWatcher (daemon and watcher {t_watch:.1f} s, "
          f"Maglev compile over phase 3's kept rows "
          f"{t_build - t_watch:.1f} s, host)")

    # per service: its two v4 backends, its v6 backend, live or not
    n = N_SERVICES
    be = np.zeros((n, 2), np.uint32)
    be6 = np.zeros(n, np.uint32)
    for i, (_svc, eps) in enumerate(objs):
        addrs = [a["ip"] for a in eps["subsets"][0]["addresses"]]
        v4 = [int(ipaddress.IPv4Address(a)) for a in addrs if ":" not in a]
        if v4:
            be[i] = v4
        v6 = [a for a in addrs if ":" in a]
        if v6:
            be6[i] = int(ipaddress.IPv6Address(v6[0])) & 0xFFFFFFFF
    empty = be[:, 0] == 0
    changed = (np.arange(n) % 2 == 0) & ~empty
    client_ips = np.array([eg.ip(c.ips[0]) for c in clients], np.uint32)
    client_ids = np.array([c.id for c in clients], np.uint32)
    others = np.array([eg.ip(p) for p in world.pod_ips[:4096]], np.uint32)
    state = {"sport": 0}

    def fresh(k, ep_ids=client_ids, ips=client_ips, vip_frac=0.5,
              v6_frac=0.1, live_only=False):
        rows = sv.rows(rng, k, n, ips, others, vip_frac=vip_frac,
                       v6_frac=v6_frac, n_v6=N_V6_SERVICES, dup_frac=0.0,
                       ep_ids=ep_ids)
        # one sport a new flow: no two flows of the run share a tuple
        rows[:, COL_SPORT] = 1024 + (state["sport"] + np.arange(k)) % 64000
        state["sport"] += k
        return rows

    def svc_of(rows):
        """-> (v4 service index or -1, v6 service index or -1)."""
        port, proto = sv.ports_protos(np.arange(n))
        i4 = rows[:, COL_DST_IP3].astype(np.int64) - sv.VIP4
        ok4 = (rows[:, COL_FAMILY] == 4) & (i4 >= 0) & (i4 < n)
        j4 = np.where(ok4, i4, 0)
        ok4 &= (rows[:, COL_DPORT] == port[j4]) & (rows[:, COL_PROTO]
                                                   == proto[j4])
        w6 = np.asarray(ip_to_words(sv.vip6(0)), np.int64)
        i6 = rows[:, COL_DST_IP3].astype(np.int64) - w6[3]
        ok6 = ((rows[:, COL_FAMILY] == 6) & (i6 >= 0)
               & (i6 < N_V6_SERVICES)
               & (rows[:, COL_DST_IP0:COL_DST_IP0 + 3] == w6[:3]).all(1))
        j6 = np.where(ok6, i6, 0)
        ok6 &= (rows[:, COL_DPORT] == port[j6]) & (rows[:, COL_PROTO]
                                                   == proto[j6])
        return np.where(ok4, i4, -1), np.where(ok6, i6, -1)

    pool = np.zeros((0, 16), np.uint32)  # established flows
    pool_be = np.zeros((0, 2), np.uint32)  # their dst ip, port after LB
    pool_when = np.zeros(0, np.int64)  # the batch that opened them
    # cached (or v6, selected per packet by a one-backend table): such a
    # flow keeps its backend; one the full cache could not take is
    # resolved again on each packet
    pool_kept = np.zeros(0, bool)
    stages = ((d, "_service_lb", "service LB (K17, K16)"),
              (d.services, "_compile", "Maglev compile (host)"),
              (d.loader, "masquerade", "snat (K11)"),
              (d, "_bw_police", "bandwidth (K13)"),
              (d.loader, "step", "datapath step (K1, K4)"),
              (d.loader, "reverse_nat", "reverse NAT (K12)"),
              (d, "_finish_batch", "decode + publish"))
    clock = StageClock({name: "caller" for _o, _a, name in stages})
    for obj, attr, name in stages:
        clock.wrap(obj, attr, name)
    totals = {"rows": 0, "no_service": 0, "locked_no_service": 0,
              "checked": 0, "kept": 0, "seconds": 0.0, "batch_s": []}

    def drive(b, rows, idx, now, n_new):
        """One batch: process_batch, then the checks.  ``idx`` gives the
        pool index of each repeated row (-1 for a new flow)."""
        nonlocal pool, pool_be, pool_when, pool_kept
        t1 = time.perf_counter()
        ev = d.process_batch(rows, now=now)
        dt = time.perf_counter() - t1
        totals["batch_s"].append(dt)
        check(len(ev) == len(rows), f"service: {len(ev)} events for "
              f"{len(rows)} rows")
        s4, s6 = svc_of(rows)
        got = ev.hdr[:, [COL_DST_IP3, COL_DPORT]]
        live4 = (s4 >= 0) & ~empty[np.maximum(s4, 0)]
        j = np.maximum(s4, 0)
        # the first backend stays valid for unchanged services, before
        # the change, and for flows established before it
        rep = idx >= 0
        first_ok = ~changed[j] | (b < SVC_CHANGE_AFTER)
        first_ok[rep] |= pool_when[idx[rep]] < SVC_CHANGE_AFTER
        in_set = ((got[:, 0] == be[j, 1])
                  | ((got[:, 0] == be[j, 0]) & first_ok))
        bad = live4 & ~(in_set & (got[:, 1] == sv.BACKEND_PORT))
        check(not bad.any(), f"service: batch {b}: {int(bad.sum())} v4 "
              f"service rows not on a backend of their own service")
        j6 = np.maximum(s6, 0)
        bad6 = (s6 >= 0) & ~((got[:, 0] == be6[j6])
                             & (got[:, 1] == sv.BACKEND_PORT))
        check(not bad6.any(), f"service: batch {b}: {int(bad6.sum())} v6 "
              f"service rows not on their backend")
        plain_rows = (s4 < 0) & (s6 < 0)
        check((got[plain_rows] == rows[plain_rows][:, [COL_DST_IP3,
                                                        COL_DPORT]]).all(),
              f"service: batch {b}: a non-service row was rewritten")
        # established flows keep their backend (the backend change
        # included); a flow with no backend is never established
        rep[rep] = pool_kept[idx[rep]]
        same = (got[rep] == pool_be[idx[rep]]).all(1)
        check(bool(same.all()), f"service: batch {b}: "
              f"{int((~same).sum())} established flows changed backend")
        nos = ev.reason == REASON_NO_SERVICE
        want = (s4 >= 0) & empty[j]
        check(bool((nos == want).all()), f"service: batch {b}: NO_SERVICE "
              f"on {int(nos.sum())} rows, {int(want.sum())} rows hit a "
              f"frontend with no backend")
        lk = rows[:, COL_EP] == locked.id
        check(bool((ev.reason[lk & live4] != 0).all()
                   & (ev.reason[lk & live4] != REASON_NO_SERVICE).all()),
              f"service: batch {b}: the locked pod reached a service")
        totals["rows"] += len(rows)
        totals["no_service"] += int(nos.sum())
        totals["locked_no_service"] += int((nos & lk).sum())
        totals["checked"] += int(live4.sum() + (s6 >= 0).sum())
        totals["kept"] += int(rep.sum())
        new = np.flatnonzero(idx < 0)[:n_new]
        keep = new[~(want[new] | lk[new])]
        pool = np.concatenate([pool, rows[keep]])
        pool_be = np.concatenate([pool_be, got[keep]])
        pool_when = np.concatenate([pool_when, np.full(len(keep), b)])
        pool_kept = np.concatenate([pool_kept,
                                    socklb_live(d._socklb, rows[keep], now)
                                    | (rows[keep, COL_FAMILY] == 6)])
        return ev, dt

    empty_idx = np.flatnonzero(empty)
    e_port, e_proto = sv.ports_protos(empty_idx)

    def batch(k_new, n_rows=LB_N):
        lk = fresh(64, ep_ids=[locked.id],
                   ips=np.array([eg.ip("10.250.9.1")], np.uint32),
                   vip_frac=1.0, v6_frac=0.0)
        # half of the locked pod's rows to frontends with no backend
        pick = rng.integers(0, len(empty_idx), 32)
        lk[:32, COL_DST_IP3] = sv.VIP4 + empty_idx[pick]
        lk[:32, COL_DPORT], lk[:32, COL_PROTO] = e_port[pick], e_proto[pick]
        new = np.concatenate([fresh(k_new), lk])
        k = n_rows - len(new)
        idx = np.concatenate([np.full(len(new), -1),
                              rng.integers(0, len(pool), k)])
        rows = np.concatenate([new, pool[idx[len(new):]]])
        perm = rng.permutation(len(rows))
        return rows[perm], idx[perm], len(new)

    reset_launch_counts()
    now = 1000
    warm = fresh(SVC_FRESH)
    drive(-1, warm, np.full(len(warm), -1), now, len(warm))
    for b in range(SVC_BATCHES):
        if b == SVC_CHANGE_AFTER:
            # a backend leaves every other service (the first of its
            # two): the Endpoints objects change, the watcher upserts
            t1 = time.monotonic()
            for i in np.flatnonzero(changed):
                svc, eps = objs[i]
                addrs = eps["subsets"][0]["addresses"][1:]
                watcher.on_endpoints_update({
                    "metadata": eps["metadata"],
                    "subsets": [{**eps["subsets"][0], "addresses": addrs}]})
            print(f"service: a backend left {int(changed.sum())} services "
                  f"({time.monotonic() - t1:.2f} s through the watcher)")
        now += 10
        rows, idx, k = batch(SVC_FRESH)
        _ev, dt = drive(b, rows, idx, now, k)
        totals["seconds"] += dt
        if b == SVC_CHANGE_AFTER:
            aff = u32.to_numpy(d._socklb.aff)
            alive = aff[:, sl.AF_EXPIRES] >= now
            valid = d.services.backend_set()
            dead = [(int(r[sl.AF_BE_IP]), int(r[sl.AF_BE_PORT]))
                    not in valid for r in aff[alive]]
            check(not any(dead), f"service: {sum(dead)} live affinity pins "
                  f"to a backend that left")
            print(f"service: {int(alive.sum())} live affinity pins after "
                  f"the change, none to a backend that left")
    occupied = int((d._socklb.fp != 0).sum())
    # the burst: more new flows than the connect path caches
    now += 10
    rows, idx, k = batch(SVC_BURST)
    drive(SVC_BATCHES, rows, idx, now, 0)
    after_burst = int((d._socklb.fp != 0).sum())
    check(after_burst == occupied, f"service: the burst cached flows "
          f"({occupied} -> {after_burst} slots)")
    launches = {k2: v.launches for k2, v in KERNELS.items()}
    for name in ("socklb_stage", "lb6_stage", "snat_egress", "bw_stage",
                 "datapath_wide", "ct_update"):
        check(launches[name] > 0, f"service: {name} never launched")
    rows_main = SVC_BATCHES * LB_N
    main_s = totals["batch_s"][1:SVC_BATCHES + 1]
    # the batch after the backend change also recompiles the Maglev
    # tables on the host
    steady_s = sum(main_s) - main_s[SVC_CHANGE_AFTER]
    stages_s = {k2: sum(v) / 1e3 for k2, v in clock.times.items()}
    stages_med = {k2: statistics.median(v) for k2, v in clock.times.items()
                  if v}
    print(f"service: {SVC_BATCHES} batches of {LB_N} rows through "
          f"process_batch in {totals['seconds']:.3f} s "
          f"({rows_main / totals['seconds']:.0f} rows/s, host clock), "
          f"{(SVC_BATCHES - 1) * LB_N / steady_s:.0f} rows/s without the "
          f"batch that recompiled the Maglev tables "
          f"({main_s[SVC_CHANGE_AFTER] * 1e3:.1f} ms); host stages over "
          f"the warm-up, the batches and the burst (median ms a call, "
          f"share of their {sum(totals['batch_s']):.3f} s): " + ", ".join(
              f"{k2} {stages_med[k2]:.3f} "
              f"{stages_s[k2] / sum(totals['batch_s']):.1%}"
              for k2 in stages_med))
    print(f"service: {totals['checked']} service rows on their own "
          f"service's backends, {totals['kept']} repeats kept their "
          f"backend across the change, NO_SERVICE {totals['no_service']} "
          f"= rows to frontends with no backend ({totals['locked_no_service']}"
          f" of them the locked pod's, over its policy's deny); cache "
          f"{occupied} of {d._socklb.capacity} slots, the burst cached none")
    print(f"service launches: {json.dumps(launches)}")
    # K17 on the main path's own inputs: the next batch against clones
    # of the live cache and the daemon's compiled frontends
    now += 10
    rows, _idx, _k = batch(SVC_FRESH)
    hdr = u32.from_numpy(rows, "cuda")
    t = d.services.tensors()

    def cache():
        c = d._socklb
        return sl.SockLBTable(c.table.clone(), c.fp.clone(), c.aff.clone())

    tabs = [cache(), cache()]
    got = sl.socklb_stage(tabs[0], t, hdr, now)
    want = sl.socklb_stage_plain(tabs[1], t, hdr, now)
    for g, w, what in zip(got[:3] + (tabs[0].table, tabs[0].fp, tabs[0].aff),
                          want[:3] + (tabs[1].table, tabs[1].fp, tabs[1].aff),
                          ("rows", "svc_hit", "no_backend", "table", "fp",
                           "aff")):
        max_abs_err(g, w, f"service: socklb_stage {what} on the main "
                    f"path's inputs")
    k17_ms = device_ms(lambda tb: sl.socklb_stage(tb, t, hdr, now), 20, cache)
    n_miss = socklb_misses(d._socklb, rows, now)
    k17_steps, k17_tail, k17_counts = claim_steps(
        launch_socklb_stage, 10, cache(), t, hdr, now)
    print(f"service: K17 on the main path's inputs ({LB_N} rows, {n_miss} "
          f"misses, the live cache): bit-exact with its plain version, "
          f"{k17_ms:.4f} ms; claim steps run {k17_steps}, one block from "
          f"step {k17_tail}, pending entering each step {k17_counts[:8]}")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        d.process_batch(rows, now=now)
        t_prof = time.perf_counter() - t1
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith("Activity Buffer"))
    print(f"service profiled batch: {LB_N} rows in {t_prof * 1e3:.3f} ms, "
          f"device busy {busy_us / 1e3:.3f} ms "
          f"({busy_us / 1e6 / t_prof:.1%}), idle "
          f"{1 - busy_us / 1e6 / t_prof:.1%}")
    # K13 and K16 at the main path's own inputs: the next batch's rows
    # as the stages before each leave them
    now += 10
    rows, _idx, _k = batch(SVC_FRESH)
    bw_in, lb6_in, rev_in = stage_inputs(d, rows, now)
    k13_path, k16_path = k13_on("service", *bw_in), k16_on("service",
                                                           *lb6_in)
    k12_path = k12_on("service", *rev_in)
    d.shutdown()
    report["service"] = {
        "build_s": t_build, "batches": SVC_BATCHES, "rows": rows_main,
        "process_batch_s": totals["seconds"],
        "rows_per_s": rows_main / totals["seconds"],
        "rows_per_s_without_recompile": (SVC_BATCHES - 1) * LB_N / steady_s,
        "stages_median_ms": stages_med,
        "batch_ms": [x * 1e3 for x in totals["batch_s"]],
        "stages_s": stages_s, "checked": totals["checked"],
        "kept": totals["kept"], "no_service": totals["no_service"],
        "occupied": occupied, "launches": launches,
        "k17_main_path": {"ms": k17_ms, "misses": n_miss,
                          "claim_steps": k17_steps,
                          "tail_from_step": k17_tail,
                          "counts": k17_counts},
        "k13_main_path": k13_path, "k16_main_path": k16_path,
        "k12_main_path": k12_path,
        "profiled": {"seconds": t_prof, "device_busy_ms": busy_us / 1e3}}
    return launches


ML_N = 1 << 18  # K18/K19 parity rows: a serving batch
ML_BATCH = 4096  # score_capture's batch
ANOMALY_SERVE = 1 << 20  # phase 13's served packets
SCAN_SHARE = 16  # one packet in 16 from PortScanScenario
LOG1P_COLS = (3, 4, 6, 19, 24)
SCORE_TOL = 2e-3  # |score| on the card against the plain version
LOGIT_TOL = 1e-2
SCANNER = "172.20.0.7"  # PortScanScenario's source


def card_state(world):
    """A fresh datapath state for ``world``'s tables on the card (CT
    2^20)."""
    from cilium_tpu_torch.datapath.verdict import build_state

    return build_state(world.tensors, world.lpm, world.ep_policy,
                       ct_capacity=CT_CAPACITY, device="cuda")


def clone_state(state):
    """A copy of ``state`` whose CT table and metrics can diverge; the
    policy and LPM tables (read-only here) are shared."""
    import copy

    from cilium_tpu_torch.datapath.conntrack import CTTable

    s = copy.copy(state)
    s.ct = CTTable(state.ct.table.clone(), state.ct.fp.clone(),
                   state.ct.dropped.clone())
    s.metrics = state.metrics.clone()
    return s


def card_model(torch, world):
    """The anomaly model at config #3's width: ``init_params`` with the
    world's labels in the embedding, V = the row map's 16384 rows, D =
    32, H = 64 (the reference defaults), on the card; novelty unfitted."""
    from cilium_tpu_torch.ml import init_params

    labels_by_row = {world.row_map.row(i.numeric_id):
                     tuple(str(l) for l in i.labels)
                     for i in world.alloc.all_identities()}
    return init_params(torch.Generator().manual_seed(20261017),
                       world.row_map.capacity, labels_by_row=labels_by_row,
                       device="cuda")


def feature_err(torch, got, want, what):
    """K18's outputs against the plain version's: id_row and every
    column but the log1p ones bit-exact, the log1p columns within 1
    float32 ulp; returns the max abs error over the features."""
    (gid, gf), (wid, wf) = got, want
    max_abs_err(gid, wid, f"{what}: id_row")
    check(gf.shape == wf.shape, f"{what}: feats {tuple(gf.shape)}")
    exact = [c for c in range(gf.shape[1]) if c not in LOG1P_COLS]
    n_diff = int((gf[:, exact] != wf[:, exact]).sum())
    check(n_diff == 0, f"{what}: {n_diff} cells of the exact columns differ")
    # float32 >= 0: the bit patterns' distance is the distance in ulps
    ulps = (gf[:, list(LOG1P_COLS)].view(torch.int32).to(torch.int64)
            - wf[:, list(LOG1P_COLS)].view(torch.int32).to(torch.int64)
            ).abs().max().item()
    check(ulps <= 1, f"{what}: log1p columns {ulps} ulps apart")
    return float((gf - wf).abs().max().item())


def score_err(torch, got, want, what, near=0.0):
    """Scores against the plain version's: within SCORE_TOL, and at
    least 99.9% of them within ``near`` (0: bit-identical, K19 on the
    same inputs; 1e-5 end to end, where K18's log1p columns may sit an
    ulp from the plain version's and d2 carries that into the novelty
    score); returns (max abs error, identical share)."""
    if not got.numel():
        return 0.0, 1.0
    diff = (got - want).abs()
    err = float(diff.max().item())
    same = float((diff == 0).float().mean().item())
    close = float((diff <= near).float().mean().item())
    check(err <= SCORE_TOL and close >= 0.999,
          f"{what}: scores max abs err {err}, {same:.5f} identical, "
          f"{close:.5f} within {near}")
    return err, same


def phase_ml_kernels(torch, rng, world, kernels, report):
    """K18 and K19 against their plain versions at full width: 2^18
    rows of ``synth_labeled_traffic`` (attack_frac 0.25) served through
    K1/K4 on config #3's tables, the model at V = 16384, D = 32, H = 64
    with its novelty fitted on the batch's benign rows (both branches
    of the max live), and a batch whose id_row runs past V; then the
    trainer's and ``score_capture``'s 4096 rows.  K18 is one kernel a
    call at either size (a CUDA-graph capture: the one-cluster kernel
    at 4096 rows, the cooperative one at 2^18); each kernel is timed,
    and bounded, at both sizes."""
    import functools

    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.datapath.verdict import datapath_step
    from cilium_tpu_torch.kernels import launch_anomaly_score
    from cilium_tpu_torch.ml import fit_novelty, synth_labeled_traffic
    from cilium_tpu_torch.ml.features import (flow_features,
                                              flow_features_plain)
    from cilium_tpu_torch.ml.model import (forward_plain, novelty_d2_plain,
                                           score_packets_plain)
    from cilium_tpu_torch.testing.capture import ops_a_call

    t0 = time.monotonic()
    hdr_np, labels = synth_labeled_traffic(world, ML_N, rng,
                                           attack_frac=0.25)
    t_synth = time.monotonic() - t0
    hdr = u32.from_numpy(hdr_np, "cuda")
    out, _ = datapath_step(card_state(world), hdr, 50_000)
    # its own stream of draws: the phases after this one see the same
    small = u32.from_numpy(synth_labeled_traffic(
        world, ML_BATCH, np.random.default_rng(ML_BATCH))[0], "cuda")
    small_out, _ = datapath_step(card_state(world), small, 50_000)
    want_f = flow_features_plain(hdr, out)
    want_s = flow_features_plain(small, small_out)
    model = fit_novelty(card_model(torch, world),
                        want_f[1][torch.from_numpy(labels < 0.5).cuda()]
                        .cpu().numpy())
    f_err = max(
        feature_err(torch, flow_features(hdr, out), want_f, "flow_features"),
        feature_err(torch, flow_features(small, small_out), want_s,
                    "flow_features, 4096 rows"))
    for h, o, n in ((hdr, out, ML_N), (small, small_out, ML_BATCH)):
        ops = ops_a_call(lambda h=h, o=o: functools.partial(
            flow_features, h, o))
        check(list(ops.values()) == [1] and "flow_features_" in next(
            iter(ops)), f"flow_features at {n} rows: {ops} a call, not "
            f"one kernel")
    # the largest service bucket's count (column 19 is log1p(n) / 12)
    hot = round(float(torch.expm1(want_f[1][:, 19].max() * 12)))

    rows, feats = want_f
    v = model.embed.shape[0]
    far = rows.clone()
    far[: ML_N // 16] = v + torch.arange(ML_N // 16, device="cuda",
                                         dtype=torch.int32)
    far[ML_N // 16: ML_N // 8] = -1 - torch.arange(
        ML_N // 16, device="cuda", dtype=torch.int32) % v
    s_errs, same, l_err, l_same = [], [], 0.0, []
    for ids, fs, what in ((rows, feats, "anomaly_score"),
                          (far, feats, "anomaly_score, id_row past V"),
                          (*want_s, "anomaly_score, 4096 rows")):
        got = launch_anomaly_score(model, ids, fs, outputs=("logit", "d2"))
        torch.cuda.synchronize()
        e, sm = score_err(torch, got["score"],
                          score_packets_plain(model, ids, fs), what)
        s_errs.append(e)
        same.append(sm)
        dl = (got["logit"] - forward_plain(model, ids, fs)).abs()
        l_err = max(l_err, float(dl.max().item()))
        l_same.append(float((dl == 0).float().mean().item()))
        d2_want = novelty_d2_plain(model, fs)
        d2_same = float((got["d2"] == d2_want).float().mean().item())
        check(l_err <= LOGIT_TOL, f"{what}: logits max abs err {l_err}")
        check(bool(torch.allclose(got["d2"], d2_want, rtol=1e-5,
                                  atol=1e-5)),
              f"{what}: d2 differs ({d2_same:.5f} identical)")
    p = torch.sigmoid(forward_plain(model, rows, feats))
    novel = float((score_packets_plain(model, rows, feats) > p).float()
                  .mean().item())
    check(0 < novel < 1, f"anomaly_score: novelty branch share {novel}")

    def k18_cost(n):
        # the 8 header and 4 out words each row reads, its id_row and 27
        # feature columns written; ~40 integer operations a key and an
        # atomic a counter set, ~60 for the columns
        return dict(bytes=n * (8 * 4 + 4 * 4 + 4 + 27 * 4),
                    ops=n * (5 * 40 + 8 + 60))

    mlp = 2 * (59 * 64 + 64 * 64 + 64)

    def k19_cost(n):
        # id_row, feats, the embedding row and the score a row, the
        # weights once; the three products on bf16 tensor cores, d . P . d
        # in float32
        return dict(bytes=n * (4 + 27 * 4 + 32 * 4 + 4) + 4 * (
            59 * 64 + 64 * 64 + 3 * 64 + 1 + 27 + 27 * 27 + 1), ops=0,
            flop_ms=(n * mlp / BF16_FLOPS_PER_S
                     + n * 2 * (27 * 27 + 27) / F32_FLOPS_PER_S) * 1e3)

    def at(fn, plain, cost):
        rec = {"rows": ML_BATCH, "ms": device_ms(fn, 20),
               "plain_ms": device_ms(plain, 3)}
        rec["bound_ms"], rec["bound_by"] = bound(
            cost["bytes"], cost["ops"], cost.get("flop_ms", 0.0))
        return rec

    kernels["flow_features"].update(
        max_abs_err=f_err,
        ms=device_ms(lambda: flow_features(hdr, out), 20),
        plain_ms=device_ms(lambda: flow_features_plain(hdr, out), 3),
        at_4096=at(lambda: flow_features(small, small_out),
                   lambda: flow_features_plain(small, small_out),
                   k18_cost(ML_BATCH)),
        **k18_cost(ML_N))
    kernels["anomaly_score"].update(
        max_abs_err=max(s_errs),
        ms=device_ms(lambda: launch_anomaly_score(model, rows, feats), 20),
        plain_ms=device_ms(lambda: score_packets_plain(model, rows,
                                                       feats), 3),
        at_4096=at(lambda: launch_anomaly_score(model, *want_s),
                   lambda: score_packets_plain(model, *want_s),
                   k19_cost(ML_BATCH)),
        **k19_cost(ML_N))
    print(f"parity flow_features: {ML_N} rows of synth_labeled_traffic "
          f"(attack_frac 0.25, made in {t_synth:.1f} s) served through "
          f"K1/K4, and {ML_BATCH} rows; id_row and 22 columns bit-exact, "
          f"log1p columns within 1 ulp (max abs err {f_err:.3g}); one "
          f"kernel a call at both sizes; the busiest service bucket holds "
          f"{hot} rows")
    print(f"parity anomaly_score: V {v} x D 32, H 64, novelty fitted "
          f"(threshold {model.nov_thresh.item():.4g}; the novelty branch "
          f"gives {novel:.1%} of the scores): scores max abs err "
          f"{max(s_errs):.3g}, identical {same[0]:.5f} / {same[1]:.5f} / "
          f"{same[2]:.5f} (the batch, its id_row past V or negative, the "
          f"{ML_BATCH} rows); logits max abs err {l_err:.3g}, identical "
          f"{l_same[0]:.5f} / {l_same[1]:.5f} / {l_same[2]:.5f}")
    for name in ("flow_features", "anomaly_score"):
        r = kernels[name]["at_4096"]
        print(f"{name} at {ML_BATCH} rows: {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.6f} ms by "
              f"{r['bound_by']})")
    report["ml_kernels"] = {"rows": ML_N, "v": v, "feature_err": f_err,
                            "score_err": s_errs, "score_identical": same,
                            "logit_err": l_err, "logit_identical": l_same,
                            "novel_share": novel, "hot_bucket_rows": hot}


def replay(torch, state, model, hdr_np, plain, now=50_000):
    """``score_capture``'s loop over ``state``: the datapath step, then
    the features and scores, 4096 rows a batch, the last padded.
    Through the kernels, or (``plain``) the plain versions on the same
    card.  Returns (out rows, scores), both on the card."""
    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.datapath.verdict import datapath_step
    from cilium_tpu_torch.ml.features import (flow_features,
                                              flow_features_plain)
    from cilium_tpu_torch.ml.model import (score_packets,
                                           score_packets_plain)

    n = len(hdr_np)
    pad = (-n) % ML_BATCH
    hdr_np = np.concatenate([hdr_np, np.repeat(hdr_np[-1:], pad, axis=0)])
    valid = torch.arange(len(hdr_np), device="cuda") < n
    outs, scores = [], []
    for i in range(0, len(hdr_np), ML_BATCH):
        hb = u32.from_numpy(hdr_np[i:i + ML_BATCH], "cuda")
        vb = valid[i:i + ML_BATCH]
        if plain:
            out = plain_serve(state, None, hb, now + i, 0, valid=vb)
            scores.append(score_packets_plain(
                model, *flow_features_plain(hb, out)))
        else:
            out, state = datapath_step(state, hb, now + i, vb)
            scores.append(score_packets(model, *flow_features(hb, out)))
        outs.append(out)
    return torch.cat(outs)[:n], torch.cat(scores)[:n]


def print_stages(label, stages):
    """One line a timed stage: thread, calls, median ms, total ms, share
    of the session."""
    print(f"{label}: stages (calls, median ms, total ms, share):")
    for name, v in stages.items():
        med = "-" if v["median_ms"] is None else f"{v['median_ms']:.3f}"
        print(f"  [{v['thread']}] {name}: {v['calls']}, {med}, "
              f"{v['total_ms']:.3f}, {v['share']:.1%}")


def scan_mix(rows, db_id, seed=7):
    """``rows`` with one packet in SCAN_SHARE replaced, in place order,
    by ``PortScanScenario``'s sweep aimed at the db endpoint."""
    import numpy as np
    from cilium_tpu_torch.core.packets import (COL_DST_IP3, COL_EP,
                                               ip_to_words)
    from cilium_tpu_torch.testing.workloads import make_scenario

    n_scan = len(rows) // SCAN_SHARE
    sc = make_scenario("port_scan", seed=seed, n_packets=n_scan,
                       batch=4096)
    scan = np.concatenate(list(sc.iter_batches(db_id)))
    scan[:, COL_DST_IP3] = ip_to_words(DB_IP)[3]
    base = rows[: len(rows) - n_scan].reshape(n_scan, SCAN_SHARE - 1, -1)
    return np.concatenate([base, scan[:, None, :]], axis=1).reshape(
        len(rows), -1)


def phase_anomaly(torch, rng, world, report):
    """Phase 13, the anomaly scorer: (a) fit_novelty_from_world and
    save_model on the card; (b) score_capture over 2^18 rows against
    the same replay through the plain versions; (c) config #3's daemon
    armed with the checkpoint, serving 2^20 packets (one in 16 from the
    port scan) through submit; (d) the scoring tax and the scorer's
    share of the event-join worker.  Returns the launch counts of the
    armed daemon's first session."""
    import copy

    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import COL_SRC_IP3, ip_to_words
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts
    from cilium_tpu_torch.ml import (auc, fit_novelty_from_world,
                                     load_model, save_model, score_capture,
                                     synth_labeled_traffic)
    from cilium_tpu_torch.ml.features import flow_features_plain
    from cilium_tpu_torch.ml.model import score_packets_plain

    # (a) the novelty fit on the card, saved in the reference's format
    w = copy.copy(world)
    w.state = card_state(world)
    reset_launch_counts()
    t0 = time.monotonic()
    model = fit_novelty_from_world(card_model(torch, world), w)
    t_fit = time.monotonic() - t0
    fit_launches = {k: v.launches for k, v in KERNELS.items()}
    check(fit_launches["flow_features"] == 8,
          f"anomaly: fit_novelty_from_world launched K18 "
          f"{fit_launches['flow_features']} times for 8 batches")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    path = str(out_dir / "anomaly_model.npz")
    save_model(path, model)
    back = load_model(path, "cuda")
    check(all(torch.equal(getattr(back, f), getattr(model, f))
              for f in ("embed", "w1", "feat_prec", "nov_thresh")),
          "anomaly: the saved model does not load back")
    print(f"anomaly (a): fit_novelty_from_world on the card in {t_fit:.2f} "
          f"s (8 x 4096 benign rows), threshold "
          f"{model.nov_thresh.item():.4g}; saved to {path}")

    # (b) score_capture on the card against the plain replay
    hdr_np, labels = synth_labeled_traffic(w, ML_N, rng, attack_frac=0.25)
    n = ML_N - 1000  # a padded last batch
    hdr_np, labels = hdr_np[:n], labels[:n]
    start = clone_state(w.state)
    states = [clone_state(start), clone_state(start)]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.monotonic()
    scores = score_capture(model, w, hdr_np)
    t_cap = time.monotonic() - t0
    cap_launches = {k: v.launches for k, v in KERNELS.items()}
    check(cap_launches["anomaly_score"] == -(-n // ML_BATCH),
          f"anomaly: score_capture launched K19 "
          f"{cap_launches['anomaly_score']} times")
    out_k, s_k = replay(torch, states[0], model, hdr_np, plain=False)
    out_p, s_p = replay(torch, states[1], model, hdr_np, plain=True)
    max_abs_err(out_k, out_p, "anomaly replay: out rows")
    max_abs_err(w.state.ct.table, states[1].ct.table,
                "anomaly replay: CT table")
    max_abs_err(w.state.metrics, states[1].metrics,
                "anomaly replay: metrics")
    check(np.array_equal(scores, s_k.cpu().numpy()),
          "anomaly: score_capture differs from its own kernel replay")
    err, same = score_err(torch, s_k, s_p, "anomaly replay", near=1e-5)
    a_card, a_plain = auc(scores, labels), auc(s_p.cpu().numpy(), labels)
    print(f"anomaly (b): score_capture over {n} rows (4096 a batch, the "
          f"last padded) in {t_cap:.3f} s on the card; out rows, CT table "
          f"and metrics equal the plain replay's, scores max abs err "
          f"{err:.3g} ({same:.5f} identical); AUC {a_card:.4f} (plain "
          f"{a_plain:.4f}; information only: the supervised half is "
          f"untrained)")

    # (c) the armed daemon, served through submit
    d, db, rows = config3_daemon(world, rng, anomaly_model_path=path)
    rows = scan_mix(rows[:ANOMALY_SERVE], db.id)
    scanner = ip_to_words(SCANNER)[3]
    captured = []

    def capture(batch):
        # one batch with scan rows, for the plain scorer's comparison
        if not captured and (batch.hdr[:, COL_SRC_IP3] == scanner).any():
            captured.append(batch)

    d.monitor.register("capture", capture)
    d.start()
    threads = dict(StageClock.THREADS)
    threads["event join: anomaly scorer"] = "worker"

    def timed_scorer():
        clock = StageClock(threads)
        clock.wrap(d.anomaly, "consume", "event join: anomaly scorer")
        d.monitor.register("anomaly", d.anomaly.consume)
        return clock

    def untime_scorer():
        del d.anomaly.consume
        d.monitor.register("anomaly", d.anomaly.consume)

    pub0 = d.monitor.published
    clock = timed_scorer()
    reset_launch_counts()
    out, t_serve = serve_session(d, rows, clock)
    launches = {k: v.launches for k, v in KERNELS.items()}
    untime_scorer()
    first_stages = clock.summary(t_serve)
    fe, ft = out["front-end"], out["front-end"]["fault-tolerance"]
    check(fe["submitted"] == fe["verdicts"] + fe["shed"]
          + ft["recovery-dropped"] and fe["verdicts"] == len(rows),
          f"anomaly: ledger broken: {fe}")
    check(out["lost"] == 0 and out["events"] > 0,
          f"anomaly: {out['events']} events, {out['lost']} lost")
    st = d.anomaly.stats()
    published = d.monitor.published - pub0
    check(d.monitor.lost_count("anomaly") == 0,
          f"anomaly: the monitor lost {d.monitor.lost_count('anomaly')} "
          f"events of the scorer")
    check(st["scored"] == published > 0,
          f"anomaly: scored {st['scored']} of {published} published")
    for name in ("flow_features", "anomaly_score", "datapath_packed"):
        check(launches[name] > 0, f"anomaly: {name} never launched")
    print(f"anomaly (c): config #3 armed with the checkpoint, {len(rows)} "
          f"packets ({len(rows) // SCAN_SHARE} from the port scan) "
          f"submit -> stop_serving in {t_serve:.3f} s "
          f"({len(rows) / t_serve:.0f} verdicts/s); ledger exact, "
          f"{out['events']} events, lost {out['lost']}; scored "
          f"{st['scored']} = published {published}, flagged "
          f"{st['flagged']} at {st['threshold']}, lost['anomaly'] 0; "
          f"K18 {launches['flow_features']}, K19 "
          f"{launches['anomaly_score']} launches")
    print_stages("anomaly (c) session", first_stages)
    check(bool(captured), "anomaly: no published batch held scan rows")
    batch = captured[0]
    hdr_in, out_in = d.anomaly.inputs(batch)
    got = torch.from_numpy(d.anomaly.scores(hdr_in, out_in)).cuda()
    want = score_packets_plain(
        d.anomaly.params,
        *flow_features_plain(u32.from_numpy(hdr_in, "cuda"),
                             u32.from_numpy(out_in, "cuda")))
    b_err, b_same = score_err(torch, got, want, "anomaly: captured batch",
                              near=1e-5)
    n_scan = int((batch.hdr[:, COL_SRC_IP3] == scanner).sum())
    print(f"anomaly (c): a captured batch of {len(batch)} events "
          f"({n_scan} from the scanner) scores the same through the plain "
          f"versions: max abs err {b_err:.3g}, {b_same:.5f} identical")

    # (d) the scoring tax: steady sessions with the scorer unregistered
    # and registered, in turns; the scorer timed on the event worker
    rates = {"off": [], "on": []}
    shares = []
    for mode in ("off", "on", "on", "off"):
        if mode == "off":
            d.monitor.unregister("anomaly")
            clock = None
        else:
            clock = timed_scorer()
        pub0, sc0 = d.monitor.published, d.anomaly.stats()["scored"]
        o, t = serve_session(d, rows, clock)
        check(o["lost"] == 0 and o["front-end"]["verdicts"] == len(rows),
              f"anomaly: the {mode} session lost rows or events")
        rates[mode].append(len(rows) / t)
        if clock is not None:
            untime_scorer()
            check(d.anomaly.stats()["scored"] - sc0
                  == d.monitor.published - pub0,
                  "anomaly: a timed session scored another count than "
                  "the monitor published")
            shares.append(clock.summary(t))
            print_stages(f"anomaly (d) session {len(shares)} with the "
                         f"scorer ({len(rows) / t:.0f} verdicts/s)",
                         shares[-1])
    d.monitor.unregister("capture")
    d.shutdown()
    tax = statistics.median(rates["on"]) / statistics.median(rates["off"])
    sc_ms = [v["event join: anomaly scorer"] for v in shares]
    join = [v["event join, all"] for v in shares]
    share = (sum(v["total_ms"] for v in sc_ms)
             / max(sum(v["total_ms"] for v in join), 1e-9))
    med = statistics.median(
        [x for v in sc_ms for x in [v["median_ms"]] if x is not None]
        or [0.0])
    per_window = (sum(v["total_ms"] for v in sc_ms)
                  / max(sum(v["calls"] for v in join), 1))
    p7 = report.get("daemon", {}).get("verdicts_per_s")
    p7_txt = f"{p7:.0f}" if p7 else "not run"
    print(f"anomaly (d): verdicts/s with the scorer "
          f"{[round(x) for x in rates['on']]}, without "
          f"{[round(x) for x in rates['off']]} (phase 7: {p7_txt}); "
          f"scoring tax {tax:.4f}; the scorer {per_window:.3f} ms a "
          f"window ({med:.3f} ms a call, median), {share:.1%} of the "
          f"event-join worker's time")
    report["anomaly"] = {
        "fit_s": t_fit, "capture_s": t_cap, "capture_rows": n,
        "capture_err": err, "capture_identical": same, "auc": a_card,
        "auc_plain": a_plain, "serve_s": t_serve, "packets": len(rows),
        "front_end": fe, "events": out["events"], "scorer": st,
        "published": published, "captured_err": b_err,
        "captured_identical": b_same, "rates": rates, "tax": tax,
        "phase7_verdicts_per_s": p7, "scorer_median_ms": med,
        "scorer_ms_per_window": per_window,
        "scorer_share_of_join": share, "stages": shares,
        "first_stages": first_stages,
        "launches": launches, "fit_launches": fit_launches,
        "capture_launches": cap_launches}
    return launches


TRAIN_N = 4096  # the trainer's batch (train's default)
TRAIN_LR = 3e-3  # train's default
TRAIN_STEPS = 200  # train's default
REPLAY_STEPS = 8  # phase 14's steps replayed through the plain versions
LOSS_RTOL = 2e-6  # K20's loss against the plain version's: the sum order
# d_embed against index_add_ (atomics on the card): a float32 sum of up
# to 2048 terms in another order, against the table's largest entry
EMBED_TOL = 1e-5
# phase 14's replay: the kernels' losses and params against the plain
# versions' over 8 steps.  The two differ only in the order of float32
# sums (K20's loss mean; the plain d_embed's index_add_ in atomic order);
# one adam step moves a parameter by ~lr, so a wrong sign, a swapped
# leaf or a wrong moment is off by thousands of times REPLAY_PARAM_TOL
INT32_MAX = (1 << 31) - 1  # adam's count saturates here, as optax's
REPLAY_LOSS_RTOL = 1e-5
REPLAY_PARAM_TOL = 1e-6
TRAIN_SHARDS = 8  # the reference test's mesh, phase 15's
# phase 14 (d): the first losses of train(mesh=8) against (a)'s unsharded
# run from the same params, state and seed.  Step 0's losses differ by
# the sum order only; then each shard's bf16 rounding of a weight
# gradient can flip adam's first steps where a gradient is near 0
MESH_LOSS_RTOL = 1e-3
GOLDEN = ("tests/data/golden_cic.pcap", "tests/data/golden_cic.csv")


def train_inputs(torch, rng, world, n=TRAIN_N):
    """A train batch at config #3: ``n`` rows of synth_labeled_traffic
    served through K1/K4 and K18, then one identity given half the rows,
    a 128th of them past V, a 128th negative within one wrap and a few
    below it (dropped by the scatter).  -> (id_row, feats, labels)."""
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.datapath.verdict import datapath_step
    from cilium_tpu_torch.ml import flow_features, synth_labeled_traffic

    hdr_np, labels = synth_labeled_traffic(world, n, rng)
    hdr = u32.from_numpy(hdr_np, "cuda")
    out, _ = datapath_step(card_state(world), hdr, 50_000)
    ids, feats = flow_features(hdr, out)
    v = world.row_map.capacity
    ids = ids.clone()
    ids[: n // 2] = ids[n - 1].item()
    k = n // 128
    ar = torch.arange(k, device="cuda", dtype=torch.int32)
    ids[n // 2: n // 2 + k] = v + ar
    ids[n // 2 + k: n // 2 + 2 * k] = -1 - ar % v
    ids[n // 2 + 2 * k: n // 2 + 2 * k + 8] = -v - 1 - ar[:8]
    perm = torch.from_numpy(rng.permutation(n)).cuda()
    return (ids[perm].contiguous(), feats.contiguous(),
            torch.from_numpy(labels).cuda())


def train_model(torch, world):
    """card_model with small random biases, so that every bias gradient
    path carries values."""
    model = card_model(torch, world)
    gen = torch.Generator().manual_seed(7)
    return model.replace(**{
        b: (torch.randn(tuple(getattr(model, b).shape), generator=gen)
            * 0.1).cuda() for b in ("b1", "b2", "b3")})


# the windows torch.profiler came back short from (each measured again)
PROFILER_SHORT = []


def pass_split(torch, fn, per_call, reps=20):
    """Each kernel (and memset) that one call of ``fn`` launches: {name:
    (device ms a launch, launches a call)}, from torch.profiler over
    ``reps`` calls after an untimed one.  The window must show
    ``per_call`` operations (a CUDA-graph capture's count of one call)
    for each of the ``reps`` calls, or a dropped event would read as a
    lower time; it opens and closes with a spin kernel that is not
    counted (the profiler has dropped one event at a window's edge).  A
    short window is measured once more; a second one fails the smoke.
    The profiler records every thread's launches, so no daemon's
    controller thread may be live: it fails the smoke at once."""
    from torch.profiler import ProfilerActivity, profile

    live = sorted(t.name for t in threading.enumerate()
                  if t.name.startswith("ctrl-"))
    check(not live, f"pass_split: a daemon's controllers are live and "
          f"would launch into the profiler's window: {live}")
    for _attempt in range(2):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for _ in range(reps):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith("Activity Buffer")
                  and "spin_kernel" not in e.key]
        seen = sum(e.count for e in events)
        if seen == per_call * reps and all(e.count % reps == 0
                                           for e in events):
            return {e.key: (e.self_device_time_total / 1e3 / reps,
                            e.count / reps) for e in events}
        PROFILER_SHORT.append({"seen": seen, "want": per_call * reps,
                               "by_kernel": {e.key: e.count
                                             for e in events}})
        print(f"profiler: {seen} device events of {per_call * reps} in a "
              f"window of {reps} calls")
    raise ProfilerShort(f"torch.profiler came back short twice: "
                        f"{PROFILER_SHORT[-2:]}")


def pass_split_or_short(torch, fn, per_call):
    """:func:`pass_split`, or {} where the profiler came back short twice
    (the windows are kept in ``PROFILER_SHORT``): for a one-kernel call,
    whose device time the events hold, and whose windows the profiler
    on the H100 now and then records only in part."""
    try:
        return pass_split(torch, fn, per_call)
    except ProfilerShort as e:
        print(f"profiler: {e}; not measured")
        return {}


def profiler_ms(split, kernel):
    """Device ms a launch of the one kernel of ``split`` whose name holds
    ``kernel``; None where the split is empty (not measured)."""
    if not split:
        return None
    keys = [k for k in split if kernel in k]
    check(len(keys) == 1, f"profiler: {kernel} in {sorted(split)}")
    return split[keys[0]][0]


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def check_k21_call(torch, name, fn, v, got, want_sorted, ids, n_shards):
    """K21 or K21s, one call: d_embed bit-exact with
    ``embed_grad_sorted_plain``; the sort (from the launch's scratch)
    equal to a stable sort of each shard's clamped keys, dropped rows
    (key V) last; the launch sequence split by pass (printed), with the
    kernels a call asserted (``testing.capture.ops_a_call``): 5 and one
    radix pass per 8 bits of V, no memset or copy.  -> the split."""
    check(torch.equal(got[0], want_sorted),
          f"{name}: d_embed differs from embed_grad_sorted_plain (max abs "
          f"err {float((got[0] - want_sorted).abs().max().item())})")
    sc = {}
    fn(sc)
    torch.cuda.synchronize()
    key = ids.to(torch.int64)
    key = torch.where(key < 0, key + v, key)
    key = torch.where((key >= 0) & (key < v), key, v)
    blk = ids.shape[0] // n_shards
    for z in range(n_shards):
        b = slice(z * blk, (z + 1) * blk)
        k, order = torch.sort(key[b], stable=True)
        check(torch.equal(sc["sorted_key"][b].to(torch.int64), k)
              and torch.equal(sc["sorted_row"][b].to(torch.int64),
                              order + z * blk),
              f"{name}: shard {z}'s sort differs from a stable sort of "
              f"its clamped keys")
    from cilium_tpu_torch.testing.capture import NODE_TYPES, ops_a_call

    ops = ops_a_call(lambda: lambda: fn(None))
    calls = sum(ops.values())
    want_calls = 5 + -(-v.bit_length() // 8)
    check(calls == want_calls and not set(ops) & set(NODE_TYPES.values()),
          f"{name}: {calls} operations a call, not {want_calls} kernels: "
          f"{ops}")
    split = pass_split(torch, lambda: fn(None), calls)
    print(f"{name} by pass ({calls} kernels a call; device ms a "
          f"call, torch.profiler over 20): " + ", ".join(
              f"{k.replace('(anonymous namespace)::', '').split('(')[0]} "
              f"{ms:.4f}"
              for k, (ms, _) in sorted(split.items(),
                                       key=lambda kv: -kv[1][0])))
    return {k: {"ms": ms, "calls": c} for k, (ms, c) in split.items()}


def phase_train_kernels(torch, rng, world, kernels, report):
    """K20-K22 against their plain versions at the trainer's shapes: B =
    4096 rows at config #3 (V = 16384), one identity on half the rows,
    id_row past V and negative.  K20's logits and saved activations and
    K21's weight and bias gradients bit-exact, K20's loss within
    LOSS_RTOL, d_embed within EMBED_TOL of the largest entry (the plain
    version's index_add_ sums in atomic order); K21 twice gives the same
    bits; K22 one step from a mid-training state (count 3), bit-exact.
    K20s/K21s over TRAIN_SHARDS blocks of the same batch: the same
    bounds against their plain versions, and bit-exact against that many
    unsharded K20/K21 launches on the blocks followed by the shard-order
    mean."""
    import functools

    from cilium_tpu_torch.kernels import (launch_adam_update,
                                          launch_anomaly_train_bwd,
                                          launch_anomaly_train_fwd)
    from cilium_tpu_torch.ml.model import (TRAINABLE,
                                           embed_grad_sorted_plain,
                                           train_backward_plain,
                                           train_forward_plain)
    from cilium_tpu_torch.ml.train import adam_update_plain

    ids, feats, labels = train_inputs(torch, rng, world)
    leaves = train_model(torch, world).leaves()
    n, v = ids.shape[0], leaves[0].shape[0]
    loss_k, saved = launch_anomaly_train_fwd(leaves, ids, feats, labels)
    loss_p, plain_saved = train_forward_plain(leaves, ids, feats, labels)
    torch.cuda.synchronize()
    x, h1, h2, logit = plain_saved
    for got, want, what in ((saved["logit"], logit, "logit"),
                            (saved["xT"], x.t(), "x"),
                            (saved["h1T"], h1.t(), "h1"),
                            (saved["h2T"], h2.t(), "h2")):
        check(torch.equal(got, want),
              f"anomaly_train_fwd: {what} differs from the plain version "
              f"({int((got != want).sum())} cells)")
    loss_err = abs(loss_k.item() - loss_p.item())
    check(loss_err <= LOSS_RTOL * abs(loss_p.item()),
          f"anomaly_train_fwd: loss {loss_k.item()} vs {loss_p.item()}")

    gloss = torch.ones(1, device="cuda")
    got = launch_anomaly_train_bwd(leaves, saved, ids, labels, gloss)
    again = launch_anomaly_train_bwd(leaves, saved, ids, labels, gloss)
    want = train_backward_plain(leaves, plain_saved, ids, labels, gloss)
    torch.cuda.synchronize()
    g_err, e_same = 0.0, 1.0
    for name, a, b, c in zip(TRAINABLE, got, again, want):
        check(torch.equal(a, b), f"anomaly_train_bwd: d{name} differs "
              f"between two runs on the same inputs")
        err = float((a - c).abs().max().item())
        g_err = max(g_err, err)
        if name == "embed":
            scale = float(c.abs().max().item())
            e_same = float((a == c).float().mean().item())
            check(err <= EMBED_TOL * scale,
                  f"anomaly_train_bwd: d_embed max abs err {err} "
                  f"(largest entry {scale})")
        else:
            check(err == 0, f"anomaly_train_bwd: d{name} differs from the "
                  f"plain version (max abs err {err})")
    hot = int((ids == ids.mode().values).sum().item())
    check(float(got[0].abs().sum().item()) > 0 and all(
        float(g.abs().max().item()) > 0 for g in got),
        "anomaly_train_bwd: a zero gradient leaf")
    k21_split = check_k21_call(
        torch, "anomaly_train_bwd",
        lambda sc: launch_anomaly_train_bwd(leaves, saved, ids, labels,
                                            gloss, scratch=sc),
        v, got, embed_grad_sorted_plain(leaves, plain_saved, ids, labels,
                                        gloss), ids, 1)

    # K22 from a mid-training state: three plain steps, then one step
    # each way on clones
    params = [t.clone() for t in leaves]
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    count = torch.zeros((), dtype=torch.int32, device="cuda")
    for _ in range(3):
        adam_update_plain(params, want, mu, nu, count, TRAIN_LR)

    def clone_all():
        return ([t.clone() for t in params], [t.clone() for t in mu],
                [t.clone() for t in nu], count.clone())

    ka, pa = clone_all(), clone_all()
    launch_adam_update(ka[0], got, ka[1], ka[2], ka[3], TRAIN_LR)
    adam_update_plain(pa[0], got, pa[1], pa[2], pa[3], TRAIN_LR)
    torch.cuda.synchronize()
    for name, i in (("param", 0), ("mu", 1), ("nu", 2)):
        for leaf, a, b in zip(TRAINABLE, ka[i], pa[i]):
            check(torch.equal(a, b), f"adam_update: {name} of {leaf} "
                  f"differs from the plain version")
    check(int(ka[3].item()) == int(pa[3].item()) == 4,
          f"adam_update: count {int(ka[3].item())}")
    # from INT_MAX - 1: two steps each way, the count saturating
    ka, pa = clone_all(), clone_all()
    for c in (ka[3], pa[3]):
        c.fill_(INT32_MAX - 1)
    for step in range(2):
        launch_adam_update(ka[0], got, ka[1], ka[2], ka[3], TRAIN_LR)
        adam_update_plain(pa[0], got, pa[1], pa[2], pa[3], TRAIN_LR)
        check(all(torch.equal(a, b) for a, b in
                  zip(ka[0] + ka[1] + ka[2], pa[0] + pa[1] + pa[2]))
              and int(ka[3].item()) == int(pa[3].item()) == INT32_MAX,
              f"adam_update: step {step} from INT_MAX - 1 differs from "
              f"the plain version (count {int(ka[3].item())})")

    def one_step():
        k = clone_all()
        return functools.partial(launch_adam_update, k[0], got, k[1], k[2],
                                 k[3], TRAIN_LR)

    k22_name = one_kernel_a_call(one_step, "adam_kernel", "adam_update")
    p_total = sum(t.numel() for t in leaves)

    # times: each on its own clones (K22 updates in place)
    tk = clone_all()
    lib = [torch.nn.Parameter(t.clone()) for t in params]
    for prm, g in zip(lib, got):
        prm.grad = g.clone()
    fused = torch.optim.Adam(lib, lr=TRAIN_LR, fused=True)
    mlp = 59 * 64 + 64 * 64 + 64
    w_bytes = 4 * (mlp + 3 * 64 + 1)
    kernels["anomaly_train_fwd"].update(
        max_abs_err=loss_err,
        ms=device_ms(lambda: launch_anomaly_train_fwd(leaves, ids, feats,
                                                      labels), 20),
        plain_ms=device_ms(lambda: train_forward_plain(leaves, ids, feats,
                                                       labels), 3),
        # id_row, feats, label and the embedding row read; x, h1, h2
        # (bf16) and the logit written; the weights once
        bytes=n * (4 + 27 * 4 + 4 + 32 * 4 + (59 + 64 + 64) * 2 + 4)
        + w_bytes + 4,
        ops=0, flop_ms=n * 2 * mlp / BF16_FLOPS_PER_S * 1e3)
    kernels["anomaly_train_bwd"].update(
        max_abs_err=g_err,
        ms=device_ms(lambda: launch_anomaly_train_bwd(leaves, saved, ids,
                                                      labels, gloss), 20),
        plain_ms=device_ms(lambda: train_backward_plain(
            leaves, plain_saved, ids, labels, gloss), 3),
        # id_row, label, logit and the saved x, h1, h2 read, the weights
        # once; every gradient written, d_embed [V, 32] in full
        bytes=n * (4 + 4 + 4 + (59 + 64 + 64) * 2) + w_bytes
        + 4 * (mlp + 3 * 64 + 1) + v * 32 * 4,
        ops=0,
        # dh1, dx[:, :32] and the three weight gradients, on bf16 cores
        flop_ms=n * 2 * (64 * 64 + 64 * 32 + mlp) / BF16_FLOPS_PER_S * 1e3)
    kernels["adam_update"].update(
        max_abs_err=0.0,
        ms=device_ms(lambda: launch_adam_update(
            tk[0], got, tk[1], tk[2], tk[3], TRAIN_LR), 20),
        plain_ms=device_ms(lambda: adam_update_plain(
            tk[0], got, tk[1], tk[2], tk[3], TRAIN_LR), 3),
        library_ms=device_ms(fused.step, 20),
        # p, g, mu, nu read; p, mu, nu written
        bytes=28 * p_total, ops=0,
        flop_ms=p_total * 16 / F32_FLOPS_PER_S * 1e3)
    print(f"parity anomaly_train_fwd: B {n}, V {v} (one identity on {hot} "
          f"rows, id_row past V and negative): logits, x, h1, h2 "
          f"bit-exact; loss {loss_k.item():.6f} (abs err {loss_err:.3g})")
    print(f"parity anomaly_train_bwd: weight and bias gradients bit-exact, "
          f"d_embed bit-exact with embed_grad_sorted_plain, max abs err "
          f"{g_err:.3g} against index_add_ ({e_same:.5f} identical); the "
          f"sort a stable sort; two runs bit-identical")
    print(f"parity adam_update: {p_total} parameters, one step from count "
          f"3: params, mu, nu bit-exact, count 4; two from INT_MAX - 1 "
          f"bit-exact, the count saturated; one kernel a call ({k22_name})")
    s_err, s_gerr, s_same, s_split = sharded_train_kernels(
        torch, kernels, leaves, ids, feats, labels, gloss,
        kernels["anomaly_train_fwd"], kernels["anomaly_train_bwd"])
    report["train_kernels"] = {"rows": n, "v": v, "hot_rows": hot,
                               "k21_split": k21_split,
                               "k21s_split": s_split,
                               "loss_err": loss_err, "grad_err": g_err,
                               "embed_identical": e_same,
                               "parameters": p_total,
                               "shards": TRAIN_SHARDS,
                               "sharded_loss_err": s_err,
                               "sharded_grad_err": s_gerr,
                               "sharded_embed_identical": s_same}


def shard_mean(torch, parts):
    """The pmean in shard order: the first, then each next added, over
    S (a tensor, as K20s/K21s and the plain versions divide)."""
    total = parts[0]
    for t in parts[1:]:
        total = total + t
    return total / torch.tensor(float(len(parts)), device=total.device)


def sharded_train_kernels(torch, kernels, leaves, ids, feats, labels, gloss,
                          k20, k21):
    """K20s/K21s at phase 3's batch over TRAIN_SHARDS blocks: against
    their plain versions (K20's and K21's bounds) and against unsharded
    launches on the blocks and their shard-order mean (bit-exact), then
    timed beside their plain versions, with K20's and K21's byte and
    FLOP counts (the same rows, weights and gradients).  -> (loss err,
    gradient err, d_embed's identical share against the plain
    version, the K21s pass split)."""
    from cilium_tpu_torch.kernels import (launch_anomaly_train_bwd,
                                          launch_anomaly_train_fwd)
    from cilium_tpu_torch.ml.model import (TRAINABLE,
                                           embed_grad_sorted_plain,
                                           train_backward_plain,
                                           train_forward_plain)

    S = TRAIN_SHARDS
    n = ids.shape[0]
    blk = n // S
    blocks = [slice(z * blk, (z + 1) * blk) for z in range(S)]
    loss, saved = launch_anomaly_train_fwd(leaves, ids, feats, labels, S)
    ploss, psaved = train_forward_plain(leaves, ids, feats, labels, S)
    singles = [launch_anomaly_train_fwd(leaves, ids[b], feats[b], labels[b])
               for b in blocks]
    torch.cuda.synchronize()
    x, h1, h2, logit = psaved
    for got, want, what in ((saved["logit"], logit, "logit"),
                            (saved["xT"], x.t(), "x"),
                            (saved["h1T"], h1.t(), "h1"),
                            (saved["h2T"], h2.t(), "h2")):
        check(torch.equal(got, want),
              f"anomaly_train_fwd_sharded: {what} differs from the plain "
              f"version ({int((got != want).sum())} cells)")
    loss_err = abs(loss.item() - ploss.item())
    check(loss_err <= LOSS_RTOL * abs(ploss.item()),
          f"anomaly_train_fwd_sharded: loss {loss.item()} vs {ploss.item()}")
    check(torch.equal(loss, shard_mean(torch, [l for l, _ in singles])),
          f"anomaly_train_fwd_sharded: loss {loss.item()} is not the mean "
          f"of {S} unsharded launches' "
          f"{[l.item() for l, _ in singles]}")
    got = launch_anomaly_train_bwd(leaves, saved, ids, labels, gloss, S)
    again = launch_anomaly_train_bwd(leaves, saved, ids, labels, gloss, S)
    want = train_backward_plain(leaves, psaved, ids, labels, gloss, S)
    parts = [launch_anomaly_train_bwd(leaves, sv, ids[b], labels[b], gloss)
             for (_, sv), b in zip(singles, blocks)]
    torch.cuda.synchronize()
    g_err, e_same = 0.0, 1.0
    for i, (name, a, b, c) in enumerate(zip(TRAINABLE, got, again, want)):
        check(torch.equal(a, b), f"anomaly_train_bwd_sharded: d{name} "
              f"differs between two runs on the same inputs")
        mean = shard_mean(torch, [p[i] for p in parts])
        check(torch.equal(a, mean), f"anomaly_train_bwd_sharded: d{name} "
              f"is not the mean of {S} unsharded launches' (max abs err "
              f"{float((a - mean).abs().max().item())})")
        err = float((a - c).abs().max().item())
        g_err = max(g_err, err)
        if name == "embed":
            scale = float(c.abs().max().item())
            e_same = float((a == c).float().mean().item())
            check(err <= EMBED_TOL * scale,
                  f"anomaly_train_bwd_sharded: d_embed max abs err {err} "
                  f"(largest entry {scale})")
        else:
            check(err == 0, f"anomaly_train_bwd_sharded: d{name} differs "
                  f"from the plain version (max abs err {err})")
    check(all(float(g.abs().max().item()) > 0 for g in got),
          "anomaly_train_bwd_sharded: a zero gradient leaf")
    split = check_k21_call(
        torch, "anomaly_train_bwd_sharded",
        lambda sc: launch_anomaly_train_bwd(leaves, saved, ids, labels,
                                            gloss, S, scratch=sc),
        leaves[0].shape[0], got,
        embed_grad_sorted_plain(leaves, psaved, ids, labels, gloss, S),
        ids, S)
    for name, k, fn, plain, err in (
            ("anomaly_train_fwd_sharded", k20,
             lambda: launch_anomaly_train_fwd(leaves, ids, feats, labels, S),
             lambda: train_forward_plain(leaves, ids, feats, labels, S),
             loss_err),
            ("anomaly_train_bwd_sharded", k21,
             lambda: launch_anomaly_train_bwd(leaves, saved, ids, labels,
                                              gloss, S),
             lambda: train_backward_plain(leaves, psaved, ids, labels,
                                          gloss, S), g_err)):
        kernels[name].update(
            max_abs_err=err, ms=device_ms(fn, 20), plain_ms=device_ms(plain, 3),
            bytes=k["bytes"], ops=k["ops"], flop_ms=k["flop_ms"])
    print(f"parity anomaly_train_fwd_sharded: {S} shards of {blk} rows: "
          f"logits, x, h1, h2 bit-exact; loss {loss.item():.6f} (abs err "
          f"{loss_err:.3g}), bit-exact with the mean of {S} unsharded "
          f"launches")
    print(f"parity anomaly_train_bwd_sharded: weight and bias gradients "
          f"bit-exact, d_embed bit-exact with embed_grad_sorted_plain, "
          f"max abs err {g_err:.3g} against index_add_ ({e_same:.5f} "
          f"identical); every gradient bit-exact with the mean of {S} "
          f"unsharded launches; two runs bit-identical")
    return loss_err, g_err, e_same, split


TRAIN_STAGES = {"synth_labeled_traffic (host)": "main",
                "u32.from_numpy (upload)": "main",
                "datapath_step (K1 + K4 enqueued)": "main",
                "flow_features (K18 enqueued)": "main",
                "value_and_grad (K20 + K21 enqueued)": "main",
                "Adam.apply_ (K22 enqueued)": "main"}


def timed_train(clock):
    """Wrap train's stages (the module's own names, so train looks them
    up through the wrappers); -> a function that undoes it."""
    import importlib

    from cilium_tpu_torch import u32
    from cilium_tpu_torch.ml.train import Adam

    tm = importlib.import_module("cilium_tpu_torch.ml.train")
    spots = [(tm, "synth_labeled_traffic", "synth_labeled_traffic (host)"),
             (u32, "from_numpy", "u32.from_numpy (upload)"),
             (tm, "datapath_step", "datapath_step (K1 + K4 enqueued)"),
             (tm, "flow_features", "flow_features (K18 enqueued)"),
             (tm, "value_and_grad", "value_and_grad (K20 + K21 enqueued)"),
             (Adam, "apply_", "Adam.apply_ (K22 enqueued)")]
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in spots]
    for owner, attr, name in spots:
        clock.wrap(owner, attr, name)

    def undo():
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)

    return undo


def plain_train(torch, world, state, model, steps, seed=0, now=1000):
    """``train``'s loop through the plain versions on the card (the
    datapath step, K18's, K20-K22's), on ``state``, from the same rng
    stream; -> (leaves, losses)."""
    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.ml.features import flow_features_plain
    from cilium_tpu_torch.ml.model import (train_backward_plain,
                                           train_forward_plain)
    from cilium_tpu_torch.ml.train import (adam_update_plain,
                                           synth_labeled_traffic)

    rng = np.random.default_rng(seed)
    params = [t.clone() for t in model.leaves()]
    mu = [torch.zeros_like(t) for t in params]
    nu = [torch.zeros_like(t) for t in params]
    count = torch.zeros((), dtype=torch.int32, device="cuda")
    gloss = torch.ones(1, device="cuda")
    losses = []
    for s in range(steps):
        hdr_np, labels = synth_labeled_traffic(world, TRAIN_N, rng)
        hb = u32.from_numpy(hdr_np, "cuda")
        out = plain_serve(state, None, hb, now + s, 0)
        ids, feats = flow_features_plain(hb, out)
        lab = torch.from_numpy(labels).cuda()
        loss, saved = train_forward_plain(params, ids, feats, lab)
        grads = train_backward_plain(params, saved, ids, lab, gloss)
        adam_update_plain(params, grads, mu, nu, count, TRAIN_LR)
        losses.append(loss)
    return params, torch.stack(losses).cpu().tolist()


def profiled_steps(torch, fn):
    """Device kernel time and wall time of ``fn()`` under torch.profiler;
    -> (busy ms, wall ms, {kernel name: device ms}, {kernel name: events
    recorded})."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
    # device-side events only, as phase_breakdown reads them
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith("Activity Buffer")
              and e.self_device_time_total > 0]
    by_name = {e.key: e.self_device_time_total / 1e3 for e in events}
    return (sum(by_name.values()), wall, by_name,
            {e.key: e.count for e in events})


def k20_split(label, by_name, counts):
    """K20's one kernel (``fwd_rows``, its loss summed by the last block,
    one launch a step) in a profiled window of REPLAY_STEPS steps: {name:
    device ms a launch}, over the launches the profiler recorded (a
    dropped event would otherwise read as a lower time), printed with
    that count."""
    k20 = {k: v / counts[k] for k, v in by_name.items() if "fwd_rows" in k}
    print(f"{label}: K20 a step on the card: "
          + (", ".join(f"{k[:48]} {v:.4f} ms ({counts[k]} of "
                       f"{REPLAY_STEPS} launches recorded)"
                       for k, v in k20.items())
             or "no event recorded"))
    return k20


def phase_train(torch, rng, world, report):
    """Phase 14, the trainer on the card: (a) ``train`` at config #3 from
    label-initialised params at the reference's defaults (200 steps of
    4096, lr 3e-3), its first 8 steps replayed through the plain
    versions, the held-out AUC, steps/s and the per-step host/device
    split; (b) ``evaluate_real_dataset`` on the golden CIC capture at the
    reference test's arguments; (c) ``train_and_evaluate`` at its
    defaults, the checkpoint saved, reloaded and re-scored; (d) ``train``
    over ``make_mesh(8)`` (K20s/K21s) from (a)'s params, start state and
    seed: its first losses against (a)'s, the held-out AUC, steps/s and
    a profiled window's device share.  Returns the launch counts of
    (a)'s and (d)'s 200-step runs."""
    import copy

    import numpy as np
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts
    from cilium_tpu_torch.ml import (evaluate_capture, evaluate_real_dataset,
                                     load_model, train_and_evaluate)
    from cilium_tpu_torch.ml.model import TRAINABLE
    from cilium_tpu_torch.ml.train import train
    from cilium_tpu_torch.parallel import make_mesh
    from cilium_tpu_torch.testing.fixtures import build_world

    t_phase = time.monotonic()
    model0 = card_model(torch, world)
    start = card_state(world)

    # the first 8 steps, through the kernels and through the plain
    # versions, each on its own copy of the start state
    wk = copy.copy(world)
    wk.state = clone_state(start)
    mk, lk = train(model0, wk, steps=REPLAY_STEPS)
    pp, lp = plain_train(torch, world, clone_state(start), model0,
                         REPLAY_STEPS)
    l_err = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    p_err = max(float((a - b).abs().max().item())
                for a, b in zip(mk.leaves(), pp))
    check(l_err <= REPLAY_LOSS_RTOL, f"train: the plain replay's losses "
          f"differ by {l_err:.3g} relative ({lk} vs {lp})")
    check(p_err <= REPLAY_PARAM_TOL,
          f"train: the plain replay's params differ by {p_err}")

    # (a) the counted run, its stages timed on the host clock
    w = copy.copy(world)
    w.state = start
    clock = StageClock(TRAIN_STAGES)
    undo = timed_train(clock)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.monotonic()
    try:
        model, losses = train(model0, w, steps=TRAIN_STEPS)
    finally:
        undo()
    t_train = time.monotonic() - t0  # train's one fetch synced the card
    launches = {k: v.launches for k, v in KERNELS.items()}
    report["train_rows"] = {}
    rows_a_launch("train (a)", report["train_rows"])
    stages = clock.summary(t_train)
    for name in ("anomaly_train_fwd", "anomaly_train_bwd", "adam_update",
                 "flow_features", "datapath_wide"):
        check(launches[name] == TRAIN_STEPS,
              f"train: {name} launched {launches[name]} times in "
              f"{TRAIN_STEPS} steps")
    check(all(np.isfinite(losses)) and len(losses) == TRAIN_STEPS,
          "train: a non-finite loss")
    check(losses[:REPLAY_STEPS] == lk,
          f"train: the first {REPLAY_STEPS} losses differ from the same "
          f"steps' earlier run ({losses[:REPLAY_STEPS]} vs {lk})")
    check(losses[-1] < 0.6 * losses[0],
          f"train: the loss fell from {losses[0]} to {losses[-1]} only")
    check(all(bool(torch.isfinite(getattr(model, k)).all())
              for k in TRAINABLE), "train: a non-finite parameter")
    a_held = heldout_auc(torch, w, model)
    check(a_held > 0.9, f"train: held-out AUC {a_held}")
    busy, wall, by_name, counts = profiled_steps(
        torch, lambda: train(model, w, steps=REPLAY_STEPS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    per_step = t_train / TRAIN_STEPS * 1e3
    print(f"train (a): {TRAIN_STEPS} steps of {TRAIN_N} at config #3 (V "
          f"{model.embed.shape[0]}) in {t_train:.3f} s, "
          f"{TRAIN_STEPS / t_train:.1f} steps/s; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; held-out AUC {a_held:.4f}; the first "
          f"{REPLAY_STEPS} steps through the plain versions: losses within "
          f"{l_err:.3g} relative, params max abs err {p_err:.3g}; "
          f"K20/K21/K22 "
          f"{launches['anomaly_train_fwd']}/{launches['anomaly_train_bwd']}"
          f"/{launches['adam_update']} launches")
    print(f"train (a): a step {per_step:.3f} ms on the host clock; profiled "
          f"{REPLAY_STEPS} steps: device busy {busy / REPLAY_STEPS:.3f} ms a "
          f"step of {wall / REPLAY_STEPS:.3f} ({busy / wall:.1%}, idle "
          f"{1 - busy / wall:.1%}); device ms a step by kernel: "
          + ", ".join(f"{k[:40]} {v / REPLAY_STEPS:.4f}" for k, v in top))
    k20_ms = k20_split("train (a)", by_name, counts)
    print_stages("train (a) host stages", stages)
    mesh_report, mesh_launches = train_mesh(
        torch, world, model0, losses, make_mesh(TRAIN_SHARDS))

    # (b) the golden CIC capture
    t0 = time.monotonic()
    reset_launch_counts()
    r = evaluate_real_dataset(str(ROOT / GOLDEN[0]), str(ROOT / GOLDEN[1]),
                              n_identities=64, epochs=2, batch=1024,
                              train_frac=0.7)
    t_real = time.monotonic() - t0
    real_launches = KERNELS["anomaly_train_bwd"].launches
    check(r["packets"] == 6144 and r["train_packets"] == 4300
          and r["eval_packets"] == 1844 and r["eval_attack_packets"] > 100,
          f"train (b): {r}")
    check(r["anomaly_auc"] > 0.85, f"train (b): golden AUC {r}")
    check(real_launches == 2 * (4300 // 1024),
          f"train (b): K21 launched {real_launches} times")
    print(f"train (b): evaluate_real_dataset on the golden CIC capture "
          f"(6144 packets, 4300 to train, 2 epochs of 1024) in "
          f"{t_real:.3f} s: AUC {r['anomaly_auc']} on {r['eval_packets']} "
          f"held-out packets ({r['eval_attack_packets']} attacks), final "
          f"loss {r['final_loss']:.4f}")

    # (c) the config #5 pipeline at its defaults
    out_dir = ROOT / "chiprun_out"
    work = out_dir / "train_eval"
    work.mkdir(parents=True, exist_ok=True)
    path = str(out_dir / "trained_model.npz")
    t0 = time.monotonic()
    res = train_and_evaluate(model_out=path, workdir=str(work))
    t_eval = time.monotonic() - t0
    check(res["auc_heldout_kind"] > 0.9,
          f"train (c): held-out kind AUC {res['auc_by_kind']}")
    check(all(res["auc_by_kind"][k] > 0.95 for k in res["train_kinds"]),
          f"train (c): trained kinds' AUC {res['auc_by_kind']}")
    back = load_model(path, "cuda")
    fresh = build_world(n_identities=1024, n_rules=16, ct_capacity=1 << 18,
                        device="cuda")
    reset_launch_counts()
    again = evaluate_capture(back, fresh, res["eval_pcap"],
                             res["eval_pcap"].replace(".pcap", ".npz"))
    check(KERNELS["anomaly_score"].launches > 0,
          "train (c): the re-score did not launch K19")
    check(abs(again["anomaly_auc"] - res["auc_heldout_kind"]) <= 0.01,
          f"train (c): re-scored AUC {again['anomaly_auc']} vs "
          f"{res['auc_heldout_kind']}")
    for f in work.iterdir():
        f.unlink()
    work.rmdir()
    print(f"train (c): train_and_evaluate at its defaults (1024 "
          f"identities, 150 steps of 4096, {res['packets']} mixed eval "
          f"packets, {res['holdout_kind']} held out) in {t_eval:.3f} s: "
          f"AUC by kind {res['auc_by_kind']}, same-mix smoke "
          f"{res['auc_same_mix_smoke']}, final loss {res['final_loss']}; "
          f"saved to {path}, reloaded and re-scored on a fresh world: AUC "
          f"{again['anomaly_auc']}")
    t_phase = time.monotonic() - t_phase
    print(f"train: phase 14 in {t_phase:.1f} s")
    report["train"] = {
        "steps": TRAIN_STEPS, "batch": TRAIN_N, "train_s": t_train,
        "steps_per_s": TRAIN_STEPS / t_train, "losses": losses,
        "heldout_auc": a_held, "replay_loss_err": l_err,
        "replay_param_err": p_err,
        "device_busy_ms_per_step": busy / REPLAY_STEPS,
        "device_ms_by_name": by_name, "k20_ms_per_step": k20_ms,
        "wall_ms_per_step_profiled": wall / REPLAY_STEPS,
        "host_ms_per_step": per_step, "stages": stages,
        "golden": r, "golden_s": t_real, "train_and_evaluate": res,
        "train_and_evaluate_s": t_eval, "rescored_auc":
        again["anomaly_auc"], "phase_s": t_phase, "launches": launches,
        "mesh": mesh_report}
    return launches, mesh_launches


def heldout_auc(torch, w, model):
    """The reference test's held-out AUC: 4096 fresh rows (seed 999)
    through the datapath on ``w`` and scored by ``forward``."""
    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.datapath.verdict import datapath_step
    from cilium_tpu_torch.ml import (auc, flow_features, forward,
                                     synth_labeled_traffic)

    hdr_np, labels = synth_labeled_traffic(w, TRAIN_N,
                                           np.random.default_rng(999))
    hb = u32.from_numpy(hdr_np, "cuda")
    out, w.state = datapath_step(w.state, hb, 50_000)
    return auc(forward(model, *flow_features(hb, out)).cpu().numpy(), labels)


def train_mesh(torch, world, model0, unsharded, mesh):
    """Phase 14 (d): ``train(mesh=...)`` at the reference's defaults from
    (a)'s params and a fresh copy of its start state, on (a)'s seed.
    The loss falls below 0.6x its first value, nothing is non-finite,
    the first REPLAY_STEPS losses are within MESH_LOSS_RTOL of (a)'s
    ``unsharded`` ones, the held-out AUC is above 0.9, and every step ran
    K20s/K21s (no unsharded K20/K21).  -> (report, launch counts)."""
    import copy

    import numpy as np
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts
    from cilium_tpu_torch.ml.model import TRAINABLE
    from cilium_tpu_torch.ml.train import train

    w = copy.copy(world)
    w.state = card_state(world)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.monotonic()
    model, losses = train(model0, w, steps=TRAIN_STEPS, mesh=mesh)
    t_train = time.monotonic() - t0  # train's one fetch synced the card
    launches = {k: v.launches for k, v in KERNELS.items()}
    for name, want in (("anomaly_train_fwd_sharded", TRAIN_STEPS),
                       ("anomaly_train_bwd_sharded", TRAIN_STEPS),
                       ("adam_update", TRAIN_STEPS),
                       ("flow_features", TRAIN_STEPS),
                       ("datapath_wide", TRAIN_STEPS),
                       ("anomaly_train_fwd", 0), ("anomaly_train_bwd", 0)):
        check(launches[name] == want,
              f"train (d): {name} launched {launches[name]} times in "
              f"{TRAIN_STEPS} steps over {mesh.n_shards} shards")
    check(all(np.isfinite(losses)) and len(losses) == TRAIN_STEPS,
          "train (d): a non-finite loss")
    check(losses[-1] < 0.6 * losses[0],
          f"train (d): the loss fell from {losses[0]} to {losses[-1]} only")
    check(all(bool(torch.isfinite(getattr(model, k)).all())
              for k in TRAINABLE), "train (d): a non-finite parameter")
    l_err = max(abs(a - b) / abs(b) for a, b in
                zip(losses[:REPLAY_STEPS], unsharded[:REPLAY_STEPS]))
    check(l_err <= MESH_LOSS_RTOL,
          f"train (d): the first {REPLAY_STEPS} losses differ from the "
          f"unsharded run's by {l_err:.3g} relative "
          f"({losses[:REPLAY_STEPS]} vs {unsharded[:REPLAY_STEPS]})")
    a_held = heldout_auc(torch, w, model)
    check(a_held > 0.9, f"train (d): held-out AUC {a_held}")
    busy, wall, by_name, counts = profiled_steps(
        torch, lambda: train(model, w, steps=REPLAY_STEPS, mesh=mesh))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"train (d): {TRAIN_STEPS} steps of {TRAIN_N} over "
          f"{mesh.n_shards} shards in {t_train:.3f} s, "
          f"{TRAIN_STEPS / t_train:.1f} steps/s; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; held-out AUC {a_held:.4f}; the first "
          f"{REPLAY_STEPS} losses within {l_err:.3g} relative of (a)'s; "
          f"K20s/K21s/K22 "
          f"{launches['anomaly_train_fwd_sharded']}/"
          f"{launches['anomaly_train_bwd_sharded']}/"
          f"{launches['adam_update']} launches")
    print(f"train (d): profiled {REPLAY_STEPS} steps: device busy "
          f"{busy / REPLAY_STEPS:.3f} ms a step of {wall / REPLAY_STEPS:.3f} "
          f"({busy / wall:.1%}, idle {1 - busy / wall:.1%}); device ms a "
          f"step by kernel: "
          + ", ".join(f"{k[:40]} {v / REPLAY_STEPS:.4f}" for k, v in top))
    k20_ms = k20_split("train (d)", by_name, counts)
    return {"shards": mesh.n_shards, "train_s": t_train,
            "steps_per_s": TRAIN_STEPS / t_train, "losses": losses,
            "heldout_auc": a_held, "first_loss_err": l_err,
            "device_busy_ms_per_step": busy / REPLAY_STEPS,
            "wall_ms_per_step_profiled": wall / REPLAY_STEPS,
            "device_ms_by_name": by_name, "k20_ms_per_step": k20_ms,
            "launches": launches}, launches


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
        # the v6 rows' LPM probes: the remote address (the source of an
        # ingress row, the destination of an egress one) through the index
        lpm = kl.state.ipcache
        remote = torch.where((hdr[:, 15] == 0)[:, None], hdr[:, 0:4],
                             hdr[:, 4:8])
        probes = lpm6_probes(lpm, remote.contiguous(), hdr[:, 13])
        kernels[name]["bytes"] = (
            N * (row_b + 24 + 2 * 64 + 8 * 4)
            + hits * 68 + min(32 * probes, lpm.v6_index.numel() * 4)
            + (0 if scal else N * 7))
        kernels[name]["ops"] = (N * (2 * (10 * 4 + 12 + 16 * 3) + 120)
                                + probes * 24)
        kernels[name]["v6_rows"] = n_v6
        print(f"parity {name}: {N} rows ({n_v6} v6, a share of "
              f"{n_v6 / N:.4f}, {probes} v6 index probes, {hits} CT hits"
              f"{', every channel + audit' if opts else ''}), bit-exact")
        s_t = fork(kl.state)  # only its metrics change, by atomic adds
        kernels[name]["ms"] = device_ms(
            lambda: verdict_stage(s_t, rows, now, **scal, **opts), 20)
        kernels[name]["plain_ms"] = device_ms(
            lambda: verdict_stage_plain(
                s_t, unpack_hdr(rows, **scal) if scal else rows, now,
                **opts), 3)

    # K1 packed with audit on: the same rows, bit for bit; its policy
    # drops of new flows forward, their reasons kept (phase 19 (d))
    sk, sp = fork(kl.state), fork(kl.state)
    ak, cin_k = verdict_stage(sk, packed, now, ep=0, dirn=0, audit=True)
    ap, cin_p = verdict_stage_plain(sp, unpack_hdr(packed, ep=0, dirn=0),
                                    now, audit=True)
    err = max(max_abs_err(ak, ap, "datapath_packed out, audit"),
              max_abs_err(sk.metrics, sp.metrics,
                          "datapath_packed metrics, audit"))
    for f in ("l4", "fwd", "result", "slot", "is_reply", "do_create",
              "proxy_port"):
        err = max(err, max_abs_err(getattr(cin_k, f), getattr(cin_p, f),
                                   f"datapath_packed {f}, audit"))
    audited = audited_rows(ak)
    check(audited > 0, "datapath_packed, audit: no policy drop to audit")
    k1 = kernels["datapath_packed"]
    k1["max_abs_err"] = max(k1["max_abs_err"], err)
    k1["audit_rows"] = audited
    print(f"parity datapath_packed with audit: {N} rows, {audited} "
          f"would-be policy drops forwarded with their reasons, bit-exact")

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
    # and at the daemon's bucket: the batch's first 2^16 rows
    n16 = 1 << 16
    out16 = out_k[:n16]
    kept16 = int(((out16[:, 5] != 0)
                  | (torch.arange(n16, device="cuda") % 1024 == 0)).sum())
    rec = {"rows": n16, "ms": device_ms(
        lambda r: rg.ring_append(r, out16, 7, 1024, None, ports), 20,
        lambda: rg.EventRing.create(RING_CAPACITY, "cuda")),
        "plain_ms": device_ms(
            lambda r: rg.ring_append_plain(r, out16, 7, 1024, None, ports),
            3, lambda: rg.EventRing.create(RING_CAPACITY, "cuda"))}
    rec["bound_ms"], rec["bound_by"] = bound(n16 * 24 + kept16 * 8 + 16,
                                             n16 * 30)
    kernels["ring_append"]["at_65536"] = rec
    # the kernel at this bucket (1 row a thread) on the served rows
    rings = [rg.EventRing.create(RING_CAPACITY, "cuda") for _ in range(2)]
    rg.ring_append(rings[0], out16, 7, 1024, None, ports)
    rg.ring_append_plain(rings[1], out16, 7, 1024, None, ports)
    kernels["ring_append"]["max_abs_err"] = max(
        kernels["ring_append"].get("max_abs_err", 0),
        max_abs_err(rings[0].buf, rings[1].buf, "ring buf at 2^16"),
        max_abs_err(rings[0].cursor, rings[1].cursor, "ring cursor at 2^16"))
    print(f"ring_append at {n16} rows ({kept16} kept): {rec['ms']:.4f} ms "
          f"(plain {rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.6f} "
          f"ms by {rec['bound_by']}); at {N} rows "
          f"{kernels['ring_append']['ms']:.4f} ms ({kept} kept)")


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
              "ct_update": ("ct_", "Memset"),
              "ring_append": ("ring_", "void ring_")}
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


def phase_k1_k4_shapes(torch, rng, world, report):
    """K1/K1s and K4/K4s at the shapes the main paths launch them, each
    on a 2^20 CT of its own: the trainer's 4096 wide rows (after 8
    warm-up steps of ``datapath_step``), phase 8's 1024-row batches of
    new flows (wide SYN rows, ``syn_rows``), the daemon's 2^16 packed
    bucket,
    the slice's 2^18 packed batch, and a 2^16 and a 2^18 bucket routed
    to 8 shards (headroom 2), a SYN batch then a steady one.  Each K1
    and K4 call is one kernel, ``datapath_kernel`` and
    ``ct_update_kernel`` (``testing.capture.ops_a_call``: the call
    captured into a CUDA graph, its nodes counted); K4 equals its plain
    version (per shard for K4s), and the rounds it ran (its pending
    counts) equal the plain version's; each timed (``device_ms``)."""
    import copy
    import functools

    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import pack_eligibility, pack_rows
    from cilium_tpu_torch.datapath import conntrack as ct
    from cilium_tpu_torch.datapath.verdict import datapath_step
    from cilium_tpu_torch.kernels import launch_ct_update, launch_datapath
    from cilium_tpu_torch.ml import synth_labeled_traffic
    from cilium_tpu_torch.parallel import mesh as pm
    from cilium_tpu_torch.parallel import route_by_flow
    from cilium_tpu_torch.testing import fixtures as fx
    from cilium_tpu_torch.testing.capture import ops_a_call

    t0 = time.monotonic()
    now = 60_000

    def fork(state):  # the verdict stage reads the CT, adds to metrics
        s2 = copy.copy(state)
        s2.metrics = state.metrics.clone()
        return s2

    def fresh_ct(c):
        return ct.CTTable(c.table.clone(), c.fp.clone(), c.dropped.clone(),
                          torch.full((2, c.table.shape[0]), -1,
                                     dtype=torch.int32, device="cuda"))

    def packed(hdr, shards):
        if shards == 1:
            return u32.from_numpy(pack_rows(hdr), "cuda"), None, \
                dict(ep=0, dirn=0)
        n = len(hdr)
        r, valid, _o, _ovf = route_by_flow(hdr, shards, 2 * n // shards)
        ok, ep, dirn = pack_eligibility(hdr)
        check(ok, "k1/k4 shapes: a batch is not packed-eligible")
        return (u32.from_numpy(pack_rows(r), "cuda"),
                torch.from_numpy(valid).cuda(), dict(ep=ep, dirn=dirn))

    cases = []  # (name, state, [(phase, rows, valid, meta)], shards)
    st = card_state(world)
    for s_ in range(8):
        hdr, _ = synth_labeled_traffic(world, TRAIN_N, rng)
        datapath_step(st, u32.from_numpy(hdr, "cuda"), now - 8 + s_)
    hdr, _ = synth_labeled_traffic(world, TRAIN_N, rng)
    cases.append(("train 4096 wide", st,
                  [("steady", u32.from_numpy(hdr, "cuda"), None, {})], 1))
    pod = world.pod_ips
    cases.append(("redirect 1024 wide", card_state(world), [(
        "syn", u32.from_numpy(syn_rows(pod[1], pod[0], 1024, 1024, 80, 0, 0),
                              "cuda"), None, {})], 1))
    for n, tag, shards in ((1 << 16, "daemon 2^16 packed", 1),
                           (N, "slice 2^18 packed", 1),
                           (1 << 16, "2^16 bucket x 8 shards", SHARDS),
                           (N, "2^18 bucket x 8 shards", SHARDS)):
        pool = fx.steady_flow_pool(world, n, rng)
        cases.append((tag, card_state(world),
                      [("syn",) + packed(pool, shards),
                       ("steady",) + packed(fx.steady_traffic(pool, n, rng),
                                            shards)], shards))
    out = {}
    for name, state, phases, shards in cases:
        sh = None if shards == 1 else shards
        for phase, rows, valid, meta in phases:
            ep, dirn = meta.get("ep"), meta.get("dirn")

            def k1(s2=None):
                return launch_datapath(s2 or fork(state), rows, now, ep,
                                       dirn, valid, None, None, None, False,
                                       n_shards=sh)

            k1_kernels = ops_a_call(
                lambda: functools.partial(k1, fork(state)))
            s_t = fork(state)
            k1_ms = device_ms(lambda: k1(s_t), 20)
            _out, c = k1(state)  # the state's metrics move on
            args = (c.l4, c.fwd, c.result, c.slot, c.is_reply, c.do_create,
                    c.proxy_port, now)
            kc, pc, scratch, stats = (fresh_ct(state.ct),
                                      fresh_ct(state.ct), {}, {})
            launch_ct_update(kc, *args, valid, n_shards=sh, scratch=scratch)
            k4_kernels = ops_a_call(
                lambda: functools.partial(
                    launch_ct_update, fresh_ct(state.ct), *args, valid,
                    n_shards=sh))
            if sh is None:
                ct.ct_update_plain(pc, *args, valid, stats=stats)
            else:
                pm.sharded_ct_update_plain(pc, c, now, shards, valid)
            for g, w_, what in ((kc.table, pc.table, "table"),
                                (kc.fp, pc.fp, "fp"),
                                (kc.dropped, pc.dropped, "dropped")):
                max_abs_err(g, w_, f"{name} {phase}: ct_update {what}")
            counts = scratch["counts"].cpu().tolist()
            rounds = sum(1 for x in counts[:-1] if x > 0)
            check(sh is not None or counts == stats["pending"],
                  f"{name} {phase}: K4's pending counts {counts}, the plain "
                  f"version's {stats.get('pending')}")
            check(list(k1_kernels.values()) == [1]
                  and "datapath_kernel" in next(iter(k1_kernels))
                  and list(k4_kernels.values()) == [1]
                  and "ct_update_kernel" in next(iter(k4_kernels))
                  and bool((kc.claim == -1).all()),
                  f"{name} {phase}: kernels a call K1 {k1_kernels}, K4 "
                  f"{k4_kernels}, or claim words left set")
            k4_ms = device_ms(lambda w_: launch_ct_update(
                w_, *args, valid, n_shards=sh), 20,
                lambda: fresh_ct(state.ct))
            launch_ct_update(state.ct, *args, valid, n_shards=sh)
            out[f"{name} {phase}"] = dict(
                rows=int(rows.shape[0]), k1_ms=k1_ms, k4_ms=k4_ms,
                k4_rounds=rounds, k4_pending=counts,
                k1_kernels=k1_kernels, k4_kernels=k4_kernels)
            print(f"k1/k4 {name} {phase}: {rows.shape[0]} rows, K1 "
                  f"{k1_ms:.4f} ms, K4 {k4_ms:.4f} ms, one kernel each "
                  f"(a captured call: {next(iter(k1_kernels))[:40]}, "
                  f"{next(iter(k4_kernels))[:40]}); "
                  f"K4 ran {rounds} rounds (pending {counts[:rounds + 1]}, "
                  f"dropped {counts[-1]})")
    report["k1_k4_shapes"] = out
    print(f"k1/k4 shapes: {time.monotonic() - t0:.1f} s")


SHARDS = 8  # K6's maximum, and the reference test's mesh
SHARD_HEADROOM = 2  # start_serving's default
SHARD_BLOCK = SHARD_HEADROOM * N // SHARDS  # 2^16 routed rows a shard
SHARD_ROWS = SHARDS * SHARD_BLOCK  # 2^19 routed rows a batch
SKEW_ROWS = 80_000  # batch 5: one flow on these rows overflows its shard
SHARD_STAGES = {"submit: queue copy in": "producer",
                "batcher: dequeue + assemble": "drain",
                "dispatch: serve_batch, all": "drain",
                "sharded leg: route + re-pack + serve_sharded":
                    "drain",
                "route: route_by_flow": "drain",
                "re-pack: pack_rows": "drain",
                "loader: staging copy + K1s/K4s/K5s enqueued": "drain",
                "drain tick: cursor read (waits for the card), K6 "
                "gather, copy start": "drain",
                "event join, all": "worker"}


def shard_batches(torch, rng, world):
    """Phase 15's routed batches on the card: 8 packed from a 2^18
    bucket (a pool of SYNs, then steady draws; batch 5 skewed: one flow
    on SKEW_ROWS rows overflows its shard on the host) and 2 wide (IPv6,
    ICMP errors), each flow-routed into 8 blocks of 2^16 (headroom 2).
    Returns [(kind, rows, valid, stream scalars, overflow)]."""
    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import pack_eligibility, pack_rows
    from cilium_tpu_torch.parallel import route_by_flow
    from cilium_tpu_torch.testing import fixtures as fx

    pool = fx.steady_flow_pool(world, N, rng)
    wpool = fx.wide_flow_pool(world, 1 << 16, rng)
    hdrs = [("packed", pool)] + [("packed", fx.steady_traffic(pool, N, rng))
                                 for _ in range(7)]
    hdrs[5][1][:SKEW_ROWS] = hdrs[5][1][0]
    hdrs += [("wide", fx.wide_traffic(wpool, N, rng)) for _ in range(2)]
    out = []
    for kind, hdr in hdrs:
        routed, valid, _orig, ovf = route_by_flow(hdr, SHARDS, SHARD_BLOCK)
        meta = {}
        if kind == "packed":
            ok, ep, dirn = pack_eligibility(hdr)
            check(ok, "sharded: a steady batch is not packed-eligible")
            routed, meta = pack_rows(routed), dict(ep=ep, dirn=dirn)
        out.append((kind, u32.from_numpy(routed, "cuda"),
                    torch.from_numpy(valid).cuda(), meta, ovf))
    return out


def phase_sharded_kernels(torch, rng, world, kernels, report):
    """Phase 15 (a): K1s/K4s/K5s against the plain per-shard loop on the
    card, at config #3 with a half-full 2^20 CT over 8 shards and 2^19
    routed rows a batch; one batch also against 8 unsharded K1/K4/K5
    calls, each on its shard's slice as a table of its own; then each
    sharded kernel timed beside its plain version and its bound."""
    import functools

    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.datapath import conntrack as ct
    from cilium_tpu_torch.datapath.verdict import (DatapathState,
                                                   verdict_stage)
    from cilium_tpu_torch.kernels import (launch_ct_update,
                                          launch_datapath,
                                          launch_ring_append)
    from cilium_tpu_torch.monitor import ring as rg
    from cilium_tpu_torch.parallel import mesh as pm

    import copy

    t0 = time.monotonic()
    now = 10_000
    table, fp, _rows = half_full_table(rng, now)
    base = card_state(world)
    base.ct.table.copy_(u32.from_numpy(table, "cuda"))
    base.ct.fp.copy_(u32.from_numpy(fp, "cuda"))
    batches = shard_batches(torch, rng, world)
    mesh = pm.make_mesh(SHARDS)
    pp = u32.from_numpy(np.array([10000], np.uint32), "cuda")
    states = [clone_state(base), clone_state(base)]
    rings = [pm.make_sharded_ring(mesh, RING_CAPACITY) for _ in range(2)]
    errs = {"packed": 0, "wide": 0}
    for b, (kind, rows, valid, meta, ovf) in enumerate(batches):
        outs = [f(st, r, rows, now + b, b, SHARDS, valid=valid,
                  proxy_ports=pp, **meta)
                for f, st, r in ((pm.sharded_serve_launch, states[0],
                                  rings[0]),
                                 (pm.sharded_serve_plain, states[1],
                                  rings[1]))]
        errs[kind] = max(errs[kind], max_abs_err(
            outs[0], outs[1], f"sharded out rows, batch {b} ({kind})"))
    ks, ps = states
    e1 = max(max_abs_err(ks.metrics, ps.metrics, "sharded metrics"),
             errs["packed"])
    e4 = max(max_abs_err(ks.ct.table, ps.ct.table, "sharded CT table"),
             max_abs_err(ks.ct.fp, ps.ct.fp, "sharded CT fp"),
             max_abs_err(ks.ct.dropped, ps.ct.dropped, "sharded dropped"))
    e5 = max(max_abs_err(rings[0].buf, rings[1].buf, "sharded ring"),
             max_abs_err(rings[0].cursor, rings[1].cursor,
                         "sharded cursors"))
    check(bool((ks.ct.claim == -1).all()),
          "sharded ct_update left claim words set")
    kernels["datapath_packed_sharded"]["max_abs_err"] = e1
    kernels["datapath_wide_sharded"]["max_abs_err"] = max(errs["wide"], e1)
    kernels["ct_update_sharded"]["max_abs_err"] = e4
    kernels["ring_append_sharded"]["max_abs_err"] = e5
    ovf = [x[4] for x in batches]
    check(ovf[5] > 0 and sum(ovf) == ovf[5],
          f"sharded: the skewed batch alone must overflow: {ovf}")
    totals = rg._cursor_totals(u32.to_numpy(rings[0].cursor))
    live = int((ks.ct.table[:, ct.V_STATE] != 0).sum())
    print(f"parity sharded: {len(batches)} batches of {SHARD_ROWS} routed "
          f"rows ({SHARDS} shards of {SHARD_BLOCK}, 8 packed + 2 wide), "
          f"host overflow {ovf[5]} in batch 5; out rows, metrics, CT "
          f"({live} live, dropped {int(ks.ct.dropped)}), ring ({totals.tolist()}"
          f" events a shard) and cursors bit-exact")

    # one launch sequence == 8 unsharded K1/K4/K5 calls, each on its
    # shard's CT slice and ring as a table and ring of its own
    kind, rows, valid, meta, _ovf = batches[1]
    a, u = clone_state(base), clone_state(base)
    ra, ru = (pm.make_sharded_ring(mesh, RING_CAPACITY) for _ in range(2))
    out_a = pm.sharded_serve_launch(a, ra, rows, now, 1, SHARDS,
                                    valid=valid, proxy_ports=pp, **meta)
    cs, blk = CT_CAPACITY // SHARDS, SHARD_BLOCK
    outs, m_parts, d_parts = [], [], []
    for s in range(SHARDS):
        r = slice(s * blk, (s + 1) * blk)
        part = DatapathState(
            policy=u.policy, ipcache=u.ipcache,
            ct=ct.CTTable(u.ct.table[s * cs:(s + 1) * cs],
                          u.ct.fp[s * cs:(s + 1) * cs],
                          torch.zeros_like(u.ct.dropped)),
            metrics=torch.zeros_like(u.metrics))
        out, c = verdict_stage(part, rows[r], now, valid=valid[r], **meta)
        ct.ct_update(part.ct, c.l4, c.fwd, c.result, c.slot, c.is_reply,
                     c.do_create, c.proxy_port, now, valid=valid[r])
        rg.ring_append(rg.EventRing(ru.buf[s * RING_CAPACITY:
                                           (s + 1) * RING_CAPACITY],
                                    ru.cursor[s]),
                       out, 1, 1024, valid[r], pp)
        outs.append(out)
        m_parts.append(part.metrics)
        d_parts.append(part.ct.dropped)
    for total, parts in ((u.metrics, m_parts), (u.ct.dropped, d_parts)):
        total.copy_(u32.narrow(u32.widen(total)
                               + sum(u32.widen(p) for p in parts)))
    for g, w, what in ((out_a, torch.cat(outs), "out rows"),
                       (a.metrics, u.metrics, "metrics"),
                       (a.ct.table, u.ct.table, "CT table"),
                       (a.ct.fp, u.ct.fp, "CT fp"),
                       (a.ct.dropped, u.ct.dropped, "dropped"),
                       (ra.buf, ru.buf, "ring"),
                       (ra.cursor, ru.cursor, "cursors")):
        max_abs_err(g, w, f"sharded vs {SHARDS} unsharded calls: {what}")
    print(f"parity sharded: one K1s/K4s/K5s sequence equals {SHARDS} "
          f"unsharded K1/K4/K5 calls on the shards' slices, bit-exact")

    # K1s (and K4s after it) with audit on, packed and wide, against the
    # plain per-shard loop (phase 19 (d))
    for b in (1, 8):
        kind, rows, valid, meta, _ovf = batches[b]
        a, p = clone_state(base), clone_state(base)
        outs = [f(st, None, rows, now + b, b, SHARDS, valid=valid,
                  proxy_ports=pp, audit=True, **meta)
                for f, st in ((pm.sharded_serve_launch, a),
                              (pm.sharded_serve_plain, p))]
        err = max(max_abs_err(outs[0], outs[1], f"sharded {kind}, audit"),
                  max_abs_err(a.metrics, p.metrics,
                              f"sharded {kind} metrics, audit"),
                  max_abs_err(a.ct.table, p.ct.table,
                              f"sharded {kind} CT, audit"))
        k1s = kernels[f"datapath_{kind}_sharded"]
        k1s["max_abs_err"] = max(k1s["max_abs_err"], err)
        k1s["audit_rows"] = audited_rows(outs[0])
        check(k1s["audit_rows"] > 0, f"sharded {kind}, audit: no policy "
              f"drop to audit")
    print(f"parity sharded with audit: K1s packed and wide on batches 1 "
          f"and 8 equal the plain per-shard loop (out rows, metrics, CT), "
          f"{kernels['datapath_packed_sharded']['audit_rows']} and "
          f"{kernels['datapath_wide_sharded']['audit_rows']} would-be "
          f"policy drops forwarded")

    # timings at the main path's shapes: 2^19 routed rows a batch
    def fork(state):  # the verdict stage reads the CT, adds to metrics
        s2 = copy.copy(state)
        s2.metrics = state.metrics.clone()
        return s2

    ms = {}
    for name, (kind, rows, valid, meta, _ovf) in (
            ("datapath_packed_sharded", batches[1]),
            ("datapath_wide_sharded", batches[8])):
        s_t = fork(ks)
        ep, dirn = meta.get("ep"), meta.get("dirn")
        kernels[name]["ms"] = device_ms(
            lambda: launch_datapath(s_t, rows, now, ep, dirn, valid, None,
                                    None, None, False, n_shards=SHARDS), 20)
        kernels[name]["plain_ms"] = device_ms(
            lambda: pm.sharded_verdict_plain(s_t, rows, now, SHARDS, valid,
                                             ep, dirn), 3)
        out_k, c = launch_datapath(fork(ks), rows, now, ep, dirn, valid,
                                   None, None, None, False,
                                   n_shards=SHARDS)
        hits = int(((out_k[:, 2] != 0) & valid).sum())
        n_valid = int(valid.sum())
        hdr_w = rows if not meta else None
        n_v6 = (0 if meta else int(((hdr_w[:, 13] != 4) & valid).sum()))
        row_b = 16 if meta else 64
        kernels[name]["bytes"] = (
            SHARD_ROWS * (row_b + 24 + 1) + n_valid * (2 * 64 + 8 * 4)
            + hits * 68 + ks.ipcache.v6_net.numel() * 9)
        kernels[name]["ops"] = (
            n_valid * (2 * (10 * 4 + 12 + 16 * 3) + 120)
            + n_v6 * ks.ipcache.v6_net.shape[0] * 14)
        ms[name] = (out_k, c, valid)
    out_k, c, valid = ms["datapath_packed_sharded"]

    def fresh_ct():
        return ct.CTTable(ks.ct.table.clone(), ks.ct.fp.clone(),
                          ks.ct.dropped.clone(), torch.full_like(ks.ct.claim,
                                                                 -1))

    args = (c.l4, c.fwd, c.result, c.slot, c.is_reply, c.do_create,
            c.proxy_port, now)
    kernels["ct_update_sharded"]["ms"] = device_ms(
        lambda w: launch_ct_update(w, *args, valid, n_shards=SHARDS), 20,
        fresh_ct)
    kernels["ct_update_sharded"]["plain_ms"] = device_ms(
        lambda w: pm.sharded_ct_update_plain(w, c, now, SHARDS, valid), 3,
        fresh_ct)
    work = fresh_ct()
    pm.sharded_ct_update_plain(work, c, now, SHARDS, valid)
    hit = (c.result != 0) & valid
    # global slots of the hits: shard base + the local slot
    shard = torch.arange(SHARD_ROWS, device="cuda") // SHARD_BLOCK
    gslot = shard * (CT_CAPACITY // SHARDS) + c.slot.to(torch.int64)
    hs = torch.unique(gslot[hit])
    sectors = torch.unique(torch.cat([(hs * 68 + 40) // 32,
                                      (hs * 68 + 63) // 32])).numel()
    inserted = int(((work.table[:, 10] != 0)
                    & (ks.ct.table[:, 10] == 0)).sum())
    pend = int((c.do_create & (c.result == 0) & valid).sum())
    kernels["ct_update_sharded"]["bytes"] = (
        SHARD_ROWS * (4 + 1 + 1) + int(hit.sum()) * (4 + 1 + 12)
        + sectors * 32 * 2 + pend * (40 + 8 + 4 + 64) + inserted * (68 + 4)
        + 4)
    kernels["ct_update_sharded"]["ops"] = (SHARD_ROWS * 40
                                           + pend * (10 * 4 + 20 * 30))
    kernels["ring_append_sharded"]["ms"] = device_ms(
        lambda r: launch_ring_append(r, out_k, 7, 1024, valid, pp,
                                     n_shards=SHARDS), 20,
        lambda: pm.make_sharded_ring(mesh, RING_CAPACITY))
    kernels["ring_append_sharded"]["plain_ms"] = device_ms(
        lambda r: pm.sharded_ring_append_plain(r, out_k, 7, SHARDS, 1024,
                                               valid, pp), 3,
        lambda: pm.make_sharded_ring(mesh, RING_CAPACITY))
    local = torch.arange(SHARD_ROWS, device="cuda") % SHARD_BLOCK
    kept = int((((out_k[:, 5] != 0) | (local % 1024 == 0)) & valid).sum())
    kernels["ring_append_sharded"]["bytes"] = (SHARD_ROWS * (24 + 1)
                                               + kept * 8 + 16 * SHARDS)
    kernels["ring_append_sharded"]["ops"] = SHARD_ROWS * 30
    k5s_name = one_kernel_a_call(lambda: functools.partial(
        launch_ring_append, pm.make_sharded_ring(mesh, RING_CAPACITY), out_k,
        7, 1024, valid, pp, n_shards=SHARDS), "ring_append_kernel",
        "ring_append_sharded")
    k = {n: kernels[n]["ms"] for n in ("datapath_packed_sharded",
                                       "ct_update_sharded",
                                       "ring_append_sharded")}
    unsharded = sum(kernels[n]["ms"] for n in ("datapath_packed",
                                               "ct_update", "ring_append"))
    bounds = sum(bound(kernels[n]["bytes"], kernels[n]["ops"])[0]
                 for n in k)
    print(f"sharded kernels at {SHARD_ROWS} routed rows: K1s "
          f"{k['datapath_packed_sharded']:.4f} ms (wide "
          f"{kernels['datapath_wide_sharded']['ms']:.4f}), K4s "
          f"{k['ct_update_sharded']:.4f}, K5s "
          f"{k['ring_append_sharded']:.4f} (one kernel a call, "
          f"{k5s_name}); sum {sum(k.values()):.4f} ms "
          f"against 2 x (K1 + K4 + K5) at {N} rows = {2 * unsharded:.4f} "
          f"ms; bound {bounds:.4f} ms")
    report["sharded_kernels"] = {
        "seconds": time.monotonic() - t0, "overflow": ovf,
        "events_per_shard": totals.tolist(), "ct_live": live,
        "sum_ms": sum(k.values()), "unsharded_x2_ms": 2 * unsharded,
        "bound_ms": bounds}


def phase_sharded_daemon(torch, rng, world, report):
    """Phase 15 (b): config #3's daemon serving sharded over 8 shards on
    the card: 2^21 packets of phase 7's steady traffic (ledger exact, no
    event lost, route overflow equal to its metric and its DROP events,
    per-reason metrics equal to the fixed-batch run when nothing
    overflowed or dropped), then 2^16 wide rows (IPv6, ICMP errors) so
    the wide sharded kernel runs too; a timed session (StageClock) and a
    profiled one.  Returns the launches of the first two sessions."""
    import numpy as np
    from cilium_tpu_torch import parallel
    from cilium_tpu_torch.core import packets
    from cilium_tpu_torch.core.packets import COL_EP
    from cilium_tpu_torch.datapath.verdict import REASON_ROUTE_OVERFLOW
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts
    from cilium_tpu_torch.monitor.api import MSG_DROP
    from cilium_tpu_torch.testing import fixtures as fx

    t0 = time.monotonic()
    d, db, rows = config3_daemon(world, rng)
    ovf_events = [0]

    def count_overflow(batch):
        ovf_events[0] += int(((batch.msg_type == MSG_DROP)
                              & (batch.reason == REASON_ROUTE_OVERFLOW))
                             .sum())

    d.monitor.register("smoke-route-overflow", count_overflow)
    reset_launch_counts()
    d.start()
    out, t_serve = serve_session(d, rows, mesh=SHARDS)
    m_daemon = d.loader.metrics()
    dropped = int(d.loader.state.ct.dropped) & 0xFFFFFFFF
    wide = fx.wide_traffic(fx.wide_flow_pool(world, 1 << 14, rng), 1 << 16,
                           rng)
    wide[:, COL_EP] = db.id
    out_w, _t = serve_session(d, wide, mesh=SHARDS)
    launches = {k: v.launches for k, v in KERNELS.items()}
    report["sharded_daemon_rows"] = {}
    rows_a_launch("sharded daemon", report["sharded_daemon_rows"])
    for o, n in ((out, len(rows)), (out_w, len(wide))):
        fe, ft = o["front-end"], o["front-end"]["fault-tolerance"]
        check(fe["submitted"] == fe["verdicts"] + fe["shed"]
              + ft["recovery-dropped"], f"sharded daemon: ledger {fe}")
        check(fe["verdicts"] == n and ft["recovery-dropped"] == 0
              and o["lost"] == 0 and o["events"] > 0
              and o["shards"] == SHARDS,
              f"sharded daemon: {fe['verdicts']} verdicts of {n}, "
              f"{o['events']} events, {o['lost']} lost")
    ovf = out["route-overflow"] + out_w["route-overflow"]
    m_all = d.loader.metrics()
    check(ovf == int(m_all[REASON_ROUTE_OVERFLOW, 0]) == ovf_events[0],
          f"sharded daemon: route overflow {ovf}, metric "
          f"{int(m_all[REASON_ROUTE_OVERFLOW, 0])}, events {ovf_events[0]}")
    for name in ("datapath_packed_sharded", "datapath_wide_sharded",
                 "ct_update_sharded", "ring_append_sharded", "ring_gather"):
        check(launches[name] > 0, f"sharded daemon: {name} never launched")
    for name in ("datapath_packed", "datapath_wide", "ct_update",
                 "ring_append"):
        check(launches[name] == 0,
              f"sharded daemon: the single-shard {name} ran")
    if out["route-overflow"] == 0 and dropped == 0:
        m_fixed = fixed_batch_metrics(d, db, rows)
        check(np.array_equal(m_daemon, m_fixed),
              f"sharded daemon: metrics {m_daemon.tolist()} differ from "
              f"the fixed-batch run {m_fixed.tolist()}")
        same = "equal the fixed-batch serve_packed run"
    else:
        same = (f"not compared (overflow {out['route-overflow']}, CT drops "
                f"{dropped})")
    fe = out["front-end"]
    print(f"sharded daemon: {len(rows)} packets over {SHARDS} shards in "
          f"{t_serve:.3f} s ({len(rows) / t_serve:.0f} verdicts/s, host "
          f"clock), {out['windows']} windows, {out['events']} events, "
          f"lost 0, {fe['batches']} batches; route overflow {ovf}; "
          f"metrics {same}; then {len(wide)} wide rows")
    print(f"sharded daemon launches: {json.dumps(launches)}")

    # a timed session: the host stages on the daemon's threads
    clock = StageClock(SHARD_STAGES)
    originals = [(parallel, "route_by_flow", parallel.route_by_flow),
                 (packets, "pack_rows", packets.pack_rows)]
    clock.wrap(d, "submit", "submit: queue copy in")
    clock.wrap(d, "serve_batch", "dispatch: serve_batch, all")
    clock.wrap(d, "_serve_batch_sharded",
               "sharded leg: route + re-pack + serve_sharded")
    clock.wrap(d.loader, "serve_sharded",
               "loader: staging copy + K1s/K4s/K5s enqueued")
    clock.wrap(d, "_event_join", "event join, all")
    clock.wrap(parallel, "route_by_flow", "route: route_by_flow")
    clock.wrap(packets, "pack_rows", "re-pack: pack_rows")
    per = len(rows) // 8

    class _After:
        def after_start(self, dd):
            s = dd._serving
            for attr in ("assemble_super", "assemble"):
                clock.wrap(s["runtime"].batcher, attr,
                           "batcher: dequeue + assemble", skip_none=True)
            clock.wrap(s["drainer"], "swap_window",
                       "drain tick: cursor read (waits for the card), K6 "
                       "gather, copy start")

        def before_start(self, dd):
            pass

        def unwrap(self, dd):
            pass

    out_st, t_st = serve_session(d, rows[per:], _After(), mesh=SHARDS)
    for owner, attr in ((d, "submit"), (d, "serve_batch"),
                        (d, "_serve_batch_sharded"), (d, "_event_join"),
                        (d.loader, "serve_sharded")):
        delattr(owner, attr)
    for owner, attr, fn in originals:
        setattr(owner, attr, fn)
    stages = clock.summary(t_st)
    check(out_st["front-end"]["verdicts"] == len(rows) - per
          and out_st["lost"] == 0, "sharded daemon: the timed session "
          "lost rows or events")
    print(f"sharded daemon timed session: {len(rows) - per} packets in "
          f"{t_st:.3f} s ({(len(rows) - per) / t_st:.0f} verdicts/s); "
          f"stages (calls, median ms, total ms, share of the session):")
    for name, v in stages.items():
        med = "-" if v["median_ms"] is None else f"{v['median_ms']:.3f}"
        print(f"  [{v['thread']}] {name}: {v['calls']}, {med}, "
              f"{v['total_ms']:.3f}, {v['share']:.1%}")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out2, t_prof = serve_session(d, rows[per:], mesh=SHARDS)
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith("Activity Buffer"))
    by_name = {e.key: e.self_device_time_total / 1e3
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0}
    print(f"sharded daemon profiled session: {len(rows) - per} packets in "
          f"{t_prof:.3f} s ({(len(rows) - per) / t_prof:.0f} verdicts/s "
          f"under the tracer); device busy {busy_us / 1e3:.3f} ms "
          f"({busy_us / 1e6 / t_prof:.1%}), idle "
          f"{1 - busy_us / 1e6 / t_prof:.1%}")
    d.shutdown()
    report["sharded_daemon"] = {
        "seconds": time.monotonic() - t0, "serve_s": t_serve,
        "packets": len(rows), "verdicts_per_s": len(rows) / t_serve,
        "front_end": fe, "windows": out["windows"], "events": out["events"],
        "route_overflow": ovf, "ct_dropped": dropped,
        "metrics": m_daemon.tolist(), "launches": launches,
        "stages": {"seconds": t_st, "by_stage": stages},
        "profiled": {"seconds": t_prof, "device_busy_ms": busy_us / 1e3,
                     "front_end": out2["front-end"],
                     "device_ms_by_name": by_name}}
    return launches


RULES_EGRESS_ENFORCED = [{
    "endpointSelector": {"matchLabels": {"app": "db"}},
    "ingress": [{"fromEndpoints": [{"matchLabels": {"app": "web"}}],
                 "toPorts": [{"ports": [{"port": "5432",
                                         "protocol": "TCP"}]}]}],
    "egress": [{"toEndpoints": [{"matchLabels": {"app": "db"}}],
                "toPorts": [{"ports": [{"port": "1", "protocol": "TCP"}]}]}],
}]


def phase_sharded_demotion(torch, report):
    """Phase 15 (c): the sharded rung's demotion on the card, under
    db's egress-enforced rules (``tests/test_serving_faults.py``'s
    shape, 8 shards): 64 flows established sharded, two injected
    sharded-dispatch faults (``loader.serve_sharded=1x2@1``) demote the
    session, and the flows' replies must all forward through the CT the
    demotion carried across."""
    from cilium_tpu_torch.agent import Daemon, DaemonConfig
    from cilium_tpu_torch.core.packets import (COL_DIR, TCP_ACK, TCP_SYN,
                                               make_batch)
    from cilium_tpu_torch.monitor.api import MSG_DROP

    t0 = time.monotonic()
    d = Daemon(DaemonConfig(
        ct_capacity=1 << 16, serving_queue_depth=4096,
        serving_bucket_ladder=(64,), serving_max_wait_us=500.0,
        serving_dispatch_deadline_ms=2000.0, serving_restart_budget=4,
        serving_restart_backoff_ms=1.0, serving_demote_threshold=2,
        serving_promote_after=1000, serving_promote_cooldown_s=0.05,
        fault_injection="loader.serve_sharded=1x2@1", fault_seed=1))
    d.add_endpoint("web", ("10.0.1.1",), ["k8s:app=web"])
    db = d.add_endpoint("db", ("10.0.2.1",), ["k8s:app=db"])
    d.policy_import(RULES_EGRESS_ENFORCED)
    got = []
    d.monitor.register("smoke-demotion", got.append)

    def syns(base):
        return make_batch([dict(src="10.0.1.1", dst="10.0.2.1",
                                sport=base + i, dport=5432, proto=6,
                                flags=TCP_SYN, ep=db.id, dir=0)
                           for i in range(64)]).data

    d.start_serving(ring_capacity=1 << 10, trace_sample=1, ingress=True,
                    packed=True, drain_every=2, mesh=SHARDS)
    rt = d._serving["runtime"]
    d.submit(syns(20000))
    wait_for(lambda: rt.stats.verdicts >= 64, "the sharded warm batch")
    check(d.serving_stats()["mode"] == "sharded",
          "demotion: not serving sharded")
    d.submit(syns(40000))
    wait_for(lambda: rt.stats.recovery_dropped >= 64, "the first fault")
    d.submit(syns(41000))
    wait_for(lambda: rt.stats.verdicts >= 128, "the demoted retry")
    st = d.serving_stats()
    check(st["mode"] in ("single", "wide")
          and st["ladder"]["demotions"] == 1
          and st["ct-snapshot"]["trigger"] == "demotion"
          and st["ct-snapshot"]["entries"] >= 64,
          f"demotion: mode {st['mode']}, ladder {st['ladder']}, "
          f"snapshot {st.get('ct-snapshot')}")
    got.clear()
    d.submit(make_batch([dict(src="10.0.2.1", dst="10.0.1.1", sport=5432,
                              dport=20000 + i, proto=6, flags=TCP_ACK,
                              ep=db.id, dir=1)
                         for i in range(64)]).data)
    wait_for(lambda: rt.stats.verdicts >= 192, "the replies")
    fe = d.stop_serving()["front-end"]
    ft = fe["fault-tolerance"]
    check(fe["submitted"] == fe["verdicts"] + fe["shed"]
          + ft["recovery-dropped"], f"demotion: ledger {fe}")
    fwd = drop = 0
    for b in got:
        m = b.hdr[:, COL_DIR] == 1
        fwd += int((b.msg_type[m] != MSG_DROP).sum())
        drop += int((b.msg_type[m] == MSG_DROP).sum())
    check(fwd == 64 and drop == 0,
          f"demotion: CT not carried ({drop} replies dropped, {fwd} "
          f"forwarded)")
    d.shutdown()
    print(f"sharded demotion: {st['mode']} after 2 injected faults, the "
          f"snapshot ({st['ct-snapshot']['entries']} entries) restored, "
          f"all 64 replies of the sharded flows forwarded "
          f"({time.monotonic() - t0:.1f} s)")
    report["sharded_demotion"] = {"mode": st["mode"],
                                  "snapshot": st["ct-snapshot"],
                                  "replies_forwarded": fwd}


# -- the policy control plane (phases 16-18) ----------------------------

CONN_SCENARIOS = {"no-policies", "client-ingress-l3", "client-ingress-l4",
                  "all-ingress-deny", "client-egress-l4", "to-entities-world",
                  "echo-ingress-l7", "echo-ingress-mutual-auth"}
PATH_KERNELS = ("datapath_wide", "datapath_packed", "ct_update",
                "ring_append", "l7_verdict", "dus")


def phase_connectivity(torch, report):
    """BASELINE.md config #1, the connectivity test: the port's
    ``run_connectivity_tests`` on a daemon on the card (a 2-pod world by
    nature: client, client2 and server arrive through the Pod watcher,
    each scenario imports and deletes its policy as a CNP, every probe
    runs through ``process_batch``).  Every probe of the 8 scenarios is
    ok, the re-attaches take the delta path, the mutual-auth probe drops
    AUTH_REQUIRED and its retry forwards after one grant.  Returns the
    launch counts of the run."""
    from cilium_tpu_torch.agent import Daemon, DaemonConfig
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts
    from cilium_tpu_torch.testing.connectivity import (
        format_results, run_connectivity_tests)

    d = Daemon(DaemonConfig(ct_capacity=1 << 12))
    check(d.loader.device.type == "cuda", "connectivity: not on the card")
    s0 = d.loader.table_stats()
    reset_launch_counts()
    t0 = time.monotonic()
    res = run_connectivity_tests(daemon=d)
    wall = time.monotonic() - t0
    launches = {k: v.launches for k, v in KERNELS.items()}
    s1 = d.loader.table_stats()
    auth = d.status()["auth"]
    failed = [r for r in res if not r.ok]
    check(not failed, "connectivity: failed probes\n" + format_results(res))
    check({r.scenario for r in res} == CONN_SCENARIOS,
          f"connectivity: scenarios {sorted({r.scenario for r in res})}")
    (mutual,) = [r for r in res if r.scenario == "echo-ingress-mutual-auth"]
    check(mutual.got == "auth-then-allow" and auth["granted"] == 1,
          f"connectivity: the mutual-auth probe got {mutual.got}, "
          f"auth {auth}")
    delta = s1["delta-attaches"] - s0["delta-attaches"]
    check(delta > 0 and s1["failed-builds"] == 0,
          f"connectivity: {delta} delta attaches, tables {s1}")
    check(launches["datapath_wide"] > 0 and launches["ct_update"] > 0
          and launches["l7_verdict"] > 0 and launches["dus"] > 0,
          f"connectivity: launches {launches}")
    d.shutdown()
    print(format_results(res))
    print(f"connectivity: {len(res)} probes of {len(CONN_SCENARIOS)} "
          f"scenarios ok in {wall:.3f} s (host clock); "
          f"{delta} delta attaches, "
          f"{s1['full-attaches'] - s0['full-attaches']} full; auth {auth}; "
          f"launches " + ", ".join(f"{k} {launches[k]}"
                                   for k in PATH_KERNELS))
    report["connectivity"] = {
        "probes": len(res), "wall_s": wall, "delta_attaches": delta,
        "full_attaches": s1["full-attaches"] - s0["full-attaches"],
        "auth": auth, "launches": launches}
    return launches


WEB_IP = "10.0.0.6"
# phase 17's edits: db's rules only; the first keeps every port
# boundary (5432 is one), the second adds 6000-6010
EDIT_SAME_PORTS = {
    "endpointSelector": {"matchLabels": {"app": "db"}},
    "ingress": [{"fromEndpoints": [{"matchLabels": {"app": "web"}}],
                 "toPorts": [{"ports": [{"port": "5432",
                                         "protocol": "TCP"}]}]}]}
EDIT_NEW_PORTS = {
    "endpointSelector": {"matchLabels": {"app": "db"}},
    "ingress": [{"fromEndpoints": [{"matchLabels": {"app": "web"}}],
                 "toPorts": [{"ports": [{"port": "6000", "endPort": 6010,
                                         "protocol": "TCP"}]}]}]}
POLICY_TABLES = ("verdict", "port_class", "class_map", "ep_policy", "auth")


def policy_tables(loader):
    p = loader.state.policy
    return {k: getattr(p, k).clone() for k in POLICY_TABLES}


@__import__("contextlib").contextmanager
def attach_stages(kept):
    """Time the attach's host stages: the functions and methods the
    loader looks up at call time are wrapped for the block, each call
    appending (stage, host ms) to ``kept``."""
    import cilium_tpu_torch.datapath.loader as lm
    import cilium_tpu_torch.policy.compiler as comp
    import cilium_tpu_torch.policy.incremental as inc

    targets = [(comp, "policy_fingerprint"), (inc, "delta_compile"),
               (lm, "compile_policy"), (lm, "compile_lpm"),
               (lm.TorchLoader, "_project_auth"),
               (lm.TorchLoader, "_delta_patch"),
               (lm.DevicePolicy, "from_tensors"),
               (lm.DeviceLPM, "from_tensors"),
               (lm.TorchLoader, "_publish_tables")]
    saved = [(owner, name, owner.__dict__[name]) for owner, name in targets]

    def timed(name, fn):
        def call(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                kept.append((name, (time.perf_counter() - t) * 1e3))
        return call

    for owner, name, orig in saved:
        label = (name if owner.__name__.startswith("cilium")
                 else f"{owner.__name__}.{name}")
        if isinstance(orig, staticmethod):
            setattr(owner, name, staticmethod(timed(label, orig.__func__)))
        else:
            setattr(owner, name, timed(label, orig))
    try:
        yield kept
    finally:
        for owner, name, orig in saved:
            setattr(owner, name, orig)


def stage_sums(calls):
    """(stage, ms) calls -> {stage: summed ms}, in first-call order."""
    out = {}
    for name, ms in calls:
        out[name] = out.get(name, 0.0) + ms
    return out


def timed_attaches(d):
    """Wrap ``d.loader.attach`` to keep each call's host ms."""
    real, kept = d.loader.attach, []

    def attach(*args):
        t = time.perf_counter()
        real(*args)
        kept.append((time.perf_counter() - t) * 1e3)

    d.loader.attach = attach
    return kept


def phase_delta_attach(torch, rng, world, report):
    """The delta attach at config #3: phase 7's daemon world plus a
    ``web`` endpoint (2 policies, db and web), and a second daemon on the
    same world built with ``policy_delta_compile=False``.  The first
    edit appends a rule to db alone while the delta daemon serves phase
    7's traffic: a delta attach that repaints db's slice alone, ledgers
    exact.  The second moves a port boundary (the class maps re-upload).
    After each edit the card's verdict, port_class, class_map, ep_policy
    and auth equal the full daemon's bit for bit.  Then K10 at a whole
    policy's slice: against its plain version, timed by the profiler (20
    calls) and by events beside ``Tensor.copy_`` of the same slice.
    Returns the launch counts of the edited session and the second
    edit."""
    import contextlib
    import threading

    from cilium_tpu_torch.agent import Daemon, DaemonConfig
    from cilium_tpu_torch.datapath.loader import _dus, _dus_plain
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts

    t0 = time.monotonic()
    d, db, rows = config3_daemon(world, rng)
    d.add_endpoint("web", (WEB_IP,), ["k8s:app=web"])
    full = Daemon(DaemonConfig(ct_capacity=1 << 4,
                               policy_delta_compile=False))
    check(config3_world(full, world).id == db.id,
          "delta: the two daemons gave db different endpoint ids")
    full.add_endpoint("web", (WEB_IP,), ["k8s:app=web"])
    d.start()
    print(f"delta: config #3 with web and db, two daemons built in "
          f"{time.monotonic() - t0:.1f} s")
    check(d.loader.state.policy.verdict.shape[0] == 2,
          f"delta: {d.loader.state.policy.verdict.shape[0]} policies")
    ms = {"delta": timed_attaches(d), "full": timed_attaches(full)}

    def same_tables(what):
        got, want = policy_tables(d.loader), policy_tables(full.loader)
        for k in POLICY_TABLES:
            check(torch.equal(got[k], want[k]),
                  f"delta: after {what} the delta daemon's {k} differs "
                  f"from the full daemon's")

    same_tables("the build")
    pi = d.loader.tensors.policy_row(
        d.endpoints.get(db.id).labels.sorted_key())
    edits, stages = [], []
    for i, (what, edit) in enumerate((("db's rules, same ports",
                                       EDIT_SAME_PORTS),
                                      ("a new port boundary",
                                       EDIT_NEW_PORTS))):
        stages.clear()
        s0 = d.loader.table_stats()
        pc0 = d.loader.state.policy.port_class.clone()
        n_ms = len(ms["delta"])
        if i == 0:
            reset_launch_counts()
            at = {}
            errors = []

            @contextlib.contextmanager
            def editing():
                def run():
                    try:
                        wait_for(lambda: d.serving_stats()["admitted"] > 0,
                                 "delta: the traffic to start")
                        at["start"] = d.serving_stats()["verdicts"]
                        d.policy_import([edit])
                        at["end"] = d.serving_stats()["verdicts"]
                    except Exception as e:  # noqa: BLE001 -- reported
                        errors.append(e)

                th = threading.Thread(target=run, name="smoke-edit")
                th.start()
                try:
                    yield
                finally:
                    th.join(timeout=120)
                check(not th.is_alive() and not errors,
                      f"delta: the edit failed: {errors}")

            with attach_stages(stages):
                out, t = serve_session(d, rows, during=editing())
            fe, ft = out["front-end"], out["front-end"]["fault-tolerance"]
            check(fe["submitted"] == fe["verdicts"] + fe["shed"]
                  + ft["recovery-dropped"] and fe["verdicts"] == len(rows)
                  and out["lost"] == 0 and out["l7"]["ledger-exact"],
                  f"delta: the edited session's ledgers: {fe}, lost "
                  f"{out['lost']}, l7 {out['l7']}")
            check(at["start"] < len(rows),
                  f"delta: the edit began after the traffic ({at})")
            serving = {"verdicts_per_s": len(rows) / t, "edit_at": at,
                       "ledger": fe}
        else:
            with attach_stages(stages):
                d.policy_import([edit])
        delta_stages = stage_sums(stages)
        stages.clear()
        with attach_stages(stages):
            full.policy_import([edit])
        full_stages = stage_sums(stages)
        s1 = d.loader.table_stats()
        moved = not torch.equal(d.loader.state.policy.port_class, pc0)
        check(s1["delta-attaches"] == s0["delta-attaches"] + 1
              and s1["policies-recompiled"] == s0["policies-recompiled"] + 1
              and s1["full-attaches"] == s0["full-attaches"]
              and moved == (i == 1),
              f"delta: {what}: tables {s0} -> {s1}, port_class moved "
              f"{moved}")
        same_tables(what)
        edits.append({"what": what, "delta_attach_ms": ms["delta"][n_ms:],
                      "full_attach_ms": ms["full"][-1],
                      "class_structure_changed": moved,
                      "delta_stages_ms": delta_stages,
                      "full_stages_ms": full_stages})
    launches = {k: v.launches for k, v in KERNELS.items()}
    check(launches["dus"] >= 2 and launches["datapath_packed"] > 0,
          f"delta: launches {launches}")
    for e in edits:
        took = ", ".join(f"{x:.1f}" for x in e["delta_attach_ms"])
        print(f"delta: {e['what']}: a delta attach (1 of 2 policies "
              f"repainted) {took} ms against a full attach "
              f"{e['full_attach_ms']:.1f} ms "
              f"(host clock); class maps re-uploaded "
              f"{e['class_structure_changed']}; the five tables equal the "
              f"full daemon's bit for bit")
        for k in ("delta", "full"):
            print(f"delta:   {k} attach stages (host ms): " + ", ".join(
                f"{n} {v:.1f}" for n, v in e[f"{k}_stages_ms"].items()))
    print(f"delta: the first edit ran while serving {len(rows)} packets "
          f"({serving['verdicts_per_s']:.0f} verdicts/s, began at verdict "
          f"{at['start']}, published by {at['end']}), ledger exact; "
          f"launches " + ", ".join(f"{k} {launches[k]}"
                                   for k in PATH_KERNELS))
    # K10 at a whole policy's slice [1, 2, n_rows, width], timed with
    # both daemons shut down: a controller's sweep would land in the
    # profiler's window and in the events' span
    verdict = d.loader.state.policy.verdict
    sl = torch.from_numpy(d.loader.tensors.verdict[pi:pi + 1].copy()).cuda()
    for x in (d, full):
        x.shutdown()
    starts = (pi, 0, 0, 0)
    got, want = verdict.clone(), verdict.clone()
    _dus(got, sl, starts)
    _dus_plain(want, sl, starts)
    err = max_abs_err(got, want, "dus at a policy's slice")
    dst = verdict.clone()
    split = pass_split_or_short(torch, lambda: _dus(dst, sl, starts), 1)
    t = [device_ms(lambda: _dus(dst, sl, starts), 20),
         device_ms(lambda: dst[pi:pi + 1].copy_(sl), 20),
         device_ms(lambda: dst[pi:pi + 1].copy_(sl), 20),
         device_ms(lambda: _dus(dst, sl, starts), 20)]
    copy_split = pass_split_or_short(
        torch, lambda: dst[pi:pi + 1].copy_(sl), 1)
    nbytes = 2 * sl.numel() * 4
    slice_t = {"update": list(sl.shape), "table": list(verdict.shape),
               "bytes": nbytes, "max_abs_err": err,
               "profiler_ms": profiler_ms(split, "dus"),
               "ms": (t[0] + t[3]) / 2, "copy_ms": (t[1] + t[2]) / 2,
               "copy_profiler_ms": (sum(v[0] for v in copy_split.values())
                                    if copy_split else None),
               "bound_ms": bound(nbytes, 0)[0], "turns": t}
    print(f"delta: K10 at a policy's slice {tuple(sl.shape)} into "
          f"{tuple(verdict.shape)} ({nbytes} bytes read and written): "
          f"bit-exact; {fmt_ms(slice_t['profiler_ms'])} (profiler, 20 "
          f"calls), {t[0]:.4f} / {t[3]:.4f} ms (events), Tensor.copy_ "
          f"{t[1]:.4f} / {t[2]:.4f} ms (profiler "
          f"{fmt_ms(slice_t['copy_profiler_ms'])}), bound "
          f"{slice_t['bound_ms']:.4f} ms by bytes")
    report["delta_attach"] = {"edits": edits, "serving": serving,
                              "k10_slice": slice_t, "launches": launches}
    return launches, slice_t


AUTH_PORT = 5433
AUTH_ROWS = 1 << 16
AUTH_IDENTITIES = 2048
AUTH_TTL = 20


def phase_auth(torch, rng, world, report):
    """Mutual authentication at config #3 (``mesh_auth`` on, the
    default; ``auth_ttl`` 20 s): phase 7's daemon world plus an
    ``authentication: {mode: required}`` ingress rule on db.  The rule
    takes port 5433: the world's broad plain allow of 5432 would win the
    merge for every source (a plain allow of the same key forwards with
    no handshake, in the reference as here).  ``process_batch`` takes
    2^16 SYNs from 2048 distinct live identities: every row drops
    AUTH_REQUIRED, the manager grants each pair once (one K10 launch a
    grant), the retry forwards every row; past the TTL and ``auth_gc``,
    fresh SYNs drop again while the established flows forward.  The
    auth table equals a full attach's projection of the grants bit for
    bit.  Then K10 at an auth cell [1, 1], timed beside ``copy_``.
    Returns the launch counts of the first pass and its retry."""
    import numpy as np
    from cilium_tpu_torch.agent import Daemon, DaemonConfig
    from cilium_tpu_torch.core import packets as pk
    from cilium_tpu_torch.datapath.loader import TorchLoader, _dus, _dus_plain
    from cilium_tpu_torch.datapath.verdict import (REASON_AUTH_REQUIRED,
                                                   REASON_FORWARDED)
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts
    from cilium_tpu_torch.labels import LabelSet

    t0 = time.monotonic()
    d = Daemon(DaemonConfig(ct_capacity=CT_CAPACITY, auth_ttl=AUTH_TTL))
    db = config3_world(d, world, extra_rules=[{
        "endpointSelector": {"matchLabels": {"app": "db"}},
        "ingress": [{"fromEndpoints": [{"matchLabels": {"ns": "default"}}],
                     "toPorts": [{"ports": [{"port": str(AUTH_PORT),
                                             "protocol": "TCP"}]}],
                     "authentication": {"mode": "required"}}]}])
    check(d.auth_manager is not None, "auth: mesh_auth is off")
    print(f"auth: config #3 with the auth rule on db:{AUTH_PORT} built in "
          f"{time.monotonic() - t0:.1f} s")
    n = AUTH_ROWS
    per = n // AUTH_IDENTITIES
    src = rng.choice(np.array(world.pod_ips), AUTH_IDENTITIES, replace=False)
    # each identity's flows on sports 20000.., as many as it sends
    rows = np.concatenate([syn_rows(ip, DB_IP, 20000, per, AUTH_PORT,
                                    db.id, 0) for ip in src])

    def reasons(ev):
        return np.asarray(ev.reason)

    upserts = []
    real_upsert = d.loader.auth_upsert

    def auth_upsert(*args):
        t = time.perf_counter()
        ok = real_upsert(*args)
        upserts.append((time.perf_counter() - t) * 1e3)
        return ok

    d.loader.auth_upsert = auth_upsert
    t_obs = []
    real_observe = d.auth_manager.observe

    def observe(batch, now):
        t_obs.append(time.perf_counter())
        return real_observe(batch, now)

    d.auth_manager.observe = observe
    now = 50
    reset_launch_counts()
    ev = d.process_batch(rows, now=now)
    k10_grants = KERNELS["dus"].launches
    r = reasons(ev)
    st = d.auth_manager.status()
    check((r == REASON_AUTH_REQUIRED).all(),
          f"auth: the first pass: {int((r == REASON_AUTH_REQUIRED).sum())} "
          f"of {n} rows dropped AUTH_REQUIRED")
    check(st["granted"] == AUTH_IDENTITIES and st["failed"] == 0
          and len(d.loader.auth_entries()) == AUTH_IDENTITIES
          and k10_grants == AUTH_IDENTITIES,
          f"auth: {st}, {len(d.loader.auth_entries())} entries, "
          f"{k10_grants} dus launches for {AUTH_IDENTITIES} pairs")
    ev = d.process_batch(rows, now=now + 1)
    t_forward = time.perf_counter()
    launches = {k: v.launches for k, v in KERNELS.items()}
    r = reasons(ev)
    check((r == REASON_FORWARDED).all(),
          f"auth: the retry forwarded {int((r == REASON_FORWARDED).sum())} "
          f"of {n} rows")
    check(d.auth_manager.status()["granted"] == AUTH_IDENTITIES,
          "auth: the retry granted again")

    def same_as_full_attach(when):
        fl = TorchLoader(ct_capacity=1 << 4, device=d.loader.device)
        fl._auth = dict(d.loader._auth)
        fl.attach([d.repo.resolve(LabelSet.parse("k8s:app=db"))],
                  d.ipcache.to_identity_map(), {db.id: 0},
                  d.endpoints.row_map)
        check(torch.equal(d.loader.state.policy.auth, fl.state.policy.auth),
              f"auth: {when}, the auth table differs from a full attach's "
              f"projection of the grants")

    same_as_full_attach("after the grants")
    # past the TTL: the sweep, then fresh SYNs and the established flows
    late = now + AUTH_TTL + 30
    swept = d.auth_manager.gc(late)
    check(swept == AUTH_IDENTITIES and d.loader.auth_entries() == [],
          f"auth: the sweep at {late} dropped {swept} grants")
    # every identity sends both: its even flows' ACKs, its odd flows
    # again as fresh SYNs (new sports), so every pair is granted again
    est = rows[0::2].copy()
    est[:, pk.COL_FLAGS] = pk.TCP_ACK
    fresh = rows[1::2].copy()
    fresh[:, pk.COL_SPORT] += per
    check(int(fresh[:, pk.COL_SPORT].max()) < 1 << 16, "auth: sports")
    mixed = np.concatenate([est, fresh])
    r = reasons(d.process_batch(mixed, now=late))
    check((r[: n // 2] == REASON_FORWARDED).all()
          and (r[n // 2:] == REASON_AUTH_REQUIRED).all(),
          f"auth: past the TTL {int((r[: n // 2] == REASON_FORWARDED).sum())}"
          f" of {n // 2} established rows forwarded, "
          f"{int((r[n // 2:] == REASON_AUTH_REQUIRED).sum())} of {n // 2} "
          f"fresh SYNs dropped AUTH_REQUIRED")
    same_as_full_attach("after the expiry and the grants again")
    # K10 at one auth cell [1, 1]
    auth = d.loader.state.policy.auth
    cell = torch.full((1, 1), 12345, dtype=torch.int32, device="cuda")
    at = (0, auth.shape[1] // 3)
    got, want = auth.clone(), auth.clone()
    _dus(got, cell, at)
    _dus_plain(want, cell, at)
    err = max_abs_err(got, want, "dus at an auth cell")
    dst = auth.clone()
    idx = (slice(at[0], at[0] + 1), slice(at[1], at[1] + 1))
    split = pass_split_or_short(torch, lambda: _dus(dst, cell, at), 1)
    t = [device_ms(lambda: _dus(dst, cell, at), 20),
         device_ms(lambda: dst[idx].copy_(cell), 20),
         device_ms(lambda: dst[idx].copy_(cell), 20),
         device_ms(lambda: _dus(dst, cell, at), 20)]
    cell_t = {"update": [1, 1], "table": list(auth.shape), "bytes": 8,
              "max_abs_err": err, "profiler_ms": profiler_ms(split, "dus"),
              "ms": (t[0] + t[3]) / 2, "copy_ms": (t[1] + t[2]) / 2,
              "bound_ms": bound(8, 0)[0], "turns": t}
    d.shutdown()
    grant_ms = np.percentile(np.array(upserts[:AUTH_IDENTITIES]), [50, 99])
    g2f = (t_forward - t_obs[0]) * 1e3
    print(f"auth: {n} SYNs from {AUTH_IDENTITIES} identities to "
          f"db:{AUTH_PORT}: all dropped AUTH_REQUIRED, {st['granted']} "
          f"grants ({k10_grants} dus launches, one a grant; auth_upsert "
          f"p50 {grant_ms[0]:.3f} ms, p99 {grant_ms[1]:.3f} ms, host "
          f"clock), the retry forwarded all {n}; grant to forward "
          f"{g2f:.1f} ms (the first drop observed to the retry's verdicts "
          f"in hand, host clock)")
    print(f"auth: past the {AUTH_TTL} s TTL the sweep dropped {swept} "
          f"grants; {n // 2} established rows forwarded, {n // 2} fresh "
          f"SYNs dropped AUTH_REQUIRED and every pair was granted again; "
          f"the auth table equals a full attach's projection bit for bit "
          f"(after each grant pass)")
    print(f"auth: launches " + ", ".join(f"{k} {launches[k]}"
                                         for k in PATH_KERNELS))
    print(f"auth: K10 at an auth cell [1, 1] into {tuple(auth.shape)}: "
          f"bit-exact; {fmt_ms(cell_t['profiler_ms'])} (profiler, 20 "
          f"calls), {t[0]:.4f} / {t[3]:.4f} ms (events), copy_ "
          f"{t[1]:.4f} / {t[2]:.4f} ms, bound {cell_t['bound_ms']:.7f} ms "
          f"by bytes")
    report["auth"] = {"rows": n, "identities": AUTH_IDENTITIES,
                      "status": st, "dus_launches_for_grants": k10_grants,
                      "auth_upsert_ms": {"p50": grant_ms[0],
                                         "p99": grant_ms[1]},
                      "grant_to_forward_ms": g2f, "swept": swept,
                      "k10_cell": cell_t, "launches": launches}
    return launches, cell_t


CONFIG2_FLOWS = {"allowed": 768, "dropped": 192, "l7": 64}  # 1024 flows
CONFIG2_PORTS = {"allowed": 5432, "dropped": 443, "l7": 80}
CONFIG2_V6 = 64  # of the flows, from the world's IPv6 pods
# a flow's 8 packets: (from db, TCP flags); SYN, SYN-ACK, ACK, two data
# packets each way, FIN
CONFIG2_PACKETS = ((0, 0x02), (1, 0x12), (0, 0x10), (0, 0x18), (1, 0x18),
                   (0, 0x18), (1, 0x18), (0, 0x11))
HUBBLE_STAGE = "event join: Hubble parser + flow metrics"


def equal_rows(got, want, what):
    """Host arrays equal, shape and every word; else the smoke fails."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    check(got.shape == want.shape and np.array_equal(got, want),
          f"{what}: {got.shape} vs {want.shape}, "
          f"{int((got != want).sum()) if got.shape == want.shape else '-'}"
          f" cells differ")


def config2_capture(rng, world):
    """BASELINE.md config #2's capture: 1024 TCP flows between config
    #3's world pods and db (768 to the allowed 5432, 192 to 443, which
    policy drops, 64 to the L7 port 80; 64 of them from the world's IPv6
    pods to ``DB_IP6``), 8 packets a flow.  Returns the header rows in
    round order (packet k of every flow, then packet k + 1), db's
    replies with COL_DIR 1, and each flow's kind."""
    import numpy as np
    from cilium_tpu_torch.core import packets as pk

    kinds = np.array([k for k, n in CONFIG2_FLOWS.items()
                      for _ in range(n)])
    rng.shuffle(kinds)
    n = len(kinds)
    dport = np.array([CONFIG2_PORTS[k] for k in kinds], np.uint32)
    v6 = np.zeros(n, bool)
    v6[rng.choice(n, CONFIG2_V6, replace=False)] = True
    w4 = np.array([pk.ip_to_words(ip) for ip in world.pod_ips], np.uint32)
    w6 = np.array([pk.ip_to_words(ip)
                   for ip in world.pod_ips6[:CONFIG2_V6]], np.uint32)
    client = np.where(v6[:, None], w6[rng.integers(0, len(w6), n)],
                      w4[rng.integers(0, len(w4), n)]).astype(np.uint32)
    db = np.where(v6[:, None], np.array(pk.ip_to_words(DB_IP6), np.uint32),
                  np.array(pk.ip_to_words(DB_IP), np.uint32))
    sport = 20000 + np.arange(n, dtype=np.uint32)  # every flow new
    rounds = []
    for k, (reply, flags) in enumerate(CONFIG2_PACKETS):
        r = np.zeros((n, pk.N_COLS), np.uint32)
        r[:, pk.COL_SRC_IP0:pk.COL_SRC_IP0 + 4] = db if reply else client
        r[:, pk.COL_DST_IP0:pk.COL_DST_IP0 + 4] = client if reply else db
        r[:, pk.COL_SPORT] = dport if reply else sport
        r[:, pk.COL_DPORT] = sport if reply else dport
        r[:, pk.COL_PROTO] = 6
        r[:, pk.COL_FLAGS] = flags
        # one length a packet of the flow: every row of the capture is
        # its own (the events join back to them by their bytes)
        r[:, pk.COL_LEN] = 100 + 100 * k
        r[:, pk.COL_FAMILY] = np.where(v6, 6, 4)
        r[:, pk.COL_DIR] = reply
        rounds.append(r)
    return np.concatenate(rounds), kinds


def from_db(rows):
    """[N] bool: the rows db sent (source DB_IP or DB_IP6): a capture
    taken at db's interface replays them as egress."""
    import numpy as np
    from cilium_tpu_torch.core import packets as pk

    src = rows[:, pk.COL_SRC_IP0:pk.COL_SRC_IP0 + 4]
    return ((src == np.array(pk.ip_to_words(DB_IP), np.uint32)).all(1)
            | (src == np.array(pk.ip_to_words(DB_IP6), np.uint32)).all(1))


def pcap_of(rows):
    """A classic LINKTYPE_ETHERNET pcap of IPv4 ``rows``, built with
    numpy from ``frames_from_batch``'s frames (no per-packet Python)."""
    import struct

    import numpy as np
    from cilium_tpu_torch.core.ingest import FRAME_LEN, frames_from_batch

    n = len(rows)
    frames = np.frombuffer(frames_from_batch(rows), np.uint8).reshape(
        n, 4 + FRAME_LEN)
    rec = np.zeros((n, 16 + FRAME_LEN), np.uint8)
    lens = np.frombuffer(struct.pack("<II", FRAME_LEN, FRAME_LEN), np.uint8)
    rec[:, 8:16] = lens
    rec[:, 16:] = frames[:, 4:]
    return struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535,
                       1) + rec.tobytes()


def replay_rounds(d, rows, n_rounds):
    """One serving session of ``rows`` in ``n_rounds`` equal rounds
    through ``submit``, each admitted whole and verdicted before the
    next, so no two packets of one flow share a batch.  The exporter's
    consumer is timed.  Returns (stop_serving's result, seconds from
    the first submit to the last exported line)."""
    stamps = []
    exporter = d.monitor._consumers.get("exporter")
    if exporter is not None:
        def timed(batch):
            exporter(batch)
            stamps.append(time.perf_counter())
        d.monitor.register("exporter", timed)
    d.start_serving(ring_capacity=RING_CAPACITY, ingress=True, packed=True,
                    superbatch_k=4)
    per = len(rows) // n_rounds
    t0 = time.perf_counter()
    for k in range(n_rounds):
        got = d.submit(rows[k * per:(k + 1) * per])
        check(got == per, f"config #2: round {k} admitted {got} of {per}")
        wait_for(lambda: d.serving_stats()["verdicts"] >= (k + 1) * per,
                 f"config #2: round {k}'s verdicts")
    out = d.stop_serving()
    if exporter is not None:
        d.monitor.register("exporter", exporter)
    return out, (stamps[-1] - t0 if stamps else None)


def check_ledger(out, n, what):
    fe = out["front-end"]
    ft = fe["fault-tolerance"]
    check(fe["submitted"] == fe["verdicts"] + fe["shed"]
          + ft["recovery-dropped"] and fe["verdicts"] == n
          and fe["shed"] == 0 and out["lost"] == 0,
          f"{what}: ledger {fe}, lost {out['lost']}")


def flow_keys_of_events(batches):
    """The exported fields of each event row: verdict name, drop
    reason, addresses, ports, reply (the CT state), proxy port."""
    import numpy as np
    from cilium_tpu_torch.core import packets as pk
    from cilium_tpu_torch.datapath.conntrack import CT_REPLY
    from cilium_tpu_torch.flow.flow import VERDICT_NAMES

    keys = []
    for b in batches:
        h = b.hdr
        proto = h[:, pk.COL_PROTO]
        sport = np.where(np.isin(proto, (6, 17, 132)), h[:, pk.COL_SPORT], 0)
        dport = np.where(np.isin(proto, (6, 17, 132, 1, 58)),
                         h[:, pk.COL_DPORT], 0)
        for i in range(len(b)):
            fam = int(h[i, pk.COL_FAMILY])
            keys.append((
                VERDICT_NAMES.get(int(b.verdict[i]), "VERDICT_UNKNOWN"),
                int(b.reason[i]),
                pk.words_to_ip(h[i, pk.COL_SRC_IP0:pk.COL_SRC_IP0 + 4], fam),
                pk.words_to_ip(h[i, pk.COL_DST_IP0:pk.COL_DST_IP0 + 4], fam),
                int(sport[i]), int(dport[i]),
                int(b.ct_state[i]) == CT_REPLY, int(b.proxy_port[i])))
    return keys


def flow_key_of_line(rec):
    """The same fields of one exported JSONL flow."""
    f = rec["flow"]
    (l4,) = f["l4"].values()
    ports = ((l4.get("source_port", 0), l4.get("destination_port", 0))
             if isinstance(l4, dict) and "type" not in l4
             else (0, l4.get("type", 0) if isinstance(l4, dict) else 0))
    return (f["verdict"], f.get("drop_reason", 0), f["IP"]["source"],
            f["IP"]["destination"], ports[0], ports[1], f["is_reply"],
            f.get("proxy_port", 0))


class FlowTally:
    """What the monitor published, the observer saw, the seven parser
    added and the exporter wrote, since the last ``take``."""

    def __init__(self, d, export_path):
        self.d, self.path = d, export_path
        self.seen = []  # the event batches the monitor fanned out
        d.monitor.register("smoke", self.seen.append)
        self.mark = self._now()

    def _now(self):
        import os

        d = self.d
        lines = 0
        if os.path.exists(self.path):
            with open(self.path, "rb") as f:
                lines = sum(1 for _ in f)
        return {"published": d.monitor.published, "seq": d.observer.seq,
                "seven": d.seven.parsed, "written": d.exporter.written,
                "lines": lines, "batches": len(self.seen)}

    def take(self, what):
        """Check the stretch since the last take: every published event
        one observer flow (the seven parser's L7 flows besides) and one
        exported line; each exported line's fields those of its event
        row, as a multiset; no consumer lost a row.  -> the stretch's
        counts and its event batches."""
        import collections

        d, a, b = self.d, self.mark, self._now()
        self.mark = b
        got = {k: b[k] - a[k] for k in a}
        batches = self.seen[a["batches"]:b["batches"]]
        events = sum(len(x) for x in batches)
        check(got["published"] == events > 0
              and got["seq"] == events + got["seven"]
              and got["written"] == got["lines"] == events,
              f"{what}: published {got['published']}, observer "
              f"{got['seq']} (seven {got['seven']}), exported "
              f"{got['written']} ({got['lines']} lines), {events} event "
              f"rows")
        for name in ("hubble", "metrics", "exporter", "smoke"):
            check(d.monitor.lost_count(name) == 0,
                  f"{what}: the {name} consumer lost rows")
        with open(self.path) as f:
            lines = f.read().splitlines()[a["lines"]:b["lines"]]
        want = collections.Counter(flow_keys_of_events(batches))
        have = collections.Counter(flow_key_of_line(json.loads(x))
                                   for x in lines)
        check(have == want, f"{what}: exported flows differ from their "
              f"event rows: {list((have - want).items())[:3]} / "
              f"{list((want - have).items())[:3]}")
        got["events"] = events
        return got, batches


def proto_round_trip(d, batches):
    """Every event row as the exporter materializes it, through
    ``encode_flow`` and ``decode_flow``: what the decoder renders equals
    the flow's ``to_dict``.  -> flows checked."""
    from cilium_tpu_torch.flow.observer import materialize_flow
    from cilium_tpu_torch.flow.proto import decode_flow, encode_flow

    n = 0
    for b in batches:
        for i in range(len(b)):
            f = materialize_flow(
                b.hdr[i], b.timestamp, n, int(b.verdict[i]),
                int(b.reason[i]), int(b.ct_state[i]), int(b.msg_type[i]),
                int(b.identity[i]), d._identity_labels, d._endpoint_info,
                proxy_port=int(b.proxy_port[i]))
            want = f.to_dict()
            back = decode_flow(encode_flow(f))
            check(back == {k: want[k] for k in back},
                  f"config #2: flow {n} changed on the wire: {back} / "
                  f"{want}")
            n += 1
    return n


def medium_keep(batch):
    """A numpy copy of the reference's "medium" monitor aggregation (no
    endpoint has Debug on here): a TCP trace with none of SYN, FIN and
    RST is dropped."""
    from cilium_tpu_torch.core import packets as pk
    from cilium_tpu_torch.monitor.api import MSG_TRACE

    boring = ((batch.hdr[:, pk.COL_PROTO] == 6)
              & ((batch.hdr[:, pk.COL_FLAGS]
                  & (pk.TCP_SYN | pk.TCP_FIN | pk.TCP_RST)) == 0)
              & (batch.msg_type == MSG_TRACE))
    return ~boring


def plain_replay(d, db, rows, n_rounds, audit):
    """The capture's rounds through the plain versions on the card, on
    a fresh CT and the tables daemon ``d`` compiled: -> (out rows, the
    metrics)."""
    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.datapath.conntrack import ct_update_plain
    from cilium_tpu_torch.datapath.loader import TorchLoader
    from cilium_tpu_torch.datapath.verdict import verdict_stage_plain
    from cilium_tpu_torch.labels import LabelSet

    fl = TorchLoader(ct_capacity=CT_CAPACITY)
    fl.attach([d.repo.resolve(LabelSet.parse("k8s:app=db"))],
              d.ipcache.to_identity_map(), {db.id: 0}, d.endpoints.row_map)
    per = len(rows) // n_rounds
    outs = []
    for k in range(n_rounds):
        hdr = u32.from_numpy(rows[k * per:(k + 1) * per], "cuda")
        out, c = verdict_stage_plain(fl.state, hdr, k + 1, audit=audit)
        ct_update_plain(fl.state.ct, c.l4, c.fwd, c.result, c.slot,
                        c.is_reply, c.do_create, c.proxy_port, k + 1, None)
        outs.append(u32.to_numpy(out))
    return np.concatenate(outs), fl.metrics()


def consumer_turns(d, rows, label, stage, timed, enable, disable,
                   counters=None):
    """Phase 7's steady traffic (``rows`` after their first eighth, the
    SYN pool) through daemon ``d`` with one monitor plane on and off in
    turns (on, off, off, on): verdicts/s and the event-join worker's
    share by ``StageClock``, the plane's work on that worker timed as
    ``stage``.  ``timed`` lists (owner, attr, thread) to time while on;
    ``enable()`` and ``disable()`` switch the plane after the wrap;
    ``counters(what)`` (optional) reads the plane's counters after each
    turn, which must not move while it is off.  -> one record a turn."""
    per = len(rows) // 8
    n = len(rows) - per
    turns = []
    for on in (True, False, False, True):
        clock = StageClock({**StageClock.THREADS, stage: "worker"})
        if on:
            for owner, attr, thread in timed:
                clock.wrap(owner, attr, stage, thread=thread)
            enable()
        else:
            disable()
        what = f"{label} {'on' if on else 'off'}"
        c0 = counters(what) if counters else {}
        out, t = serve_session(d, rows[per:], clock)
        if on:
            for owner, attr, _ in timed:
                delattr(owner, attr)
        check_ledger(out, n, what)
        c1 = counters(what) if counters else {}
        delta = {k.replace("-", "_"): c1[k] - c0[k] for k in c0}
        check(on or not any(delta.values()),
              f"{what}: the plane's counters moved: {delta}")
        st = clock.summary(t)
        med = st[stage]["median_ms"]
        turns.append({
            label: on, "seconds": t, "verdicts_per_s": n / t,
            "events": out["events"],
            "worker_share": st["event join, all"]["share"],
            f"{label}_share": st[stage]["share"],
            f"{label}_calls": st[stage]["calls"],
            f"{label}_ms_median": med, **delta})
        print(f"{what:13}: {n} packets in {t:.3f} s ({n / t:.0f} "
              f"verdicts/s), {out['events']} events; event join "
              f"{turns[-1]['worker_share']:.1%} of the session, {stage} "
              f"{st[stage]['share']:.2%} ({st[stage]['calls']} calls, "
              f"median {'-' if med is None else f'{med:.3f}'} ms)"
              + "".join(f"; {k} {v}" for k, v in delta.items()))
    return turns


def hubble_turns(d, rows):
    """:func:`consumer_turns` of Hubble (the default: the three-four
    parser and the flow metrics on the monitor)."""
    consumers = {"hubble": d.parser, "metrics": d.flow_metrics}

    def enable():
        for name, owner in consumers.items():
            d.monitor.register(name, owner.consume)

    def disable():
        for name in consumers:
            d.monitor.unregister(name)

    turns = consumer_turns(
        d, rows, "hubble", HUBBLE_STAGE,
        [(owner, "consume", None) for owner in consumers.values()],
        enable, disable)
    enable()  # the default again
    return turns


ANALYTICS_STAGE = "event join: FlowAnalytics.drain"


def analytics_ledger(d, what):
    """The flow analytics' batch ledger, which must be exact with nothing
    pending (after stop_serving or a process_batch), and no batch the
    engine could not read (those are counted drops too); -> its
    stats."""
    a = d.analytics.stats()
    check(a["batches-submitted"] == a["batches-ingested"]
          + a["batches-dropped"] and a["pending"] == 0
          and d.analytics.ingest_failures == 0,
          f"{what}: analytics ledger {a}, "
          f"{d.analytics.ingest_failures} batches unreadable")
    return a


def analytics_turns(d, rows):
    """:func:`consumer_turns` of the flow analytics (the default:
    ``FlowAnalytics.submit`` on the monitor and the ``flow-agg-roll``
    controller), ``drain`` timed on the event-join worker; the counters
    include the batches the duty governor dropped."""
    a = d.analytics

    def enable():
        d.monitor.register("analytics", a.submit)
        d.controllers.update("flow-agg-roll", a.drain,
                             d.config.flow_agg_window_s)

    def disable():
        d.monitor.unregister("analytics")
        d.controllers.remove("flow-agg-roll")

    def counters(what):
        st = analytics_ledger(d, what)
        return {k: st[k] for k in ("batches-submitted", "batches-ingested",
                                   "batches-dropped", "packets-seen")}

    return consumer_turns(d, rows, "analytics", ANALYTICS_STAGE,
                          [(a, "drain", "serving-eventjoin")], enable,
                          disable, counters)


def phase_config2(torch, rng, world, report):
    """BASELINE.md config #2: the three-four parser over a 1k-flow pcap
    replay with flow export, through the daemon at config #3's width;
    returns the replay's launches."""
    import os
    import tempfile

    import numpy as np
    from cilium_tpu_torch import native
    from cilium_tpu_torch.core import packets as pk
    from cilium_tpu_torch.core.pcap import parse_pcap_py, read_pcap, write_pcap
    from cilium_tpu_torch.datapath.verdict import (
        OUT_REASON, OUT_VERDICT, REASON_POLICY_DEFAULT_DENY,
        REASON_POLICY_DENY)
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts
    from cilium_tpu_torch.policy.mapstate import (VERDICT_ALLOW,
                                                  VERDICT_DEFAULT_DENY,
                                                  VERDICT_DENY)

    t19 = time.monotonic()
    part = report["config2"] = {}
    tmp = tempfile.TemporaryDirectory(prefix="config2-")
    # -- (a) the capture, written and read back ---------------------------
    rows, kinds = config2_capture(rng, world)
    n_rounds = len(CONFIG2_PACKETS)
    path = os.path.join(tmp.name, "config2.pcap")
    write_pcap(path, pk.HeaderBatch(rows.copy()))
    with open(path, "rb") as f:
        data = f.read()
    d, db, steady = config3_daemon(
        world, rng, v6_pods=CONFIG2_V6,
        export_path=os.path.join(tmp.name, "flows.jsonl"))
    native.reset_parse_counts()
    replay = read_pcap(path, ep=db.id, direction=0).data
    check(native.parse_counts() == {"native": 1},
          f"config #2: read_pcap parsed with {native.parse_counts()}")
    equal_rows(replay, parse_pcap_py(data, db.id, 0),
               "config #2: native parse against the Python parse")
    replay[:, pk.COL_DIR] = from_db(replay)
    want = rows.copy()
    want[:, pk.COL_EP] = db.id
    equal_rows(replay, want, "config #2: the capture read back")
    golden = read_pcap(str(ROOT / GOLDEN[0]), ep=db.id, direction=0).data
    with open(ROOT / GOLDEN[0], "rb") as f:
        equal_rows(golden, parse_pcap_py(f.read(), db.id, 0),
                   "golden capture: native parse against the Python parse")
    check(native.parse_counts() == {"native": 2, "python": 2}
          and len(golden) == 6144, f"golden capture: {len(golden)} rows, "
          f"parsers {native.parse_counts()}")
    print(f"config #2 capture: {len(rows)} packets of {len(kinds)} flows "
          f"({CONFIG2_V6} IPv6), {len(data)} pcap bytes; the native parse "
          f"equals the Python parse, as on the golden capture's "
          f"{len(golden)}")

    # -- (b) the replay with flow export ----------------------------------
    tally = FlowTally(d, d.config.export_path)
    reset_launch_counts()
    d.start()
    out, wall = replay_rounds(d, replay, n_rounds)
    check_ledger(out, len(replay), "config #2")
    got, batches = tally.take("config #2")
    n_proto = proto_round_trip(d, batches)
    reps = []
    for _ in range(21):
        t0 = time.perf_counter()
        flows = d.observer.get_flows(number=1000)
        reps.append((time.perf_counter() - t0) * 1e3)
    check(len(flows) == 1000, f"get_flows gave {len(flows)}")
    get_ms = statistics.median(reps[1:])
    print(f"config #2 replay: {got['events']} events published = observer "
          f"flows ({got['seq']} with {got['seven']} L7 flows of the seven "
          f"parser) = exported lines, each line its event row's fields, "
          f"{n_proto} flows intact through encode_flow/decode_flow; "
          f"{out['windows']} windows, lost 0")
    print(f"config #2: {wall:.4f} s from the first submit to the last "
          f"exported line ({got['written'] / wall:.0f} flows exported/s); "
          f"Observer.get_flows(number=1000) {get_ms:.3f} ms (median of 20)")
    out_g, _ = replay_rounds(d, golden, 6)
    check_ledger(out_g, len(golden), "golden replay")
    got_g, _ = tally.take("golden replay")
    for b in range(0, len(golden), 1024):
        d.process_batch(golden[b:b + 1024], now=d._now())
    got_p, _ = tally.take("golden through process_batch")
    check(got_p["events"] == len(golden),
          f"process_batch published {got_p['events']} of {len(golden)}")
    wait_for(lambda: d.controllers.statuses()["ct-gc"].success_count >= 1,
             "the ct-gc controller's first sweep")
    launches = {k: v.launches for k, v in KERNELS.items()}
    for name in ("ct_update", "ring_append", "ring_gather", "ct_gc",
                 "ct_occupied"):
        check(launches[name] > 0, f"config #2: {name} never launched")
    check(launches["datapath_wide"] + launches["datapath_packed"] > 0,
          "config #2: K1 never launched")
    print(f"golden capture: {got_g['events']} events through submit, "
          f"{got_p['events']} through process_batch, each an exported "
          f"flow; launches {json.dumps({k: v for k, v in launches.items() if v})}")

    # -- (c) monitor aggregation "medium" ---------------------------------
    def under_medium(replay_fn, what):
        """``replay_fn`` under the reference's runtime monitor-aggregation
        option "medium": what the monitor published must be, row for
        row, what the numpy copy of the filter keeps of every row the
        filter was handed.  -> (rows handed, rows kept)."""
        inputs = []
        filt = d._filter_events
        d._filter_events = lambda b: (inputs.append(b), filt(b))[1]
        d.config.monitor_aggregation = "medium"
        try:
            replay_fn()
        finally:
            del d._filter_events
            d.config.monitor_aggregation = "none"
        got_m, kept = tally.take(what)
        want_m = [b.hdr[medium_keep(b)] for b in inputs]
        n_in = sum(len(b) for b in inputs)
        equal_rows(np.concatenate([b.hdr for b in kept]),
                   np.concatenate(want_m), f"{what}: the kept rows")
        check(got_m["events"] == sum(len(x) for x in want_m) < n_in,
              f"{what}: the observer saw {got_m['events']} of {n_in}")
        print(f"{what}: {got_m['events']} of {n_in} events kept (drops, "
              f"SYN/FIN/RST, non-TCP), equal to the numpy copy of the "
              f"filter, row for row")
        return {"events_in": n_in, "kept": got_m["events"]}

    per = len(replay) // n_rounds
    medium = {
        "submit": under_medium(lambda: check_ledger(
            replay_rounds(d, replay, n_rounds)[0], len(replay),
            "config #2, medium"), "config #2, medium, through submit"),
        "process_batch": under_medium(lambda: [
            d.process_batch(replay[k * per:(k + 1) * per], now=d._now())
            for k in range(n_rounds)],
            "config #2, medium, through process_batch")}

    # -- (e) Hubble on and off at phase 7's traffic -----------------------
    d.monitor.unregister("smoke")
    d.monitor.unregister("exporter")  # phase 7's daemon exports nothing
    serve_session(d, steady)  # every pool flow established
    part["hubble_turns"] = hubble_turns(d, steady)
    d.shutdown()
    n_parse = len(steady)
    big = pcap_of(steady)  # the parse-rate capture: phase 7's 2^21 rows
    del steady

    # -- (d) policy audit mode --------------------------------------------
    da, dba, _ = config3_daemon(world, rng, v6_pods=CONFIG2_V6,
                                policy_audit_mode=True)
    check(dba.id == db.id, "audit daemon: db's id differs")
    seen = []
    da.monitor.register("smoke", seen.append)
    out_a, _ = replay_rounds(da, replay, n_rounds)
    check_ledger(out_a, len(replay), "config #2, audit")
    plain_out, plain_m = plain_replay(da, dba, replay, n_rounds, True)
    equal_rows(da.loader.metrics(), plain_m,
               "audit: the daemon's metrics against the plain versions'")
    by_row = {r.tobytes(): (int(o[OUT_VERDICT]), int(o[OUT_REASON]))
              for r, o in zip(replay, plain_out)}
    policy = (REASON_POLICY_DENY, REASON_POLICY_DEFAULT_DENY)
    audited = 0
    for b in seen:
        for i in range(len(b)):
            v, r = int(b.verdict[i]), int(b.reason[i])
            check(by_row[b.hdr[i].tobytes()] == (v, r),
                  f"audit: event {(v, r)} against the plain version's "
                  f"{by_row[b.hdr[i].tobytes()]}")
            check(not (v in (VERDICT_DENY, VERDICT_DEFAULT_DENY)
                       and r in policy), f"audit: a policy drop {(v, r)}")
            audited += v == VERDICT_ALLOW and r in policy
    plain_audited = audited_rows(plain_out)
    n_dropped = CONFIG2_FLOWS["dropped"]
    check(audited == plain_audited == n_dropped,
          f"audit: {audited} audited events, the plain versions "
          f"{plain_audited}, {n_dropped} flows policy drops")
    da.shutdown()
    print(f"config #2, policy audit mode: {sum(len(b) for b in seen)} "
          f"events, each equal to the plain versions' verdict and reason; "
          f"every one of the {n_dropped} policy-dropped flows forwarded "
          f"on its first packet with its reason, no policy drop; metrics "
          f"equal the plain versions'")

    # -- (e) the parse rates over a 2^21-packet capture -------------------
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        nat = native.parse_pcap_bytes(big)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    t0 = time.perf_counter()
    py = parse_pcap_py(big)
    t_py = time.perf_counter() - t0
    equal_rows(nat, py, "the parse-rate capture: native against Python")
    check(len(nat) == n_parse, f"parsed {len(nat)} of {n_parse} packets")
    print(f"parse {n_parse} packets ({len(big)} bytes): native "
          f"{n_parse / best:.0f} packets/s ({best:.4f} s, best of 3), "
          f"Python {n_parse / t_py:.0f} packets/s ({t_py:.3f} s); "
          f"equal rows")
    tmp.cleanup()
    part.update({
        "flows": len(kinds), "packets": len(rows), "events": got["events"],
        "observer_flows": got["seq"], "seven_flows": got["seven"],
        "exported": got["written"], "proto_round_trip": n_proto,
        "wall_s": wall, "flows_exported_per_s": got["written"] / wall,
        "get_flows_1000_ms": get_ms, "golden_events": got_g["events"],
        "process_batch_events": got_p["events"],
        "medium": medium,
        "audit": {"events": sum(len(b) for b in seen), "audited": audited},
        "parse": {"packets": n_parse, "bytes": len(big),
                  "native_s": best, "python_s": t_py,
                  "native_pps": n_parse / best,
                  "python_pps": n_parse / t_py},
        "launches": launches, "seconds": time.monotonic() - t19})
    print(f"config #2 phase: {part['seconds']:.1f} s")
    return launches


SCENARIO_SEED = 31
# the kernels the scenarios' paths run: the serving leg's packed step,
# CT update, ring append and gather, the controllers' CT sweep and
# occupancy count, l7_abuse's L7 verdicts, the churn scenarios' table
# patches, and nat_exhaustion's offline leg (the wide step, SNAT and
# reverse NAT)
SCENARIO_KERNELS = ("datapath_packed", "ct_update", "ring_append",
                    "ring_gather", "ct_gc", "ct_occupied", "l7_verdict",
                    "dus", "datapath_wide", "snat_egress", "snat_reverse")


def phase_scenarios(torch, report):
    """The scenario engine on the card, as ``bench.py``'s
    ``bench_scenarios`` drives the reference: every registered scenario
    at seed 31 and its own (the reference's) sizes, each on a fresh
    ``scenario_daemon(sc, map_pressure_interval=0.25)`` through
    ``run_scenario``, and ``elephant_mice`` once more with every
    forwarded packet evented (``trace_sample=1``), whose top talkers must
    keep the rank-0 elephant; returns the runs' launches."""
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts
    from cilium_tpu_torch.testing.workloads import (SCENARIOS,
                                                    make_scenario,
                                                    run_scenario,
                                                    scenario_daemon)

    t20 = time.monotonic()
    runs = [(name, None) for name in SCENARIOS] + [
        ("elephant_mice", {"trace_sample": 1})]
    part = report["scenarios"] = {"seed": SCENARIO_SEED, "runs": []}
    reset_launch_counts()
    for name, serving in runs:
        label = name if serving is None else f"{name} {serving}"
        sc = make_scenario(name, seed=SCENARIO_SEED)
        d = scenario_daemon(sc, map_pressure_interval=0.25)
        check(d.loader.device.type == "cuda",
              f"scenarios: {label} built on {d.loader.device}")
        d.start()
        t0 = time.monotonic()
        r = run_scenario(d, sc, serving_kwargs=serving)
        wall = time.monotonic() - t0
        m = r["metrics"]
        for crit, ok in r["checks"].items():
            check(ok, f"scenarios: {label}: {crit} = "
                      f"{sc.criteria[crit]} failed: {m}")
        check(r["passed"] and m["ledger_exact"]
              and m["submitted"] == m["verdicts"],
              f"scenarios: {label}: front-end ledger {m}")
        if sc.path == "serving":
            check(m["l7_ledger_exact"] and m["l7_redirected"] == (
                m["l7_allowed"] + m["l7_denied"] + m["l7_shed"]
                + m["l7_failed"]), f"scenarios: {label}: L7 ledger {m}")
        a = analytics_ledger(d, f"scenarios: {label}")
        check(a["batches-ingested"] > 0 and a["packets-seen"] > 0,
              f"scenarios: {label}: the flow analytics aggregated "
              f"nothing: {a}")

        def drop_spikes():
            return [i["detail"] for i in d.incidents
                    if i["kind"] == "drop-spike"]

        if "spike_min_drops" in sc.daemon_overrides:
            # the silence after the stream: the flow-agg-roll
            # controller closes the drop window, which must fire one
            # incident (the path the override exists for)
            wait_for(drop_spikes, lambda: f"scenarios: {label}: a "
                     f"drop-spike incident ({d.flows_aggregate()['spike']})",
                     timeout=4 * d.config.flow_agg_window_s)
            check(len(drop_spikes()) == 1,
                  f"scenarios: {label}: drop spikes {drop_spikes()}")
        spikes = drop_spikes()
        top = None
        if serving is not None:
            talkers = d.flows_aggregate(top=8)["top-talkers"]
            top = [t["sport"] for t in talkers]
            check(1024 in top, f"scenarios: {label}: the rank-0 elephant "
                               f"(sport 1024) is not in the top 8: {top}")
        d.shutdown()
        shown = {k: m[k] for k in (
            "submitted", "verdicts", "shed_frac", "sustained_pps", "p99_us",
            "drop_frac", "drops_by_reason", "ops_applied",
            "ct_insert_drops", "ct_occupancy", "nat_failures",
            "l7_redirected", "elapsed_s")}
        print(f"scenario {label}: passed {r['checks']}; {json.dumps(shown)}"
              f"; analytics {a['batches-submitted']} batches = "
              f"{a['batches-ingested']} ingested + {a['batches-dropped']} "
              f"dropped, {a['packets-seen']} packets, "
              f"{a['windows-closed']} windows closed; {len(spikes)} "
              f"drop-spike incidents "
              f"{[(s['drops'], s['threshold']) for s in spikes]}"
              + ("" if top is None else f"; top talkers' sports {top}")
              + f"; {wall:.2f} s")
        part["runs"].append({"scenario": name, "serving_kwargs": serving,
                             "checks": r["checks"], "metrics": m,
                             "analytics": a, "spikes": spikes,
                             "top_sports": top, "wall_s": wall})
    launches = {k: v.launches for k, v in KERNELS.items()}
    for name in SCENARIO_KERNELS:
        check(launches[name] > 0, f"scenarios: {name} never launched")
    part["launches"] = launches
    part["seconds"] = time.monotonic() - t20
    slowest = max(part["runs"], key=lambda x: x["wall_s"])
    print(f"scenarios phase: {part['seconds']:.1f} s ({len(runs)} runs; "
          f"the longest {slowest['scenario']} at "
          f"{slowest['wall_s']:.1f} s)")
    return launches


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
    t_smoke = time.monotonic()
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
        from cilium_tpu_torch.monitor.ring import _gather_rung

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
        phase_dus(torch, rng, world, kernels, report)
        phase_egress_kernels(torch, rng, kernels)
        svc_mgr = phase_lb_kernels(torch, rng, world, kernels, report)
        phase_ml_kernels(torch, rng, world, kernels, report)
        phase_train_kernels(torch, rng, world, kernels, report)
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
        phase_k1_k4_shapes(torch, rng, world, report)

        # -- 6. the superbatch ----------------------------------------------
        phase_superbatch(torch, rng, world, report)

        # -- 7. the daemon at full width -------------------------------------
        by_path["daemon"], rung = phase_daemon(torch, rng, world, report)
        time_gather(torch, rng, kernels, rung)

        # -- 8. the redirect overhead ---------------------------------------
        by_path["l7_redirect"] = phase_l7_redirect(torch, report)

        # -- 9. the FQDN flip -------------------------------------------------
        by_path["fqdn"] = phase_fqdn(torch, world, report)

        # -- 10. identity and ipcache churn ------------------------------------
        by_path["churn"] = phase_churn(torch, rng, world, report)

        # -- 11. the offline egress path --------------------------------------
        by_path["egress"] = phase_egress(torch, rng, world, report)

        # -- 12. the service path -------------------------------------------
        by_path["service"] = phase_service(torch, rng, world, svc_mgr,
                                           report)

        # -- 13. the anomaly scorer -------------------------------------------
        by_path["anomaly"] = phase_anomaly(torch, rng, world, report)

        # -- 14. the trainer ------------------------------------------------
        by_path["train"], by_path["train_mesh"] = phase_train(
            torch, rng, world, report)

        # -- 15. sharded serving ------------------------------------------
        t15 = time.monotonic()
        phase_sharded_kernels(torch, rng, world, kernels, report)
        by_path["sharded"] = phase_sharded_daemon(torch, rng, world, report)
        sd = report["sharded_daemon"]
        time_gather_sharded(torch, rng, kernels, _gather_rung(
            -(-sd["events"] // (max(sd["windows"], 1) * SHARDS)),
            RING_CAPACITY))
        phase_sharded_demotion(torch, report)
        report["sharded_s"] = time.monotonic() - t15
        print(f"sharded serving: {report['sharded_s']:.1f} s")

        # -- 16. the connectivity test (config #1) ------------------------
        by_path["connectivity"] = phase_connectivity(torch, report)

        # -- 17. the delta attach --------------------------------------
        by_path["delta_attach"], k10_slice = phase_delta_attach(
            torch, rng, world, report)

        # -- 18. mutual authentication ---------------------------------
        by_path["auth"], k10_cell = phase_auth(torch, rng, world, report)

        # -- 19. config #2: the flow plane over a pcap replay ------------
        by_path["config2"] = phase_config2(torch, rng, world, report)

        # -- 20. the scenario engine ---------------------------------------
        by_path["scenarios"] = phase_scenarios(torch, report)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    # K13 and K16 timed again on the paths' own inputs (phases 11, 12)
    kernels["bw_stage"]["path_ms"] = {
        p: report[p]["k13_main_path"]["ms"] for p in ("egress", "service")}
    kernels["lb6_stage"]["path_ms"] = {
        "service": report["service"]["k16_main_path"]["ms"]}
    # K12 on the egress and service paths' own inputs, K7 on the daemon's
    # own table (phases 11, 12, 7)
    kernels["snat_reverse"]["path_ms"] = {
        p: report[p]["k12_main_path"]["ms"] for p in ("egress", "service")}
    kernels["ct_gc"]["path_ms"] = {
        "daemon": report["daemon"]["k7_daemon_table"]["ms"]}
    kernels["ct_occupied"]["path_ms"] = {
        "daemon": report["daemon"]["k8_daemon_table"]["ms"]}
    # K10 at a delta attach's policy slice and at an auth grant's cell
    # (phases 17, 18), each with its bound and the same Tensor.copy_
    kernels["dus"]["path_ms"] = {
        "policy_slice": k10_slice["ms"], "auth_cell": k10_cell["ms"]}
    kernels["dus"]["path_shapes"] = {
        p: {k: t[k] for k in ("update", "table", "profiler_ms", "bound_ms",
                              "copy_ms")}
        for p, t in (("policy_slice", k10_slice), ("auth_cell", k10_cell))}
    on_path, launchers = [], []
    for name, k in kernels.items():
        k["bound_ms"], k["bound_by"] = bound(k.pop("bytes"), k.pop("ops"),
                                             k.pop("flop_ms", 0.0))
        # launches: the daemon path's count where the kernel runs there,
        # else the slice path's, the churn path's, the egress path's,
        # the service path's, the anomaly path's, the trainer's, the
        # trainer's over a mesh, the sharded daemon's, the connectivity
        # test's, the delta attach's, the auth grants', config #2's
        # replay or the scenarios' (each path's counts zeroed before it
        # ran)
        k["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
        k["launches"] = (by_path["daemon"][name] or by_path["slice"][name]
                         or by_path["churn"][name] or by_path["egress"][name]
                         or by_path["service"][name]
                         or by_path["anomaly"][name]
                         or by_path["train"][name]
                         or by_path["train_mesh"][name]
                         or by_path["sharded"][name]
                         or by_path["connectivity"][name]
                         or by_path["delta_attach"][name]
                         or by_path["auth"][name]
                         or by_path["config2"][name]
                         or by_path["scenarios"][name])
        lib = ("" if k["library_ms"] is None
               else f", library {k['library_ms']:.4f} ms")
        print(f"kernel {name}: {k['launches']} launches on the main path "
              f"({k['launches_by_path']}), {k['ms']:.4f} ms (plain "
              f"{k['plain_ms']:.3f} ms{lib}, bound {k['bound_ms']:.4f} ms "
              f"by {k['bound_by']}), max abs err {k['max_abs_err']}")
        (on_path if k["launches"] else launchers).append(k)
    report["kernels"] = on_path
    report["standalone_launchers"] = launchers
    # the line lists every kernel; the standalone launchers (K2, K3, K14
    # and K15, held against their plain versions in phase 3) with 0
    # launches
    for k in launchers:
        k["standalone"] = True
    report["wall_s"] = time.monotonic() - t_smoke
    print(f"smoke: {report['wall_s']:.1f} s from the device check to "
          f"the kernels line (build included)")
    report["profiler_short"] = PROFILER_SHORT
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(smi)
    print(json.dumps({"kernels": on_path + launchers}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
