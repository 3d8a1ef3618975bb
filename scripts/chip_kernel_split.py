#!/usr/bin/env python3
"""Split K4 ``ct_update`` (and K4s over 8 shards) by launch and time K1
``datapath_kernel`` (packed and wide, and K1s), K20
``anomaly_train_fwd`` (and K20s), K9 ``l7_verdict``, K18
``flow_features``, K19 ``anomaly_score``, K22 ``adam_update``, K5
``ring_append`` (and K5s), K17 ``socklb_stage``, K11 ``snat_egress``
(with K12 ``snat_reverse`` after it), K13 ``bw_stage``, K16
``lb6_stage``, K12, K7 ``ct_gc``, K6 ``ring_gather``, K8
``ct_occupied``, K2 ``lpm_lookup``, K15 ``lb_stage`` and K14
``masq_rewrite`` at the shapes the main paths launch them (K2, K15 and
K14: the shapes ``chip_smoke.py`` holds them at), for one or more
checkouts of this repository.

    python3 scripts/chip_kernel_split.py
        [--kernels=k1k4,k20,k9,k18,k19,k22,k5,k17,k11,k13,k16,k12,k7,k6,k8,
                   k2,k15,k14]
        [--variants=TREE] [--grids=TREE] [--layouts=TREE] [TREE ...]

Each TREE is a checkout (a ``git archive`` of another commit unpacked
in a directory that ``.gitignore`` lists will do); each runs in its own
process, in the order given, so ``A B B A`` compares two commits in
turns on one card.  A run builds the tree's verdict and conntrack
kernels, makes config #3's world (``chip_smoke``'s seed) and, on a CT
of 2^20 slots:

- the trainer's batch: 4096 wide rows of ``synth_labeled_traffic``
  after 8 warm-up steps of ``datapath_step``;
- the daemon's bucket (2^16 packed rows) and the slice's batch (2^18
  packed, and 2^18 wide rows with IPv6 and ICMP errors): a SYN batch
  (the flow pool, every row a new flow) and a steady batch drawn from
  the pool once the SYN batch has been served;
- the sharded step: a 2^16 and a 2^18 bucket flow-routed into 8 shard
  blocks (headroom 2: 2^17 and 2^19 routed rows), SYN and steady.

For each it times K1 (CUDA events, ``chip_smoke.device_ms``, 20 calls)
and K4 on fresh copies of the CT (events, and ``torch.profiler`` by
kernel name over 20 calls, with the launches a call), and records a
digest of the K1 outputs, of K4's inputs and of the CT table, ``fp``
and ``dropped`` after K4, so that trees are held against each other
bit for bit.  Where the tree's plain ``ct_update_plain`` takes
``stats`` it also records the insert rounds in which any row was still
pending, and where its launcher hands back the kernel's round counts
(``scratch=``), the rounds the kernel ran.

``--variants=TREE`` (a tree with PR 14's kernels) builds, in TREE's
first run, throwaway variants of its ``conntrack.cu`` with other K4
grids (at most 2 or 8 blocks of 256 an SM) or every grid barrier
doubled (its time over the barriers a call prices one), times K4 in
each on every case's inputs and holds its CT against the tree's own;
and of its ``verdict.cu`` with K1 held to 8 or 6 blocks an SM.

``--kernels`` picks the cases (every set by default).  K20: the
trainer's batch (``chip_smoke.train_inputs``: 4096 rows of
``synth_labeled_traffic`` at config #3's V = 16384, through K1/K4 and
K18) under ``chip_smoke.train_model``'s leaves, unsharded and over 8
shards (K20s); K9: config #4 (4096 requests x 208 rules, K = 2), the
same without the prefix tensor, and the daemon's shape (1 and 2
requests against config #3's one HTTP rule).  K18: 2^18 rows of
``synth_labeled_traffic`` (attack_frac 0.25, chip_smoke phase 3's
batch) served through K1/K4, the same rows with every row on one
service (one bucket takes every row), and the trainer's 4096 rows;
K19: ``chip_smoke.card_model`` (V = 16384) with its novelty fitted on
the 2^18 batch's benign rows, on the plain features of the 2^18 and
4096-row batches.  Each case records its time (CUDA events over 20
calls), its ``torch.profiler`` time by kernel name (each kernel's
event count checked against the launches of a captured call, measured
again once where the profiler dropped an event, then a failure), a
digest of its outputs (K20: the loss, the logits and ``xT``, ``h1T``,
``h2T``; K9: ``out``; K18: ``id_row`` and the features; K19: ``d2``,
with the scores and logits apart, since they hold to a tolerance),
whether they equal the plain version's (K20: all but the loss, which
sums in another order; K18: ``id_row`` and 22 columns bit-exact, the
``log1p`` columns within 1 ulp; K19: the scores' and logits' largest
error and identical share), the operations a call puts on the stream
(a CUDA-graph capture, ``testing/capture.py``) and whether two calls
give the same bits; for K20s, whether it equals 8 unsharded launches on
the blocks and their shard-order mean.  K22: the trainer's leaves and
gradients (``chip_smoke.train_model``, the plain backward of
``chip_smoke.train_inputs``) after three plain steps, from count 3 and
from INT_MAX - 1 (the count saturates), timed in place and on fresh
copies, with params, mu, nu and count digested after one and two calls.
K5: K1's out rows of served packed batches (config #3, listener table
(10000,), trace sample 1024): the daemon's 2^16 bucket and the slice's
2^18 batch (steady), the 2^16 SYN batch into a ring of 2^15
(overflow), the 2^16 batch with the cursor's low word 256 short of
2^32, and K5s over a 2^18 bucket routed into 8 shards of 2^16; each
timed on fresh rings, the ring's buffer and cursors digested.

K17 (``lb_cases``): phase 3's service world (4096 v4 frontends, Maglev
16381) and ``testing.services.socklb_steps`` on the 2^16 cache: the last
connect batch (8192 new flows), the steady batch, the burst over
CONNECT_CAP, the forced fingerprint overflow and the mixed batch (2^16
rows, 4096 new flows: phase 12's shape).  K11 (``nat_cases``): phase
11's main path (``chip_smoke.egress_daemon`` driven through its 8
batches, then the next batch against the live pool and CT), phase 3's
case (``chip_smoke.nat_case`` after one batch) and its rows into an
empty 2^10 pool; K12 on replies to each call's rows.  Each case is timed
on fresh copies of its table, split by the profiler, digested (rows,
masks, tables; NAT ``failed``) and held against the plain version's, a
second call's and the claim words' being free after the call; where the
tree's launcher hands them back, the kernel's step counts and its phase
times (``phase_ns``).  ``--grids=TREE`` builds, in TREE's first run,
variants of its ``socklb.cu`` and ``nat.cu`` (1 or 2 blocks an SM, 1 or
2 rows a thread in the one-block tail; K17 without its frontend scans,
K11 without its reverse-CT probe or gateway rules: those outputs
differ, and say so) and times each case in each.

K13 and K16 (``bw_lb_cases``): K13 on phase 3's case (2^16 rows over 257
endpoints, 65 limited, after clocks across 2^32), every row an egress
row of one limited endpoint, n = 0 and 1, and the egress and service
paths' own inputs (``chip_smoke.egress_daemon`` driven through
``process_batch``; the rows ``Daemon._bw_police`` takes in the next
batch); K16 on phase 3's case (half of 2^16 rows v6, 256 v6 frontends),
the service path's own rows (those ``lb6_stage`` takes), no v6 row,
every v6 row on a port or protocol no frontend has, and 4096 v6
frontends.  Each is timed (K13 on fresh copies of its buckets), split
by the profiler and digested (K13: reasons, tokens, last; K16: rows and
both masks), held against the plain version's and a second call's;
where the tree's K13 launcher hands them back, whether its sums are
zero after the call and its phase times.

K12 (``k12_cases`` and ``bw_lb_cases``): phase 3's pool (a batch at
1000, then the next at 1090) and that batch's replies (misses and
forged protocol words mixed in); 2^16 replies to one TCP mapping; 2^16
forged twins (protocol 6 | 0x100, the remote port one lower) aliasing
TCP mappings' slots, in random order; 2^16 replies below the pool; one
reply; the egress and service paths' own inputs (the rows
``TorchLoader.reverse_nat`` takes in the next batch).  K7
(``k7_cases``): phase 3's half-full 2^20 CT with its edge expiries, the
daemon's own CT (config #3's 2^18-flow steady pool through K1/K4, swept
at its clock), an empty CT, a full one with 10% expired and a full one
all expired.  Each is timed on fresh copies of its table, split by the
profiler, digested (K12: rows and table; K7: table, fingerprints and
count) and held against the plain version's and a second call's, with
its operations a call (a CUDA-graph capture); K12 also with its claim
words free after the call and, where its launcher hands them back, its
phase times.  ``--grids=TREE`` also builds K12's grid variants (256 or
512 threads a block, 1-4 rows a thread in registers, every hit
bidding) and K7's (1-64 blocks an SM).

K6 (``k6_cases``): a ring of 2^18 random event words a shard
(``chip_smoke.random_ring_words``), one shard at rungs 2^18, 4096 and
64 from slot 0 and from an odd slot that wraps, 8 shards at rungs 2^15
and 2^18 from starts even and odd by turns.  K8 (``k8_cases``): phase
3's half-full 2^20 fingerprints, the same table empty and full, shard
3's slice of 8 (a view at an offset), that slice from its fourth slot
and 5 slots short, a half-full 2^12 table.  Each is timed, split by the
profiler (K8's memset apart, where the tree has one), digested, held
against the plain version's and a second call's, with its operations a
call (a CUDA-graph capture) and its library time: one
``torch.index_select`` of the same rows (its index built once on the
card, not timed) for K6, ``torch.count_nonzero`` for K8; K6 also with
the host's enqueue microseconds of a call and of its ``torch.empty``.
``--grids=TREE`` builds K6's grid variants (1-8 blocks an SM) and K8's
(1-4 blocks an SM, 2 or 4 loads a thread).

K2 (``k2_cases``): config #3's LPM (257 v6 entries) on phase 1's
inputs (``chip_smoke.lpm_rows``: 2^18 addresses, 20% v6, 30% of those
off every /128), the same 2^18 all v4 and all v6, 4096 rows of phase
1's mix, the larger TCAM of ``chip_smoke.big_tcam`` (4177 v6 entries,
four prefix lengths) with the same mix and a table with no v6 entry,
with the host time of ``DeviceLPM.from_tensors`` for each table (the
best of 5).  K15 (``k15_cases``): phase 3's service world (4096 v4
frontends, Maglev 16381) on phase 3's rows (2^16, half to a VIP, every
fifth source above 2^31), with no row to a VIP, with every row to one,
4096 rows of that mix, a world of 64 frontends, and that world with a
second name on one VIP:port (correctness).  Each is timed, split by the
profiler (a window short twice is recorded, not fatal: the events time
holds), digested (K2: the rows' values; K15: rows and both masks), held
against the plain version's (K2's a slice of rows at a time) and a
second call's, with its operations a call.  ``--layouts=TREE`` builds
K15's slot layouts (the source's 16-byte slot against a slot naming the
frontend, whose words the probe then reads) and K2's mask staging
(shared memory against global) from TREE's source and times each case
in each.

K14 (``k14_make_inputs``, made once by this checkout's code in a
temporary directory and fed to every tree): phase 3's inputs
(``chip_smoke.nat_case``: 2^16 rows, 4096 replies to 8192 live inbound
connections in a 2^20 CT) with the probe and without it, 2^16 replies
that all find their entry, those rows with no candidate, a CT 86% full,
4096 rows; then, for correctness only, ``chip_smoke.masq_edge_cases``
(entries past N_CAND fingerprint matches, wrapping windows, a clock near
2^32, no and four exclusions), rows off a 16-byte boundary, n = 1 and 0.
Each is digested (rows and mask) and held against the plain version's
and a second call's, with its operations a call, its candidates and the
rows its probe keeps; the timed ones are timed and split by the
profiler.  ``--grids=TREE`` also builds K14's grid variants (1 or 4
blocks an SM, a grid sized to the rows, blocks of 256, two rows a
thread).

Each run writes ``chiprun_out/split/<label>.json``; the main process
prints, for every later run, the digests that differ from an earlier
run's.  The line before the last is the card's name and power limit
(nvidia-smi); the last line is one JSON object with every run.  Needs a
CUDA device.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import ipaddress
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "chiprun_out" / "split"
REPS = 20
SEED = 20261017  # chip_smoke's
NOW = 50_000
SHARDS = 8
HEADROOM = 2

# (pattern, replacement) for each throwaway variant of a source: K4's
# grid shapes of the cooperative conntrack.cu (every grid barrier doubled,
# to price one; at most 2 or 8 blocks of 256 an SM, 8 being the
# co-resident maximum)
K4_GRID = {
    "as_is": [],
    "double_sync": [("grid.sync();", "grid.sync();\n  grid.sync();")],
    "per_sm2": [("constexpr int K4_BLOCKS_PER_SM = 1;",
                 "constexpr int K4_BLOCKS_PER_SM = 2;")],
    "per_sm8": [("constexpr int K4_BLOCKS_PER_SM = 1;",
                 "constexpr int K4_BLOCKS_PER_SM = 8;")],
}
# K1's occupancy: the redesigned kernel held to 8 or 6 blocks of 256 an
# SM (32 or 40 registers a thread) instead of the registers it asks for
K1_OCCUPANCY = {
    "as_is": [],
    "min_blocks8": [("__global__ void __launch_bounds__(TPB)\n"
                     "    datapath_kernel(",
                     "__global__ void __launch_bounds__(TPB, 8)\n"
                     "    datapath_kernel(")],
    "min_blocks6": [("__global__ void __launch_bounds__(TPB)\n"
                     "    datapath_kernel(",
                     "__global__ void __launch_bounds__(TPB, 6)\n"
                     "    datapath_kernel(")],
}
# K17's and K11's grids (at most 1 or 2 blocks of 256 an SM: at 2^16
# rows 2 or 1 rows a thread) and one-block tails (1 or 4 rows a thread
# against the sources' 2); K17 without its frontend lookups (every miss
# to no frontend: its outputs differ, and say so)
K17_GRID = {**{f"per_sm{b}": [("constexpr int SK_BLOCKS_PER_SM = 1;",
                               f"constexpr int SK_BLOCKS_PER_SM = {b};")]
               for b in (1, 2)},
            **{f"tail{r}": [("constexpr int SK_TAIL_ROWS = 2;",
                             f"constexpr int SK_TAIL_ROWS = {r};")]
               for r in (1, 4)},
            "no_lookup": [("svc = lb_lookup4(t, fe_ip, fe_pp, fe_index, "
                           "staged, b.w, c.y, c.z);", "svc = -1;")]}
K11_GRID = {**{f"per_sm{b}": [("constexpr int NAT_BLOCKS_PER_SM = 1;",
                               f"constexpr int NAT_BLOCKS_PER_SM = {b};")]
               for b in (1, 2)},
            **{f"tail{r}": [("constexpr int NAT_TAIL_ROWS = 2;",
                             f"constexpr int NAT_TAIL_ROWS = {r};")]
               for r in (1, 4)}}
# K11's prep without its reverse-CT probe (every egress v4 row taken for
# one with no live reverse entry) or without its gateway rules: what each
# costs (their outputs differ, and say so)
K11_PARTS = {
    "no_ct_probe": [("    p = ct_probe_begin(ct, rev);\n",
                     "    p = CtProbe{0u, 0u, 0};\n"),
                    ("              !reverse_ct_found_fp(ct, rev, p, io.now);",
                     "              true;")],
    "no_gateway": [("  const bool gw = gateway_rule(t, rules, n_rules, src, dst, "
                    "&rip);", "  const bool gw = false;")],
}


def _knob(name, old, new):
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


# K12's block and grid (threads a block, blocks an SM, hits a thread
# keeps in registers: at 2^16 rows the source's 132 blocks of 256 keep
# 2 rows a thread) and its bids without the warp's same-slot pairing
# (every hit bids)
K12_GRID = {
    "as_is": [],
    **{f"tpb{t}_per_sm{b}_rows{r}": [
        _knob("REV_TPB", 256, t), _knob("REV_BLOCKS_PER_SM", 1, b),
        _knob("REV_ROWS", 2, r)]
       for t, b, r in ((256, 1, 1), (256, 1, 4), (512, 1, 1))},
    "bid_every_hit": [("  if (h.slot >= 0 && ((threadIdx.x & 31) == 31 || "
                       "next != h.slot))", "  if (h.slot >= 0)")],
}
# K7's grid: blocks an SM (at 2^20 slots the source's 8 an SM stride
# four times over the table; 64 an SM is a thread a slot, the old grid)
K7_GRID = {"as_is": [], **{
    f"per_sm{b}": [_knob("GC_BLOCKS_PER_SM", 8, b)] for b in (1, 2, 4, 16,
                                                              64)}}
# K6's grid: blocks an SM (at rung 2^18 the source's 4 an SM give a
# unit a thread; 1 an SM 4 units a thread)
K6_GRID = {"as_is": [], **{f"per_sm{b}": [_knob("GATHER_BLOCKS_PER_SM", 4, b)]
                           for b in (1, 2, 8)}}
# K8's grid: blocks an SM, 16 B loads a thread in flight
K8_GRID = {"as_is": [],
           **{f"per_sm{b}_loads{n}": [_knob("OCC_BLOCKS_PER_SM", 2, b),
                                      _knob("OCC_LOADS", 4, n)]
              for b in (1, 2, 4) for n in (2, 4) if (b, n) != (2, 4)}}
# K15's index slot: the source's 16-byte slot (the key and its lowest
# frontend: a load a probe step) against K16's layout, a slot that names
# the frontend whose address, port and protocol the probe then reads
K15_LAYOUT = {"as_is": [], "slot_then_frontend": [(
    """    const uint4 s = __ldg(slots + h);
    if ((int32_t)s.w < 0) return -1;
    if (s.x == dst && s.y == dport && s.z == proto) return (int32_t)s.w;""",
    """    const int32_t q = (int32_t)__ldg(t.index + 4 * h + 3);
    if (q < 0) return -1;
    if (__ldg(t.svc_ip + q) == dst && __ldg(t.svc_port + q) == dport &&
        __ldg(t.svc_proto + q) == proto)
      return q;""")]}
# K2's group masks: staged in shared memory a block (the source) against
# read from global memory (L1) by every lane
K2_GROUPS = {"as_is": [], "groups_global": [(
    "const bool in_smem = t.n_groups <= LPM_SMEM_GROUPS;",
    "const bool in_smem = false;")]}
# K14's grid: a thread a row in blocks of 128, at most 2 an SM striding
# over the rows (the source), against 1 or 4 an SM, a grid sized to the
# rows, blocks of 256 and two rows a thread (two fingerprint windows in
# flight)
K14_GRID = {"as_is": [],
            **{f"per_sm{b}": [_knob("MASQ_BLOCKS_PER_SM", 2, b)]
               for b in (1, 4)},
            "grid_rows": [("    masq_kernel<MASQ_ROWS><<<(int)(want < most ? "
                           "want : most), MASQ_TPB, 0,",
                           "    masq_kernel<MASQ_ROWS><<<(int)want, "
                           "MASQ_TPB, 0,")],
            "tpb256": [_knob("MASQ_TPB", 128, 256)],
            "rows2": [_knob("MASQ_ROWS", 1, 2)]}
# variant set: (source, its variants)
ABLATIONS = {"k4_grid": ("conntrack", K4_GRID),
             "k1_occupancy": ("verdict", K1_OCCUPANCY),
             "k17_grid": ("socklb", K17_GRID),
             "k11_grid": ("nat", K11_GRID),
             "k11_parts": ("nat", K11_PARTS),
             "k12_grid": ("nat", K12_GRID),
             "k7_grid": ("conntrack", K7_GRID),
             "k6_grid": ("ring", K6_GRID),
             "k8_grid": ("conntrack", K8_GRID),
             "k15_layout": ("lb", K15_LAYOUT),
             "k2_groups": ("lpm", K2_GROUPS),
             "k14_grid": ("nat", K14_GRID)}
# the flags that name a tree, and the variant sets each runs there
TREE_FLAGS = {"--variants": ("k4_grid", "k1_occupancy"),
              "--grids": ("k17_grid", "k11_grid", "k11_parts", "k12_grid",
                          "k7_grid", "k6_grid", "k8_grid", "k14_grid"),
              "--layouts": ("k15_layout", "k2_groups")}
KERNEL_SETS = ("k1k4", "k20", "k9", "k18", "k19", "k22", "k5", "k17",
               "k11", "k13", "k16", "k12", "k7", "k6", "k8", "k2", "k15",
               "k14")
INT_MAX = (1 << 31) - 1
RING_CAP = 1 << 18  # chip_smoke's ring, a shard's on the sharded path
LISTENERS = (10000,)  # the daemon's listener table: config #3's one rule


def digest(*tensors) -> str:
    import torch

    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:  # numpy has no bf16: its bits
            t = t.view(torch.int16)
        h.update(t.numpy().tobytes())
    return h.hexdigest()[:16]


def build_ablations(tree: Path, which: str) -> dict:
    """nvcc each variant of set ``which`` of ``tree``'s source at once,
    outside the tree; -> {name: (library path, ptxas log)}."""
    from cilium_tpu_torch.kernels import build

    source, variants = ABLATIONS[which]
    csrc = tree / "cilium_tpu_torch" / "csrc"
    src = (csrc / f"{source}.cu").read_text()
    own_header = f'#include "{source}.cuh"'
    work = OUT / "ablate"
    work.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in text and own_header in text:
                # a pattern of the source's own header: inline it
                text = text.replace(own_header, (
                    csrc / f"{source}.cuh").read_text().replace(
                        "#pragma once\n", ""))
            if old not in text:
                raise RuntimeError(f"ablation {name}: pattern not found: "
                                   f"{old[:60]!r}")
            text = text.replace(old, new)
        cu = work / f"{which}_{name}.cu"
        cu.write_text(text)
        so = work / f"{which}_{name}.so"
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(csrc), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT), so)
    libs = {}
    for name, (p, so) in procs.items():
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode != 0:
            raise RuntimeError(f"ablation {name}: nvcc failed\n{log}")
        libs[name] = (so, log)
    return libs


def use_library(source: str, path: Path) -> None:
    """Point the tree's launchers of ``source``.cu at another build."""
    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.kernels import build

    lib = ctypes.CDLL(str(path))
    lib.cuda_error_name.restype = ctypes.c_char_p
    lib.cuda_error_name.argtypes = [ctypes.c_int]
    build._LIBS[source] = lib
    kernels._READY.discard(source)


def ptxas_regs(log: str) -> list:
    """[(entry, registers, spill store bytes)] from an nvcc -Xptxas -v log."""
    out, entry, spill = [], None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in line and "registers" in line and entry:
            regs = int(line.split("Used")[1].split("registers")[0])
            out.append((entry, regs, spill))
    return out


# the windows torch.profiler came back short from, each measured again
SHORT_WINDOWS = []


def profiled(fn, fresh=None) -> dict:
    """{kernel name: {ms, calls}} a call of ``fn``: torch.profiler over
    REPS calls after an untimed one (``fresh()`` makes each call's
    inputs before the window, for a call that changes them).  The
    operations one call puts on the stream are counted first from a
    CUDA-graph capture (``testing.capture.ops_a_call``), and the window
    must show each of them REPS times: a dropped event would read as a
    lower time.  The window opens and closes with a spin kernel that is
    not counted (the profiler has dropped one event at a window's edge).
    A short window is measured once more; a second one fails the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cilium_tpu_torch.testing.capture import ops_a_call

    def call(x):
        return fn(x) if fresh else fn()

    def prepare():
        x = fresh() if fresh else None
        return lambda: call(x)

    want = sum(ops_a_call(prepare).values()) * REPS
    for _attempt in range(2):
        inputs = [fresh() if fresh else None for _ in range(REPS + 1)]
        call(inputs[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for x in inputs[1:]:
                call(x)
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith("Activity Buffer")
                  and "spin_kernel" not in e.key]
        seen = sum(e.count for e in events)
        if seen == want and all(e.count % REPS == 0 for e in events):
            return {e.key: {"ms": e.self_device_time_total / 1e3 / REPS,
                            "calls": e.count / REPS} for e in events}
        SHORT_WINDOWS.append({"seen": seen, "want": want,
                              "by_kernel": {e.key: e.count for e in events}})
        print(f"profiler: {seen} device events of {want} in a window of "
              f"{REPS} calls")
    raise RuntimeError(f"torch.profiler came back short twice: "
                       f"{SHORT_WINDOWS[-2:]}")


def train_cases(world, rng) -> dict:
    """K20 and K20s at the trainer's batch: {case: (call, plain call,
    blocks or None)}."""
    import chip_smoke as cs
    import torch
    from cilium_tpu_torch.kernels import launch_anomaly_train_fwd
    from cilium_tpu_torch.ml.model import train_forward_plain

    ids, feats, labels = cs.train_inputs(torch, rng, world)
    leaves = cs.train_model(torch, world).leaves()
    n = ids.shape[0]
    cases = {}
    for name, shards in (("k20_4096", None), (f"k20s_4096x{SHARDS}",
                                               SHARDS)):
        blocks = None
        if shards:
            blk = n // shards
            blocks = [(ids[z * blk:(z + 1) * blk],
                       feats[z * blk:(z + 1) * blk],
                       labels[z * blk:(z + 1) * blk])
                      for z in range(shards)]
        cases[name] = (
            lambda s=shards: launch_anomaly_train_fwd(leaves, ids, feats,
                                                      labels, s),
            lambda s=shards: train_forward_plain(leaves, ids, feats, labels,
                                                 s),
            None if blocks is None else
            (lambda b=blocks: [launch_anomaly_train_fwd(leaves, *x)[0]
                               for x in b]))
    return cases


def k20_digests(out) -> dict:
    loss, saved = out
    return {"loss": digest(loss),
            "rest": digest(saved["logit"], saved["xT"], saved["h1T"],
                           saved["h2T"])}


def run_k20(label, cases) -> dict:
    """Time each K20 case, digest its outputs and hold them against the
    plain version, a second call and (K20s) the unsharded launches'
    mean; -> {case: record}."""
    import chip_smoke as cs
    import torch

    recs = {}
    for name, (fn, plain, singles) in cases.items():
        out = fn()
        again = fn()
        d, d2 = k20_digests(out), k20_digests(again)
        rec = {"ms": cs.device_ms(fn, REPS), "out": d["loss"] + d["rest"],
               "repeat_equal": d == d2}
        ploss, (x, h1, h2, logit) = plain()
        saved = out[1]
        rec["plain_equal"] = all(
            torch.equal(a, b) for a, b in
            ((saved["logit"], logit), (saved["xT"], x.t()),
             (saved["h1T"], h1.t()), (saved["h2T"], h2.t())))
        rec["loss_err"] = abs(out[0].item() - ploss.item())
        if singles is not None:
            parts = singles()
            total = parts[0]
            for t in parts[1:]:
                total = total + t
            mean = total / torch.tensor(float(len(parts)),
                                        device=total.device)
            rec["shard_mean_equal"] = bool(torch.equal(out[0], mean))
        rec["by_kernel"] = profiled(fn)
        recs[name] = rec
        print(f"[{label}] K20 {name}: {rec['ms']:.4f} ms (events); "
              + ", ".join(f"{k}={v}" for k, v in rec.items()
                          if k not in ("ms", "by_kernel")))
        print(f"[{label}]   " + ", ".join(
            f"{k[:40]} {v['ms']:.4f}x{v['calls']:.0f}"
            for k, v in rec["by_kernel"].items()))
    return recs


def l7_cases(rng) -> dict:
    """K9 at config #4 (with and without its prefix tensor) and at the
    daemon's shape: {case: (call, plain call)}."""
    import chip_smoke as cs
    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.policy.api import L7Rules
    from cilium_tpu_torch.proxy.featurize import (featurize_http,
                                                  path_prefix_hashes)
    from cilium_tpu_torch.proxy.l7policy import (compile_l7, l7_verdict,
                                                 l7_verdict_plain,
                                                 prefix_columns)

    def tensors(redirects, reqs, port):
        t = compile_l7(redirects)
        rows, raw = featurize_http(reqs, port)
        rules_d, rows_d = (u32.from_numpy(a, "cuda") for a in (t.rules, rows))
        if not t.n_prefix:
            return rules_d, rows_d, None, None, None
        pref = path_prefix_hashes([r["path"] for r in raw], t.prefix_lengths)
        lens_d = u32.from_numpy(np.asarray(t.prefix_lengths), "cuda")
        return (rules_d, rows_d, u32.from_numpy(pref, "cuda"), lens_d,
                prefix_columns(rules_d, lens_d))

    pol, reqs = cs.l7_world(rng)
    r4, q4, p4, l4, c4 = tensors(pol.redirects, reqs, cs.L7_PORT)
    cases = {
        f"config4_{q4.shape[0]}x{r4.shape[0]}_k{p4.shape[1]}": (
            lambda: l7_verdict(r4, q4, p4, l4, rule_cols=c4),
            lambda: l7_verdict_plain(r4, q4, p4, l4)),
        f"config4_{q4.shape[0]}x{r4.shape[0]}_nopref": (
            lambda: l7_verdict(r4, q4), lambda: l7_verdict_plain(r4, q4))}
    # config #3's one HTTP rule (GET), as the daemon's proxy holds it
    red3 = [(80, "r", L7Rules.from_dict({"http": [{"method": "GET"}]}))]
    for n_req in (1, 2):
        reqs3 = [{"method": "GET" if i % 2 else "POST", "path": f"/v{i}",
                  "host": "db"} for i in range(n_req)]
        r3, q3, p3, l3, c3 = tensors(red3, reqs3, 80)
        cases[f"daemon_{n_req}x{r3.shape[0]}"] = (
            lambda r3=r3, q3=q3, p3=p3, l3=l3, c3=c3:
                l7_verdict(r3, q3, p3, l3, rule_cols=c3),
            lambda r3=r3, q3=q3, p3=p3, l3=l3:
                l7_verdict_plain(r3, q3, p3, l3))
    return cases


def run_k9(label, cases) -> dict:
    import chip_smoke as cs
    import torch

    recs = {}
    for name, (fn, plain) in cases.items():
        out = fn()
        want = plain()
        rec = {"rows": int(out.shape[0]), "ms": cs.device_ms(fn, REPS),
               "out": digest(out), "plain_equal": bool(torch.equal(out, want)),
               "admitted": int(out.sum().item()), "by_kernel": profiled(fn)}
        recs[name] = rec
        print(f"[{label}] K9 {name}: {rec['ms']:.4f} ms (events), "
              f"{rec['admitted']} of {rec['rows']} admitted, plain equal "
              f"{rec['plain_equal']}; " + ", ".join(
                  f"{k[:30]} {v['ms']:.4f}x{v['calls']:.0f}"
                  for k, v in rec["by_kernel"].items()))
    return recs


def ml_cases(world, rng):
    """K18's and K19's inputs at their paths' shapes: ({case: (hdr,
    out)}, {case: (model, id_row, feats)}).  2^18 rows of
    ``synth_labeled_traffic`` (attack_frac 0.25) through K1/K4 (phase
    3's batch), the same rows on one service, and the trainer's 4096
    rows; K19 takes the plain features of the 2^18 and 4096-row
    batches, under ``card_model`` with its novelty fitted on the big
    batch's benign rows."""
    import chip_smoke as cs
    import torch
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import (COL_DPORT, COL_DST_IP3,
                                               COL_PROTO)
    from cilium_tpu_torch.datapath.verdict import datapath_step
    from cilium_tpu_torch.ml import fit_novelty, synth_labeled_traffic
    from cilium_tpu_torch.ml.features import flow_features_plain

    def served(n, **kw):
        hdr_np, labels = synth_labeled_traffic(world, n, rng, **kw)
        hdr = u32.from_numpy(hdr_np, "cuda")
        out, _ = datapath_step(cs.card_state(world), hdr, NOW)
        return hdr, out, labels

    big, big_out, labels = served(cs.ML_N, attack_frac=0.25)
    one = big.clone()
    one[:, COL_DST_IP3], one[:, COL_DPORT], one[:, COL_PROTO] = 7, 5432, 6
    small, small_out, _ = served(cs.TRAIN_N)
    k18 = {f"k18_{cs.ML_N}": (big, big_out),
           f"k18_{cs.ML_N}_one_service": (one, big_out),
           f"k18_{cs.TRAIN_N}": (small, small_out)}
    f_big = flow_features_plain(big, big_out)
    f_small = flow_features_plain(small, small_out)
    benign = torch.from_numpy(labels < 0.5).cuda()
    model = fit_novelty(cs.card_model(torch, world),
                        f_big[1][benign].cpu().numpy())
    k19 = {f"k19_{cs.ML_N}": (model, *f_big),
           f"k19_{cs.TRAIN_N}": (model, *f_small)}
    return k18, k19


def run_k18(label, cases) -> dict:
    """Time each K18 case, digest its outputs and hold them against the
    plain version (``chip_smoke.feature_err``) and a second call."""
    import chip_smoke as cs
    import torch
    from cilium_tpu_torch.ml.features import (flow_features,
                                              flow_features_plain)
    from cilium_tpu_torch.testing.capture import ops_a_call

    recs = {}
    for name, (hdr, out) in cases.items():
        def fn(hdr=hdr, out=out):
            return flow_features(hdr, out)

        got, again = fn(), fn()
        want = flow_features_plain(hdr, out)
        rec = {"rows": int(hdr.shape[0]), "ms": cs.device_ms(fn, REPS),
               "out": digest(*got), "repeat_equal": digest(*again) ==
               digest(*got), "ops_a_call": ops_a_call(lambda f=fn: f),
               "hot_bucket_rows": round(float(torch.expm1(
                   want[1][:, 19].max() * 12))),
               "by_kernel": profiled(fn)}
        try:
            rec["max_abs_err"] = cs.feature_err(torch, got, want, name)
            rec["plain_equal"] = True
        except cs.SmokeFailure as e:
            rec["plain_equal"] = str(e)
        recs[name] = rec
        print(f"[{label}] K18 {name}: {rec['ms']:.4f} ms (events); "
              + ", ".join(f"{k}={v}" for k, v in rec.items()
                          if k not in ("ms", "by_kernel")))
        print(f"[{label}]   " + ", ".join(
            f"{k[:40]} {v['ms']:.4f}x{v['calls']:.0f}"
            for k, v in rec["by_kernel"].items()))
    return recs


def run_k19(label, cases) -> dict:
    """Time each K19 case (the score alone, as the scorer asks, and with
    the logits and d2), digest its outputs and hold them against the
    plain versions and a second call: d2 bit-exact, the scores' and
    logits' largest error and identical share."""
    import chip_smoke as cs
    import torch
    from cilium_tpu_torch.kernels import launch_anomaly_score
    from cilium_tpu_torch.ml.model import (forward_plain, novelty_d2_plain,
                                           score_packets_plain)
    from cilium_tpu_torch.testing.capture import ops_a_call

    recs = {}
    for name, (model, ids, feats) in cases.items():
        def fn(ids=ids, feats=feats):
            return launch_anomaly_score(model, ids, feats)

        def full(ids=ids, feats=feats):
            return launch_anomaly_score(model, ids, feats,
                                        outputs=("logit", "d2"))

        got, again = full(), full()
        ds = (got["score"] - score_packets_plain(model, ids, feats)).abs()
        dl = (got["logit"] - forward_plain(model, ids, feats)).abs()
        rec = {"rows": int(ids.shape[0]), "ms": cs.device_ms(fn, REPS),
               "ms_logit_d2": cs.device_ms(full, REPS),
               "out": digest(got["d2"]),
               "scores": digest(got["score"], got["logit"]),
               "repeat_equal": all(torch.equal(got[k], again[k])
                                   for k in got),
               "d2_plain_equal": bool(torch.equal(
                   got["d2"], novelty_d2_plain(model, feats))),
               "score_err": float(ds.max().item()),
               "score_identical": float((ds == 0).float().mean().item()),
               "logit_err": float(dl.max().item()),
               "logit_identical": float((dl == 0).float().mean().item()),
               "ops_a_call": ops_a_call(lambda f=fn: f),
               "by_kernel": profiled(fn)}
        recs[name] = rec
        print(f"[{label}] K19 {name}: {rec['ms']:.4f} ms (events); "
              + ", ".join(f"{k}={v}" for k, v in rec.items()
                          if k not in ("ms", "by_kernel")))
        print(f"[{label}]   " + ", ".join(
            f"{k[:40]} {v['ms']:.4f}x{v['calls']:.0f}"
            for k, v in rec["by_kernel"].items()))
    return recs


def adam_cases(world, rng) -> dict:
    """K22 at the trainer's leaves (``chip_smoke.train_model``, V =
    16384) and gradients (the plain backward of ``chip_smoke
    .train_inputs``, d_embed summed in K21's order so that every process
    gets the same bits), after three plain steps from zero moments:
    {case: (params, grads, mu, nu, count before the call)}; the count 3
    and, for the saturation, INT_MAX - 1."""
    import chip_smoke as cs
    import torch
    from cilium_tpu_torch.ml.model import (embed_grad_sorted_plain,
                                           train_backward_plain,
                                           train_forward_plain)
    from cilium_tpu_torch.ml.train import adam_update_plain

    ids, feats, labels = cs.train_inputs(torch, rng, world)
    leaves = cs.train_model(torch, world).leaves()
    _loss, saved = train_forward_plain(leaves, ids, feats, labels)
    gloss = torch.ones(1, device="cuda")
    grads = list(train_backward_plain(leaves, saved, ids, labels, gloss))
    grads[0] = embed_grad_sorted_plain(leaves, saved, ids, labels, gloss)
    params = [t.clone() for t in leaves]
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    count = torch.zeros((), dtype=torch.int32, device="cuda")
    for _ in range(3):
        adam_update_plain(params, grads, mu, nu, count, cs.TRAIN_LR)
    return {"k22_count3": (params, grads, mu, nu, 3),
            "k22_saturate": (params, grads, mu, nu, INT_MAX - 1)}


def run_k22(label, cases) -> dict:
    """Time each K22 case (in place, as the trainer calls it, and on
    fresh copies of the state), digest params, mu, nu and count after
    one and after two calls, and hold them against the plain version's
    and a second run's; -> {case: record}."""
    import functools

    import chip_smoke as cs
    import torch
    from cilium_tpu_torch.kernels import launch_adam_update
    from cilium_tpu_torch.ml.train import adam_update_plain
    from cilium_tpu_torch.testing.capture import ops_a_call

    recs = {}
    for name, (params, grads, mu, nu, c0) in cases.items():
        def fresh(params=params, mu=mu, nu=nu, c0=c0):
            return ([t.clone() for t in params], [t.clone() for t in mu],
                    [t.clone() for t in nu],
                    torch.full((), c0, dtype=torch.int32, device="cuda"))

        def fn(st, grads=grads):
            launch_adam_update(st[0], grads, st[1], st[2], st[3],
                               cs.TRAIN_LR)

        def plain(st, grads=grads):
            adam_update_plain(st[0], grads, st[1], st[2], st[3],
                              cs.TRAIN_LR)

        def two(call):
            st, ds, counts = fresh(), [], []
            for _ in range(2):
                call(st)
                ds.append(digest(*st[0], *st[1], *st[2], st[3]))
                counts.append(int(st[3].item()))
            return ds, counts

        got, counts = two(fn)
        again, _ = two(fn)
        want, want_counts = two(plain)
        inplace = fresh()
        rec = {"elements": sum(t.numel() for t in params),
               "inputs": digest(*params, *grads, *mu, *nu),
               "ms": cs.device_ms(lambda: fn(inplace), REPS),
               "ms_fresh": cs.device_ms(fn, REPS, fresh),
               "out": "".join(got), "counts": counts,
               "plain_equal": got == want and counts == want_counts,
               "repeat_equal": got == again,
               "ops_a_call": ops_a_call(
                   lambda: functools.partial(fn, fresh())),
               "by_kernel": profiled(lambda: fn(inplace))}
        recs[name] = rec
        print(f"[{label}] K22 {name}: {rec['ms']:.4f} ms in place, "
              f"{rec['ms_fresh']:.4f} on fresh copies (events); "
              + ", ".join(f"{k}={v}" for k, v in rec.items()
                          if k not in ("ms", "ms_fresh", "by_kernel",
                                       "inputs")))
        print(f"[{label}]   " + ", ".join(
            f"{k[:40]} {v['ms']:.4f}x{v['calls']:.0f}"
            for k, v in rec["by_kernel"].items()))
    return recs


def ring_cases(world, rng) -> dict:
    """K5 and K5s on K1's out rows of served packed batches (config #3,
    a 2^20 CT): the daemon's 2^16 bucket and the slice's 2^18 batch, each
    a steady batch drawn from a flow pool served first as SYNs; the
    2^16 SYN batch (every row a new flow, so every row kept) into a
    ring of 2^15 (newest-wins overflow); the 2^16 steady batch with the
    cursor's low word 256 short of 2^32; and a 2^18 bucket routed into 8
    shards of 2^16 (headroom 2) through K1s/K4s.  -> {case: (out rows,
    valid or None, shards or None, ring capacity a shard, cursor)}."""
    import chip_smoke as cs
    import torch
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import pack_eligibility, pack_rows
    from cilium_tpu_torch.datapath.verdict import datapath_step_packed
    from cilium_tpu_torch.parallel import mesh as pm
    from cilium_tpu_torch.parallel import route_by_flow
    from cilium_tpu_torch.testing import fixtures as fx

    def served(n):  # -> out rows of the SYN batch, of the steady batch
        st = cs.card_state(world)
        pool = fx.steady_flow_pool(world, n, rng)
        outs = []
        for b, hdr in enumerate((pool, fx.steady_traffic(pool, n, rng))):
            out, _ = datapath_step_packed(
                st, u32.from_numpy(pack_rows(hdr), "cuda"), NOW + b, 0, 0)
            outs.append(out)
        return outs

    syn16, steady16 = served(1 << 16)
    _syn18, steady18 = served(1 << 18)
    cases = {"k5_daemon_65536": (steady16, None, None, RING_CAP, (0, 0)),
             "k5_slice_262144": (steady18, None, None, RING_CAP, (0, 0)),
             "k5_overflow_65536_cap32768": (syn16, None, None, 1 << 15,
                                            (0, 0)),
             "k5_carry_65536": (steady16, None, None, RING_CAP,
                                (0xFFFFFF00, 7))}
    n = 1 << 18
    st = cs.card_state(world)
    pool = fx.steady_flow_pool(world, n, rng)
    for b, hdr in enumerate((pool, fx.steady_traffic(pool, n, rng))):
        routed, valid, _o, _ovf = route_by_flow(hdr, SHARDS,
                                                HEADROOM * n // SHARDS)
        ok, ep, dirn = pack_eligibility(hdr)
        valid = torch.from_numpy(valid).cuda()
        out = pm.sharded_serve_launch(
            st, None, u32.from_numpy(pack_rows(routed), "cuda"), NOW + b, b,
            SHARDS, valid=valid, ep=ep, dirn=dirn)
    cases[f"k5s_{SHARDS}x65536"] = (out, valid, SHARDS, RING_CAP, (0, 0))
    return cases


def run_k5(label, cases) -> dict:
    """Time each K5/K5s case on fresh rings, digest the ring's buffer
    and cursors after one call and hold them against the plain version's
    and a second run's; -> {case: record}."""
    import functools

    import chip_smoke as cs
    import numpy as np
    import torch
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.kernels import launch_ring_append
    from cilium_tpu_torch.monitor import ring as rg
    from cilium_tpu_torch.parallel import mesh as pm
    from cilium_tpu_torch.testing.capture import ops_a_call

    pp = u32.from_numpy(np.array(LISTENERS, np.uint32), "cuda")
    recs = {}
    for name, (out, valid, shards, cap, cursor) in cases.items():
        s = shards or 1

        def fresh(cap=cap, cursor=cursor, s=s):
            r = (pm.make_sharded_ring(pm.make_mesh(s), cap) if s > 1
                 else rg.EventRing.create(cap, "cuda"))
            r.cursor.copy_(u32.from_numpy(
                np.tile(np.array(cursor, np.uint32), (s, 1)).reshape(
                    r.cursor.shape), "cuda"))
            return r

        def fn(r, out=out, valid=valid, shards=shards):
            launch_ring_append(r, out, 7, 1024, valid, pp, n_shards=shards)

        def plain(r, out=out, valid=valid, shards=shards):
            if shards:
                pm.sharded_ring_append_plain(r, out, 7, shards, 1024, valid,
                                             pp)
            else:
                rg.ring_append_plain(r, out, 7, 1024, valid, pp)

        def one(call):
            r = fresh()
            call(r)
            return r, digest(r.buf, r.cursor)

        r, got = one(fn)
        _r2, again = one(fn)
        _r3, want = one(plain)
        before = rg._cursor_totals(np.tile(np.array(cursor, np.uint32),
                                           (s, 1)))
        kept = rg._cursor_totals(u32.to_numpy(r.cursor).reshape(s, 2)) \
            - before
        rec = {"rows": int(out.shape[0]), "shards": s, "capacity": cap,
               "inputs": digest(out, *(() if valid is None else (valid,))),
               "kept": [int(k) for k in kept],
               "ms": cs.device_ms(fn, REPS, fresh), "out": got,
               "plain_equal": got == want, "repeat_equal": got == again,
               "ops_a_call": ops_a_call(
                   lambda: functools.partial(fn, fresh())),
               "by_kernel": profiled(fn, fresh)}
        recs[name] = rec
        print(f"[{label}] K5 {name}: {rec['ms']:.4f} ms (events); "
              + ", ".join(f"{k}={v}" for k, v in rec.items()
                          if k not in ("ms", "by_kernel", "inputs")))
        print(f"[{label}]   " + ", ".join(
            f"{k[:40]} {v['ms']:.4f}x{v['calls']:.0f}"
            for k, v in rec["by_kernel"].items()))
    return recs


def lb_cases(world, rng):
    """K17's inputs at phase 3's and phase 12's shapes: the service world
    of ``chip_smoke.service_world`` (4096 v4 frontends, Maglev tables of
    16381 slots) and ``testing.services.socklb_steps`` threaded through
    the tree's K17 on the daemon's default 2^16-slot cache: the last of
    4 connect batches (8192 new flows, every row a miss), the steady
    batch (2^16 rows, every flow cached), the burst (2^16 new flows, over
    CONNECT_CAP: resolved, nothing cached), the overflow batch (one row
    whose window holds more fingerprint matches than the probe reads:
    every row takes the full-window probe) and the mixed batch (2^16
    rows, 4096 of them new flows: phase 12's shape).  -> (LB tensors,
    {case: (cache before the call, rows, now)})."""
    import dataclasses

    import chip_smoke as cs
    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.k8s.watchers import ServiceWatcher
    from cilium_tpu_torch.service import ServiceManager
    from cilium_tpu_torch.service import socklb as sl
    from cilium_tpu_torch.testing import services as sv

    mgr = ServiceManager(device="cuda")
    sv.install(ServiceWatcher(mgr), cs.service_world(world))
    t = mgr.tensors()
    clients = (0x0A000000 + rng.choice(1 << 16, cs.N_LB_CLIENTS,
                                       replace=False)).astype(np.uint32)
    others = np.array([int(ipaddress.IPv4Address(ip))
                       for ip in world.pod_ips[:2048]], np.uint32)
    tbl = sl.SockLBTable.create(1 << 16, device="cuda")
    names = {"connect": "k17_connect_8192", "steady": "k17_steady_65536",
             "burst": "k17_burst_65536", "overflow": "k17_overflow_65536",
             "backend-change": "k17_mixed_65536"}
    cases = {}
    for label, rows, now, ovf in sv.socklb_steps(
            rng, cs.N_SERVICES, clients, others, cs.LB_N,
            connect=sl.CONNECT_CAP, n_connect=4, n_v6=cs.N_V6_SERVICES):
        if label not in names and label != "connect":
            break
        if ovf >= 0:
            tbl.fp.copy_(u32.from_numpy(
                sv.force_overflow(u32.to_numpy(tbl.fp), rows[ovf]), "cuda"))
        hdr = u32.from_numpy(rows, "cuda")
        # copies share the table's other fields (its claim words, where
        # the tree keeps them)
        cases[names[label]] = (dataclasses.replace(
            tbl, table=tbl.table.clone(), fp=tbl.fp.clone(),
            aff=tbl.aff.clone()), hdr, now)
        sl.socklb_stage(tbl, t, hdr, now)
    return t, cases


def claims_free(tbl, names) -> Optional[bool]:
    """Whether every claim word the table keeps (``names``) is free
    (None for a tree whose tables keep none)."""
    from cilium_tpu_torch.service.nat import CLAIM_FREE

    words = [getattr(tbl, n, None) for n in names]
    if any(w is None for w in words):
        return None
    return all(bool((w == CLAIM_FREE).all()) for w in words)


def scratch_counts(launcher, *args) -> tuple:
    """The kernel's step counts of one call and the ns each of its phases
    took (``scratch=``), where the tree's launcher hands them back."""
    import inspect

    if "scratch" not in inspect.signature(launcher).parameters:
        return None, None
    sc = {}
    launcher(*args, scratch=sc)
    return sc["counts"].cpu().tolist(), sc["phase_ns"]()


def run_k17(label, t, cases) -> dict:
    """Time each K17 case on fresh copies of its cache, split it by the
    profiler, digest the rows, masks, flow table, fingerprints and pins
    after one call and hold them against the plain version's and a
    second call's; -> {case: record}."""
    import dataclasses
    import functools

    import chip_smoke as cs
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.kernels import launch_socklb_stage
    from cilium_tpu_torch.service import socklb as sl
    from cilium_tpu_torch.testing.capture import ops_a_call

    recs = {}
    for name, (base, hdr, now) in cases.items():
        def fresh(base=base):
            return dataclasses.replace(base, table=base.table.clone(),
                                       fp=base.fp.clone(),
                                       aff=base.aff.clone())

        def fn(tb, hdr=hdr, now=now):
            return launch_socklb_stage(tb, t, hdr, now)

        def one(call):
            tb = fresh()
            got = call(tb, t, hdr, now)
            return tb, digest(*got[:3], tb.table, tb.fp, tb.aff)

        tb, got = one(sl.socklb_stage)
        _t2, again = one(sl.socklb_stage)
        _t3, want = one(sl.socklb_stage_plain)
        rec = {"rows": int(hdr.shape[0]),
               "misses": cs.socklb_misses(base, u32.to_numpy(hdr), now),
               "inputs": digest(hdr, base.table, base.fp, base.aff),
               "ms": cs.device_ms(fn, REPS, fresh), "out": got,
               "plain_equal": got == want, "repeat_equal": got == again,
               "claims_free": claims_free(tb, ("claim", "aclaim")),
               "ops_a_call": ops_a_call(
                   lambda: functools.partial(fn, fresh())),
               "by_kernel": profiled(fn, fresh)}
        rec["counts"], rec["phase_ns"] = scratch_counts(
            launch_socklb_stage, fresh(), t, hdr, now)
        recs[name] = rec
        print(f"[{label}] K17 {name}: {rec['ms']:.4f} ms (events); "
              + ", ".join(f"{k}={v}" for k, v in rec.items()
                          if k not in ("ms", "by_kernel", "inputs")))
        print(f"[{label}]   " + ", ".join(
            f"{k[:40]} {v['ms']:.4f}x{v['calls']:.0f}"
            for k, v in rec["by_kernel"].items()))
    return recs


def nat_cases(world, rng) -> dict:
    """K11's inputs: phase 11's main path (``chip_smoke.egress_daemon``
    driven through ``process_batch`` for its 8 batches of 2^16 rows,
    then the next batch against the live pool of 2^14 slots, the live
    CT and the daemon's compiled gateway table); phase 3's case
    (``chip_smoke.nat_case``: 2^16 rows, a 2^20 CT holding 8192 inbound
    connections, 256 gateway rules, the pool after one batch); and the
    same rows into a pool of 2^10 slots that one batch runs dry (every
    claim step used, the failures counted).  -> {case: (NAT table
    before, NAT tensors, CT, rows, now)}."""
    import dataclasses

    import chip_smoke as cs
    import numpy as np
    import torch
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import N_COLS
    from cilium_tpu_torch.service import nat
    from cilium_tpu_torch.testing import egress as eg

    def copy(tbl):
        return dataclasses.replace(tbl, table=tbl.table.clone(),
                                   failed=tbl.failed.clone())

    cases = {}
    d, clients, _rates = cs.egress_daemon(world, rng)
    flows, prev, now = np.zeros((0, N_COLS), np.uint32), None, 100
    for b in range(cs.EGRESS_BATCHES):
        rows, new, _want = cs.egress_batch(rng, clients, flows, b, prev)
        prev = (rows, d.process_batch(rows, now=now))
        flows = new
        now += 60
    rows, _new, _want = cs.egress_batch(rng, clients, flows,
                                        cs.EGRESS_BATCHES, prev)
    cases["k11_main_65536"] = (copy(d.loader.nat_state), d.nat,
                               d.loader.state.ct,
                               u32.from_numpy(rows, "cuda"), now)
    t, cti, rows, pods = cs.nat_case(torch, rng, 1000)
    tbl = nat.NATTable.create(cs.NAT_POOL, "cuda")
    nat.snat_egress(tbl, t, cti, u32.from_numpy(rows, "cuda"), 1000)
    rows = np.concatenate([rows[::2], eg.egress_rows(
        rng, len(rows) - len(rows[::2]), pods, sports=16384)])
    hdr = u32.from_numpy(rows, "cuda")
    cases["k11_phase3_65536"] = (copy(tbl), t, cti, hdr, 1090)
    cases["k11_exhaust_65536_pool1024"] = (
        nat.NATTable.create(1 << 10, "cuda"), t, cti, hdr, 1090)
    return cases


def run_k11(label, cases) -> dict:
    """Time each K11 case on fresh copies of its pool, split it by the
    profiler, digest the rows, drop mask, table and ``failed`` after one
    call and hold them against the plain version's and a second call's;
    then K12 on replies to that call's rows against the pool it left
    (digested and held the same way).  -> {case: record}."""
    import dataclasses
    import functools

    import chip_smoke as cs
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.kernels import launch_snat_egress
    from cilium_tpu_torch.service import nat
    from cilium_tpu_torch.testing import egress as eg
    from cilium_tpu_torch.testing.capture import ops_a_call
    import numpy as np

    recs = {}
    rng = np.random.default_rng(SEED + 12)
    for name, (base, t, cti, hdr, now) in cases.items():
        def fresh(base=base):
            return dataclasses.replace(base, table=base.table.clone(),
                                       failed=base.failed.clone())

        def fn(tb, t=t, cti=cti, hdr=hdr, now=now):
            return launch_snat_egress(tb, t, cti, hdr, now)

        def one(call):
            tb = fresh()
            got = call(tb, t, cti, hdr, now)
            return tb, got, digest(got[0], got[2], tb.table, tb.failed)

        tb, res, got = one(nat.snat_egress)
        _t2, _r2, again = one(nat.snat_egress)
        _t3, _r3, want = one(nat.snat_egress_plain)
        rec = {"rows": int(hdr.shape[0]),
               "inputs": digest(hdr, base.table, base.failed),
               "ms": cs.device_ms(fn, REPS, fresh), "out": got,
               "plain_equal": got == want, "repeat_equal": got == again,
               "dropped": int(res[2].sum()),
               "claims_free": claims_free(tb, ("claim",)),
               "ops_a_call": ops_a_call(
                   lambda: functools.partial(fn, fresh())),
               "by_kernel": profiled(fn, fresh)}
        rec["counts"], rec["phase_ns"] = scratch_counts(
            launch_snat_egress, fresh(), t, cti, hdr, now)
        # K12 on replies to the rows K11 rewrote, against its pool
        rep = u32.from_numpy(eg.reply_rows(rng, u32.to_numpy(res[0]),
                                           int(hdr.shape[0])), "cuda")

        def after(tb=tb):
            return dataclasses.replace(tb, table=tb.table.clone(),
                                       failed=tb.failed.clone())

        def rev(tb2, t=t, rep=rep, now=now):
            return nat.snat_reverse(tb2, t, rep, now + 1)

        k12 = {}
        for what, call in (("out", nat.snat_reverse),
                           ("again", nat.snat_reverse),
                           ("want", nat.snat_reverse_plain)):
            tb2 = after()
            k12[what] = digest(call(tb2, t, rep, now + 1)[0], tb2.table)
            if what == "out":
                k12["claims_free"] = claims_free(tb2, ("claim",))
        rec["k12"] = {"out": k12["out"],
                      "plain_equal": k12["out"] == k12["want"],
                      "repeat_equal": k12["out"] == k12["again"],
                      "claims_free": k12["claims_free"],
                      "ms": cs.device_ms(rev, REPS, after),
                      "ops_a_call": ops_a_call(
                          lambda: functools.partial(rev, after())),
                      "by_kernel": profiled(rev, after)}
        recs[name] = rec
        print(f"[{label}] K11 {name}: {rec['ms']:.4f} ms (events); "
              + ", ".join(f"{k}={v}" for k, v in rec.items()
                          if k not in ("ms", "by_kernel", "inputs", "k12")))
        print(f"[{label}]   " + ", ".join(
            f"{k[:40]} {v['ms']:.4f}x{v['calls']:.0f}"
            for k, v in rec["by_kernel"].items()))
        print(f"[{label}] K12 after {name}: {rec['k12']['ms']:.4f} ms "
              f"(events); " + ", ".join(
                  f"{k}={v}" for k, v in rec["k12"].items()
                  if k not in ("ms", "by_kernel")))
    return recs


def k17_lb_calls(t, cases) -> dict:
    """{case: (call, fresh, digest of a call's outputs, phase ns of a
    call)} for K17."""
    import dataclasses

    from cilium_tpu_torch.kernels import launch_socklb_stage

    calls = {}
    for name, (base, hdr, now) in cases.items():
        def fresh(base=base):
            return dataclasses.replace(base, table=base.table.clone(),
                                       fp=base.fp.clone(),
                                       aff=base.aff.clone())

        def call(tb, hdr=hdr, now=now):
            return launch_socklb_stage(tb, t, hdr, now)

        def out(fresh=fresh, call=call):
            tb = fresh()
            got = call(tb)
            return digest(*got[:3], tb.table, tb.fp, tb.aff)

        def phases(fresh=fresh, hdr=hdr, now=now):
            return scratch_counts(launch_socklb_stage, fresh(), t, hdr,
                                  now)[1]

        calls[name] = (call, fresh, out, phases)
    return calls


def k11_nat_calls(cases) -> dict:
    """{case: (call, fresh, digest of a call's outputs, phase ns of a
    call)} for K11."""
    import dataclasses

    from cilium_tpu_torch.kernels import launch_snat_egress

    calls = {}
    for name, (base, t, cti, hdr, now) in cases.items():
        def fresh(base=base):
            return dataclasses.replace(base, table=base.table.clone(),
                                       failed=base.failed.clone())

        def call(tb, t=t, cti=cti, hdr=hdr, now=now):
            return launch_snat_egress(tb, t, cti, hdr, now)

        def out(fresh=fresh, call=call):
            tb = fresh()
            got = call(tb)
            return digest(got[0], got[2], tb.table, tb.failed)

        def phases(fresh=fresh, t=t, cti=cti, hdr=hdr, now=now):
            return scratch_counts(launch_snat_egress, fresh(), t, cti, hdr,
                                  now)[1]

        calls[name] = (call, fresh, out, phases)
    return calls


def copy_bw(state):
    """A copy of a bandwidth state (every tensor field cloned)."""
    import dataclasses

    import torch

    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)})


def copy_nat(tbl):
    """A copy of a NAT table with claim words of its own."""
    from cilium_tpu_torch.service import nat

    return nat.NATTable(tbl.table.clone(), tbl.failed.clone())


def stage_inputs(d, rows, now) -> tuple:
    """The inputs K13 (``Daemon._bw_police``), K16 (``lb6_stage``) and
    K12 (``TorchLoader.reverse_nat``) take in one ``d.process_batch(rows,
    now)``: ((bandwidth state before, rows, now, rates) or None, (v6 LB
    tensors, rows) or None, (NAT table before, NAT tensors, rows, now)
    or None)."""
    import cilium_tpu_torch.service as svc

    got13, got16, got12 = [], [], []
    police, lb6, rev = d._bw_police, svc.lb6_stage, d.loader.reverse_nat

    def spy13(hdr, now):
        got13.append((copy_bw(d._bw), hdr.clone(), now, d._bw_rates))
        return police(hdr, now)

    def spy16(t, hdr):
        got16.append((t, hdr.clone()))
        return lb6(t, hdr)

    def spy12(t, hdr, now):
        got12.append((copy_nat(d.loader._nat_table()), t,
                      d.loader._to_device(hdr).clone(), now))
        return rev(t, hdr, now)

    d._bw_police, svc.lb6_stage, d.loader.reverse_nat = spy13, spy16, spy12
    try:
        d.process_batch(rows, now=now)
    finally:
        d._bw_police, svc.lb6_stage, d.loader.reverse_nat = police, lb6, rev
    return tuple(g[0] if g else None for g in (got13, got16, got12))


def bw_lb_cases(world, rng, v6_world=True) -> tuple:
    """K13's and K16's inputs.  K13: phase 3's case (2^16 rows of
    ``testing.egress.bw_rows`` over 257 endpoints, 65 limited, the
    buckets threaded through clocks 10, 10, 11, 4000, 2^32 - 1, 3, then
    the batch at 5); every row an egress row of one limited endpoint;
    n = 0 and n = 1; phase 11's main path (``chip_smoke.egress_daemon``
    through its 8 batches, then the next batch, as SNAT leaves it); and
    phase 12's (that daemon with phase 3's service world, a warm-up of
    4096 new flows and two batches of 2^16 rows, 4096 of them new flows
    of phase 12's mix, then the next such batch after the LB and SNAT
    stages).  K16: phase 3's case (2^16 rows, half v6, to the 256 v6
    frontends); phase 12's batch; 2^16 rows with no v6 row; 2^16 v6 rows
    to the VIPs on a port or protocol no frontend has; and 2^16 rows,
    half v6, against a world of 4096 v6 frontends (left out unless
    ``v6_world``).  K12: the egress and service paths' own inputs (the
    rows ``TorchLoader.reverse_nat`` takes in those next batches).  ->
    ({K13 case: (state before, rows, now, rates)}, {K16 case: (LB
    tensors, rows)}, {K12 case: (NAT table before, NAT tensors, rows,
    now)})."""
    import chip_smoke as cs
    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import (COL_DIR, COL_DPORT,
                                               COL_PROTO, COL_SPORT, N_COLS)
    from cilium_tpu_torch.datapath import bandwidth as bw
    from cilium_tpu_torch.k8s.watchers import ServiceWatcher
    from cilium_tpu_torch.service import ServiceManager
    from cilium_tpu_torch.testing import egress as eg
    from cilium_tpu_torch.testing import services as sv

    def dev(a):
        return u32.from_numpy(np.ascontiguousarray(a), "cuda")

    k13, k16, k12 = {}, {}, {}
    eps = list(range(1, 257)) + [5000]
    limits = {e: int(x) for e, x in zip(
        range(1, 65), rng.integers(100_000, 2_000_000, 64))}
    limits[2] = 0x7FFFFFFF
    rates = dev(bw.rates_array(limits))
    state = bw.BandwidthState.create("cuda")
    for now in (10, 10, 11, 4000, (1 << 32) - 1, 3):
        hdr = dev(eg.bw_rows(rng, cs.EGRESS_N, eps))
        bw.bw_stage(state, hdr, now, rates)
    k13["k13_phase3_65536"] = (copy_bw(state), hdr, 5, rates)
    one = eg.bw_rows(rng, cs.EGRESS_N, [1])
    one[:, COL_DIR] = 1
    k13["k13_one_endpoint_65536"] = (copy_bw(state), dev(one), 6, rates)
    k13["k13_n0"] = (copy_bw(state), dev(np.zeros((0, N_COLS), np.uint32)),
                     7, rates)
    k13["k13_n1"] = (copy_bw(state), dev(one[:1]), 7, rates)

    # phase 11's main path
    d, clients, _rates = cs.egress_daemon(world, rng)
    flows, prev, now = np.zeros((0, N_COLS), np.uint32), None, 100
    for b in range(cs.EGRESS_BATCHES):
        rows, new, _want = cs.egress_batch(rng, clients, flows, b, prev)
        prev = (rows, d.process_batch(rows, now=now))
        flows = new
        now += 60
    rows, _new, _want = cs.egress_batch(rng, clients, flows,
                                        cs.EGRESS_BATCHES, prev)
    k13["k13_egress_65536"], _k16, k12["k12_egress_65536"] = stage_inputs(
        d, rows, now)
    d.shutdown()

    # phase 3's service world, and phase 12's daemon over it
    mgr = ServiceManager(device="cuda")
    sv.install(ServiceWatcher(mgr), cs.service_world(world))
    t6 = mgr.tensors6()
    lb_clients = (0x0A000000 + rng.choice(1 << 16, cs.N_LB_CLIENTS,
                                          replace=False)).astype(np.uint32)
    lb_others = np.array([int(ipaddress.IPv4Address(ip))
                          for ip in world.pod_ips[:2048]], np.uint32)
    rows = sv.rows(rng, cs.LB_N, cs.N_SERVICES, lb_clients, lb_others,
                   vip_frac=0.0, v6_frac=0.5, n_v6=cs.N_V6_SERVICES)
    rows[::5, 3] |= 0x80000000
    k16["k16_phase3_65536"] = (t6, dev(rows))
    k16["k16_no_v6_65536"] = (t6, dev(sv.rows(
        rng, cs.LB_N, cs.N_SERVICES, lb_clients, lb_others, vip_frac=0.5)))
    miss = sv.rows(rng, cs.LB_N, cs.N_SERVICES, lb_clients, lb_others,
                   vip_frac=0.0, v6_frac=1.0, n_v6=cs.N_V6_SERVICES)
    miss[::2, COL_DPORT] = 8443
    miss[1::2, COL_PROTO] = 132
    k16["k16_no_match_65536"] = (t6, dev(miss))

    d, clients, _rates = cs.egress_daemon(world, rng)
    d.services = mgr
    sv.install(ServiceWatcher(mgr, node_ip=eg.NODE_IP),
               cs.service_world(world))
    ips = np.array([eg.ip(c.ips[0]) for c in clients], np.uint32)
    ids = np.array([c.id for c in clients], np.uint32)
    others = np.array([eg.ip(p) for p in world.pod_ips[:4096]], np.uint32)
    sport = [0]

    def fresh(k):
        r = sv.rows(rng, k, cs.N_SERVICES, ips, others, vip_frac=0.5,
                    v6_frac=0.1, n_v6=cs.N_V6_SERVICES, dup_frac=0.0,
                    ep_ids=ids)
        r[:, COL_SPORT] = 1024 + (sport[0] + np.arange(k)) % 64000
        sport[0] += k
        return r

    pool = fresh(cs.SVC_FRESH)
    now = 1000
    d.process_batch(pool, now=now)
    for b in range(3):
        new = fresh(cs.SVC_FRESH)
        rows = np.concatenate([new, pool[rng.integers(
            0, len(pool), cs.LB_N - len(new))]])[rng.permutation(cs.LB_N)]
        now += 10
        if b == 2:
            (k13["k13_service_65536"], k16["k16_service_65536"],
             k12["k12_service_65536"]) = stage_inputs(d, rows, now)
        else:
            d.process_batch(rows, now=now)
        pool = np.concatenate([pool, new])
    d.shutdown()
    if not v6_world:
        return k13, k16, k12

    # 4096 v6 frontends: every service of the world dual-stack
    sv.install(ServiceWatcher(mgr), sv.k8s_objects(
        world.pod_ips, world.pod_ips6, n=cs.N_SERVICES,
        n_v6=cs.N_SERVICES))
    k16["k16_v6_frontends_4096"] = (mgr.tensors6(), dev(sv.rows(
        rng, cs.LB_N, cs.N_SERVICES, lb_clients, lb_others,
        vip_frac=0.0, v6_frac=0.5, n_v6=cs.N_SERVICES)))
    return k13, k16, k12


def run_k13(label, cases) -> dict:
    """Time each K13 case on fresh copies of its buckets, split it by the
    profiler, digest the reasons, tokens and last after one call and hold
    them against the plain version's and a second call's; where the
    tree's launcher hands back its sums (``scratch=``), whether they are
    zero after the call, and its phase times.  -> {case: record}."""
    import functools

    import chip_smoke as cs
    import inspect
    import torch
    from cilium_tpu_torch.datapath import bandwidth as bw
    from cilium_tpu_torch.kernels import launch_bw_stage
    from cilium_tpu_torch.testing.capture import ops_a_call

    has_scratch = "scratch" in inspect.signature(launch_bw_stage).parameters
    recs = {}
    for name, (base, hdr, now, rates) in cases.items():
        def fresh(base=base):
            return copy_bw(base)

        def fn(st, hdr=hdr, now=now, rates=rates):
            return launch_bw_stage(st, hdr, now, rates)

        def one(call):
            st = fresh()
            got = call(st, hdr, now, rates)
            return digest(got, st.tokens, st.last)

        got, again, want = (one(bw.bw_stage), one(bw.bw_stage),
                            one(bw.bw_stage_plain))
        st = fresh()
        reasons = bw.bw_stage(st, hdr, now, rates)
        rec = {"rows": int(hdr.shape[0]),
               "dropped": int((reasons != 0).sum()),
               "inputs": digest(hdr, base.tokens, base.last, rates),
               "ms": cs.device_ms(fn, REPS, fresh), "out": got,
               "plain_equal": got == want, "repeat_equal": got == again,
               "ops_a_call": ops_a_call(
                   lambda: functools.partial(fn, fresh())),
               "by_kernel": profiled(fn, fresh)}
        if has_scratch:
            sc = {}
            launch_bw_stage(fresh(), hdr, now, rates, scratch=sc)
            torch.cuda.synchronize()
            rec["sums_zero"] = bool((sc["sums"] == 0).all())
            rec["phase_ns"] = sc["phase_ns"]()
        recs[name] = rec
        print(f"[{label}] K13 {name}: {rec['ms']:.4f} ms (events); "
              + ", ".join(f"{k}={v}" for k, v in rec.items()
                          if k not in ("ms", "by_kernel", "inputs")))
        print(f"[{label}]   " + ", ".join(
            f"{k[:40]} {v['ms']:.4f}x{v['calls']:.0f}"
            for k, v in rec["by_kernel"].items()))
    return recs


def run_k16(label, cases) -> dict:
    """Time each K16 case, split it by the profiler, digest its rows and
    both masks and hold them against the plain version's and a second
    call's.  -> {case: record}."""
    import functools

    import chip_smoke as cs
    from cilium_tpu_torch.core.packets import COL_FAMILY
    from cilium_tpu_torch.kernels import launch_lb6_stage
    from cilium_tpu_torch.service import lb6_stage, lb6_stage_plain
    from cilium_tpu_torch.testing.capture import ops_a_call

    recs = {}
    for name, (t, hdr) in cases.items():
        def fn(t=t, hdr=hdr):
            return launch_lb6_stage(t, hdr)

        got = lb6_stage(t, hdr)
        out = digest(*got)
        rec = {"rows": int(hdr.shape[0]),
               "v6_rows": int((hdr[:, COL_FAMILY] == 6).sum()),
               "frontends": int(t.svc_port.shape[0]),
               "have_backend": int(got[1].sum()),
               "no_backend": int(got[2].sum()),
               "inputs": digest(hdr, t.svc_ip, t.svc_port, t.svc_proto),
               "ms": cs.device_ms(fn, REPS), "out": out,
               "plain_equal": out == digest(*lb6_stage_plain(t, hdr)),
               "repeat_equal": out == digest(*lb6_stage(t, hdr)),
               "ops_a_call": ops_a_call(lambda: fn),
               "by_kernel": profiled(fn)}
        recs[name] = rec
        print(f"[{label}] K16 {name}: {rec['ms']:.4f} ms (events); "
              + ", ".join(f"{k}={v}" for k, v in rec.items()
                          if k not in ("ms", "by_kernel", "inputs")))
        print(f"[{label}]   " + ", ".join(
            f"{k[:40]} {v['ms']:.4f}x{v['calls']:.0f}"
            for k, v in rec["by_kernel"].items()))
    return recs


def k12_cases(rng) -> dict:
    """K12's inputs beside the paths' own (``bw_lb_cases``), on the pool
    phase 3 times it on (``chip_smoke.nat_case``: a batch at 1000, then
    the next at 1090, half of it repeats): that batch's replies
    (``testing.egress.reply_rows``: misses and forged protocol words
    mixed in); 2^16 replies to one TCP mapping (2^16 bids for one claim
    word); 2^16 replies to the TCP mappings of odd remote ports, half of
    them with the protocol word 6 | 0x100 and the remote port one lower,
    which alias the same slots with a non-TCP lifetime, in random order
    (the highest row's refresh must stand); 2^16 replies below the pool
    (no hit: the copy alone); one reply that hits.  -> {case: (NAT table
    before, NAT tensors, rows, now)}."""
    import chip_smoke as cs
    import numpy as np
    import torch
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import (COL_DPORT, COL_PROTO,
                                               COL_SPORT)
    from cilium_tpu_torch.service import nat
    from cilium_tpu_torch.testing import egress as eg

    t, cti, rows, pods = cs.nat_case(torch, rng, 1000)
    tbl = nat.NATTable.create(cs.NAT_POOL, "cuda")
    nat.snat_egress(tbl, t, cti, u32.from_numpy(rows, "cuda"), 1000)
    rows = np.concatenate([rows[::2], eg.egress_rows(
        rng, len(rows) - len(rows[::2]), pods, sports=16384)])
    out = u32.to_numpy(nat.snat_egress(tbl, t, cti, u32.from_numpy(
        rows, "cuda"), 1090)[0])
    now = 1090
    rep = eg.reply_rows(rng, out, cs.EGRESS_N)
    cases = {"k12_phase3_65536": (copy_nat(tbl), t, rep, now)}
    # the replies that hit, as the plain version finds them
    probe = copy_nat(tbl)
    hit = u32.to_numpy(nat.snat_reverse_plain(
        probe, t, u32.from_numpy(rep, "cuda"), now)[0]) != rep
    hit = hit.any(1)
    tcp = rep[hit & (rep[:, COL_PROTO] == 6)]
    cases["k12_one_slot_65536"] = (copy_nat(tbl), t, np.repeat(
        tcp[:1], cs.EGRESS_N, axis=0), now)
    odd = tcp[tcp[:, COL_SPORT] % 2 == 1]
    fr = odd[rng.integers(0, len(odd), cs.EGRESS_N)]
    forged = rng.random(cs.EGRESS_N) < 0.5
    fr[forged, COL_PROTO] = 6 | 0x100
    fr[forged, COL_SPORT] -= 1
    cases["k12_forged_65536"] = (copy_nat(tbl), t, fr, now)
    miss = rep.copy()
    miss[:, COL_DPORT] = 1000
    cases["k12_no_hit_65536"] = (copy_nat(tbl), t, miss, now)
    cases["k12_n1"] = (copy_nat(tbl), t, tcp[:1].copy(), now)
    return {k: (b, tt, u32.from_numpy(np.ascontiguousarray(r), "cuda"), n)
            for k, (b, tt, r, n) in cases.items()}


def run_k12(label, cases) -> dict:
    """Time each K12 case on fresh copies of its pool, split it by the
    profiler, digest the rows and table after one call and hold them
    against the plain version's and a second call's, with the claim
    words free after the call; where the tree's launcher hands them
    back, its phase times.  -> {case: record}."""
    import functools
    import inspect

    import chip_smoke as cs
    from cilium_tpu_torch.kernels import launch_snat_reverse
    from cilium_tpu_torch.service import nat
    from cilium_tpu_torch.testing.capture import ops_a_call

    has_scratch = "scratch" in inspect.signature(
        launch_snat_reverse).parameters
    recs = {}
    for name, (base, t, hdr, now) in cases.items():
        def fresh(base=base):
            return copy_nat(base)

        def fn(tb, t=t, hdr=hdr, now=now):
            return launch_snat_reverse(tb, t, hdr, now)

        def one(call):
            tb = fresh()
            got = call(tb, t, hdr, now)
            return tb, got, digest(got[0], tb.table)

        tb, res, got = one(nat.snat_reverse)
        _t2, _r2, again = one(nat.snat_reverse)
        _t3, _r3, want = one(nat.snat_reverse_plain)
        rec = {"rows": int(hdr.shape[0]),
               "hits": int((res[0] != hdr).any(1).sum()),
               "inputs": digest(hdr, base.table),
               "ms": cs.device_ms(fn, REPS, fresh), "out": got,
               "plain_equal": got == want, "repeat_equal": got == again,
               "claims_free": claims_free(tb, ("claim",)),
               "ops_a_call": ops_a_call(
                   lambda: functools.partial(fn, fresh())),
               "by_kernel": profiled(fn, fresh)}
        if has_scratch:
            sc = {}
            launch_snat_reverse(fresh(), t, hdr, now, scratch=sc)
            rec["phase_ns"] = sc["phase_ns"]()
        recs[name] = rec
        print(f"[{label}] K12 {name}: {rec['ms']:.4f} ms (events); "
              + ", ".join(f"{k}={v}" for k, v in rec.items()
                          if k not in ("ms", "by_kernel", "inputs")))
        print(f"[{label}]   " + ", ".join(
            f"{k[:40]} {v['ms']:.4f}x{v['calls']:.0f}"
            for k, v in rec["by_kernel"].items()))
    return recs


def k7_cases(world, rng) -> dict:
    """K7's inputs, each a 2^20 CT (``chip_smoke.CT_CAPACITY``): phase
    3's half-full table (``chip_smoke.half_full_table`` at now = 2^31 +
    1000, its live expiries drawn from the u32 edges around 2^31 and
    now, as ``phase_maint`` draws them); the daemon's own table at a
    sweep (config #3's steady flow pool of 2^18 flows, phase 7's, served
    through K1/K4 in 4 wide batches of 2^16, swept at the batches'
    clock: nothing has expired); an empty table (the daemon's first
    sweeps); every slot live, 10% expired; every slot live and expired
    (every row written back).  -> {case: (CT before, now)}."""
    import chip_smoke as cs
    import numpy as np
    import torch
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.datapath import conntrack as ct
    from cilium_tpu_torch.datapath.verdict import datapath_step
    from cilium_tpu_torch.testing import fixtures as fx

    def card(table, fp):
        return ct.CTTable(table=u32.from_numpy(table, "cuda"),
                          fp=u32.from_numpy(fp, "cuda"),
                          dropped=torch.zeros((), dtype=torch.int32,
                                              device="cuda"))

    cap = cs.CT_CAPACITY
    cases = {}
    now = (1 << 31) + 1000
    table, fp, _rows = cs.half_full_table(rng, now)
    live = table[:, ct.V_STATE] != ct.ST_FREE
    edges = np.array([(1 << 31) - 1, 1 << 31, (1 << 31) + 1, now - 1, now,
                      now + 1, 0xFFFFFFFF, 5, now + 100], np.uint32)
    table[live, ct.V_EXPIRES] = rng.choice(edges, int(live.sum()))
    cases["k7_phase3_half"] = (card(table, fp), now)

    st = cs.card_state(world)
    pool = fx.steady_flow_pool(world, 1 << 18, rng)
    for b in range(4):
        datapath_step(st, u32.from_numpy(
            pool[b << 16:(b + 1) << 16], "cuda"), NOW + b)
    cases["k7_daemon"] = (st.ct, NOW + 4)
    cases["k7_empty"] = (ct.CTTable.create(cap, "cuda"), now)

    full = np.zeros((cap, ct.ROW_WORDS), np.uint32)
    full[:, :ct.KEY_WORDS] = rng.integers(0, 1 << 32, (cap, ct.KEY_WORDS),
                                          dtype=np.uint64)
    full[:, ct.V_STATE] = rng.integers(1, 4, cap)
    full[:, ct.V_EXPIRES] = np.where(rng.random(cap) < 0.1, now - 5,
                                     now + 100)
    ffp = rng.integers(1, 256, cap).astype(np.uint32)
    cases["k7_full_10pct_expired"] = (card(full, ffp), now)
    full[:, ct.V_EXPIRES] = now - 5
    cases["k7_full_all_expired"] = (card(full, ffp), now)
    return cases


def run_k7(label, cases) -> dict:
    """Time each K7 case on fresh copies of its CT, split it by the
    profiler, digest the table, fingerprints and count after one call
    and hold them against the plain version's and a second call's.  ->
    {case: record}."""
    import functools

    import chip_smoke as cs
    from cilium_tpu_torch.datapath import conntrack as ct
    from cilium_tpu_torch.kernels import launch_ct_gc
    from cilium_tpu_torch.testing.capture import ops_a_call

    recs = {}
    for name, (base, now) in cases.items():
        def fresh(base=base):
            return ct.CTTable(base.table.clone(), base.fp.clone(),
                              base.dropped.clone())

        def fn(w, now=now):
            return launch_ct_gc(w, now)

        def one(call):
            w = fresh()
            n = call(w, now)
            return n, digest(n.reshape(-1).to(w.fp.dtype), w.table, w.fp)

        n, got = one(ct.ct_gc)
        _n2, again = one(ct.ct_gc)
        _n3, want = one(ct.ct_gc_plain)
        rec = {"slots": int(base.fp.shape[0]),
               "live": int((base.fp != 0).sum()), "evicted": int(n.sum()),
               "inputs": digest(base.table, base.fp),
               "ms": cs.device_ms(fn, REPS, fresh), "out": got,
               "plain_equal": got == want, "repeat_equal": got == again,
               "ops_a_call": ops_a_call(
                   lambda: functools.partial(fn, fresh())),
               "by_kernel": profiled(fn, fresh)}
        recs[name] = rec
        print(f"[{label}] K7 {name}: {rec['ms']:.4f} ms (events); "
              + ", ".join(f"{k}={v}" for k, v in rec.items()
                          if k not in ("ms", "by_kernel", "inputs")))
        print(f"[{label}]   " + ", ".join(
            f"{k[:40]} {v['ms']:.4f}x{v['calls']:.0f}"
            for k, v in rec["by_kernel"].items()))
    return recs


def k6_cases(rng) -> dict:
    """K6's inputs, each a ring of 2^18 slots a shard of random event
    words (``chip_smoke.random_ring_words``, as phase 7's ``time_gather``
    makes it): one shard at rung 2^18 from slot 0 (the daemon's window
    before its ring laps) and from an odd slot, so that the window
    wraps; one shard at rungs 64 and 4096 (the ladder's small rungs,
    ``monitor/ring.py`` ``GATHER_MIN_RUNG``), from slot 0 and from an odd
    slot that wraps; 8 shards (the sharded drainer's most) at rungs 2^15
    and 2^18, their starts even and odd by turns.  -> {case: (ring
    buffer, starts, rung)}."""
    import chip_smoke as cs
    from cilium_tpu_torch import u32

    cap = cs.RING_CAPACITY
    one = u32.from_numpy(cs.random_ring_words(rng, cap), "cuda")
    eight = u32.from_numpy(cs.random_ring_words(rng, SHARDS * cap), "cuda")
    mixed = [int(rng.integers(0, cap // 2)) * 2 + (s & 1)
             for s in range(SHARDS)]
    return {"k6_1x262144_even": (one, [0], cap),
            "k6_1x262144_odd": (one, [cap // 2 + 12345], cap),
            "k6_1x4096_even": (one, [0], 4096),
            "k6_1x4096_odd": (one, [cap - 1001], 4096),
            "k6_1x64_even": (one, [0], 64),
            "k6_1x64_odd": (one, [cap - 31], 64),
            f"k6_{SHARDS}x32768_mixed": (eight, mixed, 1 << 15),
            f"k6_{SHARDS}x262144_mixed": (eight, mixed, cap)}


def enqueue_us(fn, n=200) -> float:
    """Host microseconds one call of ``fn`` takes to return (the
    wrapper, its argument block, its allocation, the launch), over ``n``
    calls after a synchronize; the card runs behind."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def run_k6(label, cases) -> dict:
    """Time each K6 case, split it by the profiler, digest its output
    and hold it against the plain version's, a second call's and, as its
    library time, one ``torch.index_select`` of the same rows (the index
    built once on the card, not timed); the host's enqueue time of a
    call and of its ``torch.empty`` alone.  -> {case: record}."""
    import chip_smoke as cs
    import torch
    from cilium_tpu_torch.monitor import ring as rg
    from cilium_tpu_torch.testing.capture import ops_a_call

    cap = cs.RING_CAPACITY
    recs = {}
    for name, (buf, starts, rung) in cases.items():
        buf = buf[:len(starts) * cap]

        def fn(buf=buf, starts=starts, rung=rung):
            return rg.ring_gather(buf, starts, rung, cap)

        st = torch.tensor(starts, dtype=torch.int64, device="cuda")
        idx = ((st[:, None] + torch.arange(rung, device="cuda")[None, :])
               & (cap - 1)) + (torch.arange(len(starts), device="cuda")
                               * cap)[:, None]
        idx = idx.reshape(-1)
        got, again = fn(), fn()
        want = rg.ring_gather_plain(buf, starts, rung, cap)
        lib = torch.index_select(buf, 0, idx)
        rec = {"shards": len(starts), "rung": rung, "starts": starts,
               "inputs": digest(buf), "out": digest(got),
               "plain_equal": bool(torch.equal(got, want)),
               "repeat_equal": bool(torch.equal(got, again)),
               "library_equal": bool(torch.equal(got, lib)),
               "ms": cs.device_ms(fn, REPS),
               "library_ms": cs.device_ms(
                   lambda buf=buf, idx=idx: torch.index_select(buf, 0, idx),
                   REPS),
               "bound_ms": len(starts) * rung * 16 / cs.HBM_BYTES_PER_S
               * 1e3,
               "enqueue_us": enqueue_us(fn),
               "empty_us": enqueue_us(
                   lambda n=len(starts) * rung: torch.empty(
                       (n, 2), dtype=torch.int32, device="cuda")),
               "ops_a_call": ops_a_call(lambda fn=fn: fn),
               "by_kernel": profiled(fn)}
        recs[name] = rec
        print(f"[{label}] K6 {name}: {rec['ms']:.4f} ms (events); "
              + ", ".join(f"{k}={v}" for k, v in rec.items()
                          if k not in ("ms", "by_kernel", "inputs")))
        print(f"[{label}]   " + ", ".join(
            f"{k[:40]} {v['ms']:.4f}x{v['calls']:.0f}"
            for k, v in rec["by_kernel"].items()))
    return recs


def k8_cases(rng) -> dict:
    """K8's inputs: phase 3's half-full 2^20 CT's fingerprints
    (``chip_smoke.half_full_table``, the occupancy the daemon's map-
    pressure samples see by its third session); the same table empty and
    full; shard 3's slice of the half-full one over 8 shards (a view at
    an offset, as ``parallel/mesh.py`` ``_shard_part`` cuts it); that
    slice from its fourth slot, 5 slots short (no 16 B boundary at
    either end); a 2^12 table, half full.  -> {case: fingerprints}."""
    import chip_smoke as cs
    import numpy as np
    from cilium_tpu_torch import u32

    cap = cs.CT_CAPACITY
    _table, fp, _rows = cs.half_full_table(rng, (1 << 31) + 1000)
    half = u32.from_numpy(fp, "cuda")
    full = u32.from_numpy(rng.integers(1, 256, cap).astype(np.uint32),
                          "cuda")
    cs_ = cap // SHARDS
    small = np.where(rng.random(1 << 12) < 0.5,
                     rng.integers(1, 256, 1 << 12), 0).astype(np.uint32)
    return {"k8_half_1048576": half,
            "k8_empty_1048576": u32.from_numpy(np.zeros(cap, np.uint32),
                                               "cuda"),
            "k8_full_1048576": full,
            f"k8_shard3_of_{SHARDS}": half[3 * cs_:4 * cs_],
            f"k8_shard3_of_{SHARDS}_unaligned": half[3 * cs_ + 3:
                                                      4 * cs_ - 2],
            "k8_half_4096": u32.from_numpy(small, "cuda")}


def run_k8(label, cases) -> dict:
    """Time each K8 case, split it by the profiler (the memset and the
    kernel apart, where the tree has a memset), digest the count and
    hold it against the plain version's, a second call's and
    ``torch.count_nonzero``'s (its library time).  -> {case: record}."""
    import chip_smoke as cs
    import torch
    from cilium_tpu_torch.datapath.loader import (_ct_occupied,
                                                  _ct_occupied_plain)
    from cilium_tpu_torch.testing.capture import ops_a_call

    recs = {}
    for name, fp in cases.items():
        def fn(fp=fp):
            return _ct_occupied(fp)

        got, again = fn(), fn()
        want = int(_ct_occupied_plain(fp))
        rec = {"slots": int(fp.shape[0]),
               "offset_bytes": fp.data_ptr() % 16,
               "inputs": digest(fp), "out": digest(got),
               "count": int(got.sum()), "plain_equal": int(got.sum()) == want,
               "repeat_equal": bool(torch.equal(got, again)),
               "ms": cs.device_ms(fn, REPS),
               "library_ms": cs.device_ms(
                   lambda fp=fp: torch.count_nonzero(fp), REPS),
               "bound_ms": (fp.shape[0] * 4 + 4) / cs.HBM_BYTES_PER_S * 1e3,
               "ops_a_call": ops_a_call(lambda fn=fn: fn),
               "by_kernel": profiled(fn)}
        recs[name] = rec
        print(f"[{label}] K8 {name}: {rec['ms']:.4f} ms (events); "
              + ", ".join(f"{k}={v}" for k, v in rec.items()
                          if k not in ("ms", "by_kernel", "inputs")))
        print(f"[{label}]   " + ", ".join(
            f"{k[:40]} {v['ms']:.4f}x{v['calls']:.0f}"
            for k, v in rec["by_kernel"].items()))
    return recs


def k6_calls(cases) -> dict:
    """{case: (call, None, digest of a call's output, None)} for K6."""
    import chip_smoke as cs
    from cilium_tpu_torch.monitor import ring as rg

    cap = cs.RING_CAPACITY
    calls = {}
    for name, (buf, starts, rung) in cases.items():
        def call(buf=buf[:len(starts) * cap], starts=starts, rung=rung):
            return rg.ring_gather(buf, starts, rung, cap)

        calls[name] = (call, None, lambda call=call: digest(call()),
                       lambda: None)
    return calls


def k8_calls(cases) -> dict:
    """{case: (call, None, digest of a call's output, None)} for K8."""
    from cilium_tpu_torch.datapath.loader import _ct_occupied

    return {name: (lambda fp=fp: _ct_occupied(fp), None,
                   lambda fp=fp: digest(_ct_occupied(fp)), lambda: None)
            for name, fp in cases.items()}


def k12_calls(cases) -> dict:
    """{case: (call, fresh, digest of a call's outputs, phase ns of a
    call)} for K12."""
    from cilium_tpu_torch.kernels import launch_snat_reverse

    calls = {}
    for name, (base, t, hdr, now) in cases.items():
        def fresh(base=base):
            return copy_nat(base)

        def call(tb, t=t, hdr=hdr, now=now):
            return launch_snat_reverse(tb, t, hdr, now)

        def out(fresh=fresh, call=call):
            tb = fresh()
            return digest(call(tb)[0], tb.table)

        def phases(fresh=fresh, t=t, hdr=hdr, now=now):
            sc = {}
            launch_snat_reverse(fresh(), t, hdr, now, scratch=sc)
            return sc["phase_ns"]()

        calls[name] = (call, fresh, out, phases)
    return calls


def k7_calls(cases) -> dict:
    """{case: (call, fresh, digest of a call's outputs, None)} for K7."""
    from cilium_tpu_torch.datapath import conntrack as ct
    from cilium_tpu_torch.kernels import launch_ct_gc

    calls = {}
    for name, (base, now) in cases.items():
        def fresh(base=base):
            return ct.CTTable(base.table.clone(), base.fp.clone(),
                              base.dropped.clone())

        def call(w, now=now):
            return launch_ct_gc(w, now)

        def out(fresh=fresh, call=call):
            w = fresh()
            n = call(w)
            return digest(n.reshape(-1).to(w.fp.dtype), w.table, w.fp)

        calls[name] = (call, fresh, out, lambda: None)
    return calls


@functools.lru_cache(maxsize=None)
def own_smoke():
    """This checkout's ``chip_smoke`` (K2's case makers, which an older
    tree's copy lacks), loaded beside the tree's own."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("own_chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k2_cases(world, rng) -> tuple:
    """K2's inputs on config #3's world (``chip_smoke.lpm_rows``): phase
    1's (2^18 addresses, 20% v6 on the 256 /128 pods, 30% of those off
    every /128), the same 2^18 all v4 and all v6, 4096 rows of phase 1's
    mix, the larger TCAM of ``chip_smoke.big_tcam`` with the same mix,
    and a table with no v6 entry (the v6 rows all take the default).  -> ({case: (DeviceLPM, words,
    families)}, {table: host ms of ``DeviceLPM.from_tensors``, the best
    of 5})."""
    import numpy as np
    import torch
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import ip_to_words
    from cilium_tpu_torch.datapath.lpm import DeviceLPM, compile_lpm

    own = own_smoke()
    lpm_rows = own.lpm_rows
    pods = np.array([ip_to_words(ip)[3] for ip in world.pod_ips], np.uint32)
    pods6 = np.array([ip_to_words(ip) for ip in world.pod_ips6], np.uint32)
    ent_big, pods_big, misses = own.big_tcam(world)
    tables = {"config3_257": world.lpm,
              "big_4177": compile_lpm(ent_big),
              "no_v6": compile_lpm({c: v for c, v in world.ipcache.items()
                                    if ":" not in c})}
    build_ms = {}
    for name, lt in tables.items():
        best = None
        for _ in range(5):
            t0 = time.perf_counter()
            dev = DeviceLPM.from_tensors(lt, "cuda")
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            best = ms if best is None else min(best, ms)
        build_ms[name] = best
        tables[name] = dev

    def case(t, words, fam):
        return (t, u32.from_numpy(words, "cuda"), u32.from_numpy(fam, "cuda"))

    n = 1 << 18
    cases = {
        "k2_phase1_262144": case(tables["config3_257"],
                                 *lpm_rows(rng, n, pods, pods6)),
        "k2_all_v4_262144": case(tables["config3_257"],
                                 *lpm_rows(rng, n, pods, pods6, 0.0)),
        "k2_all_v6_262144": case(tables["config3_257"],
                                 *lpm_rows(rng, n, pods, pods6, 1.0)),
        "k2_phase1_4096": case(tables["config3_257"],
                               *lpm_rows(rng, 4096, pods, pods6)),
        "k2_big_tcam_262144": case(tables["big_4177"], *lpm_rows(
            rng, n, pods, pods_big, misses=misses)),
        "k2_no_v6_table_262144": case(tables["no_v6"],
                                      *lpm_rows(rng, n, pods, pods6)),
    }
    return cases, build_ms


def profiled_or_short(fn) -> dict:
    """:func:`profiled`, or {} where the profiler came back short twice
    (the windows are kept in ``profiler_short``): the events time holds
    the case."""
    try:
        return profiled(fn)
    except RuntimeError as e:
        print(f"profiler: {e}")
        return {}


def run_k2(label, cases) -> dict:
    """Time each K2 case, split it by the profiler, digest its output and
    hold it against the plain version's and a second call's, with its
    operations a call.  -> {case: record}."""
    import chip_smoke as cs
    from cilium_tpu_torch.datapath.lpm import lpm_lookup
    from cilium_tpu_torch.kernels import launch_lpm_lookup
    from cilium_tpu_torch.testing.capture import ops_a_call

    recs = {}
    for name, (t, w, f) in cases.items():
        def fn(t=t, w=w, f=f):
            return launch_lpm_lookup(t, w, f)

        got = lpm_lookup(t, w, f)
        out = digest(got)
        rec = {"rows": int(w.shape[0]), "v6_rows": int((f == 6).sum()),
               "v6_entries": int(t.v6_net.shape[0]),
               "default_rows": int((got == t.default).sum()),
               "inputs": digest(w, f, t.l1, t.l2, t.l3, t.v6_net, t.v6_mask,
                                t.v6_value, t.v6_plen),
               "ms": cs.device_ms(fn, REPS), "out": out,
               "plain_equal": out == digest(
                   own_smoke().lpm_plain_chunked(t, w, f)),
               "repeat_equal": out == digest(lpm_lookup(t, w, f)),
               "ops_a_call": ops_a_call(lambda fn=fn: fn),
               "by_kernel": profiled_or_short(fn)}
        recs[name] = rec
        print(f"[{label}] K2 {name}: {rec['ms']:.4f} ms (events); "
              + ", ".join(f"{k}={v}" for k, v in rec.items()
                          if k not in ("ms", "by_kernel", "inputs")))
        print(f"[{label}]   " + ", ".join(
            f"{k[:40]} {v['ms']:.4f}x{v['calls']:.0f}"
            for k, v in rec["by_kernel"].items()))
    return recs


def k15_cases(world, rng) -> dict:
    """K15's inputs: phase 3's (2^16 rows, half to the 4096 v4 frontends
    of ``chip_smoke.service_world``, Maglev 16381, every fifth source
    above 2^31), the same with no row to a VIP and with every row to
    one, 4096 rows of that mix, 2^16 rows over a world of 64 frontends,
    and that world with a second name on svc3's VIP:port (correctness:
    the lower frontend wins).  -> {case: (LBTensors, rows)}."""
    import chip_smoke as cs
    import numpy as np
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.k8s.watchers import ServiceWatcher
    from cilium_tpu_torch.service import ServiceManager
    from cilium_tpu_torch.testing import services as sv

    mgr = ServiceManager(device="cuda")
    sv.install(ServiceWatcher(mgr), cs.service_world(world))
    small = ServiceManager(device="cuda")
    sv.install(ServiceWatcher(small), sv.k8s_objects(
        world.pod_ips, world.pod_ips6, n=64))
    t64 = small.tensors()
    small.upsert("a-dup", f"{sv.vip4(3)}:443", ["10.9.9.9:1"])
    clients = (0x0A000000 + rng.choice(1 << 16, cs.N_LB_CLIENTS,
                                       replace=False)).astype(np.uint32)
    others = np.array([int(ipaddress.IPv4Address(ip))
                       for ip in world.pod_ips[:2048]], np.uint32)

    def rows(n, n_svc, vip_frac):
        r = sv.rows(rng, n, n_svc, clients, others, vip_frac=vip_frac)
        r[::5, 3] |= 0x80000000
        return u32.from_numpy(r, "cuda")

    t = mgr.tensors()
    return {"k15_phase3_65536": (t, rows(cs.LB_N, cs.N_SERVICES, 0.5)),
            "k15_no_vip_65536": (t, rows(cs.LB_N, cs.N_SERVICES, 0.0)),
            "k15_all_vip_65536": (t, rows(cs.LB_N, cs.N_SERVICES, 1.0)),
            "k15_phase3_4096": (t, rows(4096, cs.N_SERVICES, 0.5)),
            "k15_frontends_64_65536": (t64, rows(cs.LB_N, 64, 0.5)),
            "k15_shared_frontend_65536": (small.tensors(),
                                          rows(cs.LB_N, 64, 0.5))}


def run_k15(label, cases) -> dict:
    """Time each K15 case, split it by the profiler, digest its rows and
    both masks and hold them against the plain version's and a second
    call's, with its operations a call.  -> {case: record}."""
    import chip_smoke as cs
    from cilium_tpu_torch.core.packets import COL_FAMILY
    from cilium_tpu_torch.kernels import launch_lb_stage
    from cilium_tpu_torch.service import lb_stage, lb_stage_plain
    from cilium_tpu_torch.testing.capture import ops_a_call

    recs = {}
    for name, (t, hdr) in cases.items():
        def fn(t=t, hdr=hdr):
            return launch_lb_stage(t, hdr)

        got = lb_stage(t, hdr)
        out = digest(*got)
        rec = {"rows": int(hdr.shape[0]),
               "v4_rows": int((hdr[:, COL_FAMILY] == 4).sum()),
               "frontends": int(t.svc_port.shape[0]),
               "have_backend": int(got[1].sum()),
               "no_backend": int(got[2].sum()),
               "inputs": digest(hdr, t.svc_ip, t.svc_port, t.svc_proto,
                                t.maglev),
               "ms": cs.device_ms(fn, REPS), "out": out,
               "plain_equal": out == digest(*lb_stage_plain(t, hdr)),
               "repeat_equal": out == digest(*lb_stage(t, hdr)),
               "ops_a_call": ops_a_call(lambda fn=fn: fn),
               "by_kernel": profiled_or_short(fn)}
        recs[name] = rec
        print(f"[{label}] K15 {name}: {rec['ms']:.4f} ms (events); "
              + ", ".join(f"{k}={v}" for k, v in rec.items()
                          if k not in ("ms", "by_kernel", "inputs")))
        print(f"[{label}]   " + ", ".join(
            f"{k[:40]} {v['ms']:.4f}x{v['calls']:.0f}"
            for k, v in rec["by_kernel"].items()))
    return recs


def k2_calls(cases) -> dict:
    """{case: (call, None, digest of a call's output, None)} for K2."""
    from cilium_tpu_torch.kernels import launch_lpm_lookup

    calls = {}
    for name, (t, w, f) in cases.items():
        def call(t=t, w=w, f=f):
            return launch_lpm_lookup(t, w, f)

        calls[name] = (call, None, lambda call=call: digest(call()),
                       lambda: None)
    return calls


def k15_calls(cases) -> dict:
    """{case: (call, None, digest of a call's outputs, None)} for K15."""
    from cilium_tpu_torch.kernels import launch_lb_stage

    calls = {}
    for name, (t, hdr) in cases.items():
        def call(t=t, hdr=hdr):
            return launch_lb_stage(t, hdr)

        calls[name] = (call, None, lambda call=call: digest(*call()),
                       lambda: None)
    return calls


K14_INPUTS = "CHIP_SPLIT_K14_INPUTS"  # where main() saved K14's inputs
K14_NETS = ("10.0.0.0/8",)  # phase 11's non-masquerade network


def k14_make_inputs(path: Path) -> None:
    """Make K14's inputs once, with this checkout's code, and save them
    under ``path`` (numpy files and ``cases.json``) for every tree's run.
    Timed: phase 3's (``chip_smoke.nat_case`` at NOW: 2^16 rows, 4096 of
    them replies to 8192 live inbound connections in a 2^20 CT) with
    the probe and without it (``snat_stage``'s call); 2^16 replies whose
    reverse entries are all live; the first case's rows with no
    candidate (every row ingress, v6 or toward 10.0.0.0/8); its rows on
    a CT 86% full (its connections and random live keys placed by the
    device hash); 4096 of its rows.  Correctness only:
    ``chip_smoke.masq_edge_cases`` (reverse entries past N_CAND
    fingerprint matches, wrapping windows, a clock within 150 of 2^32,
    no and four exclusions), the overflow case without the probe, its
    rows off a 16-byte boundary, n = 0, and one reply that finds its
    entry."""
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    from cilium_tpu_torch.core.packets import (COL_DIR, COL_DST_IP3,
                                               COL_FAMILY)
    from cilium_tpu_torch.datapath import conntrack as ct
    from cilium_tpu_torch.testing import egress as eg

    own = own_smoke()
    rng = np.random.default_rng(SEED + 14)
    path.mkdir(parents=True, exist_ok=True)
    arrays, cases = {}, {}

    def case(name, cidrs, rows, ct_name, now, timed, offset=0):
        arrays.setdefault(f"rows_{name}", np.ascontiguousarray(rows))
        cases[name] = {"cidrs": list(cidrs), "rows": f"rows_{name}",
                       "ct": ct_name, "now": int(now), "timed": timed,
                       "offset": offset}

    _t, cti, rows, pods = own.nat_case(torch, rng, NOW)
    arrays["ct_phase3"] = (cti.table.cpu().numpy(), cti.fp.cpu().numpy())
    del cti
    case("k14_phase3_probe_65536", K14_NETS, rows, "ct_phase3", NOW, True)
    case("k14_phase3_no_probe_65536", K14_NETS, rows, None, NOW, True)
    inbound, replies = eg.inbound_pairs(rng, own.EGRESS_N, pods)
    arrays["ct_all_found"] = eg.inbound_ct(inbound, NOW, own.CT_CAPACITY)
    case("k14_all_found_65536", K14_NETS, replies, "ct_all_found", NOW,
         True)
    none = rows.copy()
    k = np.arange(len(none)) % 3
    none[k == 0, COL_DIR] = 0
    none[k == 1, COL_FAMILY] = 6
    none[k == 2, COL_DST_IP3] = eg.ip(eg.CLUSTER[0])
    case("k14_no_candidate_65536", K14_NETS, none, "ct_phase3", NOW, True)
    n86 = int(own.CT_CAPACITY * 0.86)
    table0 = arrays["ct_phase3"][0]
    live = table0[table0[:, ct.V_STATE] != ct.ST_FREE]
    filler = np.zeros((n86 - len(live), ct.ROW_WORDS), np.uint32)
    filler[:, :ct.KEY_WORDS] = own.random_keys(rng, len(filler))
    filler[:, ct.V_STATE] = ct.ST_ESTABLISHED
    filler[:, ct.V_EXPIRES] = NOW + 1000
    table86, _dropped = ct.ct_table_from_rows(
        np.concatenate([live, filler]), own.CT_CAPACITY)
    arrays["ct_86pct"] = (table86, ct.ct_fp_from_table(table86))
    case("k14_ct_86pct_65536", K14_NETS, rows, "ct_86pct", NOW, True)
    case("k14_phase3_probe_4096", K14_NETS,
         rows[np.sort(rng.choice(len(rows), 4096, replace=False))],
         "ct_phase3", NOW, True)
    ct_names = {}  # the edge cases share some tables
    for name, (cidrs, e_rows, table_fp, e_now) in own.masq_edge_cases(
            rng).items():
        ct_name = ct_names.setdefault(id(table_fp), f"ct_{name}")
        arrays.setdefault(ct_name, table_fp)
        case(f"k14_{name}", cidrs, e_rows, ct_name, e_now, False)
    over = cases["k14_overflow"]
    o_rows = arrays[over["rows"]]
    case("k14_overflow_no_probe", K14_NETS, o_rows, None, over["now"],
         False)
    case("k14_unaligned", K14_NETS, o_rows, over["ct"], over["now"], False,
         offset=1)
    case("k14_n1", K14_NETS, replies[:1], "ct_all_found", NOW, False)
    case("k14_n0", K14_NETS, o_rows[:0], over["ct"], over["now"], False)
    for name, a in arrays.items():
        if isinstance(a, tuple):
            np.save(path / f"{name}_table.npy", a[0])
            np.save(path / f"{name}_fp.npy", a[1])
        else:
            np.save(path / f"{name}.npy", a)
    (path / "cases.json").write_text(json.dumps(cases, indent=1))


def k14_cases(path: Path) -> dict:
    """K14's inputs saved by :func:`k14_make_inputs`, on the card: {case:
    (NAT tensors, CT or None, rows, now, timed)}."""
    import numpy as np
    import torch
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.datapath import conntrack as ct
    from cilium_tpu_torch.service import nat
    from cilium_tpu_torch.testing import egress as eg

    spec = json.loads((path / "cases.json").read_text())
    tables = {}

    def table(name):
        if name not in tables:
            tables[name] = ct.CTTable(
                table=u32.from_numpy(np.load(path / f"{name}_table.npy"),
                                     "cuda"),
                fp=u32.from_numpy(np.load(path / f"{name}_fp.npy"), "cuda"),
                dropped=torch.zeros((), dtype=torch.int32, device="cuda"))
        return tables[name]

    out = {}
    for name, c in spec.items():
        hdr = u32.from_numpy(np.load(path / f"{c['rows']}.npy"), "cuda")
        if c["offset"]:  # the same rows `offset` words past 16 bytes
            buf = torch.empty(hdr.numel() + c["offset"], dtype=hdr.dtype,
                              device="cuda")
            buf[c["offset"]:] = hdr.reshape(-1)
            hdr = buf[c["offset"]:].view(hdr.shape)
        t = nat.NATConfig(node_ip=eg.NODE_IP,
                          non_masquerade_cidrs=tuple(c["cidrs"])).compile(
                              "cuda")
        out[name] = (t, table(c["ct"]) if c["ct"] else None, hdr, c["now"],
                     c["timed"])
    return out


def run_k14(label, cases) -> dict:
    """Hold each K14 case against the plain version's and a second call's
    by digest (rows and mask), with its operations a call, the rows that
    are candidates (egress v4 toward no non-masquerade network) and those
    the probe keeps; time the timed ones (events) and split them by the
    profiler.  A tree whose launcher refuses the rows records why.  ->
    {case: record}."""
    import chip_smoke as cs
    from cilium_tpu_torch.kernels import launch_masq_rewrite
    from cilium_tpu_torch.service import nat
    from cilium_tpu_torch.testing.capture import ops_a_call

    recs, ct_digests = {}, {}
    for name, (t, cti, hdr, now, timed) in cases.items():
        def fn(t=t, cti=cti, hdr=hdr, now=now):
            return launch_masq_rewrite(t, hdr, cti, now)

        rec = {"rows": int(hdr.shape[0])}
        try:
            got = fn()
        except ValueError as e:
            rec["refused"] = str(e)
            recs[name] = rec
            print(f"[{label}] K14 {name}: refused: {e}")
            continue
        plain = nat.masq_rewrite_plain(t, hdr, cti, now)
        cand = nat.masq_rewrite_plain(t, hdr, None, now)[1]
        if cti is not None and id(cti) not in ct_digests:
            ct_digests[id(cti)] = digest(cti.table, cti.fp)
        out = digest(*got)
        rec.update(candidates=int(cand.sum()),
                   kept=int(cand.sum() - plain[1].sum()),
                   inputs=digest(hdr) + (ct_digests[id(cti)] if cti is not
                                         None else ""),
                   out=out, plain_equal=out == digest(*plain),
                   repeat_equal=out == digest(*fn()),
                   # an empty capture cannot be read: n = 0 launches
                   # nothing
                   ops_a_call=ops_a_call(lambda fn=fn: fn) if len(hdr)
                   else {})
        if timed:
            rec.update(ms=cs.device_ms(fn, REPS),
                       by_kernel=profiled_or_short(fn))
        recs[name] = rec
        print(f"[{label}] K14 {name}: "
              + (f"{rec['ms']:.4f} ms (events); " if timed else "")
              + ", ".join(f"{k}={v}" for k, v in rec.items()
                          if k not in ("ms", "by_kernel", "inputs")))
        if timed:
            print(f"[{label}]   " + ", ".join(
                f"{k[:40]} {v['ms']:.4f}x{v['calls']:.0f}"
                for k, v in rec["by_kernel"].items()))
    return recs


def k14_calls(cases) -> dict:
    """{case: (call, None, digest of a call's outputs, None)} for K14's
    timed cases."""
    from cilium_tpu_torch.kernels import launch_masq_rewrite

    calls = {}
    for name, (t, cti, hdr, now, timed) in cases.items():
        if not timed:
            continue

        def call(t=t, cti=cti, hdr=hdr, now=now):
            return launch_masq_rewrite(t, hdr, cti, now)

        calls[name] = (call, None, lambda call=call: digest(*call()),
                       lambda: None)
    return calls


def run_grids(tree: Path, label: str, which: str, recs: dict,
              calls: dict) -> dict:
    """Each grid variant of ``which`` (built from ``tree``'s source, out
    of the tree) timed on every case, its outputs held against the
    tree's own by digest."""
    import chip_smoke as cs
    from cilium_tpu_torch.kernels import build

    source = ABLATIONS[which][0]
    own = build.library_path(source)
    out = {}
    for aname, (so, log) in build_ablations(tree, which).items():
        use_library(source, so)
        rec = {"ptxas": ptxas_regs(log)}
        for case, (call, fresh, digest_of, phases) in calls.items():
            rec[case] = {"ms": cs.device_ms(call, REPS, fresh),
                         "out_equal": digest_of() == recs[case]["out"],
                         "phase_ns": phases()}
        out[aname] = rec
        print(f"[{label}] {which} {aname}: " + ", ".join(
            f"{k} {v['ms']:.4f}" + ("" if v["out_equal"] else " (DIFFERS)")
            + f" {v['phase_ns']}"
            for k, v in rec.items() if k != "ptxas")
            + f" ms; ptxas {[r for r in rec['ptxas'] if 'kernel' in r[0]]}")
    use_library(source, own)
    return out


def split_one(tree: Path, label: str, flags: set, kernels: set) -> dict:
    """One tree, in this process: build, make the cases, time them."""
    sys.path.insert(0, str(tree))
    import copy
    import inspect

    import numpy as np
    import torch
    import chip_smoke as cs
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import pack_eligibility, pack_rows
    from cilium_tpu_torch.datapath import conntrack as ct
    from cilium_tpu_torch.datapath.verdict import datapath_step
    from cilium_tpu_torch.kernels import (build, launch_ct_update,
                                          launch_datapath)
    from cilium_tpu_torch.ml import synth_labeled_traffic
    from cilium_tpu_torch.parallel import route_by_flow
    from cilium_tpu_torch.testing import fixtures as fx

    variants = "--variants" in flags
    sources = (["verdict", "conntrack"] if kernels & {"k1k4", "k18", "k19",
                                                      "k20", "k22", "k5"}
               else []) + (
        ["ml"] if kernels & {"k18", "k19", "k20", "k22"} else []) + (
        ["mltrain"] if kernels & {"k20", "k22"} else []) + (
        ["l7"] if "k9" in kernels else []) + (
        ["ring"] if kernels & {"k5", "k6"} else []) + (
        ["conntrack"] if "k8" in kernels else []) + (
        ["socklb"] if "k17" in kernels else []) + (
        ["lpm"] if "k2" in kernels else []) + (
        ["lb"] if "k15" in kernels else []) + (
        ["nat"] if "k14" in kernels else [])
    if kernels & {"k11", "k13", "k16", "k12", "k7"}:  # the daemons run
        sources = list(build.SOURCES)  # every kernel
    t0 = time.monotonic()
    build.build(sources)
    res = {"tree": str(tree), "label": label,
           "build_s": time.monotonic() - t0,
           "ptxas": {n: ptxas_regs((build.BUILD_DIR / f"{n}.log").read_text())
                     for n in sources},
           "k1": {}, "k4": {}, "k20": {}, "k9": {}, "k18": {}, "k19": {},
           "k22": {}, "k5": {}, "k17": {}, "k11": {}, "k13": {},
           "k16": {}, "k12": {}, "k7": {}, "k6": {}, "k8": {}, "k2": {},
           "k15": {}, "k14": {}}
    rng = np.random.default_rng(SEED)
    world = fx.build_world(10_000, 64, ct_capacity=1 << 4, n_v6=256,
                           device="cpu")
    if "k20" in kernels:
        res["k20"] = run_k20(label, train_cases(world, rng))
    if "k9" in kernels:
        res["k9"] = run_k9(label, l7_cases(rng))
    if kernels & {"k18", "k19"}:
        k18, k19 = ml_cases(world, np.random.default_rng(SEED + 18))
        if "k18" in kernels:
            res["k18"] = run_k18(label, k18)
        if "k19" in kernels:
            res["k19"] = run_k19(label, k19)
    if "k22" in kernels:
        res["k22"] = run_k22(label, adam_cases(
            world, np.random.default_rng(SEED + 22)))
    if "k5" in kernels:
        res["k5"] = run_k5(label, ring_cases(
            world, np.random.default_rng(SEED + 5)))
    if "k17" in kernels:
        k17_t, k17_cases = lb_cases(world, np.random.default_rng(SEED + 17))
        res["k17"] = run_k17(label, k17_t, k17_cases)
    if "k11" in kernels:
        k11_cases = nat_cases(world, np.random.default_rng(SEED + 11))
        res["k11"] = run_k11(label, k11_cases)
    if kernels & {"k13", "k16", "k12"}:
        k13_cases, k16_cases, k12_paths = bw_lb_cases(
            world, np.random.default_rng(SEED + 13),
            v6_world="k16" in kernels)
        if "k13" in kernels:
            res["k13"] = run_k13(label, k13_cases)
        if "k16" in kernels:
            res["k16"] = run_k16(label, k16_cases)
    if "k12" in kernels:
        k12_all = {**k12_cases(np.random.default_rng(SEED + 120)),
                   **k12_paths}
        res["k12"] = run_k12(label, k12_all)
    if "k7" in kernels:
        k7_all = k7_cases(world, np.random.default_rng(SEED + 7))
        res["k7"] = run_k7(label, k7_all)
    if "k6" in kernels:
        k6_all = k6_cases(np.random.default_rng(SEED + 6))
        res["k6"] = run_k6(label, k6_all)
    if "k8" in kernels:
        k8_all = k8_cases(np.random.default_rng(SEED + 8))
        res["k8"] = run_k8(label, k8_all)
    if "k15" in kernels:
        k15_all = k15_cases(world, np.random.default_rng(SEED + 15))
        res["k15"] = run_k15(label, k15_all)
    if "k14" in kernels:
        k14_all = k14_cases(Path(os.environ[K14_INPUTS]))
        res["k14"] = run_k14(label, k14_all)
    if "--layouts" in flags:
        res["grids"] = {}
        if "k15" in kernels:
            res["grids"]["k15"] = run_grids(tree, label, "k15_layout",
                                            res["k15"], k15_calls(k15_all))
    if "--grids" in flags:
        res.setdefault("grids", {})
        if "k17" in kernels:
            res["grids"]["k17"] = run_grids(tree, label, "k17_grid", res["k17"],
                                            k17_lb_calls(k17_t, k17_cases))
        if "k11" in kernels:
            res["grids"]["k11"] = run_grids(tree, label, "k11_grid", res["k11"],
                                            k11_nat_calls(k11_cases))
            res["grids"]["k11_parts"] = run_grids(
                tree, label, "k11_parts", res["k11"],
                k11_nat_calls(k11_cases))
        if "k12" in kernels:
            res["grids"]["k12"] = run_grids(tree, label, "k12_grid",
                                            res["k12"], k12_calls(k12_all))
        if "k7" in kernels:
            res["grids"]["k7"] = run_grids(tree, label, "k7_grid",
                                           res["k7"], k7_calls(k7_all))
        if "k6" in kernels:
            res["grids"]["k6"] = run_grids(tree, label, "k6_grid",
                                           res["k6"], k6_calls(k6_all))
        if "k8" in kernels:
            res["grids"]["k8"] = run_grids(tree, label, "k8_grid",
                                           res["k8"], k8_calls(k8_all))
        if "k14" in kernels:
            res["grids"]["k14"] = run_grids(tree, label, "k14_grid",
                                            res["k14"], k14_calls(k14_all))
    def last_k2_and_save():
        # K2 last: after the parent's 43 ms profiler window (the larger
        # TCAM) every later window came back two events short
        if "k2" in kernels:
            k2_all, res["k2_build_ms"] = k2_cases(
                world, np.random.default_rng(SEED + 2))
            res["k2"] = run_k2(label, k2_all)
            print(f"[{label}] K2 DeviceLPM.from_tensors host ms: "
                  f"{res['k2_build_ms']}")
            if "--layouts" in flags:
                res.setdefault("grids", {})["k2"] = run_grids(
                    tree, label, "k2_groups", res["k2"], k2_calls(k2_all))
        return save(label, res)

    if "k1k4" not in kernels:
        return last_k2_and_save()
    has_stats = "stats" in inspect.signature(ct.ct_update_plain).parameters
    has_scratch = "scratch" in inspect.signature(launch_ct_update).parameters

    def fork(state):  # the verdict stage reads the CT, adds to metrics
        s2 = copy.copy(state)
        s2.metrics = state.metrics.clone()
        return s2

    def k1(state, rows, meta, valid, shards):
        return launch_datapath(state, rows, NOW, meta.get("ep"),
                               meta.get("dirn"), valid, None, None, None,
                               False, n_shards=shards)

    def k4(w, c, valid, shards, scratch=None):
        kw = {"scratch": scratch} if scratch is not None else {}
        return launch_ct_update(w, c.l4, c.fwd, c.result, c.slot,
                                c.is_reply, c.do_create, c.proxy_port, NOW,
                                valid, n_shards=shards, **kw)

    def run_k4(name, state, c, valid, shards):
        base = state.ct

        def fresh():
            return ct.CTTable(base.table.clone(), base.fp.clone(),
                              base.dropped.clone(),
                              torch.full((2, base.table.shape[0]), -1,
                                         dtype=torch.int32, device="cuda"))

        ms = cs.device_ms(lambda w: k4(w, c, valid, shards), REPS, fresh)
        by_launch = profiled(lambda w: k4(w, c, valid, shards), fresh)
        w = fresh()
        k4(w, c, valid, shards)
        rec = {"rows": int(c.fwd.shape[0]), "shards": shards or 1,
               "ms": ms, "by_launch": by_launch,
               "launches": sum(v["calls"] for v in by_launch.values()),
               "inputs": digest(c.l4, c.fwd, c.result, c.slot, c.is_reply,
                                c.do_create, c.proxy_port,
                                *(() if valid is None else (valid,))),
               "ct": digest(w.table, w.fp, w.dropped),
               "claim_clear": bool((w.claim == -1).all()),
               "pending_rows": int((c.do_create & (c.result == 0)).sum()
                                   if valid is None else
                                   (c.do_create & (c.result == 0)
                                    & valid).sum())}
        if has_stats and not shards:
            st = {}
            p = fresh()
            ct.ct_update_plain(p, c.l4, c.fwd, c.result, c.slot, c.is_reply,
                               c.do_create, c.proxy_port, NOW, valid,
                               stats=st)
            rec["plain_rounds"] = st["rounds"]
            rec["plain_pending"] = st["pending"]
            rec["plain_equal"] = digest(p.table, p.fp, p.dropped) == rec["ct"]
        if has_scratch:
            sc = {}
            k4(fresh(), c, valid, shards, scratch=sc)
            rc = sc["counts"].cpu().tolist()
            rec["kernel_pending"] = rc
            rec["kernel_rounds"] = sum(1 for x in rc[:-1] if x > 0)
        res["k4"][name] = rec
        top = sorted(by_launch.items(), key=lambda kv: -kv[1]["ms"])[:6]
        print(f"[{label}] K4 {name}: {ms:.4f} ms (events), "
              f"{rec['launches']:.0f} launches a call, pending rows "
              f"{rec['pending_rows']}, rounds "
              f"{rec.get('plain_rounds', rec.get('kernel_rounds', '?'))}; "
              + ", ".join(f"{k[:28]} {v['ms']:.4f}x{v['calls']:.0f}"
                          for k, v in top))
        if variants:
            k4_inputs.append((name, fresh(), c, valid, shards))
        k4(state.ct, c, valid, shards)  # the state moves on

    cases = []  # (name, state, rows, meta, valid, shards) for K1
    k4_inputs = []  # (case, CT before, inputs, valid, shards) for K4

    # the trainer's batch after 8 warm-up steps
    st = cs.card_state(world)
    for s in range(8):
        hdr, _ = synth_labeled_traffic(world, 4096, rng)
        datapath_step(st, u32.from_numpy(hdr, "cuda"), NOW - 8 + s)
    hdr, _ = synth_labeled_traffic(world, 4096, rng)
    train_rows = u32.from_numpy(hdr, "cuda")
    cases.append(("train_wide_4096", st, train_rows, {}, None, None))

    def packed_pair(n):
        pool = fx.steady_flow_pool(world, n, rng)
        return (pack_rows(pool), pack_rows(fx.steady_traffic(pool, n, rng)))

    def routed(hdr, n):
        r, valid, _o, _ovf = route_by_flow(hdr, SHARDS, HEADROOM * n // SHARDS)
        ok, ep, dirn = pack_eligibility(hdr)
        return (u32.from_numpy(pack_rows(r), "cuda"),
                torch.from_numpy(valid).cuda(), dict(ep=ep, dirn=dirn))

    for n, tag in ((1 << 16, "daemon"), (1 << 18, "slice")):
        syn, steady = packed_pair(n)
        cases.append((f"{tag}_packed_{n}", cs.card_state(world),
                      (u32.from_numpy(syn, "cuda"),
                       u32.from_numpy(steady, "cuda")),
                      dict(ep=0, dirn=0), None, None))
    wpool = fx.wide_flow_pool(world, 1 << 16, rng)
    cases.append((f"slice_wide_{1 << 18}", cs.card_state(world),
                  (u32.from_numpy(wpool, "cuda"),
                   u32.from_numpy(fx.wide_traffic(wpool, 1 << 18, rng),
                                  "cuda")), {}, None, None))
    for n in (1 << 16, 1 << 18):
        pool = fx.steady_flow_pool(world, n, rng)
        syn = routed(pool, n)
        steady = routed(fx.steady_traffic(pool, n, rng), n)
        cases.append((f"sharded_packed_{n}x{SHARDS}", cs.card_state(world),
                      (syn, steady), None, None, SHARDS))

    for name, state, rows, meta, valid, shards in cases:
        if name.startswith("train"):
            phases = [("steady", rows, meta, valid)]
        elif shards:  # rows: ((rows, valid, meta) syn, ... steady)
            phases = [(ph, r, m, v) for ph, (r, v, m) in
                      zip(("syn", "steady"), rows)]
        else:
            phases = [("syn", rows[0], meta, valid),
                      ("steady", rows[1], meta, valid)]
        for phase, r, m, v in phases:
            out, c = k1(fork(state), r, m, v, shards)
            s_t = fork(state)
            ms = cs.device_ms(lambda: k1(s_t, r, m, v, shards), REPS)
            m_before = state.metrics.clone()
            k1(state, r, m, v, shards)  # metrics move on with the state
            key = f"{name}/{phase}"
            res["k1"][key] = {
                "rows": int(r.shape[0]), "ms": ms,
                "out": digest(out, c.l4, c.fwd, c.result, c.slot, c.is_reply,
                              c.do_create, c.proxy_port,
                              state.metrics - m_before)}
            print(f"[{label}] K1 {key}: {ms:.4f} ms a launch (events)")
            run_k4(key, state, c, v, shards)

    if variants:
        libs = build_ablations(tree, "k4_grid")
        res["k4_grid"] = {}
        for aname, (so, log) in libs.items():
            use_library("conntrack", so)
            rec = {"ptxas": ptxas_regs(log)}
            for key, base, c, valid, shards in k4_inputs:
                def fresh(base=base):
                    return ct.CTTable(base.table.clone(), base.fp.clone(),
                                      base.dropped.clone(),
                                      torch.full((2, base.table.shape[0]),
                                                 -1, dtype=torch.int32,
                                                 device="cuda"))

                w = fresh()
                k4(w, c, valid, shards)
                ok = digest(w.table, w.fp, w.dropped) == res["k4"][key]["ct"]
                rec[key] = {"ms": cs.device_ms(
                    lambda w_: k4(w_, c, valid, shards), REPS, fresh),
                    "ct_equal": ok}
            res["k4_grid"][aname] = rec
            print(f"[{label}] K4 grid {aname}: "
                  + ", ".join(f"{k} {v['ms']:.4f}"
                              + ("" if v["ct_equal"] else " (CT DIFFERS)")
                              for k, v in rec.items() if k != "ptxas")
                  + f" ms; ptxas {rec['ptxas']}")
    if variants:  # K1 held to fewer registers
        st_case = {c[0]: c for c in cases}
        res["k1_occupancy"] = {}
        for aname, (so, log) in build_ablations(tree,
                                                "k1_occupancy").items():
            use_library("verdict", so)
            rec = {"ptxas": ptxas_regs(log)}
            for cname in ("train_wide_4096", f"daemon_packed_{1 << 16}",
                          f"slice_packed_{1 << 18}",
                          f"slice_wide_{1 << 18}"):
                _n, state, rows, meta, valid, _s = st_case[cname]
                r = rows if cname.startswith("train") else rows[1]
                s_t = fork(state)
                rec[cname] = cs.device_ms(
                    lambda: k1(s_t, r, meta, valid, None), REPS)
            res["k1_occupancy"][aname] = rec
            print(f"[{label}] K1 occupancy {aname}: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in rec.items()
                              if k != "ptxas")
                  + f" ms; ptxas {rec['ptxas']}")
    return last_k2_and_save()


def save(label, res) -> dict:
    """Write one run's record, with the profiler's short windows."""
    res["profiler_short"] = SHORT_WINDOWS
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{label}.json").write_text(json.dumps(res, indent=1))
    return res


def split_trees(trees, kernels, opts, env) -> Optional[list]:
    """Each tree's run in a process of its own, in the order given; ->
    their records (None where one failed)."""
    runs = []
    for i, tree in enumerate(trees):
        label = f"{i}_{tree.name}"
        # each variant set once, on the first run of the tree it names
        extra = [k for k, v in opts.items()
                 if v == tree and tree not in trees[:i]]
        p = subprocess.run([sys.executable, __file__,
                            f"--kernels={','.join(sorted(kernels))}",
                            "--one", str(tree), label, *extra], timeout=900,
                           env=env)
        if p.returncode != 0:
            print(f"chip_kernel_split: {tree} failed ({p.returncode})",
                  file=sys.stderr)
            return None
        runs.append(json.loads((OUT / f"{label}.json").read_text()))
    return runs


def main() -> int:
    args = sys.argv[1:]
    kernels = set(KERNEL_SETS)
    opts = {}
    for a in [a for a in args if a.startswith("--") and "=" in a]:
        flag, val = a.split("=", 1)
        if flag == "--kernels":
            kernels = set(val.split(","))
            if not kernels <= set(KERNEL_SETS):
                print(f"chip_kernel_split: --kernels takes {KERNEL_SETS}",
                      file=sys.stderr)
                return 2
        elif flag in TREE_FLAGS:
            opts[flag] = Path(val).resolve()
        else:
            print(f"chip_kernel_split: unknown flag {flag}", file=sys.stderr)
            return 2
    args = [a for a in args if not (a.startswith("--") and "=" in a)]
    if len(args) >= 3 and args[0] == "--one":
        split_one(Path(args[1]).resolve(), args[2], set(args[3:]), kernels)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_kernel_split: no CUDA device", file=sys.stderr)
        return 1
    trees = [Path(t).resolve() for t in args] or [ROOT]
    env = dict(os.environ)
    if "k14" in kernels:
        env[K14_INPUTS] = tempfile.mkdtemp(prefix="k14_inputs_")
    try:
        if "k14" in kernels:
            k14_make_inputs(Path(env[K14_INPUTS]))
        runs = split_trees(trees, kernels, opts, env)
    finally:
        if K14_INPUTS in env:
            shutil.rmtree(env[K14_INPUTS])
    if runs is None:
        return 1
    for later in runs[1:]:
        first = runs[0]
        for kern in ("k1", "k4", "k20", "k9", "k18", "k19", "k22", "k5",
                     "k17", "k11", "k13", "k16", "k12", "k7", "k6", "k8",
                     "k2", "k15", "k14"):
            for case, rec in later[kern].items():
                want = first[kern].get(case, {})
                for field in ("out", "inputs", "ct", "scores", "k12"):
                    if field in rec and field in want:
                        same = (rec[field] == want[field] if field != "k12"
                                else rec[field]["out"] == want[field]["out"])
                        print(f"{later['label']} {kern} {case} {field}: "
                              f"{'equal to' if same else 'DIFFERS from'} "
                              f"{first['label']}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi,
                      "runs": [{k: r[k] for k in ("label", "k1", "k4",
                                                  "k20", "k9", "k18",
                                                  "k19", "k22", "k5",
                                                  "k17", "k11", "k13",
                                                  "k16", "k12", "k7",
                                                  "k6", "k8", "k2",
                                                  "k2_build_ms", "k15",
                                                  "k14", "profiler_short")
                                if k in r} for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
