"""The port's kernels against their plain versions on the card, at a
small size: the slice through CUDA kernels must equal the slice through
the plain PyTorch versions, the maintenance, gather, L7, table-update,
egress, service-LB, anomaly and trainer kernels their plain versions, the superbatch its
sequential steps, and the daemon on the card the daemon on the CPU.  Needs a CUDA device (marker ``gpu``) and
skips without one.  It imports nothing of JAX, so it runs on the card's
machine, which has no JAX:

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import functools

import numpy as np
import pytest
import torch

from cilium_tpu_torch.core.packets import pack_rows
from cilium_tpu_torch.datapath.loader import TorchLoader
from cilium_tpu_torch.monitor import ring as tring
from cilium_tpu_torch.testing import fixtures as tfix

torch.set_num_threads(1)


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_the_card():
    """On a CUDA machine: the slice through the kernels equals the
    slice through the plain versions on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest "
                    "tests/test_torch_gpu.py --noconftest)")
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts

    w = tfix.build_world(256, 8, ct_capacity=1 << 12, n_v6=16,
                         device="cpu")
    loaders = [TorchLoader(ct_capacity=1 << 12, device=d)
               for d in ("cuda", "cpu")]
    rings = [tring.EventRing.create(1 << 12, device=l.device)
             for l in loaders]
    for l in loaders:
        l.attach(w.policies, w.ipcache, {0: 0}, w.row_map)
    rng = np.random.default_rng(2)
    pool = tfix.wide_flow_pool(w, 256, rng)
    reset_launch_counts()
    for b in range(3):
        packed = pack_rows(tfix.bench_traffic(w, 512, rng))
        hdr = tfix.wide_traffic(pool, 512, rng)
        for i, l in enumerate(loaders):
            rings[i], _ = l.serve_packed(rings[i], packed, 100 + b, b, 0, 0)
            rings[i], _ = l.serve(rings[i], hdr, 100 + b, b)
    got = [tring.ring_drain(r) for r in rings]
    np.testing.assert_array_equal(got[0][0], got[1][0])
    np.testing.assert_array_equal(loaders[0].metrics(), loaders[1].metrics())
    np.testing.assert_array_equal(loaders[0].ct_snapshot(),
                                  loaders[1].ct_snapshot())
    for name in ("datapath_packed", "datapath_wide", "ct_update",
                 "ring_append"):
        assert KERNELS[name].launches > 0
    # the kernel's claim words live with the table, -1 between calls
    assert bool((loaders[0].state.ct.claim == -1).all())


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest "
                    "tests/test_torch_gpu.py --noconftest)")


@pytest.mark.gpu
def test_maintenance_and_gather_kernels_match_plain_versions():
    """ct_gc, ct_occupied and ring_gather on the card against their
    plain versions, with expiries on both sides of 2^31."""
    _need_card()
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.datapath import conntrack as ct
    from cilium_tpu_torch.datapath.loader import (_ct_occupied,
                                                  _ct_occupied_plain)
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts

    rng = np.random.default_rng(5)
    cap, now = 1 << 12, (1 << 31) + 7
    table = np.zeros((cap, ct.ROW_WORDS), np.uint32)
    live = rng.random(cap) < 0.5
    table[live, ct.V_STATE] = rng.integers(1, 4, int(live.sum()))
    table[:, ct.V_EXPIRES] = rng.choice(np.array(
        [5, (1 << 31) - 1, 1 << 31, now - 1, now, now + 1, 0xFFFFFFFF],
        np.uint32), cap)
    fp = np.where(live, rng.integers(1, 256, cap), 0).astype(np.uint32)
    reset_launch_counts()
    tabs = [ct.CTTable(table=u32.from_numpy(table, "cuda"),
                       fp=u32.from_numpy(fp, "cuda"),
                       dropped=torch.zeros((), dtype=torch.int32,
                                           device="cuda"))
            for _ in range(2)]
    assert int(_ct_occupied(tabs[0].fp).sum()) == int(
        _ct_occupied_plain(tabs[1].fp)) == int(live.sum())
    n_k = int(ct.ct_gc(tabs[0], now).sum())
    n_p = int(ct.ct_gc_plain(tabs[1], now))
    assert n_k == n_p == int((live & (table[:, ct.V_EXPIRES] < now)).sum())
    assert torch.equal(tabs[0].table, tabs[1].table)
    assert torch.equal(tabs[0].fp, tabs[1].fp)
    from cilium_tpu_torch.monitor import ring as tring

    words = u32.from_numpy(rng.integers(0, 1 << 32, (2 * cap, 2),
                                        dtype=np.uint64), "cuda")
    for starts in ([0], [cap - 3], [5, cap - 1]):
        for rung in (64, 1024, cap):
            got = tring.ring_gather(words[:len(starts) * cap], starts, rung,
                                    cap)
            want = tring.ring_gather_plain(words[:len(starts) * cap],
                                           starts, rung, cap)
            assert torch.equal(got, want)
    for name in ("ct_gc", "ct_occupied", "ring_gather"):
        assert KERNELS[name].launches > 0


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [1 << 12, 1 << 16])
@pytest.mark.parametrize("occupancy", ["empty", "half", "full",
                                       "all_expired"])
def test_ct_gc_is_one_launch_matching_its_plain_version(cap, occupancy):
    """K7, one kernel a call and no memset, against the plain version on
    the same CUDA tensors over successive sweeps (clocks on both sides of
    2^31), bit-exact (table, fingerprints, count): tables empty, half and
    wholly live with expiries on the u32 edges, and wholly live and
    expired.  The stream's scratch (the blocks' sum and the ticket) is
    zero after every call."""
    _need_card()
    from cilium_tpu_torch import kernels, u32
    from cilium_tpu_torch.datapath import conntrack as ct

    rng = np.random.default_rng(cap + len(occupancy))
    now = (1 << 31) + 7
    table = np.zeros((cap, ct.ROW_WORDS), np.uint32)
    live = rng.random(cap) < {"empty": 0.0, "half": 0.5}.get(occupancy, 1.0)
    table[:, :ct.KEY_WORDS] = rng.integers(0, 1 << 32, (cap, ct.KEY_WORDS),
                                           dtype=np.uint64)
    table[live, ct.V_STATE] = rng.integers(1, 4, int(live.sum()))
    table[:, ct.V_EXPIRES] = rng.choice(np.array(
        [5, (1 << 31) - 1, 1 << 31, now - 1, now, now + 1, now + 5000,
         0xFFFFFFFF], np.uint32), cap)
    if occupancy == "all_expired":
        table[:, ct.V_EXPIRES] = now - 1
    fp = np.where(live, rng.integers(1, 256, cap), 0).astype(np.uint32)
    tabs = [ct.CTTable(table=u32.from_numpy(table, "cuda"),
                       fp=u32.from_numpy(fp, "cuda"),
                       dropped=torch.zeros((), dtype=torch.int32,
                                           device="cuda"))
            for _ in range(2)]
    stream = torch.cuda.current_stream()
    for sweep_now in (now - 100, now, now + 4999, (1 << 32) - 1):
        n_k = ct.ct_gc(tabs[0], sweep_now)
        n_p = ct.ct_gc_plain(tabs[1], sweep_now)
        assert int(n_k.sum()) == int(n_p)
        assert torch.equal(tabs[0].table, tabs[1].table)
        assert torch.equal(tabs[0].fp, tabs[1].fp)
        words = kernels._STREAM_SCRATCH[(n_k.device, "ct_gc",
                                         stream.cuda_stream)]
        assert not bool(words.any())
    _one_kernel(lambda: functools.partial(
        ct.ct_gc, ct.CTTable(u32.from_numpy(table, "cuda"),
                             u32.from_numpy(fp, "cuda"),
                             torch.zeros((), dtype=torch.int32,
                                         device="cuda")), now),
        "ct_gc_kernel")


@pytest.mark.gpu
@pytest.mark.parametrize("n_shards", [1, 2, 8])
@pytest.mark.parametrize("rung", [64, 1024, "cap"])
def test_ring_gather_is_one_kernel_matching_its_plain_version(n_shards,
                                                              rung):
    """K6, one kernel and one graph node a call, against its plain
    version on the same CUDA tensors, bit-exact: each shard's window
    from slot 0, from an even and an odd slot, from the last slot (every
    window wraps there) and, over several shards, from starts even and
    odd by turns."""
    _need_card()
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts

    cap = 1 << 12
    rung = cap if rung == "cap" else rung
    rng = np.random.default_rng(n_shards * 7 + rung)
    buf = u32.from_numpy(rng.integers(0, 1 << 32, (n_shards * cap, 2),
                                      dtype=np.uint64), "cuda")
    patterns = [[0] * n_shards, [2 * int(rng.integers(1, cap // 2))]
                * n_shards, [2 * int(rng.integers(0, cap // 2)) + 1]
                * n_shards, [cap - 1] * n_shards,
                [int(rng.integers(0, cap // 2)) * 2 + (s & 1)
                 for s in range(n_shards)]]
    reset_launch_counts()
    for starts in patterns:
        got = tring.ring_gather(buf, starts, rung, cap)
        want = tring.ring_gather_plain(buf, starts, rung, cap)
        assert torch.equal(got, want), starts
    assert KERNELS["ring_gather"].launches == len(patterns)
    _one_kernel(lambda: functools.partial(
        tring.ring_gather, buf, patterns[2], rung, cap),
        "ring_gather_kernel")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["odd_rung", "buffer_off_16_bytes"])
def test_ring_gather_row_path_matches_its_plain_version(case):
    """K6's row path, a row a thread: an odd rung, and a ring buffer
    that starts 8 bytes past a 16-byte boundary, each from even and odd
    starts over 1 and 3 shards, against the plain version."""
    _need_card()
    from cilium_tpu_torch import u32

    cap, rng = 1 << 10, np.random.default_rng(len(case))
    words = u32.from_numpy(rng.integers(0, 1 << 32, (3 * cap + 1, 2),
                                        dtype=np.uint64), "cuda")
    for n_shards in (1, 3):
        buf = (words[1:1 + n_shards * cap] if case == "buffer_off_16_bytes"
               else words[:n_shards * cap])
        rung = 33 if case == "odd_rung" else 64
        for starts in ([0] * n_shards, [cap - 1] * n_shards,
                       [5 + s for s in range(n_shards)]):
            got = tring.ring_gather(buf, starts, rung, cap)
            assert torch.equal(
                got, tring.ring_gather_plain(buf, starts, rung, cap))


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [1 << 12, 1 << 16])
@pytest.mark.parametrize("occupancy", ["empty", "half", "full"])
def test_ct_occupied_is_one_kernel_matching_its_plain_version(cap,
                                                              occupancy):
    """K8, one kernel and one graph node a call with no memset or fill,
    against its plain version over successive calls on one stream: the
    whole table, shard 3's slice of 8 (a view at an offset), and a view
    from slot 3 whose length is not a multiple of 4 (no 16-byte boundary
    at either end).  The stream's scratch (the blocks' sum, the ticket
    and their counts) is zero after every call."""
    _need_card()
    from cilium_tpu_torch import kernels, u32
    from cilium_tpu_torch.datapath.loader import (_ct_occupied,
                                                  _ct_occupied_plain)

    rng = np.random.default_rng(cap + len(occupancy))
    share = {"empty": 0.0, "half": 0.5, "full": 1.0}[occupancy]
    fp = u32.from_numpy(np.where(rng.random(cap) < share,
                                 rng.integers(1, 256, cap), 0).astype(
                                     np.uint32), "cuda")
    part = cap // 8
    stream = torch.cuda.current_stream()
    for view in (fp, fp[3 * part:4 * part], fp[3:cap - 2],
                 fp[3 * part + 1:4 * part + 2]):
        for _ in range(2):
            got = _ct_occupied(view)
            assert got.shape == (1,) and got.is_cuda
            assert int(got.sum()) == int(_ct_occupied_plain(view))
            words = kernels._STREAM_SCRATCH[(got.device, "ct_occupied",
                                             stream.cuda_stream)]
            assert not bool(words.any())
    _one_kernel(lambda: functools.partial(_ct_occupied, fp),
                "ct_occupied_kernel")


@pytest.mark.gpu
def test_fingerprint_marks_the_live_slots_after_k4_and_k7():
    """The invariant K7's sweep rests on, on the card: after K4 has
    inserted flows (a window run full), refreshed them with replies and
    closed some, and after K7's sweeps, a slot's fingerprint is 0
    exactly when its state is ST_FREE."""
    _need_card()
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core import packets as pk
    from cilium_tpu_torch.datapath import conntrack as ct

    def check(c):
        table, fp = u32.to_numpy(c.table), u32.to_numpy(c.fp)
        np.testing.assert_array_equal(fp != 0,
                                      table[:, ct.V_STATE] != ct.ST_FREE)

    def step(c, hdr, now):
        th = u32.from_numpy(hdr, "cuda")
        f, r = ct.ct_keys_from_headers(th)
        res, slot, rep = ct.ct_lookup(c, f, r, now)
        n = len(hdr)
        ct.ct_update(c, ct.ct_l4_from_headers(th), f, res, slot, rep,
                     torch.ones(n, dtype=torch.bool, device="cuda"),
                     torch.zeros(n, dtype=torch.int32, device="cuda"), now)
        check(c)

    rng = np.random.default_rng(64)
    cap, n = 1 << 10, 1 << 11
    rows = np.zeros((n, pk.N_COLS), np.uint32)
    rows[:, pk.COL_SRC_IP3] = 0x0A000000 + rng.choice(1 << 20, n,
                                                      replace=False)
    rows[:, pk.COL_DST_IP3] = 0x0AC80001
    rows[:, pk.COL_SPORT] = rng.integers(1024, 60000, n)
    rows[:, pk.COL_DPORT] = 443
    rows[:, pk.COL_PROTO] = np.where(rng.random(n) < 0.8, 6, 17)
    rows[:, pk.COL_FLAGS] = pk.TCP_SYN
    rows[:, pk.COL_LEN] = 100
    rows[:, pk.COL_FAMILY] = 4
    rows[:, pk.COL_DIR] = 1
    rep = rows.copy()
    rep[:, [pk.COL_SRC_IP3, pk.COL_DST_IP3]] = rows[:, [pk.COL_DST_IP3,
                                                        pk.COL_SRC_IP3]]
    rep[:, [pk.COL_SPORT, pk.COL_DPORT]] = rows[:, [pk.COL_DPORT,
                                                    pk.COL_SPORT]]
    rep[:, pk.COL_DIR], rep[:, pk.COL_FLAGS] = 0, pk.TCP_ACK
    c = ct.CTTable.create(cap, "cuda")
    step(c, rows, 100)  # twice the table: windows run full
    assert int(c.dropped) > 0
    step(c, rep, 101)
    close = rows[::3].copy()
    close[:, pk.COL_FLAGS] = pk.TCP_FIN | pk.TCP_ACK
    step(c, close, 102)
    for now in (100 + ct.LIFETIME_CLOSE + 1, 100 + ct.LIFETIME_SYN + 1,
                1 << 31):
        ct.ct_gc(c, now)
        check(c)
    step(c, rows[: cap // 2], 1 << 31)
    assert int((c.fp != 0).sum()) > 0


@pytest.mark.gpu
def test_superbatch_and_daemon_on_the_card_match_the_cpu():
    """A packed superbatch through the kernels equals sequential
    serve_packed calls; the daemon's ingress path on the card (pinned
    staging, gather, asynchronous drain) gives the CPU daemon's events,
    metrics and ledger."""
    _need_card()
    from cilium_tpu_torch.agent import Daemon, DaemonConfig
    from cilium_tpu_torch.core.packets import COL_DST_IP3, COL_EP
    from cilium_tpu_torch.labels import LabelSet

    w = tfix.build_world(256, 8, ct_capacity=1 << 12, device="cpu")
    rng = np.random.default_rng(6)
    pool = tfix.steady_flow_pool(w, 512, rng)
    steps = [pool, tfix.steady_traffic(pool, 512, rng),
             tfix.bench_traffic(w, 512, rng), pool]
    packed = np.stack([pack_rows(h) for h in steps])
    valid = np.ones((4, 512), bool)
    valid[2] = rng.random(512) < 0.5
    valid[3] = False
    zeros = np.zeros(4, np.uint32)
    loaders = [TorchLoader(ct_capacity=1 << 12, device="cuda")
               for _ in range(2)]
    rings = [tring.EventRing.create(1 << 12, device="cuda") for _ in "ab"]
    for l in loaders:
        l.attach(w.policies, w.ipcache, {0: 0}, w.row_map)
    rings[0], _ = loaders[0].serve_superbatch(
        rings[0], packed, 100, 7, eps=zeros, dirns=zeros, valid=valid,
        packed=True)
    for k in range(4):
        rings[1], _ = loaders[1].serve_packed(rings[1], packed[k], 100,
                                              7 + k, 0, 0, valid=valid[k])
    assert torch.equal(rings[0].buf, rings[1].buf)
    assert torch.equal(rings[0].cursor, rings[1].cursor)
    np.testing.assert_array_equal(loaders[0].metrics(), loaders[1].metrics())
    np.testing.assert_array_equal(loaders[0].ct_snapshot(),
                                  loaders[1].ct_snapshot())

    rules = tfix.world_rules(256, 8)
    rules[-1] = dict(rules[-1], ingress=rules[-1]["ingress"][:2])  # no L7
    rows = np.concatenate([pool] + [tfix.steady_traffic(pool, 512, rng)
                                    for _ in range(7)])
    results = []
    for dev in ("cuda", "cpu"):
        d = Daemon(DaemonConfig(ct_capacity=1 << 12,
                                serving_bucket_ladder=(256, 1024),
                                serving_queue_depth=1 << 14),
                   device=dev)
        for i, ip in enumerate(w.pod_ips):
            ident = d.allocator.allocate(LabelSet.parse(
                f"k8s:app=svc{i}", "k8s:ns=default"))
            d.ipcache.upsert(ip + "/32", ident.numeric_id)
        d.policy_import(rules)
        db = d.add_endpoint("db", ("10.0.0.5",), ["k8s:app=db"])
        got = []
        d.monitor.register("test", got.append)
        d.start_serving(ingress=True, packed=True, superbatch_k=2,
                        ring_capacity=1 << 12)
        r = rows.copy()
        r[:, COL_EP] = db.id
        r[:, COL_DST_IP3] = 0x0A000005
        d.submit(r)
        out = d.stop_serving()
        fe = out["front-end"]
        assert fe["submitted"] == fe["verdicts"] == len(r)
        results.append((out["events"], out["lost"], d.loader.metrics(),
                        sum(len(b) for b in got)))
        d.shutdown()
    (ek, lk, mk, nk), (ep_, lp, mp, np_) = results
    assert (ek, lk, nk) == (ep_, lp, np_) and ek > 0 and lk == 0
    np.testing.assert_array_equal(mk, mp)


def _l7_world(rng, n, n_rules, k):
    """Rules and requests drawn from small value pools (every field
    both matches and misses), prefix rules with both flags, and
    rolling prefix hashes that hit some prefix rules."""
    from cilium_tpu_torch.proxy.l7policy import KIND_HTTP_PREFIX

    hashes = np.array([[0, 0], [1, 0x80000000], [0xDEADBEEF, 7],
                       [0xFFFFFFFF, 0xFFFFFFFF]], np.uint32)
    lens = np.sort(rng.choice(np.arange(1, 49), k, replace=False))
    rules = np.zeros((n_rules, 7), np.uint32)
    rules[:, 0] = rng.choice(np.array([10000, 10001], np.uint32), n_rules)
    rules[:, 1] = rng.choice(np.array([0, 1, 2, 3, 16], np.uint32), n_rules)
    rules[:, 2] = rng.choice(np.array([0, 1, 2], np.uint32), n_rules)
    pre = rules[:, 1] == KIND_HTTP_PREFIX
    plen = rng.choice(np.concatenate([lens, lens - 1]), n_rules)
    rules[pre, 2] |= ((plen[pre].astype(np.uint32) << 8)
                      | (rng.integers(0, 2, int(pre.sum())).astype(np.uint32)
                         << 16))
    rules[:, 3:5] = hashes[rng.integers(0, 4, n_rules)]
    rules[:, 5:7] = hashes[rng.integers(0, 4, n_rules)]
    rows = np.zeros((n, 8), np.uint32)
    rows[:, 0] = rng.choice(np.array([10000, 10001], np.uint32), n)
    rows[:, 1] = rng.choice(np.array([0, 1, 2, 16], np.uint32), n)
    rows[:, 2] = rng.choice(np.array([0, 1, 2], np.uint32), n)
    rows[:, 3:5] = hashes[rng.integers(0, 4, n)]
    rows[:, 5:7] = hashes[rng.integers(0, 4, n)]
    pref = hashes[rng.integers(0, 4, (n, k))]
    pref[rng.random((n, k)) < 0.3] = 0
    return rules, rows, pref, lens.astype(np.int32)


def _l7_edge_cases(rng):
    """K9's warp-a-request edges: {name: (rules, rows, pref, lens, the
    admitted count)}.  A hit only at the last lane of a later 32-rule
    pass (and of a later 256-rule tile), and at the last lane of a table
    of one pass (read from global memory) and the first of a table of
    two (staged); prefix and ".+" rules deciding alone, in a staged table
    and in one of one pass; one request against one rule; request counts
    that are not a multiple of a block's 8, and of thousands of blocks; a
    prefix tensor too wide for 48 KB of shared memory a block."""
    from cilium_tpu_torch.proxy.l7policy import KIND_HTTP_PREFIX

    def table(n_rules, hit_at):
        # GETs (method 1) on port 10001, but rule hit_at on port 10000: a
        # request on 10000 hits there only, one on 10002 nowhere
        rules = np.zeros((n_rules, 7), np.uint32)
        rules[:, 0] = 10001
        rules[:, 2] = 1
        rules[hit_at, 0] = 10000
        return rules

    def requests(n, k):
        rows = np.zeros((n, 8), np.uint32)
        rows[:, 0] = rng.choice(np.array([10000, 10001, 10002], np.uint32),
                                n, p=[0.6, 0.3, 0.1])
        rows[0, 0] = 10000
        rows[:, 2] = 1
        rows[:, 7] = np.arange(n)
        return rows, np.zeros((n, k, 2), np.uint32)

    cases = {}
    lens = np.array([4, 5], np.int32)
    for name, n, n_rules, hit_at in (("last-lane-pass-3", 1003, 96, 95),
                                     ("last-lane-tile-2", 517, 600, 319),
                                     ("one-by-one", 1, 1, 0),
                                     ("one-pass-last-lane", 301, 32, 31),
                                     ("two-pass-first-rule", 299, 33, 32),
                                     ("many-blocks", 20000, 40, 39),
                                     ("many-blocks-tiles", 9001, 300, 290)):
        rows, pref = requests(n, 2)
        admitted = (rows[:, 0] == 10000).sum() + (
            (rows[:, 0] == 10001).sum() if n_rules > 1 else 0)
        cases[name] = (table(n_rules, hit_at), rows, pref, lens,
                       int(admitted))
    # prefix rules decide: literal rules that match nothing (64: a staged
    # table; 4: one pass), then a ".+" prefix rule (length 4, hash A:
    # needs a non-zero hash at length 5) and a plain prefix rule (length
    # 5, hash B)
    for name, n_lit in (("prefix-and-dot-plus", 64),
                        ("prefix-and-dot-plus-one-pass", 4)):
        n = 777
        rules = np.zeros((n_lit + 2, 7), np.uint32)
        rules[:, 0] = 10000
        rules[:n_lit, 3:5] = [5, 5]  # a literal path no request has
        rules[n_lit, 1] = rules[n_lit + 1, 1] = KIND_HTTP_PREFIX
        rules[n_lit, 2] = (4 << 8) | (1 << 16)
        rules[n_lit, 3:5] = [0xA, 0xA]
        rules[n_lit + 1, 2] = 5 << 8
        rules[n_lit + 1, 3:5] = [0xB, 0xB]
        rows, pref = requests(n, 2)
        rows[:, 0] = 10000
        rows[:, 3:5] = [7, 7]
        pick = rng.integers(0, 4, n)
        pref[pick == 0, 0] = [0xA, 0xA]  # ".+" and something further: hit
        pref[pick == 0, 1] = [3, 0]
        pref[pick == 1, 0] = [0xA, 0xA]  # ".+" with nothing further: miss
        pref[pick == 2, 1] = [0xB, 0xB]  # the plain prefix rule: hit
        cases[name] = (rules, rows, pref, lens,
                       int((pick == 0).sum() + (pick == 2).sum()))
    # K = 800 prefix columns: 8 warps x 1600 words past 48 KB a block
    k = 800
    rules = np.zeros((3, 7), np.uint32)
    rules[:, 0] = 10000
    rules[:, 1] = KIND_HTTP_PREFIX
    rules[:, 2] = np.array([700, 10, 255], np.uint32) << 8
    rules[:, 3:5] = [[1, 2], [3, 4], [5, 6]]
    rows, pref = requests(50, k)
    rows[:, 0] = 10000
    pref[::2, 254] = [5, 6]  # column of length 255 (lens 1 .. 800)
    cases["wide-prefix-tensor"] = (rules, rows, pref,
                                   np.arange(1, k + 1, dtype=np.int32), 25)
    return cases


@pytest.mark.gpu
def test_l7_verdict_kernel_and_proxy_match_plain_on_the_card():
    """K9 against l7_verdict_plain on CUDA tensors (one tile and three,
    with and without a prefix tensor, no rules; the warp-a-request edges
    of ``_l7_edge_cases``), and L7Proxy on the card against L7Proxy on
    the CPU."""
    _need_card()
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts
    from cilium_tpu_torch.policy.api import L7Rules
    from cilium_tpu_torch.proxy import L7Proxy
    from cilium_tpu_torch.proxy.l7policy import l7_verdict, l7_verdict_plain

    rng = np.random.default_rng(9)
    reset_launch_counts()
    for n, n_rules, k in ((1000, 40, 6), (333, 700, 3)):
        rules, rows, pref, lens = _l7_world(rng, n, n_rules, k)
        if n_rules > 512:  # no request's port: hits only past tile 2
            rules[:512, 0] = 10002
        t = [u32.from_numpy(a, "cuda") for a in (rules, rows, pref)]
        tl = torch.from_numpy(lens).cuda()
        for p, pl in ((t[2], tl), (t[2], None), (None, None)):
            got = l7_verdict(t[0], t[1], p, pl)
            want = l7_verdict_plain(t[0], t[1], p, pl)
            assert torch.equal(got, want)
            assert 0 < int(want.sum()) < n
    assert not l7_verdict(t[0][:0], t[1]).any()
    assert KERNELS["l7_verdict"].launches == 6

    edges = _l7_edge_cases(rng)
    for name, (rules, rows, pref, lens, admitted) in edges.items():
        t = [u32.from_numpy(a, "cuda") for a in (rules, rows, pref)]
        tl = torch.from_numpy(lens).cuda()
        got = l7_verdict(t[0], t[1], t[2], tl)
        want = l7_verdict_plain(t[0], t[1], t[2], tl)
        assert torch.equal(got, want), name
        assert int(got.sum()) == admitted, name
    assert KERNELS["l7_verdict"].launches == 6 + len(edges)

    http = [{"method": ("GET", "POST")[i % 2], "path": f"/api/r{i}"}
            for i in range(200)] + [
        {"method": "GET", "path": f"/static/{i}/.*"} for i in range(8)] + [
        {"method": "GET", "path": "/legacy/[a-z]+"}]
    pol = type("P", (), {"redirects": [(10000, "r", L7Rules.from_dict(
        {"http": http}))]})()
    reqs = []
    for i in range(2048):
        j = int(rng.integers(0, 220))
        reqs.append({"method": "GET" if j % 2 == 0 else "POST",
                     "path": (f"/api/r{j}" if j < 200 else
                              f"/static/{j % 9}/x.js" if j < 215 else
                              "/legacy/abc"), "host": "db.svc"})
    proxies = [L7Proxy(), L7Proxy(device="cpu")]
    for p in proxies:
        p.update([pol])
    reset_launch_counts()
    got, want = (p.handle_http(10000, reqs) for p in proxies)
    np.testing.assert_array_equal(got, want)
    assert KERNELS["l7_verdict"].launches == 1
    for c in ("requests_total", "requests_denied", "host_fallback_checked",
              "host_fallback_allowed"):
        assert getattr(proxies[0], c) == getattr(proxies[1], c), c


# K10's shapes on the patch paths (config #3 widths cut to 2 policies and
# 1024 rows) and the start rule's edges
DUS_CASES = {
    "verdict-row": ((2, 2, 1024, 256), (2, 2, 1, 256), (0, 0, 517, 0)),
    "auth-column": ((2, 1024), (2, 1), (0, 1023)),
    "l1-cell": ((1 << 16,), (1,), (40961,)),
    "l3-row": ((40, 256), (1, 256), (39, 0)),
    "clamp-past-edge": ((2, 2, 1024, 256), (2, 2, 1, 256), (5, 9, 4096, 3)),
    "clamp-negative": ((40, 256), (3, 256), (-2, -300)),
    # the copy's paths: 16-byte vectors over one long run, a misaligned
    # start (word by word), many runs of 1 (more than a block's rows),
    # rank-1 tables, runs over the grid's y and z
    "vector-run": ((40, 256), (3, 256), (4, 0)),
    "misaligned-start": ((40, 256), (1, 100), (3, 5)),
    "runs-of-1": ((300, 64), (300, 1), (0, 7)),
    "rank-1-vector": ((1 << 16,), (300,), (65100,)),
    "rank-1-words": ((1000,), (37,), (5,)),
    "rank-4-grid-y": ((4, 5, 6, 8), (2, 3, 2, 8), (1, 1, 3, 0)),
    "rank-4-grid-z": ((4, 5, 6, 8), (2, 3, 4, 1), (0, 2, 1, 7)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(DUS_CASES))
def test_dus_kernel_matches_its_plain_version(case):
    """K10 against ``_dus_plain`` on the same CUDA tensors, bit-exact,
    in place, one launch each."""
    _need_card()
    from cilium_tpu_torch.datapath.loader import _dus, _dus_plain
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts

    dst_shape, upd_shape, starts = DUS_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(len(case))
    dst = torch.randint(-2**31, 2**31 - 1, dst_shape, dtype=torch.int32,
                        device="cuda", generator=g)
    upd = torch.randint(-2**31, 2**31 - 1, upd_shape, dtype=torch.int32,
                        device="cuda", generator=g)
    want = _dus_plain(dst.clone(), upd, starts)
    reset_launch_counts()
    got = dst.clone()
    assert _dus(got, upd, starts) is got
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert KERNELS["dus"].launches == 1


@pytest.mark.gpu
def test_a_patch_from_another_stream_lands_in_serve_order():
    """An FQDN mint patches from an L7 worker that runs inside the
    proxy's stream.  Here a thread inside a side stream patches a /32
    between two ``serve_packed`` batches that wait behind a spin on the
    serving stream: the patch must land after the first batch and
    before the second, so the card's rings equal the CPU's, and differ
    from a run without the patch."""
    _need_card()
    import contextlib
    import threading

    from cilium_tpu_torch.core.packets import COL_SRC_IP3, ip_to_words
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts

    w = tfix.build_world(256, 8, ct_capacity=1 << 12, n_v6=16,
                         device="cpu")
    rng = np.random.default_rng(6)
    hdr = tfix.bench_traffic(w, 512, rng)
    hdr[:, COL_SRC_IP3] = ip_to_words(w.pod_ips[0])[3]
    packed = pack_rows(hdr)
    target = w.ipcache[w.pod_ips[1] + "/32"]
    drained = []
    for dev, patch in (("cuda", True), ("cpu", True), ("cpu", False)):
        loader = TorchLoader(ct_capacity=1 << 12, device=dev)
        loader.attach(w.policies, dict(w.ipcache), {0: 0}, w.row_map)
        ring = tring.EventRing.create(1 << 12, device=loader.device)
        rows = torch.from_numpy(packed.view(np.int32)).to(dev)
        side = torch.cuda.Stream() if dev == "cuda" else None
        reset_launch_counts()
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda._sleep(200_000_000)  # the serving stream is busy
        ring, _ = loader.serve_packed(ring, rows, 100, 0, 0, 0,
                                      trace_sample=1)

        def do_patch():
            with (torch.cuda.stream(side) if side is not None
                  else contextlib.nullcontext()):
                assert loader.patch_ipcache(w.pod_ips[0] + "/32", target)

        if patch:
            t = threading.Thread(target=do_patch)
            t.start()
            t.join(timeout=60)
            assert not t.is_alive()
        ring, _ = loader.serve_packed(ring, rows, 101, 1, 0, 0,
                                      trace_sample=1)
        drained.append(tring.ring_drain(ring)[0])
        if dev == "cuda":
            assert KERNELS["dus"].launches >= 1
    np.testing.assert_array_equal(drained[0], drained[1])
    assert not np.array_equal(drained[1], drained[2])


def _nat_inputs(rng, cap, now, n=4096, ct_cap=1 << 14):
    """Egress rows over one pool: mixed traffic, a crafted collision
    window, duplicates, pods' replies to live inbound connections (whose
    CT entries the returned table holds)."""
    from cilium_tpu_torch.testing import egress as eg

    pods = eg.pod_ips(64)
    inbound, replies = eg.inbound_pairs(rng, 256, pods)
    rows = np.concatenate([eg.colliding_rows(12, cap, 5),
                           replies, eg.egress_rows(rng, n - 268, pods)])
    return rows, eg.inbound_ct(inbound, now, ct_cap)


def _card_nat(rng, cap, now, rules=()):
    """(kernel table, plain table, NAT tensors, CT) on the card."""
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.datapath import conntrack as ct
    from cilium_tpu_torch.service import nat
    from cilium_tpu_torch.testing import egress as eg

    rows, (table, fp) = _nat_inputs(rng, cap, now)
    cfg = nat.NATConfig(node_ip=eg.NODE_IP, egress_rules=rules)
    cttab = ct.CTTable(table=u32.from_numpy(table, "cuda"),
                       fp=u32.from_numpy(fp, "cuda"),
                       dropped=torch.zeros((), dtype=torch.int32,
                                           device="cuda"))
    return ([nat.NATTable.create(cap, "cuda") for _ in range(2)],
            cfg.compile("cuda"), cttab, rows)


def _same_nat(tabs):
    assert torch.equal(tabs[0].table, tabs[1].table)
    assert torch.equal(tabs[0].failed, tabs[1].failed)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["snat_egress", "snat_reverse", "bw_stage",
                                  "masq_rewrite"])
def test_egress_kernels_match_their_plain_versions(case):
    """K11-K14 on the card against their plain versions on the same CUDA
    tensors (state fed as clones), over successive calls: crafted
    collision windows, duplicates, an exhausted 2^8 pool, replies to
    live inbound connections, forged protocol words, and clocks near
    2^32."""
    _need_card()
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.datapath import bandwidth as bw
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts
    from cilium_tpu_torch.service import nat
    from cilium_tpu_torch.testing import egress as eg

    rng = np.random.default_rng(21)
    reset_launch_counts()
    # the rule table phase 11's gateway compiles to: one rule per pod,
    # with overlapping rules ahead and behind (first match wins)
    rules = eg.gateway_rules(eg.pod_ips(64))
    if case in ("snat_egress", "snat_reverse"):
        for cap, now in ((1 << 8, 100), (1 << 12, (1 << 32) - 90)):
            tabs, t, cttab, rows = _card_nat(rng, cap, now, rules)
            for step in range(3):
                hdr = u32.from_numpy(rows, "cuda")
                t_now = (now + 100 * step) & 0xFFFFFFFF
                got = nat.snat_egress(tabs[0], t, cttab, hdr, t_now)
                want = nat.snat_egress_plain(tabs[1], t, cttab, hdr, t_now)
                assert torch.equal(got[0], want[0])
                assert torch.equal(got[2], want[2])
                _same_nat(tabs)
                assert bool((tabs[0].claim == nat.CLAIM_FREE).all())
                if case == "snat_reverse":
                    rep = u32.from_numpy(eg.reply_rows(
                        rng, u32.to_numpy(got[0]), 4096), "cuda")
                    g = nat.snat_reverse(tabs[0], t, rep, t_now + 1)
                    w = nat.snat_reverse_plain(tabs[1], t, rep, t_now + 1)
                    assert torch.equal(g[0], w[0])
                    _same_nat(tabs)
                    assert bool((tabs[0].claim == nat.CLAIM_FREE).all())
                rows = np.concatenate([rows[::3], eg.egress_rows(
                    rng, len(rows) - len(rows[::3]), eg.pod_ips(64))])
            if cap == 1 << 8:
                assert int(tabs[0].failed) > 0  # the pool ran dry
    elif case == "bw_stage":
        limits = {1: 16_000, 2: 0x7FFFFFFF, 7: 90_000, 4095: 1_000}
        rates = u32.from_numpy(bw.rates_array(limits), "cuda")
        states = [bw.BandwidthState.create("cuda") for _ in range(2)]
        for now in (10, 10, 11, 5000, (1 << 32) - 1, 2):
            hdr = u32.from_numpy(eg.bw_rows(rng, 4096, [1, 2, 3, 7, 4095,
                                                        9000]), "cuda")
            got = bw.bw_stage(states[0], hdr, now, rates)
            want = bw.bw_stage_plain(states[1], hdr, now, rates)
            assert torch.equal(got, want)
            assert torch.equal(states[0].tokens, states[1].tokens)
            assert torch.equal(states[0].last, states[1].last)
    else:
        _tabs, t, cttab, rows = _card_nat(rng, 1 << 8, 100)
        hdr = u32.from_numpy(rows, "cuda")
        for ct_arg in (cttab, None):
            got = nat.masq_rewrite(t, hdr, ct_arg, 100)
            want = nat.masq_rewrite_plain(t, hdr, ct_arg, 100)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
    torch.cuda.synchronize()
    assert KERNELS[case].launches > 0


MASQ_CASES = ("overflow", "wrap", "expired", "clock_near_2^32",
              "no_exclusions", "four_exclusions", "unaligned", "n0", "n1")


def _masq_case(case, rng, cap=1 << 12, n=1024):
    """K14's edges at a small size: (non-masquerade CIDRs, rows, (CT
    table, fingerprints), now, words the rows sit past a 16-byte
    boundary).  Replies to inbound connections among egress rows (some
    toward 172.16.0.0/12 and 100.64.0.0/10), the connections' entries
    crowded by ``testing.egress.crowded_ct``: every one behind N_CAND + 1
    or more live entries of its fingerprint (found, expired or absent),
    or ("wrap") homing in the CT's last slots; "expired" probes past
    every expiry, "clock_near_2^32" at 2^32 - 150 a table whose live
    entries expire at 2^32 - 100."""
    from cilium_tpu_torch.core.packets import COL_DST_IP3
    from cilium_tpu_torch.testing import egress as eg

    pods = eg.pod_ips(64)
    now = (1 << 32) - 150 if case == "clock_near_2^32" else 1000
    if case == "wrap":
        inbound = eg.wrap_inbound(rng, 16, pods, cap)
        replies = np.repeat(eg.replies_to(inbound), 4, 0)
    else:
        inbound, replies = eg.inbound_pairs(rng, 128, pods)
    made = now - 950 if case == "clock_near_2^32" else now
    ct = eg.crowded_ct(rng, inbound, made, cap,
                       crowded=0.3 if case == "wrap" else 1.0)
    mix = eg.egress_rows(rng, n - len(replies), pods)
    mix[::7, COL_DST_IP3] = eg.ip("172.16.5.5")
    mix[::11, COL_DST_IP3] = eg.ip("100.64.1.1")
    rows = np.concatenate([replies, mix])[rng.permutation(n)]
    cidrs = {"no_exclusions": (),
             "four_exclusions": ("10.0.0.0/8", "172.16.0.0/12",
                                 "192.168.0.0/16", "100.64.0.0/10")}.get(
                                     case, ("10.0.0.0/8",))
    rows = {"n0": rows[:0], "n1": replies[:1]}.get(case, rows)
    return (cidrs, rows, ct, now + 1001 if case == "expired" else now,
            1 if case == "unaligned" else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", MASQ_CASES)
def test_masq_rewrite_is_one_kernel_matching_its_plain_version(case):
    """K14 on its edges, with its CT probe and without it: reverse entries
    behind more than N_CAND live entries of their fingerprint (the
    full-window fallback), windows wrapping the CT's end, expired
    entries, a clock near 2^32, no and four non-masquerade networks,
    rows off a 16-byte boundary, n = 0 and 1.  Rows and mask equal the
    plain version's; one graph node a call (n = 0 launches nothing, and
    an empty capture cannot be read)."""
    _need_card()
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.datapath import conntrack as ct
    from cilium_tpu_torch.service import nat
    from cilium_tpu_torch.testing import egress as eg
    from cilium_tpu_torch.testing.capture import ops_a_call

    cidrs, rows, (table, fp), now, offset = _masq_case(
        case, np.random.default_rng(23))
    t = nat.NATConfig(node_ip=eg.NODE_IP,
                      non_masquerade_cidrs=cidrs).compile("cuda")
    cttab = ct.CTTable(table=u32.from_numpy(table, "cuda"),
                       fp=u32.from_numpy(fp, "cuda"),
                       dropped=torch.zeros((), dtype=torch.int32,
                                           device="cuda"))
    hdr = u32.from_numpy(rows, "cuda")
    if offset:
        buf = torch.empty(hdr.numel() + offset, dtype=hdr.dtype,
                          device="cuda")
        buf[offset:] = hdr.reshape(-1)
        hdr = buf[offset:].view(hdr.shape)
        assert hdr.data_ptr() % 16
    for ct_arg in (cttab, None):
        got = nat.masq_rewrite(t, hdr, ct_arg, now)
        want = nat.masq_rewrite_plain(t, hdr, ct_arg, now)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
        if len(rows):
            ops = ops_a_call(lambda ct_arg=ct_arg: functools.partial(
                nat.masq_rewrite, t, hdr, ct_arg, now))
            assert list(ops.values()) == [1]
            assert "masq_kernel" in next(iter(ops))


def _lb_world(n=512, n_v6=64, m=4093):
    """A mid-size service world on the card, through ServiceWatcher: 512
    services (a 16th with ClientIP affinity, 8 with no backend, the
    first 64 dual-stack), Maglev tables of 4093 slots."""
    from cilium_tpu_torch.k8s.watchers import ServiceWatcher
    from cilium_tpu_torch.service import ServiceManager
    from cilium_tpu_torch.testing import services as sv

    pods = [f"10.1.{i // 250}.{i % 250 + 1}" for i in range(700)]
    pods6 = [f"2001:db8::{i + 1:x}" for i in range(n_v6)]
    mgr = ServiceManager(m=m, device="cuda")
    sv.install(ServiceWatcher(mgr), sv.k8s_objects(
        pods, pods6, n=n, n_v6=n_v6, n_empty=8))
    clients = (0x0A000000 + np.arange(1, 97)).astype(np.uint32)
    others = np.array([0x0A010001 + i for i in range(600)], np.uint32)
    return mgr, clients, others


def _lpm_case(case, rng, n):
    """K2's inputs at a small size: (LPM tensors on the card, [n, 4]
    words, [n] families).  "mixed": 20% v6 on 16 /128 pods (30% of them
    outside 2001:db8::/32, only ::/0 holds them), the rest v4 on /32
    pods or random; "all-v4", "all-v6"; "big-tcam": 1024 /128s, 64 /64s
    and 16 /48s with misses inside each; "no-v6-table": the v6 rows all
    take the default; "hand-built": non-prefix masks, a net with bits
    outside its mask, a plen of -1, a key under two plens and two masks
    of one top plen; "many-groups": every prefix length 0-128 (more
    masks than a block stages)."""
    import ipaddress

    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import ip_to_words
    from cilium_tpu_torch.datapath.lpm import (DeviceLPM, LPMTensors,
                                               compile_lpm)

    pods = [f"10.0.{i // 250}.{i % 250 + 1}" for i in range(512)]
    ent = {f"{p}/32": 10 + i for i, p in enumerate(pods)}
    ent["10.0.0.0/8"] = 3
    v6 = [f"2001:db8::{i + 1:x}" for i in range(16)]
    if case == "big-tcam":
        v6 = [f"2001:db8:{i % 16:x}:{i % 64 + 1:x}::{i + 1:x}"
              for i in range(1024)]
        for k in range(16):
            ent[f"2001:db8:{k:x}::/48"] = 900 + k
        for j in range(64):
            ent[f"2001:db8:{j % 16:x}:{j + 1:x}::/64"] = 950 + j
    if case == "many-groups":
        for p in range(1, 128):
            net = ipaddress.ip_network(f"2001:db8::1/{p}", strict=False)
            ent[str(net)] = 1000 + p
    if case != "no-v6-table":
        ent.update({f"{a}/128": 600 + i for i, a in enumerate(v6)})
        ent["::/0"] = 2
    if case == "hand-built":
        f = 0xFFFFFFFF
        lt = compile_lpm(ent)
        extra = [([0x20010DB8, 0, 0, 7], [f, 0, 0, 0xF], 71, 100),
                 ([0x20010DB8, 0, 1, 0], [f, 0, 0, 0], 72, 128),
                 ([0x20010DB8, 0, 0, 0], [f, 0, 0, 0], 73, -1),
                 ([0x20010DB8, 0, 0, 0], [f, 0xFFFF0000, 0, 0], 74, 120),
                 ([0x20010DB8, 0, 0, 0], [f, 0, 0, 0], 75, 120),
                 ([0x20010DB8, 0, 0, 0], [f, 0, 0, 0], 76, 120)]
        net, mask, value, plen = zip(*extra)
        lt = LPMTensors(
            l1=lt.l1, l2=lt.l2, l3=lt.l3,
            v6_net=np.concatenate([np.array(net, np.uint32), lt.v6_net]),
            v6_mask=np.concatenate([np.array(mask, np.uint32),
                                    lt.v6_mask]),
            v6_value=np.concatenate([np.array(value, np.int32),
                                     lt.v6_value]),
            v6_plen=np.concatenate([np.array(plen, np.int32), lt.v6_plen]),
            default=lt.default)
    else:
        lt = compile_lpm(ent, default=1)
    words = np.zeros((n, 4), np.uint32)
    words[:, 3] = np.where(
        rng.random(n) < 0.7,
        rng.choice([int(ipaddress.IPv4Address(p)) for p in pods], n),
        rng.integers(0, 1 << 32, n, dtype=np.uint64))
    frac = {"all-v4": 0.0, "all-v6": 1.0}.get(case, 0.2)
    six = rng.random(n) < frac
    v6w = np.array([ip_to_words(a) for a in v6], np.uint32)
    words[six] = v6w[rng.integers(0, len(v6w), int(six.sum()))]
    miss = six & (rng.random(n) < 0.3)
    words[miss, 3] ^= rng.integers(1, 1 << 32, int(miss.sum()),
                                   dtype=np.uint64).astype(np.uint32)
    words[miss & (rng.random(n) < 0.3), 0] = 0x20020000
    words[miss & (rng.random(n) < 0.3), 1] ^= 0x00100000
    fam = np.where(six, 6, 4).astype(np.uint32)
    return (DeviceLPM.from_tensors(lt, "cuda"), u32.from_numpy(words, "cuda"),
            u32.from_numpy(fam, "cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["mixed", "all-v4", "all-v6", "big-tcam",
                                  "no-v6-table", "hand-built",
                                  "many-groups"])
def test_lpm_lookup_is_one_kernel_matching_its_plain_version(case):
    """K2, one kernel and one graph node a call, through the host-built
    v6 index, against its plain version (the TCAM scan) on the same CUDA
    tensors at 1, 300 and 2^14 addresses: the step-0 cases at a small
    size, hand-built masks and more masks than a block stages in shared
    memory."""
    _need_card()
    from cilium_tpu_torch.datapath.lpm import lpm_lookup, lpm_lookup_plain
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts

    rng = np.random.default_rng(67)
    reset_launch_counts()
    for n in (1, 300, 1 << 14):
        t, w, f = _lpm_case(case, rng, n)
        got, want = lpm_lookup(t, w, f), lpm_lookup_plain(t, w, f)
        assert torch.equal(got, want), n
    if case == "no-v6-table":
        assert t.v6_groups.shape[0] == 0
        assert bool((got[f == 6] == t.default).all())
    if case == "many-groups":
        assert t.v6_groups.shape[0] > 64
    assert KERNELS["lpm_lookup"].launches == 3
    _one_kernel(lambda: functools.partial(lpm_lookup, t, w, f),
                "lpm_lookup_kernel")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["lb_stage", "lb6_stage", "socklb_stage"])
def test_lb_kernels_match_their_plain_versions(case):
    """K15-K17 on the card against their plain versions on the same CUDA
    tensors: duplicate frontends, wrong ports and protocols, empty
    backend sets, v4 and v6 rows mixed; for K17 a threaded sequence
    (connect batches, a steady batch, a burst over CONNECT_CAP, a
    forced fingerprint overflow, a backend change, affinity pins and
    their expiry, clocks across 2^32) and a full table, the flow table,
    fingerprints and pins compared word for word after every batch."""
    _need_card()
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts
    from cilium_tpu_torch.service import (lb6_stage, lb6_stage_plain,
                                          lb_stage, lb_stage_plain)
    from cilium_tpu_torch.service import socklb as sl
    from cilium_tpu_torch.testing import services as sv

    rng = np.random.default_rng(23)
    mgr, clients, others = _lb_world()
    reset_launch_counts()
    if case in ("lb_stage", "lb6_stage"):
        # a second name on an existing VIP:port: the lower name wins
        mgr.upsert("a-dup", f"{sv.vip4(3)}:443", ["10.9.9.9:1"])
        kernel, plain, t = ((lb_stage, lb_stage_plain, mgr.tensors())
                            if case == "lb_stage" else
                            (lb6_stage, lb6_stage_plain, mgr.tensors6()))
        # K15 also on batches with no row to a VIP, with every row to one
        # and with every row to the VIP:port two names share
        batches = [(n, 0.5) for n in (1, 300, 8192)] + (
            [(8192, 0.0), (8192, 1.0), (8192, "shared")]
            if case == "lb_stage" else [])
        for n, vip_frac in batches:
            rows = sv.rows(rng, n, 512, clients, others,
                           vip_frac=1.0 if vip_frac == "shared" else vip_frac,
                           v6_frac=0.3 if vip_frac == 0.5 else 0.0,
                           n_v6=64)
            if vip_frac == "shared":
                rows[:, 7], rows[:, 9], rows[:, 10] = sv.VIP4 + 3, 443, 6
            rows[: n // 8, 3] |= 0x80000000  # sources above 2^31
            hdr = u32.from_numpy(rows, "cuda")
            got = kernel(t, hdr)
            for g, w in zip(got, plain(t, hdr)):
                assert torch.equal(g, w), (n, vip_frac)
            if vip_frac == "shared":  # one frontend's backends for all
                assert bool(got[1].all())
                assert len(set(got[0][:, 7].tolist())) <= 2
        if case == "lb_stage":
            _one_kernel(lambda: functools.partial(lb_stage, t, hdr),
                        "lb_stage_kernel")
    else:
        def clone(tbl):
            return sl.SockLBTable(tbl.table.clone(), tbl.fp.clone(),
                                  tbl.aff.clone())

        for cap, aff_cap, n in ((1 << 14, 1 << 12, sl.CONNECT_CAP + 512),
                                (1 << 6, 1 << 4, 512)):
            tabs = [sl.SockLBTable.create(cap, aff_cap, device="cuda")]
            tabs.append(clone(tabs[0]))
            steps = sv.socklb_steps(rng, 512, clients, others, n,
                                    connect=min(4096, n), n_connect=2,
                                    n_v6=64)
            for label, rows, now, ovf in steps:
                if label == "backend-change":
                    for i in range(0, 512, 2):
                        svc = mgr.get(f"default/svc{i}:{sv.port_proto(i)[0]}")
                        if svc is not None and len(svc.backends) > 1:
                            mgr.upsert(svc.name, f"{svc.frontend_ip}:"
                                       f"{svc.frontend_port}",
                                       [b.key for b in svc.backends[1:]],
                                       protocol=svc.protocol,
                                       affinity_timeout=svc.affinity_timeout)
                    for tb in tabs:
                        tb.prune_affinity(mgr.backend_set())
                if ovf >= 0:
                    fp = sv.force_overflow(u32.to_numpy(tabs[0].fp), rows[ovf])
                    for tb in tabs:
                        tb.fp.copy_(u32.from_numpy(fp, "cuda"))
                hdr = u32.from_numpy(rows, "cuda")
                t = mgr.tensors()
                got = sl.socklb_stage(tabs[0], t, hdr, now)
                want = sl.socklb_stage_plain(tabs[1], t, hdr, now)
                for g, w in zip(got[:3], want[:3]):
                    assert torch.equal(g, w), label
                for f in ("table", "fp", "aff"):
                    assert torch.equal(getattr(tabs[0], f),
                                       getattr(tabs[1], f)), (label, f)
                for f in ("claim", "aclaim"):
                    assert bool((getattr(tabs[0], f)
                                 == sl.CLAIM_FREE).all()), (label, f)
    torch.cuda.synchronize()
    assert KERNELS[case].launches > 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["empty", "one-row", "wide", "one-endpoint",
                                  "clamped", "drained-then-empty",
                                  "past-registers"])
def test_bw_stage_is_one_launch_matching_its_plain_version(case):
    """K13, one cooperative kernel and one graph node a call (no fill),
    against its plain version on the same CUDA tensors over successive
    batches with clocks across 2^32: an empty batch (the buckets still
    accrue), one row, 2^16 rows over 7 endpoints, 2^16 egress rows of
    one limited endpoint (every sum on one word), endpoints past
    MAX_ENDPOINTS clamped onto the last bucket, and 2^16-row batches
    that drain the buckets each followed by an empty one a second later
    (every bucket refills only if each thread read the clock before
    ``last`` was written), and 2^18 rows, more than the co-resident grid
    keeps in registers (the rest are read again in phase 2); its two
    sums zero after every call."""
    _need_card()
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import COL_DIR
    from cilium_tpu_torch.datapath import bandwidth as bw
    from cilium_tpu_torch.kernels import (KERNELS, launch_bw_stage,
                                          reset_launch_counts)
    from cilium_tpu_torch.testing import egress as eg

    rng = np.random.default_rng(31)
    limits = {1: 16_000, 2: 0x7FFFFFFF, 7: 90_000, 300: 50_000, 4095: 1_000}
    rates = u32.from_numpy(bw.rates_array(limits), "cuda")
    n = {"empty": 0, "one-row": 1, "past-registers": 1 << 18}.get(case,
                                                                  1 << 16)
    eps = {"one-endpoint": [7],
           "clamped": [7, 4095, 4096, 9000, 1 << 31, 0xFFFFFFFF]}.get(
        case, [1, 2, 3, 7, 300, 4095, 9000])
    states = [bw.BandwidthState.create("cuda") for _ in range(2)]
    clock = [(now, n) for now in (10, 10, 11, 5000, (1 << 32) - 1, 2)]
    if case == "drained-then-empty":
        clock = [(100 + k, n * (1 - k % 2)) for k in range(32)]
    reset_launch_counts()
    for now, n in clock:
        rows = eg.bw_rows(rng, max(n, 2), eps)[:n]
        if case == "one-endpoint":
            rows[:, COL_DIR] = 1
        hdr = u32.from_numpy(rows, "cuda")
        sc = {}
        got = launch_bw_stage(states[0], hdr, now, rates, scratch=sc)
        want = bw.bw_stage_plain(states[1], hdr, now, rates)
        assert torch.equal(got, want), now
        assert torch.equal(states[0].tokens, states[1].tokens), now
        assert torch.equal(states[0].last, states[1].last), now
        assert bool((sc["sums"] == 0).all()), now
    if case == "one-endpoint":
        assert bool((got != 0).any())  # the one bucket polices
    assert KERNELS["bw_stage"].launches == len(clock)
    _one_kernel(lambda: functools.partial(
        bw.bw_stage, bw.BandwidthState(states[0].tokens.clone(),
                                       states[0].last.clone()),
        hdr, 5, rates), "bw_stage_kernel")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["duplicates", "4096-frontends", "no-v6",
                                  "all-v6", "wrong-port"])
def test_lb6_stage_is_one_kernel_matching_its_plain_version(case):
    """K16, one kernel and one graph node a call, through the host-built
    frontend index, against its plain version on the same CUDA tensors:
    a second name on a v6 VIP:port (the lower name wins), 4096 v6
    frontends (index collisions, long probes), no v6 row (a copy), every
    row v6, and v6 rows to the VIPs on a port or protocol no frontend
    has."""
    _need_card()
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import (COL_DPORT, COL_FAMILY,
                                               COL_PROTO)
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts
    from cilium_tpu_torch.service import lb6_stage, lb6_stage_plain
    from cilium_tpu_torch.testing import services as sv

    rng = np.random.default_rng(37)
    n_svc, n_v6 = (4096, 4096) if case == "4096-frontends" else (512, 64)
    mgr, clients, others = _lb_world(n=n_svc, n_v6=n_v6)
    if case == "duplicates":
        mgr.upsert("a-dup6", f"[{sv.vip6(3)}]:443", ["2001:db8::99:1"])
        mgr.upsert("a-dup6b", f"[{sv.vip6(5)}]:443", [])
    t = mgr.tensors6()
    assert t.index.shape[0] >= 2 * t.svc_port.shape[0]
    v6_frac = {"no-v6": 0.0, "all-v6": 1.0, "wrong-port": 1.0}.get(case,
                                                                   0.5)
    reset_launch_counts()
    for n in (1, 300, 1 << 16):
        rows = sv.rows(rng, n, n_svc, clients, others,
                       vip_frac=0.5 * (1 - v6_frac), v6_frac=v6_frac,
                       n_v6=n_v6)
        rows[: n // 8, 3] |= 0x80000000  # sources above 2^31
        if case == "wrong-port":
            rows[::2, COL_DPORT] = 8443
            rows[1::2, COL_PROTO] = 132
        hdr = u32.from_numpy(rows, "cuda")
        got, want = lb6_stage(t, hdr), lb6_stage_plain(t, hdr)
        for g, w in zip(got, want):
            assert torch.equal(g, w), n
        six = int((hdr[:, COL_FAMILY] == 6).sum())
        if case in ("duplicates", "4096-frontends", "all-v6") and n > 1:
            assert bool(got[1].any())
        if case in ("no-v6", "wrong-port"):
            assert not bool(got[1].any()) and not bool(got[2].any())
            assert torch.equal(got[0], hdr)
        if case == "no-v6":
            assert six == 0
    assert KERNELS["lb6_stage"].launches == 3
    _one_kernel(lambda: functools.partial(lb6_stage, t, hdr),
                "lb6_stage_kernel")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["steady", "grid-then-tail", "crowded",
                                  "full-table", "overflow", "over-cap"])
def test_socklb_is_one_launch_whose_steps_stop(case):
    """K17, one cooperative kernel a call (no fill node), against its
    plain version on the same CUDA tensors, the claim steps it ran read
    from its counts: a steady batch of cached flows (no row pending: no
    step runs); 4096 new flows on a 2^14 cache (more pending rows than
    one block's tail takes: grid steps, then the tail); 12 new flows
    sharing one window among 1024 others (contention: one wins a slot at
    each step, all 8 steps run, 4 stay uncached); 512 new flows on a
    2^6 cache (every window filled: rows left uncached); a forced
    fingerprint overflow (every row re-probes its whole window);
    CONNECT_CAP + 1 misses (resolved, nothing claimed).  Every claim
    word of both tables is free after the call."""
    _need_card()
    import functools

    from cilium_tpu_torch import u32
    from cilium_tpu_torch.kernels import launch_socklb_stage
    from cilium_tpu_torch.service import socklb as sl
    from cilium_tpu_torch.testing import services as sv

    rng = np.random.default_rng(61)
    mgr, clients, others = _lb_world()
    t = mgr.tensors()
    cap = {"full-table": 1 << 6, "grid-then-tail": 1 << 14,
           "crowded": 1 << 14}.get(case, 1 << 16)
    base = sl.SockLBTable.create(cap, 1 << 12, device="cuda")

    def fresh(k):
        return sv.rows(rng, k, 512, clients, others, dup_frac=0.0)

    now = 100
    if case == "steady" or case == "overflow":
        pool = fresh(4096)
        sl.socklb_stage_plain(base, t, u32.from_numpy(pool, "cuda"), now)
        now += 10
        rows = pool[rng.integers(0, len(pool), 8192)]
        if case == "overflow":
            rows = np.concatenate([rows, fresh(1)])
            base.fp.copy_(u32.from_numpy(sv.force_overflow(
                u32.to_numpy(base.fp), rows[-1]), "cuda"))
    elif case == "crowded":
        rows = np.concatenate([sv.crowded_rows(12, cap, clients, others[0]),
                               fresh(1024)])
    else:
        rows = fresh({"grid-then-tail": 4096, "full-table": 512}.get(
            case, sl.CONNECT_CAP + 1))
    hdr = u32.from_numpy(rows, "cuda")

    def copy():
        return sl.SockLBTable(base.table.clone(), base.fp.clone(),
                              base.aff.clone())

    tabs, sc = [copy(), copy()], {}
    got = launch_socklb_stage(tabs[0], t, hdr, now, scratch=sc)
    want = sl.socklb_stage_plain(tabs[1], t, hdr, now)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    for f in ("table", "fp", "aff"):
        assert torch.equal(getattr(tabs[0], f), getattr(tabs[1], f)), f
    for f in ("claim", "aclaim"):
        assert bool((getattr(tabs[0], f) == sl.CLAIM_FREE).all()), f
    _one_kernel(lambda: functools.partial(launch_socklb_stage, copy(), t,
                                          hdr, now), "socklb_kernel")
    counts = sc["counts"].cpu().tolist()
    steps, left, misses, tail = counts[:8], counts[8], counts[9], counts[10]
    if case in ("steady", "over-cap"):
        assert not any(steps) and tail == 0, counts
    if case == "over-cap":
        assert misses == sl.CONNECT_CAP + 1
    if case == "grid-then-tail":
        assert steps[0] > 4 * 256 and tail >= 2, counts
    if case == "crowded":
        assert all(steps) and left >= 4, counts
    if case == "full-table":
        assert steps[0] > 0 and left > 0, counts


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["steady", "grid-then-tail", "exhausted",
                                  "dry", "duplicates"])
def test_snat_egress_is_one_launch_whose_steps_stop(case):
    """K11, one cooperative kernel a call (no fill node), against its
    plain version on the same CUDA tensors, the claim steps it ran read
    from its counts, then K12 on replies to its rows (no fill node): a
    batch whose flows all hold live mappings (no row pending: no step
    runs); 4096 new flows on a 2^14 pool (more pending rows than one
    block's tail takes: grid steps, then the tail); the same rows into a
    2^8 pool (every step used, the failures counted in ``failed``); new
    flows into that pool once it is full of live mappings (no window
    holds a claimable slot: every pending row fails, no step runs);
    every flow four times in one batch, with a crafted collision window
    (same-tuple losers adopt the lowest row's slot).  Every claim word is
    free after K11 and after K12."""
    _need_card()
    import functools

    from cilium_tpu_torch import u32
    from cilium_tpu_torch.kernels import launch_snat_egress
    from cilium_tpu_torch.service import nat
    from cilium_tpu_torch.testing import egress as eg
    from cilium_tpu_torch.testing.capture import ops_a_call

    rng = np.random.default_rng(62)
    now = 1000
    cap = 1 << 8 if case in ("exhausted", "dry") else 1 << 14
    (base, _), t, cttab, rows = _card_nat(rng, cap, now,
                                          eg.gateway_rules(eg.pod_ips(64)))
    if case == "steady":  # past the crafted window, whose rows never fit
        rows = rows[12:2060]
        nat.snat_egress_plain(base, t, cttab, u32.from_numpy(rows, "cuda"),
                              now)
        now += 10
    elif case == "grid-then-tail":
        rows = eg.egress_rows(rng, 8192, eg.pod_ips(64))
    elif case == "dry":
        nat.snat_egress_plain(base, t, cttab, u32.from_numpy(rows, "cuda"),
                              now)
        now += 10
        rows = eg.egress_rows(rng, 4096, eg.pod_ips(64), dup_frac=0.0)
    elif case == "duplicates":
        flows = eg.egress_rows(rng, 256, eg.pod_ips(64), dup_frac=0.0)
        rows = np.concatenate([eg.colliding_rows(12, cap, 5),
                               np.repeat(flows, 4, axis=0)])
        rows = rows[rng.permutation(len(rows))]
    hdr = u32.from_numpy(rows, "cuda")

    def copy():
        return nat.NATTable(base.table.clone(), base.failed.clone())

    tabs, sc = [copy(), copy()], {}
    got = launch_snat_egress(tabs[0], t, cttab, hdr, now, scratch=sc)
    want = nat.snat_egress_plain(tabs[1], t, cttab, hdr, now)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    _same_nat(tabs)
    assert bool((tabs[0].claim == nat.CLAIM_FREE).all())
    _one_kernel(lambda: functools.partial(launch_snat_egress, copy(), t,
                                          cttab, hdr, now),
                "snat_egress_kernel")
    counts = sc["counts"].cpu().tolist()
    steps, failed, tail = counts[:8], counts[8], counts[9]
    dropped = int(got[2].sum())
    assert failed == dropped
    assert (int(tabs[0].failed) & 0xFFFFFFFF) == (
        int(base.failed) & 0xFFFFFFFF) + dropped
    if case == "steady":
        assert not any(steps) and tail == 0, counts
    if case == "grid-then-tail":
        assert steps[0] > 4 * 256 and tail >= 2, counts
    if case == "exhausted":
        assert steps[0] > 0 and dropped > 0, counts
    if case == "dry":
        assert steps == [counts[0]] * 8 == [counts[8]] * 8, counts
        assert counts[0] > 0 and tail == 0, counts
    if case == "duplicates":  # the crafted window: a winner each step
        assert all(steps), counts
        out = u32.to_numpy(got[0])
        ok = ~got[2].cpu().numpy()
        alloc = ok & (out[:, 8] >= nat.NAT_PORT_MIN)
        pre = {}
        for r, o in zip(rows[alloc], out[alloc]):
            pre.setdefault(tuple(r[[3, 7, 8, 9, 10]]), set()).add(
                (int(o[3]), int(o[8])))
        assert all(len(v) == 1 for v in pre.values())
    # K12 on replies to the rewritten rows: one kernel, no fill, the
    # words free again
    rep = u32.from_numpy(eg.reply_rows(rng, u32.to_numpy(got[0]),
                                       len(rows)), "cuda")
    g = nat.snat_reverse(tabs[0], t, rep, now + 1)
    w = nat.snat_reverse_plain(tabs[1], t, rep, now + 1)
    assert torch.equal(g[0], w[0])
    _same_nat(tabs)
    assert bool((tabs[0].claim == nat.CLAIM_FREE).all())
    ops = ops_a_call(lambda: functools.partial(nat.snat_reverse, copy(), t,
                                               rep, now + 1))
    assert sorted(ops.values()) == [1] and not any(
        "Fill" in k or k == "memset" for k in ops), ops
    assert "snat_reverse_kernel" in next(iter(ops)), ops


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["replies", "forged", "one_slot", "no_hit",
                                  "n1", "wrap", "past_registers"])
def test_snat_reverse_is_one_launch_matching_its_plain_version(case):
    """K12, one cooperative kernel a call, against the plain version on
    the same CUDA tensors over successive calls, bit-exact (rows and
    table), the claim words CLAIM_FREE after every call: replies with
    misses and forged protocol words mixed in; replies to TCP mappings
    whose forged twins (protocol 6 | 0x100, the remote port one lower)
    alias the same slots with a non-TCP lifetime, in random order; every
    reply on one slot; no reply in the pool; one reply; clocks across
    2^32 (a refresh that wraps); 2^18 rows, more than the grid keeps in
    registers."""
    _need_card()
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import (COL_DPORT, COL_PROTO,
                                               COL_SPORT)
    from cilium_tpu_torch.service import nat
    from cilium_tpu_torch.testing import egress as eg

    rng = np.random.default_rng(63)
    now = (1 << 32) - 30_000 if case == "wrap" else 1000
    (base, _), t, cttab, rows = _card_nat(rng, 1 << 12, now,
                                          eg.gateway_rules(eg.pod_ips(64)))
    out = nat.snat_egress_plain(base, t, cttab, u32.from_numpy(rows, "cuda"),
                                now)[0]
    n = 1 << 18 if case == "past_registers" else 4096
    rep = eg.reply_rows(rng, u32.to_numpy(out), n)
    hit = (u32.to_numpy(nat.snat_reverse_plain(
        nat.NATTable(base.table.clone(), base.failed.clone()), t,
        u32.from_numpy(rep, "cuda"), now)[0]) != rep).any(1)
    tcp = rep[hit & (rep[:, COL_PROTO] == 6)]
    assert len(tcp) > 0
    if case == "forged":
        odd = tcp[tcp[:, COL_SPORT] % 2 == 1]
        rep = odd[rng.integers(0, len(odd), n)]
        forged = rng.random(n) < 0.5
        rep[forged, COL_PROTO] = 6 | 0x100
        rep[forged, COL_SPORT] -= 1
    elif case == "one_slot":
        rep = np.repeat(tcp[:1], n, axis=0)
    elif case == "no_hit":
        rep[:, COL_DPORT] = 1000
    elif case == "n1":
        rep = tcp[:1].copy()
    hdr = u32.from_numpy(np.ascontiguousarray(rep), "cuda")
    tabs = [nat.NATTable(base.table.clone(), base.failed.clone())
            for _ in range(2)]
    for step in range(4):  # at "wrap" the third call's refreshes wrap
        t_now = (now + 7000 * step) & 0xFFFFFFFF
        got = nat.snat_reverse(tabs[0], t, hdr, t_now)
        want = nat.snat_reverse_plain(tabs[1], t, hdr, t_now)
        assert torch.equal(got[0], want[0])
        _same_nat(tabs)
        assert bool((tabs[0].claim == nat.CLAIM_FREE).all())
        if step == 0 and case in ("forged", "one_slot", "n1"):
            assert bool((got[0] != hdr).any(1).all())  # every row hit
    if case == "no_hit":
        assert torch.equal(got[0], hdr)
    _one_kernel(lambda: functools.partial(
        nat.snat_reverse, nat.NATTable(base.table.clone(),
                                       base.failed.clone()), t, hdr, now),
        "snat_reverse_kernel")


def _ml_batch(rng, n):
    """A small world's rows of ``synth_labeled_traffic`` (every attack
    kind) served on the CPU, and a model from ``init_params`` with the
    world's labels, its novelty fitted on the benign rows."""
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.datapath.verdict import datapath_step
    from cilium_tpu_torch.ml import (fit_novelty, init_params,
                                     synth_labeled_traffic)
    from cilium_tpu_torch.ml.features import flow_features_plain

    w = tfix.build_world(256, 8, ct_capacity=1 << 12, device="cpu")
    hdr, labels = synth_labeled_traffic(w, n, rng)
    hdr_t = u32.from_numpy(hdr, "cpu")
    out, _ = datapath_step(w.state, hdr_t, 100)
    feats = flow_features_plain(hdr_t, out)[1]
    labels_by_row = {w.row_map.row(i.numeric_id):
                     tuple(str(l) for l in i.labels)
                     for i in w.alloc.all_identities()}
    model = init_params(torch.Generator().manual_seed(1),
                        w.row_map.capacity, labels_by_row=labels_by_row,
                        device="cpu")
    model = fit_novelty(model, feats[torch.from_numpy(labels < 0.5)].numpy())
    return hdr_t, out, model


def _k18_matches_plain(h, o):
    """K18 on (h, o) against its plain version: id_row and all but the
    log1p columns bit-exact, those within 1 ulp."""
    from cilium_tpu_torch.ml.features import (flow_features,
                                              flow_features_plain)

    (gid, gf), (wid, wf) = flow_features(h, o), flow_features_plain(h, o)
    assert torch.equal(gid, wid)
    exact = [c for c in range(27) if c not in (3, 4, 6, 19, 24)]
    assert torch.equal(gf[:, exact], wf[:, exact])
    ulps = (gf.view(torch.int32).long()
            - wf.view(torch.int32).long()).abs().max().item()
    assert ulps <= 1
    return gid, gf


def _done_within(event, seconds, what):
    """Wait for ``event`` without a blocking synchronize, so that a
    device-side deadlock fails the test instead of hanging it."""
    import time

    deadline = time.monotonic() + seconds
    while not event.query():
        assert time.monotonic() < deadline, f"{what}: not done in {seconds} s"
        time.sleep(0.01)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["flow_features", "anomaly_score",
                                  "flow_features_shapes",
                                  "anomaly_score_tile_edges",
                                  "flow_features_beside_ct_update"])
def test_ml_kernels_match_their_plain_versions(case):
    """K18 and K19 on the card against their plain versions on the same
    CUDA tensors.  K18: id_row and all but the log1p columns bit-exact,
    those within 1 ulp, on a ragged batch, a one-service batch (every
    row in one bucket) and words at the top of the u32 range; at 1,
    4096, 16384 and 16385 rows (the one-cluster kernel's last batch, the
    cooperative one's first), 2^18 and 9 * 2^20 rows (rows past the
    resident grid's registers, a block's counts past 16 bits) and 2^18
    rows on one service, one
    kernel a call (a CUDA-graph capture) and two calls bit-identical;
    and 100 calls at
    2^18 rows on one stream beside 100 cooperative K4 launches on
    another, both done within a minute (two cooperative grids never wait
    on each other), K18's outputs right and K4's CT equal to the same
    100 launches run alone.  K19: scores within 2e-3 and 99.9%
    bit-identical, logits within 1e-2, d2 bit-exact, with id_row past
    the table and negative, and with the novelty unfitted (exactly the
    supervised score); at 1, 15, 17, 4095 and 4096 rows (warp-tile
    edges) each row's outputs bit-identical to the whole batch's, two
    launches bit-identical."""
    _need_card()
    from cilium_tpu_torch.kernels import (KERNELS, launch_anomaly_score,
                                          reset_launch_counts)
    from cilium_tpu_torch.ml.features import (flow_features,
                                              flow_features_plain)
    from cilium_tpu_torch.ml.model import (NOV_DISABLED, forward_plain,
                                           novelty_d2_plain,
                                           score_packets_plain)
    from cilium_tpu_torch.testing.capture import ops_a_call

    rng = np.random.default_rng(31)
    hdr, out, model = _ml_batch(rng, 5000)
    hdr, out, model = hdr.cuda(), out.cuda(), model.to("cuda")
    reset_launch_counts()
    kernel = "flow_features" if case.startswith("flow") else "anomaly_score"
    if case == "flow_features":
        one_svc = hdr.clone()
        one_svc[:, 7], one_svc[:, 9], one_svc[:, 10] = 7, 5432, 6
        top = torch.from_numpy(rng.integers(
            -(1 << 31), 1 << 31, (777, 16), dtype=np.int64).astype(
                np.int32)).cuda()
        for h, o in ((hdr, out), (one_svc, out), (hdr[:1], out[:1]),
                     (top, out[:777])):
            _k18_matches_plain(h, o)
    elif case == "flow_features_shapes":
        big, huge = 1 << 18, 9 << 20
        reps = -(-huge // 5000)
        hh, oh = hdr.repeat(reps, 1)[:huge], out.repeat(reps, 1)[:huge]
        hb, ob = hh[:big], oh[:big]
        one_svc = hb.clone()
        one_svc[:, 7], one_svc[:, 9], one_svc[:, 10] = 7, 5432, 6
        for h, o in ((hdr[:1], out[:1]), (hdr[:4096], out[:4096]),
                     (hh[:16384], oh[:16384]), (hh[:16385], oh[:16385]),
                     (hb, ob), (one_svc, ob), (hh, oh)):
            got = _k18_matches_plain(h, o)
            again = flow_features(h, o)
            assert torch.equal(got[0], again[0])
            assert torch.equal(got[1], again[1])
            ops = ops_a_call(lambda h=h, o=o: functools.partial(
                flow_features, h, o))
            assert list(ops.values()) == [1], ops
            assert "flow_features_" in next(iter(ops)), ops
    elif case == "flow_features_beside_ct_update":
        from cilium_tpu_torch import u32
        from cilium_tpu_torch.datapath.verdict import verdict_stage_plain
        from cilium_tpu_torch.kernels import launch_ct_update

        big = 1 << 18
        reps = -(-big // 5000)
        hb, ob = hdr.repeat(reps, 1)[:big], out.repeat(reps, 1)[:big]
        want = flow_features_plain(hb, ob)
        w = tfix.build_world(256, 8, ct_capacity=1 << 16, device="cuda")
        _pool, rows, _r, _v = _verdict_inputs(w, "syn", 1 << 15, 1, rng)
        _o, c = verdict_stage_plain(w.state, u32.from_numpy(rows, "cuda"),
                                    100)
        args = (c.l4, c.fwd, c.result, c.slot, c.is_reply, c.do_create,
                c.proxy_port, 100, None)
        alone, beside = _ct_clone(w.state.ct), _ct_clone(w.state.ct)
        for _ in range(100):
            launch_ct_update(alone, *args)
        torch.cuda.synchronize()
        s4, s18 = torch.cuda.Stream(), torch.cuda.Stream()
        with torch.cuda.stream(s4):
            for _ in range(100):
                launch_ct_update(beside, *args)
        with torch.cuda.stream(s18):
            for _ in range(100):
                got = flow_features(hb, ob)
        done = [torch.cuda.Event(), torch.cuda.Event()]
        done[0].record(s4)
        done[1].record(s18)
        for e, what in zip(done, ("ct_update", "flow_features")):
            _done_within(e, 60, what)
        assert torch.equal(got[0], want[0])
        assert (got[1] - want[1]).abs().max().item() <= 2.4e-7
        for a, b in ((alone.table, beside.table), (alone.fp, beside.fp),
                     (alone.dropped, beside.dropped)):
            assert torch.equal(a, b)
        assert bool((beside.claim == -1).all())
    elif case == "anomaly_score":
        rows, feats = flow_features_plain(hdr, out)
        v = model.embed.shape[0]
        far = rows.clone()
        far[:300] = v + torch.arange(300, device="cuda", dtype=torch.int32)
        far[300:310] = -1 - torch.arange(10, device="cuda",
                                         dtype=torch.int32)
        unfit = model.replace(
            feat_mean=torch.zeros_like(model.feat_mean),
            feat_prec=torch.zeros_like(model.feat_prec),
            nov_thresh=torch.full_like(model.nov_thresh, NOV_DISABLED))
        for m, ids in ((model, rows), (model, far), (unfit, rows)):
            got = launch_anomaly_score(m, ids, feats,
                                       outputs=("logit", "d2"))
            want = score_packets_plain(m, ids, feats)
            assert (got["score"] - want).abs().max().item() <= 2e-3
            assert (got["score"] == want).float().mean().item() >= 0.999
            assert (got["logit"] - forward_plain(m, ids, feats)).abs() \
                .max().item() <= 1e-2
            assert torch.equal(got["d2"], novelty_d2_plain(m, feats))
    else:  # anomaly_score_tile_edges
        rows, feats = flow_features_plain(hdr, out)
        whole = launch_anomaly_score(model, rows, feats,
                                     outputs=("logit", "d2"))
        for m in (1, 15, 17, 4095, 4096):
            got = launch_anomaly_score(model, rows[:m], feats[:m],
                                       outputs=("logit", "d2"))
            again = launch_anomaly_score(model, rows[:m], feats[:m],
                                         outputs=("logit", "d2"))
            for k in ("score", "logit", "d2"):
                assert torch.equal(got[k], whole[k][:m]), (m, k)
                assert torch.equal(got[k], again[k]), (m, k)
    torch.cuda.synchronize()
    assert KERNELS[kernel].launches > 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["anomaly_train_fwd", "anomaly_train_bwd",
                                  "adam_update", "anomaly_train_fwd_sharded",
                                  "anomaly_train_bwd_sharded"])
def test_train_kernels_match_their_plain_versions(case):
    """K20-K22 on the card against their plain versions on the same CUDA
    tensors, 3000 rows with one identity on half of them and ids past
    the table and negative.  K20: logits and saved activations
    bit-exact, the loss within 2e-6 relative, two launches
    bit-identical, and the same on 1 and 1001 rows (not whole 32-row
    blocks); K21: weight and bias gradients bit-exact, d_embed within 1e-5 of its largest entry (the
    plain version's index_add_ sums in atomic order), two runs
    bit-identical, and the same on a 20000-row batch (the radix sort's
    tiles grown to 512 rows); K22: one step from count 3 bit-exact.  K20s and K21s
    over 8 shards of 375 rows: the same bounds against their plain
    versions, and bit-exact against 8 unsharded launches on the blocks
    followed by the shard-order mean (K20s: two launches bit-identical;
    375-row blocks are not whole 32-row blocks); the same over 2 shards
    of 20000 rows (each block's sort in tiles of 512 rows)."""
    _need_card()
    from cilium_tpu_torch.kernels import (KERNELS, launch_adam_update,
                                          launch_anomaly_train_bwd,
                                          launch_anomaly_train_fwd,
                                          reset_launch_counts)
    from cilium_tpu_torch.ml.model import (train_backward_plain,
                                           train_forward_plain)
    from cilium_tpu_torch.ml.train import adam_update_plain

    rng = np.random.default_rng(41)
    hdr, out, model = _ml_batch(rng, 3000)
    from cilium_tpu_torch.ml.features import flow_features_plain

    ids, feats = flow_features_plain(hdr, out)
    v = model.embed.shape[0]
    ids = ids.clone()
    ids[:1500] = 3
    ids[1500:1530] = v + torch.arange(30, dtype=torch.int32)
    ids[1530:1540] = -1 - torch.arange(10, dtype=torch.int32)
    ids[1540:1545] = -v - 2
    ids = ids[torch.from_numpy(rng.permutation(3000))].contiguous().cuda()
    feats = feats.cuda()
    labels = torch.from_numpy((rng.random(3000) < 0.3).astype(
        np.float32)).cuda()
    gen = torch.Generator().manual_seed(3)
    model = model.replace(**{b: torch.randn(tuple(getattr(model, b).shape),
                                            generator=gen) * 0.1
                             for b in ("b1", "b2", "b3")}).to("cuda")
    leaves = model.leaves()
    reset_launch_counts()
    loss, saved = launch_anomaly_train_fwd(leaves, ids, feats, labels)
    ploss, psaved = train_forward_plain(leaves, ids, feats, labels)
    gloss = torch.ones(1, device="cuda")
    if case == "anomaly_train_fwd":
        _check_train_fwd(saved, loss, psaved, ploss)
        # a second launch gives the same bits (the last block's ticket is
        # back at 0); 1 row and 1001 rows (not whole 32-row blocks nor
        # whole 16-byte stores) against the plain version
        loss2, saved2 = launch_anomaly_train_fwd(leaves, ids, feats, labels)
        assert torch.equal(loss2, loss)
        assert all(torch.equal(saved2[k], saved[k]) for k in saved)
        for m in (1, 1001):
            part = (ids[:m], feats[:m], labels[:m])
            _check_train_fwd(*launch_anomaly_train_fwd(leaves, *part)[::-1],
                             *train_forward_plain(leaves, *part)[::-1])
    grads = launch_anomaly_train_bwd(leaves, saved, ids, labels, gloss)
    if case == "anomaly_train_bwd":
        again = launch_anomaly_train_bwd(leaves, saved, ids, labels, gloss)
        want = train_backward_plain(leaves, psaved, ids, labels, gloss)
        # a batch over 16384 rows: the radix sort's tiles grow to 512
        big = [t.repeat(*([7] + [1] * (t.dim() - 1)))[:20000].contiguous()
               for t in (ids, feats, labels)]
        bsaved = launch_anomaly_train_fwd(leaves, *big)[1]
        bgot = launch_anomaly_train_bwd(leaves, bsaved, big[0], big[2],
                                        gloss)
        bwant = train_backward_plain(
            leaves, train_forward_plain(leaves, *big)[1], big[0], big[2],
            gloss)
        for got_, again_, want_ in ((grads, again, want),
                                    (bgot, bgot, bwant)):
            for i, (a, b, c) in enumerate(zip(got_, again_, want_)):
                assert torch.equal(a, b)
                if i == 0:
                    err = (a - c).abs().max().item()
                    assert err <= 1e-5 * c.abs().max().item()
                    assert a[3].abs().max().item() > 0
                else:
                    assert torch.equal(a, c)
    if case == "adam_update":
        params = [t.clone() for t in leaves]
        mu = [torch.zeros_like(t) for t in leaves]
        nu = [torch.zeros_like(t) for t in leaves]
        count = torch.zeros((), dtype=torch.int32, device="cuda")
        for _ in range(3):
            adam_update_plain(params, grads, mu, nu, count, 3e-3)
        k = ([t.clone() for t in params], [t.clone() for t in mu],
             [t.clone() for t in nu], count.clone())
        launch_adam_update(k[0], grads, k[1], k[2], k[3], 3e-3)
        adam_update_plain(params, grads, mu, nu, count, 3e-3)
        for a, b in zip(k[0] + k[1] + k[2], params + mu + nu):
            assert torch.equal(a, b)
        assert int(k[3].item()) == int(count.item()) == 4
    if case.endswith("_sharded"):
        _check_sharded_train_kernels(case, leaves, ids, feats, labels, gloss)
        # 2 shards of 20000 rows: each block sorted in tiles of 512 rows
        big = [t.repeat(*([14] + [1] * (t.dim() - 1)))[:40000].contiguous()
               for t in (ids, feats, labels)]
        _check_sharded_train_kernels(case, leaves, *big, gloss, n_shards=2)
    torch.cuda.synchronize()
    assert KERNELS[case].launches > 0


# K21's scatter at the trainer's shapes and the sort's edges: (rows,
# shards, V) -- B = 4096 unsharded and over 8 shards (phase 3's), a batch
# that is not a multiple of the sort's 256-row tile with a V that is not
# a power of two, blocks of 750 under a V of one radix pass, and a V of
# three passes
K21_SORT_CASES = {"b4096-s1": (4096, None, 16384),
                  "b4096-s8": (4096, 8, 16384),
                  "b3000-v1000": (3000, None, 1000),
                  "b3000-s4-v200": (3000, 4, 200),
                  "b2048-s2-v70000": (2048, 2, 70000)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(K21_SORT_CASES))
def test_k21_sort_and_embedding_gradient(case):
    """K21/K21s on the card: each shard's sorted keys and rows (the
    launch's scratch) equal a stable sort of its clamped keys with the
    dropped ids (key V) last; d_embed equals ``embed_grad_sorted_plain``
    bit for bit and every other gradient ``train_backward_plain``'s;
    two runs give the same bits.  A hot identity on half the rows, ids
    past V and negative."""
    _need_card()
    from cilium_tpu_torch.kernels import (launch_anomaly_train_bwd,
                                          launch_anomaly_train_fwd)
    from cilium_tpu_torch.ml import init_params
    from cilium_tpu_torch.ml.model import (embed_grad_sorted_plain,
                                           train_backward_plain,
                                           train_forward_plain)

    n, n_shards, v = K21_SORT_CASES[case]
    rng = np.random.default_rng(n + v)
    ids = rng.integers(0, v, n).astype(np.int64)
    ids[: n // 2] = v // 3
    ids[n // 2: n // 2 + 40] = v + np.arange(40)
    ids[n // 2 + 40: n // 2 + 60] = -1 - np.arange(20)
    ids[n // 2 + 60: n // 2 + 64] = -v - 1
    rng.shuffle(ids)
    ids = torch.from_numpy(ids.astype(np.int32)).cuda()
    feats = torch.from_numpy(rng.random((n, 27)).astype(np.float32)).cuda()
    labels = torch.from_numpy((rng.random(n) < 0.3).astype(
        np.float32)).cuda()
    gen = torch.Generator().manual_seed(5)
    model = init_params(gen, v, device="cpu")
    model = model.replace(
        embed=torch.randn((v, 32), generator=gen) * 0.5,
        **{b: torch.randn(tuple(getattr(model, b).shape), generator=gen)
           * 0.1 for b in ("b1", "b2", "b3")}).to("cuda")
    leaves = model.leaves()
    gloss = torch.ones(1, device="cuda")
    _, saved = launch_anomaly_train_fwd(leaves, ids, feats, labels, n_shards)
    _, psaved = train_forward_plain(leaves, ids, feats, labels, n_shards)
    sc = {}
    got = launch_anomaly_train_bwd(leaves, saved, ids, labels, gloss,
                                   n_shards, scratch=sc)
    again = launch_anomaly_train_bwd(leaves, saved, ids, labels, gloss,
                                     n_shards)
    torch.cuda.synchronize()
    key = ids.to(torch.int64)
    key = torch.where(key < 0, key + v, key)
    key = torch.where((key >= 0) & (key < v), key, v)
    blk = n // (n_shards or 1)
    for z in range(n_shards or 1):
        b = slice(z * blk, (z + 1) * blk)
        k, order = torch.sort(key[b], stable=True)
        assert torch.equal(sc["sorted_key"][b].to(torch.int64), k), z
        assert torch.equal(sc["sorted_row"][b].to(torch.int64),
                           order + z * blk), z
    want = train_backward_plain(leaves, psaved, ids, labels, gloss, n_shards)
    assert torch.equal(got[0], embed_grad_sorted_plain(
        leaves, psaved, ids, labels, gloss, n_shards))
    assert float((got[0] - want[0]).abs().max()) <= 1e-5 * float(
        want[0].abs().max())
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
    for a, c in zip(got[1:], want[1:]):
        assert torch.equal(a, c)


def _shard_mean(parts):
    total = parts[0]
    for t in parts[1:]:
        total = total + t
    return total / torch.tensor(float(len(parts)), device=total.device)


def _check_train_fwd(saved, loss, psaved, ploss):
    """K20's logits and saved activations bit-exact with the plain
    version's, its loss within 2e-6 relative (another sum order)."""
    x, h1, h2, logit = psaved
    assert torch.equal(saved["logit"], logit)
    assert torch.equal(saved["xT"], x.t())
    assert torch.equal(saved["h1T"], h1.t())
    assert torch.equal(saved["h2T"], h2.t())
    assert abs(loss.item() - ploss.item()) <= 2e-6 * abs(ploss.item())


def _check_sharded_train_kernels(case, leaves, ids, feats, labels, gloss,
                                 n_shards=8):
    """K20s/K21s against their plain versions and against n_shards
    unsharded K20/K21 launches on the blocks and their mean."""
    from cilium_tpu_torch.kernels import (launch_anomaly_train_bwd,
                                          launch_anomaly_train_fwd)
    from cilium_tpu_torch.ml.model import (train_backward_plain,
                                           train_forward_plain)

    blk = ids.shape[0] // n_shards
    blocks = [slice(z * blk, (z + 1) * blk) for z in range(n_shards)]
    loss, saved = launch_anomaly_train_fwd(leaves, ids, feats, labels,
                                           n_shards)
    ploss, psaved = train_forward_plain(leaves, ids, feats, labels, n_shards)
    singles = [launch_anomaly_train_fwd(leaves, ids[b], feats[b], labels[b])
               for b in blocks]
    if case == "anomaly_train_fwd_sharded":
        _check_train_fwd(saved, loss, psaved, ploss)
        assert torch.equal(loss, _shard_mean([l for l, _ in singles]))
        # a second launch gives the same bits (its own ticket, back at 0)
        loss2, saved2 = launch_anomaly_train_fwd(leaves, ids, feats, labels,
                                                 n_shards)
        assert torch.equal(loss2, loss)
        assert all(torch.equal(saved2[k], saved[k]) for k in saved)
        return
    grads = launch_anomaly_train_bwd(leaves, saved, ids, labels, gloss,
                                     n_shards)
    again = launch_anomaly_train_bwd(leaves, saved, ids, labels, gloss,
                                     n_shards)
    want = train_backward_plain(leaves, psaved, ids, labels, gloss,
                                n_shards)
    parts = [launch_anomaly_train_bwd(leaves, sv, ids[b], labels[b], gloss)
             for (_, sv), b in zip(singles, blocks)]
    for i, (a, b, c) in enumerate(zip(grads, again, want)):
        assert torch.equal(a, b)
        assert torch.equal(a, _shard_mean([p[i] for p in parts])), i
        if i == 0:
            err = (a - c).abs().max().item()
            assert err <= 1e-5 * c.abs().max().item()
            assert a[3].abs().max().item() > 0
        else:
            assert torch.equal(a, c)


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "wide"])
def test_sharded_kernels_match_their_plain_versions(packed):
    """K1s/K4s/K5s (one launch sequence for 4 shards) against the plain
    per-shard loop on the card: out rows, CT, counters, ring and cursors
    equal over 3 routed batches with padding and one skewed shard."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest "
                    "tests/test_torch_gpu.py --noconftest)")
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import pack_eligibility
    from cilium_tpu_torch.kernels import KERNELS, reset_launch_counts
    from cilium_tpu_torch.parallel import mesh as pm

    S, cap = 4, 1 << 10
    w = tfix.build_world(256, 8, ct_capacity=1 << 12, n_v6=16,
                         device="cpu")
    states = [tfix.build_world(256, 8, ct_capacity=1 << 12, n_v6=16,
                               device="cuda").state for _ in "kp"]
    mesh = pm.make_mesh(S)
    rings = [pm.make_sharded_ring(mesh, cap) for _ in "kp"]
    rng = np.random.default_rng(31 + packed)
    pool = (tfix.steady_flow_pool(w, 512, rng) if packed
            else tfix.wide_flow_pool(w, 512, rng))
    pp = u32.from_numpy(np.array([10000], np.uint32), "cuda")
    reset_launch_counts()
    for b in range(3):
        hdr = pool if b == 0 else (
            tfix.steady_traffic(pool, 512, rng) if packed
            else tfix.wide_traffic(pool, 512, rng))
        if b == 2:
            hdr[:200] = hdr[0]  # one shard overflows on the host
        routed, valid, _orig, _ovf = pm.route_by_flow(hdr, S, 256)
        meta = {}
        rows = routed
        if packed:
            ok, ep, dirn = pack_eligibility(hdr)
            assert ok
            rows, meta = pack_rows(routed), dict(ep=ep, dirn=dirn)
        rows = u32.from_numpy(rows, "cuda")
        v = torch.from_numpy(valid).cuda()
        outs = [f(st, r, rows, 100 + b, 8190 + b, S, valid=v,
                  proxy_ports=pp, trace_sample=64, **meta)
                for f, st, r in ((pm.sharded_serve_launch, states[0],
                                  rings[0]),
                                 (pm.sharded_serve_plain, states[1],
                                  rings[1]))]
        assert torch.equal(outs[0], outs[1])
    for a, b in ((states[0].ct.table, states[1].ct.table),
                 (states[0].ct.fp, states[1].ct.fp),
                 (states[0].ct.dropped, states[1].ct.dropped),
                 (states[0].metrics, states[1].metrics),
                 (rings[0].buf, rings[1].buf),
                 (rings[0].cursor, rings[1].cursor)):
        assert torch.equal(a, b)
    assert bool((states[0].ct.claim == -1).all())
    kind = "packed" if packed else "wide"
    for name in (f"datapath_{kind}_sharded", "ct_update_sharded",
                 "ring_append_sharded"):
        assert KERNELS[name].launches == 3


def _ct_clone(c):
    from cilium_tpu_torch.datapath.conntrack import CTTable

    return CTTable(c.table.clone(), c.fp.clone(), c.dropped.clone(),
                   torch.full((2, c.table.shape[0]), -1, dtype=torch.int32,
                              device=c.table.device))


def _verdict_inputs(w, case, n, shards, rng):
    """A pool of ``n`` flows (SYN rows), a batch of ``n`` wide header
    rows for ``case`` and, for ``shards`` > 1, the batch flow-routed into
    blocks (headroom 2): -> (pool, batch, routed rows or None, valid)."""
    from cilium_tpu_torch.parallel import route_by_flow

    pool = tfix.steady_flow_pool(w, n, rng)
    if case in ("syn", "collision"):
        hdr = pool
    elif case == "hot":
        hdr = np.repeat(pool[:1], n, axis=0)
    else:
        hdr = tfix.steady_traffic(pool, n, rng)
    if shards == 1:
        return pool, hdr, None, None
    routed, valid, _o, _ovf = route_by_flow(hdr, shards, 2 * n // shards)
    return pool, hdr, routed, valid


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 8])
@pytest.mark.parametrize("case", ["syn", "steady", "collision", "nothing"])
def test_ct_update_is_one_launch_matching_its_plain_version(case, shards):
    """K4/K4s, one cooperative kernel a call (no memset), against the
    plain ct_update (per shard for K4s): the CT table, fp and dropped
    equal and every claim word back at -1, on a SYN batch, a steady
    batch, a collision batch whose inserts run all 20 rounds and drop,
    and a batch with nothing to insert; with one shard the kernel's
    pending counts a round equal the plain version's."""
    _need_card()
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.datapath import conntrack as ct
    from cilium_tpu_torch.datapath.verdict import verdict_stage_plain
    from cilium_tpu_torch.kernels import launch_ct_update
    from cilium_tpu_torch.parallel import mesh as pm
    from cilium_tpu_torch.testing.capture import ops_a_call

    cap, n = (1 << 9 if case == "collision" else 1 << 14), 2048
    w = tfix.build_world(256, 8, ct_capacity=cap, device="cuda")
    rng = np.random.default_rng(51)
    pool, rows, routed, valid = _verdict_inputs(w, case, n, shards, rng)
    rows = rows if routed is None else routed
    st, now = w.state, 100
    if case in ("steady", "nothing"):  # the pool's flows established
        h = u32.from_numpy(pool, "cuda")
        _o, c = verdict_stage_plain(st, h, now)
        ct.ct_update_plain(st.ct, c.l4, c.fwd, c.result, c.slot,
                           c.is_reply, c.do_create, c.proxy_port, now)
        now += 1
    rows = u32.from_numpy(rows, "cuda")
    valid = None if valid is None else torch.from_numpy(valid).cuda()
    if shards == 1:
        _o, c = verdict_stage_plain(st, rows, now, valid=valid)
    else:
        _o, c = pm.sharded_verdict_plain(st, rows, now, shards, valid)
    if case == "nothing":
        c.do_create = torch.zeros_like(c.do_create)
    kc, pc = _ct_clone(st.ct), _ct_clone(st.ct)
    scratch, stats = {}, {}
    args = (c.l4, c.fwd, c.result, c.slot, c.is_reply, c.do_create,
            c.proxy_port, now, valid)
    sh = None if shards == 1 else shards
    launch_ct_update(kc, *args, n_shards=sh, scratch=scratch)
    # one call captured into a CUDA graph, not run: its nodes
    kernels = ops_a_call(lambda: functools.partial(
        launch_ct_update, _ct_clone(st.ct), *args, n_shards=sh))
    assert list(kernels.values()) == [1], kernels
    assert "ct_update_kernel" in next(iter(kernels)), kernels
    if shards == 1:
        ct.ct_update_plain(pc, c.l4, c.fwd, c.result, c.slot, c.is_reply,
                           c.do_create, c.proxy_port, now, valid,
                           stats=stats)
        assert scratch["counts"].cpu().tolist() == stats["pending"]
    else:
        pm.sharded_ct_update_plain(pc, c, now, shards, valid)
    for a, b in ((kc.table, pc.table), (kc.fp, pc.fp),
                 (kc.dropped, pc.dropped)):
        assert torch.equal(a, b)
    assert bool((kc.claim == -1).all())
    counts = scratch["counts"].cpu().tolist()
    if case == "collision":
        assert int(kc.dropped) > 0 and all(counts[:-1]), counts
    if case == "nothing":
        assert not any(counts), counts


@pytest.mark.gpu
@pytest.mark.parametrize("settle", [0, 3, 4, 19, None],
                         ids=["round0", "round3", "round4", "round19",
                              "dropped"])
def test_ct_update_stops_where_the_last_pending_row_settles(settle):
    """K4 on the tables of ``testing.fixtures.ct_round_table``: the rounds
    it runs end with the round in which its one pending row settles
    (all 20, and the row dropped, for None), and its CT equals the plain
    version's."""
    _need_card()
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.datapath import conntrack as ct
    from cilium_tpu_torch.kernels import launch_ct_update

    cap, now = 1 << 9, 100
    hdr = tfix.steady_flow_pool(
        tfix.build_world(256, 8, ct_capacity=cap, device="cpu"), 1,
        np.random.default_rng(5))
    fwd, rev = ct.ct_keys_from_headers(u32.from_numpy(hdr, "cuda"))
    table, fp = tfix.ct_round_table(u32.to_numpy(fwd)[0], settle, cap, now,
                                    np.random.default_rng(3))
    base = ct.CTTable(u32.from_numpy(table, "cuda"),
                      u32.from_numpy(fp, "cuda"),
                      torch.zeros((), dtype=torch.int32, device="cuda"))
    res, slot, rep = ct.ct_lookup_plain(base, fwd, rev, now)
    l4 = ct.ct_l4_from_headers(u32.from_numpy(hdr, "cuda"))
    args = (l4, fwd, res, slot, rep, torch.ones(1, dtype=torch.bool,
                                                device="cuda"),
            torch.zeros(1, dtype=torch.int32, device="cuda"), now)
    kc, pc = _ct_clone(base), _ct_clone(base)
    scratch, stats = {}, {}
    launch_ct_update(kc, *args, scratch=scratch)
    ct.ct_update_plain(pc, *args, stats=stats)
    counts = scratch["counts"].cpu().tolist()
    assert counts == stats["pending"]
    assert stats["rounds"] == (ct.N_ROUNDS if settle is None else settle + 1)
    for a, b in ((kc.table, pc.table), (kc.fp, pc.fp),
                 (kc.dropped, pc.dropped)):
        assert torch.equal(a, b)
    assert int(kc.dropped) == (1 if settle is None else 0)
    assert bool((kc.claim == -1).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    "packed-4096", "packed-65536", "packed-262144", "wide-4096",
    "wide-65536", "wide-262144", "packed-hot", "wide-hot",
    "packed-sharded", "wide-sharded", "wide-tcam"])
def test_verdict_kernel_matches_its_plain_version(case):
    """K1 (packed, and wide with every channel and audit) and K1s over 8
    shards against the plain verdict stage on the card: out rows, the
    ct_update hand-off and the metrics bit-exact, at 4096, 2^16 and
    2^18 rows, and with every row in one hot metrics cell; wide rows
    with IPv6 also against a TCAM of 90 prefix lengths (its v6 index
    probed a group at a time), a third of them on addresses no /128
    holds."""
    _need_card()
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.core.packets import pack_eligibility, unpack_hdr
    from cilium_tpu_torch.datapath import conntrack as ct
    from cilium_tpu_torch.datapath.verdict import (verdict_stage,
                                                   verdict_stage_plain)
    from cilium_tpu_torch.kernels import launch_datapath
    from cilium_tpu_torch.parallel import mesh as pm

    kind, size = case.split("-")
    shards = 8 if size == "sharded" else 1
    n = {"hot": 1 << 16, "sharded": 1 << 16, "tcam": 1 << 16}.get(
        size) or int(size)
    w = tfix.build_world(256, 8, ct_capacity=1 << 16, n_v6=16,
                         device="cuda")
    if size == "tcam":
        w.state.ipcache = _deep_tcam(w)
    rng = np.random.default_rng(61)
    st, now = w.state, 100
    pool, hdr, routed, valid = _verdict_inputs(
        w, "hot" if size == "hot" else "steady", n, shards, rng)
    # the pool's flows established, so that the batch has CT hits
    h = u32.from_numpy(pool, "cuda")
    _o, c = verdict_stage_plain(st, h, now)
    ct.ct_update_plain(st.ct, c.l4, c.fwd, c.result, c.slot, c.is_reply,
                       c.do_create, c.proxy_port, now)
    now += 1
    if kind == "wide" and shards == 1 and size != "hot":
        wpool = tfix.wide_flow_pool(w, 512, rng)
        hdr = tfix.wide_traffic(wpool, n, rng)  # IPv6, ICMP errors
        if size == "tcam":  # v6 rows off every /128: deeper probes
            six = np.flatnonzero(hdr[:, 13] == 6)[::3]
            hdr[six, 3] += 0x1000
            hdr[six, 7] += 0x1000
    ep = dirn = None
    rows = hdr if routed is None else routed
    if kind == "packed":
        ok, ep, dirn = pack_eligibility(hdr)
        assert ok
        rows = pack_rows(rows)
    rows = u32.from_numpy(rows, "cuda")
    m = st.metrics
    if shards == 1:
        opts = {}
        if kind == "wide" and size != "hot":
            opts = dict(
                valid=torch.from_numpy(rng.random(n) < 0.9).cuda(),
                pre_drop=torch.from_numpy(rng.random(n) < 0.05).cuda(),
                pre_drop_reason=u32.from_numpy(np.where(
                    rng.random(n) < 0.05, rng.choice(np.array(
                        [6, 13, 0xFFFFFFFF], np.uint32), n), 0), "cuda"),
                lb_drop=torch.from_numpy(rng.random(n) < 0.02).cuda(),
                audit=True)
        st.metrics = m.clone()
        got = verdict_stage(st, rows, now, ep=ep, dirn=dirn, **opts)
        mk, st.metrics = st.metrics, m.clone()
        hdr_t = rows if ep is None else unpack_hdr(rows, ep, dirn)
        want = verdict_stage_plain(st, hdr_t, now, **opts)
    else:
        v = torch.from_numpy(valid).cuda()
        st.metrics = m.clone()
        got = launch_datapath(st, rows, now, ep, dirn, v, None, None, None,
                              False, n_shards=shards)
        mk, st.metrics = st.metrics, m.clone()
        want = pm.sharded_verdict_plain(st, rows, now, shards, v, ep, dirn)
    assert torch.equal(got[0], want[0])
    for f in ("l4", "fwd", "result", "slot", "is_reply", "do_create",
              "proxy_port"):
        assert torch.equal(getattr(got[1], f), getattr(want[1], f)), f
    assert torch.equal(mk, st.metrics)
    if size == "hot":
        added = (u32.widen(mk) - u32.widen(m)).flatten()
        assert int((added != 0).sum()) == 1 and int(added.sum()) == n


def _deep_tcam(w):
    """``w``'s ipcache with the v6 TCAM deepened: the network of
    2001:db8::1 at every prefix length from 40 to 127 (88 more masks,
    each on a row of the world), so that a v6 address off every /128
    probes group after group."""
    import ipaddress

    from cilium_tpu_torch.datapath.lpm import DeviceLPM, compile_lpm

    ent = {c: w.row_map.row(i) for c, i in w.ipcache.items()}
    rows = sorted(set(ent.values()))
    for k, p in enumerate(range(40, 128)):
        net = ipaddress.ip_network(f"2001:db8::1/{p}", strict=False)
        ent[str(net)] = rows[k % len(rows)]
    t = DeviceLPM.from_tensors(compile_lpm(ent), "cuda")
    assert t.v6_groups.shape[0] == 90
    return t


def _one_kernel(prepare, name):
    """The operations of one captured call (``testing.capture``): one
    kernel named ``name``."""
    from cilium_tpu_torch.testing.capture import ops_a_call

    ops = ops_a_call(prepare)
    assert list(ops.values()) == [1] and name in next(iter(ops)), ops


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["count3", "saturate"])
def test_adam_update_is_one_launch_matching_its_plain_version(case):
    """K22, one kernel a step, against the plain version on the same
    CUDA tensors, bit-exact: from count 3 (to 4), and from INT_MAX - 1
    over two steps (INT_MAX, then INT_MAX again: the count saturates).
    The leaves mix whole 16-byte units with tails, a leaf that is a view
    at a 4-byte offset (its scalar path) and a one-element leaf."""
    _need_card()
    from cilium_tpu_torch.kernels import launch_adam_update
    from cilium_tpu_torch.ml.train import adam_update_plain

    gen = torch.Generator().manual_seed(17)
    shapes = [(300, 32), (59, 64), (64,), (4099,), (1,), (7,)]

    def leaf(shape, scale, offset=False):
        n = int(np.prod(shape))
        t = (torch.randn(n + offset, generator=gen) * scale).cuda()
        return (t[1:] if offset else t).reshape(shape)

    # the fourth leaf of each list is a view at a 4-byte offset
    params = [leaf(s, 0.5, i == 3) for i, s in enumerate(shapes)]
    grads = [leaf(s, 1e-2, i == 3) for i, s in enumerate(shapes)]
    grads[0][::3] = 0  # rows with no gradient still decay
    mu = [leaf(s, 1.0, i == 3).zero_() for i, s in enumerate(shapes)]
    nu = [leaf(s, 1.0, i == 3).zero_() for i, s in enumerate(shapes)]
    assert all(t[3].data_ptr() % 16 == 4 for t in (params, grads, mu, nu))
    count = torch.zeros((), dtype=torch.int32, device="cuda")
    for _ in range(3):
        adam_update_plain(params, grads, mu, nu, count, 3e-3)
    if case == "saturate":
        count.fill_((1 << 31) - 2)

    def clone():
        return ([t.clone() for t in params], [t.clone() for t in mu],
                [t.clone() for t in nu], count.clone())

    k, p = clone(), clone()
    steps = 1 if case == "count3" else 2
    for step in range(steps):
        launch_adam_update(k[0], grads, k[1], k[2], k[3], 3e-3)
        adam_update_plain(p[0], grads, p[1], p[2], p[3], 3e-3)
        for a, b in zip(k[0] + k[1] + k[2], p[0] + p[1] + p[2]):
            assert torch.equal(a, b)
        want = 4 if case == "count3" else (1 << 31) - 1
        assert int(k[3].item()) == int(p[3].item()) == want, step
    def prepare():
        c = clone()
        return functools.partial(launch_adam_update, c[0], grads, c[1],
                                 c[2], c[3], 3e-3)

    _one_kernel(prepare, "adam_kernel")


def _ring_out(rng, n, trace_frac=0.8):
    """[n, 6] out rows: random words, a ``trace_frac`` share of TRACE
    events, proxy ports from the listener table, 0 and strays."""
    from cilium_tpu_torch.datapath.verdict import (EV_DROP, EV_TRACE,
                                                   EV_VERDICT, OUT_EVENT,
                                                   OUT_PROXY)

    out = rng.integers(0, 1 << 32, (n, 6), dtype=np.uint64).astype(
        np.uint32)
    out[:, OUT_EVENT] = np.where(rng.random(n) < trace_frac, EV_TRACE,
                                 rng.choice([EV_DROP, EV_VERDICT], n))
    out[:, OUT_PROXY] = rng.choice(
        np.array([0, 0, 10000, 15001, 10001, 7], np.uint32), n)
    return out


# K5/K5s cases: (shards, rows a shard, ring capacity a shard, trace
# sample, valid share or None, listener table?, cursor, TRACE share)
RING_CASES = {
    "empty": (1, 0, 1 << 10, 1024, None, True, (0xFFFFFF00, 2), 0.8),
    "n3000": (1, 3000, 1 << 12, 1024, None, True, (0, 0), 0.8),
    "overflow": (1, 5000, 1 << 10, 1024, None, True, (0, 0), 0.1),
    "carry": (1, 3000, 1 << 12, 0, None, True, (0xFFFFFF00, 2), 0.3),
    "trace0": (1, 3000, 1 << 12, 0, 0.7, True, (0, 0), 0.8),
    "trace7": (1, 3000, 1 << 12, 7, None, True, (0, 0), 0.8),
    "valid": (1, 3000, 1 << 12, 1024, 0.6, True, (5, 0), 0.8),
    "no_listeners": (1, 3000, 1 << 12, 1024, None, False, (0, 0), 0.8),
    "rows_2^19": (1, 1 << 19, 1 << 18, 1024, 0.95, True, (0, 0), 0.9),
    "s8_empty": (8, 0, 1 << 10, 1024, None, True, (0xFFFFFF00, 2), 0.8),
    "s8": (8, 3000, 1 << 10, 7, 0.8, True, (0xFFFFFFF0, 0), 0.5),
    "s8_2^16": (8, 1 << 16, 1 << 14, 1024, 0.9, True, (0, 0), 0.9),
    "s8_2^19": (8, 1 << 19, 1 << 16, 1024, None, False, (0, 0), 0.95),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_append_is_one_launch_matching_its_plain_version(case):
    """K5 and K5s, one cooperative kernel a call, against the plain
    version (per shard for K5s) on the same CUDA tensors: the ring's
    buffer and cursors bit-exact for an empty batch, rows not a multiple
    of the block, more kept rows than the ring holds, the cursor's carry
    into its high word, trace samples 0, 7 and 1024, ``valid`` None and
    masked, no listener table, 8 shards, and the launcher's largest
    batch (2^19 rows a shard, alone and over 8 shards: each thread holds
    several rows)."""
    _need_card()
    from cilium_tpu_torch import u32
    from cilium_tpu_torch.kernels import launch_ring_append
    from cilium_tpu_torch.parallel import mesh as pm

    s, block, cap, ts, vfrac, listeners, cursor, trace = RING_CASES[case]
    rng = np.random.default_rng(71)
    n = s * block
    out = u32.from_numpy(_ring_out(rng, n, trace), "cuda")
    valid = (None if vfrac is None
             else torch.from_numpy(rng.random(n) < vfrac).cuda())
    pp = (u32.from_numpy(np.array([10000, 10001, 15001], np.uint32), "cuda")
          if listeners else None)
    sh = None if s == 1 else s

    def fresh():
        r = (pm.make_sharded_ring(pm.make_mesh(s), cap) if sh
             else tring.EventRing.create(cap, "cuda"))
        r.cursor.copy_(u32.from_numpy(np.tile(np.array(
            cursor, np.uint32), (s, 1)).reshape(r.cursor.shape), "cuda"))
        return r

    for batch_id in (8190, 8191):  # two calls: the second on the first
        if batch_id == 8190:
            k, p = fresh(), fresh()
        launch_ring_append(k, out, batch_id, ts, valid, pp, n_shards=sh)
        if sh:
            pm.sharded_ring_append_plain(p, out, batch_id, s, ts, valid, pp)
        else:
            tring.ring_append_plain(p, out, batch_id, ts, valid, pp)
        assert torch.equal(k.buf, p.buf), batch_id
        assert torch.equal(k.cursor, p.cursor), batch_id
    totals = tring._cursor_totals(u32.to_numpy(k.cursor))
    start = tring._cursor_totals(np.tile(np.array(cursor, np.uint32),
                                         (s, 1)))
    if case == "overflow":
        assert int(totals[0] - start[0]) > 2 * cap
    if case in ("carry", "s8"):
        assert (totals >> 32 > start >> 32).all()
    if block == 0:
        assert (totals == start).all()
    _one_kernel(lambda: functools.partial(
        launch_ring_append, fresh(), out, 7, ts, valid, pp, n_shards=sh),
        "ring_append_kernel")
