"""The port's kernels against their plain versions on the card, at a
small size: the slice through CUDA kernels must equal the slice through
the plain PyTorch versions, the maintenance and gather kernels their
plain versions, the superbatch its sequential steps, and the daemon on
the card the daemon on the CPU.  Needs a CUDA device (marker ``gpu``) and
skips without one.  It imports nothing of JAX, so it runs on the card's
machine, which has no JAX:

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

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
