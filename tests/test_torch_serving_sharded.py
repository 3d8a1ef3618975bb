"""Sharded serving through the port's daemon on the CPU against the JAX
daemon on a 4-device CPU mesh: flow-routed dispatch through the sharded
serve step, flow-affine conntrack, router-overflow accounting, per-shard
rings drained round-robin with no event lost, and the ladder's sharded
demotion carrying the CT.  Mirrors ``tests/test_serving_sharded.py`` and
``tests/test_serving_faults.py::TestLadderDemotion::
test_sharded_demotion_preserves_established_ct``: for each, the port's
per-reason metrics and event counts equal the reference's, and so do
the Hubble flows both observers hold (``to_dict``, wall-clock times
aside): every published event a flow, the overflow drops rendered
QUEUE_OVERFLOW.

Four shards, not the reference's eight: the reference's sharded compile
is its suite's largest cost, and the properties do not depend on S.
"""

import time

import numpy as np
import pytest
import torch

from cilium_tpu.agent import Daemon as JDaemon, DaemonConfig as JConfig
from cilium_tpu.parallel import make_mesh as jmake_mesh
from cilium_tpu_torch.agent import Daemon, DaemonConfig
from cilium_tpu_torch.core.packets import (COL_DIR, TCP_ACK, TCP_SYN,
                                           make_batch)
from cilium_tpu_torch.datapath.verdict import REASON_ROUTE_OVERFLOW
from cilium_tpu_torch.monitor.api import (DROP_REASON_NAMES, MSG_DROP,
                                          MSG_POLICY_VERDICT, DropNotify,
                                          materialize)
from cilium_tpu_torch.parallel import make_mesh

torch.set_num_threads(1)

S = 4

RULES = [{
    "endpointSelector": {"matchLabels": {"app": "db"}},
    "ingress": [{
        "fromEndpoints": [{"matchLabels": {"app": "web"}}],
        "toPorts": [{"ports": [{"port": "5432", "protocol": "TCP"}]}],
    }],
}]

# db with egress enforced: a db-sourced reply passes its egress hook
# only through the CT reply path, on the shard its forward packet used
RULES_EGRESS_ENFORCED = [{
    **RULES[0],
    "egress": [{
        "toEndpoints": [{"matchLabels": {"app": "db"}}],
        "toPorts": [{"ports": [{"port": "1", "protocol": "TCP"}]}],
    }],
}]


def _pair(rules=RULES, **over):
    """The port's daemon (CPU) and the reference's, on one config."""
    cfg = dict(backend="tpu", ct_capacity=1 << 12,
               flow_ring_capacity=1 << 13,
               serving_bucket_ladder=(64, 256))
    cfg.update(over)
    out = []
    for d in (Daemon(DaemonConfig(**cfg), device="cpu"),
              JDaemon(JConfig(**cfg))):
        d.add_endpoint("web", ("10.0.1.1",), ["k8s:app=web"])
        db = d.add_endpoint("db", ("10.0.2.1",), ["k8s:app=db"])
        d.policy_import(rules)
        got = []
        d.monitor.register("t", got.append)
        out.append((d, db, got))
    return out


def _meshes():
    return make_mesh(S, "cpu"), jmake_mesh(S)


def _syns(db_id, base, n=64, allow_every=2):
    """NEW flows into db: every ``allow_every``-th to 5432, the rest to
    a denied port."""
    return make_batch([
        dict(src="10.0.1.1", dst="10.0.2.1", sport=base + i,
             dport=5432 if i % allow_every == 0 else 9999, proto=6,
             flags=TCP_SYN, ep=db_id, dir=0)
        for i in range(n)]).data


def _replies(db_id, base, n=32):
    return make_batch([
        dict(src="10.0.2.1", dst="10.0.1.1", sport=5432, dport=base + i,
             proto=6, flags=TCP_ACK, ep=db_id, dir=1)
        for i in range(n)]).data


def _events(got):
    msg = (np.concatenate([b.msg_type for b in got]) if got
           else np.zeros(0, np.uint8))
    return int((msg == MSG_POLICY_VERDICT).sum()), int((msg == MSG_DROP).sum())


def _flows(d):
    out = [f.to_dict() for f in d.observer.get_flows(number=1 << 13)]
    for f in out:
        f.pop("time")
    return out


def _same(pair):
    """Equal per-reason metrics, event counts and Hubble flows in both
    daemons; every published event became a flow."""
    (td, _, tgot), (jd, _, jgot) = pair
    np.testing.assert_array_equal(td.loader.metrics(), jd.loader.metrics())
    assert _events(tgot) == _events(jgot)
    assert td.observer.seq == td.monitor.published == jd.observer.seq
    assert _flows(td) == _flows(jd)


def _shutdown(pair):
    for d, _db, _got in pair:
        d.shutdown()


def test_events_survive_the_sharded_path():
    pair = _pair()
    stats = []
    for (d, db, _got), mesh in zip(pair, _meshes()):
        d.start_serving(ring_capacity=1 << 10, drain_every=2,
                        trace_sample=0, packed=True, mesh=mesh)
        for i in range(6):
            info = d.serve_batch(_syns(db.id, 20000 + 100 * i), now=10 + i)
            assert info["mode"] == "sharded-packed"
        stats.append(d.stop_serving())
    for st in stats:
        assert st["lost"] == 0 and st["shards"] == S
        assert st["route-overflow"] == 0
    assert stats[0]["events"] == stats[1]["events"] == 6 * 64
    _same(pair)
    tgot = pair[0][2]
    assert _events(tgot) == (6 * 32, 6 * 32)
    for b in tgot:  # padding never leaks an event
        assert (b.hdr.sum(axis=1) != 0).all()
    _shutdown(pair)


def test_flow_affine_conntrack():
    """A reply forwards only through the CT entry its forward packet
    created on the same shard; the control (tuples with no forward)
    default-denies at db's enforced egress hook."""
    pair = _pair(RULES_EGRESS_ENFORCED)
    verdicts = []
    for (d, db, got), mesh in zip(pair, _meshes()):
        d.start_serving(ring_capacity=1 << 10, drain_every=2,
                        trace_sample=1, packed=True, mesh=mesh)
        d.serve_batch(_syns(db.id, 30000, 32, allow_every=1), now=100)
        d.serve_batch(_replies(db.id, 30000), now=101)
        d.serve_batch(_replies(db.id, 50000), now=102)
        assert d.stop_serving()["lost"] == 0

        def verdicts_for(base):
            out = []
            for b in got:
                m = ((b.hdr[:, 9] >= base) & (b.hdr[:, 9] < base + 32)
                     & (b.hdr[:, 8] == 5432))
                out.extend(int(v) for v in b.verdict[m])
            return out

        verdicts.append((verdicts_for(30000), verdicts_for(50000)))
    reply_v, ctrl_v = verdicts[0]
    assert len(reply_v) == 32 and all(v != 0 for v in reply_v)
    assert len(ctrl_v) == 32 and all(v == 0 for v in ctrl_v)
    assert verdicts[0] == verdicts[1]
    _same(pair)
    _shutdown(pair)


def test_route_overflow_counted_and_decoded():
    """One elephant flow overwhelms its shard's block (headroom 1):
    counted as REASON_ROUTE_OVERFLOW in the metricsmap and surfaced as
    one DROP event a packet."""
    pair = _pair(serving_bucket_ladder=(64,))
    for (d, db, _got), mesh in zip(pair, _meshes()):
        d.start_serving(ring_capacity=1 << 10, drain_every=2,
                        trace_sample=0, packed=True, mesh=mesh,
                        shard_headroom=1)
        one_flow = make_batch([
            dict(src="10.0.1.1", dst="10.0.2.1", sport=33333, dport=5432,
                 proto=6, flags=TCP_ACK, ep=db.id, dir=0)] * 64).data
        d.serve_batch(one_flow, now=10)
        st = d.stop_serving()
        # 64 rows of one flow, block 64 / S: the rest overflow
        assert st["route-overflow"] == 64 - 64 // S
        assert int(d.loader.metrics()[REASON_ROUTE_OVERFLOW, 0]) == \
            64 - 64 // S
    tgot = pair[0][2]
    drops = [b for b in tgot
             if (np.asarray(b.reason) == REASON_ROUTE_OVERFLOW).any()]
    assert sum(int((np.asarray(b.reason) == REASON_ROUTE_OVERFLOW).sum())
               for b in tgot) == 64 - 64 // S
    assert DropNotify(materialize(drops[0], 0)).reason_name == \
        "Shard queue overflow" == DROP_REASON_NAMES[REASON_ROUTE_OVERFLOW]
    # the flow layer (hubble JSON)
    ovf = [f for f in _flows(pair[0][0])
           if f.get("drop_reason") == REASON_ROUTE_OVERFLOW]
    assert len(ovf) == 64 - 64 // S
    assert ovf[0]["drop_reason_desc"] == "QUEUE_OVERFLOW"
    _same(pair)
    _shutdown(pair)


def test_sharded_ingress_runtime_end_to_end():
    """submit -> batcher -> flow-routed sharded dispatch: every admitted
    packet verdicts, the batches re-pack after routing, and the loader
    leaves the mesh on stop (process_batch works after)."""
    pair = _pair()
    rng = np.random.default_rng(5)
    chunks = [_syns(pair[0][1].id, 40000 + 300 * k,
                    max(int(rng.poisson(100)), 1)) for k in range(8)]
    fes = []
    for (d, _db, _got), mesh in zip(pair, _meshes()):
        d.start_serving(trace_sample=0, ingress=True, packed=True,
                        mesh=mesh)
        sent = sum(d.submit(c) for c in chunks)
        stats = d.stop_serving()
        fe = stats["front-end"]
        assert fe["verdicts"] == fe["admitted"] == sent
        assert stats["lost"] == 0 and stats["shards"] == S
        assert fe["h2d"]["packed-batches"] >= 1
        assert fe["h2d"]["wide-batches"] == 0
        fes.append(fe)
        out = d.process_batch(_syns(pair[0][1].id, 60000, 16), now=999)
        assert len(out) == 16
        assert d.loader._serving_mesh is None
    assert fes[0]["verdicts"] == fes[1]["verdicts"]
    _same(pair)
    _shutdown(pair)


def test_ladder_mesh_mismatch_rejected():
    d = Daemon(DaemonConfig(ct_capacity=1 << 12,
                            serving_bucket_ladder=(2, 256)), device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        d.start_serving(mesh=S)
    with pytest.raises(ValueError, match="shard_headroom"):
        d.start_serving(mesh=2, shard_headroom=0)
    d.shutdown()


def _wait(pred, timeout=60.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            return False
        time.sleep(0.002)
    return True


def test_sharded_demotion_preserves_established_ct():
    """Flows established while sharded still pass their replies after
    the ladder demotes to a single shard: db's egress hook is enforced,
    so a reply passes only through the CT entry carried across by the
    snapshot and ``ct_restore`` (fault spec ``loader.serve_sharded=
    1x2@1``: the second and third sharded dispatches fail)."""
    d = Daemon(DaemonConfig(
        ct_capacity=1 << 12, serving_queue_depth=4096,
        serving_bucket_ladder=(64,), serving_max_wait_us=500.0,
        serving_dispatch_deadline_ms=500.0, serving_restart_budget=4,
        serving_restart_backoff_ms=1.0, serving_demote_threshold=2,
        serving_promote_after=1000, serving_promote_cooldown_s=0.05,
        fault_injection="loader.serve_sharded=1x2@1", fault_seed=1),
        device="cpu")
    d.add_endpoint("web", ("10.0.1.1",), ["k8s:app=web"])
    db = d.add_endpoint("db", ("10.0.2.1",), ["k8s:app=db"])
    d.policy_import(RULES_EGRESS_ENFORCED)
    got = []
    d.monitor.register("t", got.append)
    d.start_serving(ring_capacity=1 << 10, trace_sample=1, ingress=True,
                    packed=True, drain_every=2, mesh=S)
    rt = d._serving["runtime"]
    d.submit(_syns(db.id, 20000, allow_every=1))  # 64 flows, sharded
    assert _wait(lambda: rt.stats.verdicts >= 64)
    assert d.serving_stats()["mode"] == "sharded"
    d.submit(_syns(db.id, 40000, allow_every=1))  # fault 1: contained
    assert _wait(lambda: rt.stats.recovery_dropped >= 64)
    d.submit(_syns(db.id, 41000, allow_every=1))  # fault 2: demote
    assert _wait(lambda: rt.stats.verdicts >= 128)
    st = d.serving_stats()
    assert st["mode"] in ("single", "wide")
    assert st["ladder"]["demotions"] == 1
    assert "shards" not in st
    assert st["ct-snapshot"]["trigger"] == "demotion"
    assert st["ct-snapshot"]["entries"] >= 64
    got.clear()
    d.submit(_replies(db.id, 20000, 64))
    assert _wait(lambda: rt.stats.verdicts >= 192)
    fe = d.stop_serving()["front-end"]
    ft = fe["fault-tolerance"]
    assert fe["submitted"] == fe["verdicts"] + fe["shed"] + \
        ft["recovery-dropped"]
    rep_fwd = rep_drop = 0
    for b in got:
        m = b.hdr[:, COL_DIR] == 1
        rep_fwd += int((b.msg_type[m] != MSG_DROP).sum())
        rep_drop += int((b.msg_type[m] == MSG_DROP).sum())
    assert rep_drop == 0 and rep_fwd == 64, (rep_drop, rep_fwd)
    d.shutdown()
