"""CT and NAT restore (ROADMAP A4) in the port against the JAX package:
``TorchLoader.ct_restore`` of dense rows and of a full hashed table,
``nat_restore``, the daemon's CT snapshot surface (``ct_snapshot_now``,
``ct_snapshot_info``, ``restore_ct_snapshot``, the ``ct-snapshot``
controller) and ``checkpoint``/``restore`` with the checkpoint on
``shutdown``.  Mirrors ``tests/test_nat.py::test_nat_survives_checkpoint_
restore`` and the restore paths of ``tests/test_serving_faults.py``; the
port's CT row sets equal the reference's after the same sequence."""

import ipaddress
import json
import time

import numpy as np
import pytest
import torch

from cilium_tpu.agent import Daemon as JDaemon, DaemonConfig as JConfig
from cilium_tpu.datapath.loader import TPULoader
from cilium_tpu.testing import fixtures as jfix
from cilium_tpu_torch.agent import Daemon, DaemonConfig
from cilium_tpu_torch.core.packets import (COL_DST_IP3, COL_SPORT, TCP_SYN,
                                           make_batch)
from cilium_tpu_torch.datapath import conntrack as ct
from cilium_tpu_torch.datapath.loader import TorchLoader
from cilium_tpu_torch.testing import fixtures as tfix

torch.set_num_threads(1)

CAP = 1 << 12


def _loaders():
    kw = dict(n_identities=64, n_rules=4, ct_capacity=CAP, n_v6=8)
    w, jw = tfix.build_world(**kw, device="cpu"), jfix.build_world(**kw)
    tl = TorchLoader(ct_capacity=CAP, device="cpu")
    jl = TPULoader(ct_capacity=CAP)
    tl.attach(w.policies, w.ipcache, {0: 0}, w.row_map)
    jl.attach(jw.policies, jw.ipcache, {0: 0}, jw.row_map)
    return tl, jl


def _rows(rng, n):
    rows = np.zeros((n, ct.ROW_WORDS), np.uint32)
    rows[:, :ct.KEY_WORDS] = rng.integers(0, 1 << 32, (n, ct.KEY_WORDS),
                                          dtype=np.uint64)
    rows[:, ct.V_STATE] = rng.integers(1, 4, n)
    rows[:, ct.V_EXPIRES] = rng.integers(1, 1 << 20, n)
    rows[:, ct.V_TX_PKTS:] = rng.integers(0, 1 << 16, (n, 5))
    return rows


def _row_set(rows):
    return sorted(map(bytes, np.asarray(rows, np.uint32)))


@pytest.mark.parametrize("form", ["dense", "table", "crowded"])
def test_ct_restore_matches_the_reference(form):
    """Dense rows, a full hashed table (live rows taken out and placed
    again) and more rows than the probe windows hold (the rest dropped
    and counted): snapshots, tables, fingerprints and drops equal."""
    tl, jl = _loaders()
    rng = np.random.default_rng(len(form))
    rows = _rows(rng, 1500 if form != "crowded" else 6000)
    if form == "table":
        rows, _n = ct.ct_table_from_rows(rows, 1 << 13)
    tl.ct_restore(rows)
    jl.ct_restore(rows)
    got, want = tl.ct_snapshot(), jl.ct_snapshot()
    np.testing.assert_array_equal(got, want)
    for name in ("table", "fp"):
        np.testing.assert_array_equal(
            getattr(tl.state.ct, name).numpy().view(np.uint32),
            np.asarray(getattr(jl.state.ct, name)))
    dropped = int(tl.state.ct.dropped) & 0xFFFFFFFF
    assert dropped == int(jl.state.ct.dropped)
    assert (dropped > 0) == (form == "crowded")
    assert len(got) + dropped == len(ct.ct_rows_from_table(rows))
    with pytest.raises(ValueError):
        tl.ct_restore(rows[:, :5])


def test_restored_flows_are_found_by_the_step():
    """After a restore the verdict step finds the restored entries: a
    reply to a restored forward flow is REPLY, as on the reference."""
    tl, jl = _loaders()
    w = tfix.build_world(64, 4, ct_capacity=CAP, n_v6=8, device="cpu")
    rng = np.random.default_rng(3)
    pool = tfix.steady_flow_pool(w, 256, rng)
    tl.step(pool, 100)
    snap = tl.ct_snapshot()
    fresh = TorchLoader(ct_capacity=CAP, device="cpu")
    fresh.attach(w.policies, w.ipcache, {0: 0}, w.row_map)
    fresh.ct_restore(snap)
    jl.ct_restore(snap)
    later = tfix.steady_traffic(pool, 256, rng)
    got, _ = fresh.step(later, 101)
    want, _ = jl.step(later, 101)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got[:, 2] != ct.CT_NEW).any()
    np.testing.assert_array_equal(fresh.ct_snapshot(), jl.ct_snapshot())


def _daemons(**over):
    cfg = dict(backend="tpu", ct_capacity=CAP)
    cfg.update(over)
    return (Daemon(DaemonConfig(**cfg), device="cpu"),
            JDaemon(JConfig(**cfg)))


def _flows(ep_id, n=32):
    return make_batch([
        dict(src="10.0.1.1", dst="10.0.2.1", sport=30000 + i, dport=5432,
             proto=6, flags=TCP_SYN, ep=ep_id, dir=0)
        for i in range(n)]).data


def test_ct_snapshot_surface_matches_the_reference():
    """ct_snapshot_now / ct_snapshot_info / restore_ct_snapshot: the
    snapshot of established flows survives a wiped CT in both."""
    snaps = []
    for d in _daemons():
        assert d.ct_snapshot_info() is None
        assert d.restore_ct_snapshot() is False
        db = d.add_endpoint("db", ("10.0.2.1",), ["k8s:app=db"])
        d.process_batch(_flows(db.id), now=10)
        info = d.ct_snapshot_now()
        assert info["trigger"] == "manual" and info["entries"] == 32
        assert info["mode"] == "offline"
        d.loader.ct_restore(np.zeros((0, ct.ROW_WORDS), np.uint32))
        assert len(d.loader.ct_snapshot()) == 0
        assert d.restore_ct_snapshot() is True
        snaps.append(d.loader.ct_snapshot())
        d.shutdown()
    assert len(snaps[0]) == 32
    np.testing.assert_array_equal(snaps[0], snaps[1])


def test_ct_snapshot_controller_runs_on_its_interval():
    d = Daemon(DaemonConfig(ct_capacity=CAP, ct_snapshot_interval=0.02),
               device="cpu")
    d.start()
    t0 = time.monotonic()
    while (d.ct_snapshot_info() is None
           and time.monotonic() - t0 < 30):
        time.sleep(0.01)
    info = d.ct_snapshot_info()
    assert info is not None and info["trigger"] == "interval"
    assert "ct-snapshot" in d.controllers.statuses()
    d.shutdown()


def test_nat_survives_checkpoint_restore(tmp_path):
    """Replies to allocated node ports keep reverse-translating across
    an agent restart, in both packages, with the same node port and the
    same CT afterwards; the port's checkpoint is the one its shutdown
    writes (``state_dir``)."""
    results = []
    for which in ("port", "reference"):
        state_dir = str(tmp_path / which)
        cfg = dict(backend="tpu", ct_capacity=CAP, masquerade=True,
                   node_ip="192.168.0.1", state_dir=state_dir)
        mk = ((lambda: Daemon(DaemonConfig(**cfg), device="cpu"))
              if which == "port" else (lambda: JDaemon(JConfig(**cfg))))
        d = mk()
        a = d.add_endpoint("pa", ("10.0.2.1",), ["k8s:app=a"])
        d.start()
        out = make_batch([dict(src="10.0.2.1", dst="8.8.8.8", sport=40000,
                               dport=53, proto=17, ep=a.id, dir=1)]).data
        p = int(d.process_batch(out, now=5).hdr[0, COL_SPORT])
        if which == "port":
            d.shutdown()  # checkpoints into state_dir
        else:
            d.checkpoint(state_dir)
        meta = json.load(open(f"{state_dir}/state.json"))
        assert meta["version"] == "0.1.0" and meta["endpoints"]
        d2 = mk()
        assert d2.restore(state_dir)
        reply = make_batch([dict(src="8.8.8.8", dst="192.168.0.1", sport=53,
                                 dport=p, proto=17, ep=a.id, dir=0)]).data
        ev = d2.process_batch(reply, now=8)
        assert int(ev.hdr[0, COL_DST_IP3]) == int(
            ipaddress.IPv4Address("10.0.2.1"))
        assert d2.status()["nat"]["alloc-failed"] == 0
        results.append((p, _row_set(d2.loader.ct_snapshot()),
                        np.asarray(d2.loader.nat_snapshot())))
        if which == "reference":
            d.shutdown()
        d2.shutdown()
    assert results[0][0] == results[1][0]
    assert results[0][1] == results[1][1]
    np.testing.assert_array_equal(results[0][2], results[1][2])


def test_restore_skips_a_torn_checkpoint(tmp_path):
    """A CT snapshot whose policy revision differs from state.json's is
    skipped (never resurrects flows of a since-revoked policy)."""
    state_dir = str(tmp_path / "st")
    d = Daemon(DaemonConfig(ct_capacity=CAP), device="cpu")
    db = d.add_endpoint("db", ("10.0.2.1",), ["k8s:app=db"])
    d.process_batch(_flows(db.id), now=10)
    d.checkpoint(state_dir)
    assert d.ct_snapshot_info()["trigger"] == "checkpoint"
    meta = json.load(open(f"{state_dir}/state.json"))
    meta["revision"] += 1
    json.dump(meta, open(f"{state_dir}/state.json", "w"))
    d2 = Daemon(DaemonConfig(ct_capacity=CAP), device="cpu")
    assert d2.restore(state_dir)
    assert len(d2.loader.ct_snapshot()) == 0
    assert [e.name for e in d2.endpoints.list()] == ["db"]
    assert Daemon(DaemonConfig(ct_capacity=CAP), device="cpu").restore(
        str(tmp_path / "none")) is False
    d.shutdown()
    d2.shutdown()
