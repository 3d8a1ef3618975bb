"""The delta attach: a re-attach repaints only the policies whose
fingerprints changed (``policy.incremental.delta_compile``), each
changed slice written into the live verdict tensor by the ``dus``
kernel's plain version here (K10 on the card).

The port (``device="cpu"``) against the JAX package (JAX on the CPU),
as ``tests/test_churn_gate.py`` pins the reference:

- ``TestDeltaCompile``: the port's ``DeltaPlan`` (changed rows, painted
  slices, class structure, policy index) equals the reference's
  ``delta_compile`` on the same policies, array for array, in the four
  compiler cases;
- the loader: a re-attach takes the delta path on both packages, and
  the published tables (verdict, port_class, class_map, ep_policy,
  auth) equal the reference's and a full compile's bit for bit, also
  when an edit moves a port boundary;
- mid-swap faults: an attach that dies at the build, at the swap
  instant, or between two slice writes heals to the pre-edit tables,
  and the retry then equals the reference."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from cilium_tpu.agent import Daemon as JDaemon, DaemonConfig as JConfig
from cilium_tpu.core import make_batch
from cilium_tpu.policy import compile_policy as jcompile_policy
from cilium_tpu.policy import IdentityRowMap as JIdentityRowMap
from cilium_tpu.policy.compiler import policy_fingerprint as jfingerprint
from cilium_tpu.policy.incremental import delta_compile as jdelta_compile
from cilium_tpu.testing.workloads import (ChurnOp as JChurnOp,
                                          IdentityChurnScenario as JScenario)
from cilium_tpu_torch import u32
from cilium_tpu_torch.agent import Daemon, DaemonConfig
from cilium_tpu_torch.core.packets import TCP_SYN
from cilium_tpu_torch.datapath import loader as loader_mod
from cilium_tpu_torch.infra import faults
from cilium_tpu_torch.policy.compiler import (IdentityRowMap,
                                              compile_policy,
                                              policy_fingerprint)
from cilium_tpu_torch.policy.incremental import delta_compile
from cilium_tpu_torch.testing.workloads import (ChurnOp,
                                                IdentityChurnScenario)

torch.set_num_threads(1)

CT = 1 << 12
STEP_ROWS = 8  # every step of these tests: one JAX executable
# tests/test_churn_gate.py's world
RULES = [{
    "endpointSelector": {"matchLabels": {"app": "db"}},
    "ingress": [
        {"fromEndpoints": [{"matchLabels": {"app": "web"}}],
         "toPorts": [{"ports": [{"port": "5432", "protocol": "TCP"}]}]},
        {"fromEndpoints": [{"matchLabels": {"churn": "yes"}}],
         "toPorts": [{"ports": [{"port": "5432", "protocol": "TCP"}]}]},
    ],
}]
# an edit of web's and db's policies that adds a port boundary (7000)
BOTH_RULES = [{
    "endpointSelector": {"matchExpressions": [
        {"key": "app", "operator": "In", "values": ["web", "db"]}]},
    "ingress": [{"fromEndpoints": [{"matchLabels": {"app": "web"}}],
                 "toPorts": [{"ports": [{"port": "7000",
                                         "protocol": "TCP"}]}]}],
}]
# an edit of db's policy alone that adds a port boundary (6000-6010)
DB_RANGE_RULES = [{
    "endpointSelector": {"matchLabels": {"app": "db"}},
    "ingress": [{"fromEndpoints": [{"matchLabels": {"app": "web"}}],
                 "toPorts": [{"ports": [{"port": "6000", "endPort": 6010,
                                         "protocol": "TCP"}]}]}],
}]


@pytest.fixture(autouse=True)
def _disarm_port_faults():
    """No armed injector of the port may leak into the next test."""
    yield
    faults.disarm()


def _world(d, rules=RULES, start=True):
    d.add_endpoint("web", ("10.0.1.1",), ["k8s:app=web"])
    db = d.add_endpoint("db", ("10.0.2.1",), ["k8s:app=db"])
    d.policy_import(rules)
    if start:
        d.start()
    return db.id


def _jdaemon(backend="tpu", **over):
    cfg = dict(backend=backend, ct_capacity=CT, enable_hubble=False,
               flow_agg_enabled=False, history_interval=0.0)
    cfg.update(over)
    return JDaemon(JConfig(**cfg))


def _pair(**over):
    """A JAX daemon and a port daemon built alike (delta attach on by
    default on both); returns (jd, td, db id)."""
    jd = _jdaemon(**over)
    td = Daemon(DaemonConfig(ct_capacity=CT, **over), device="cpu")
    ids = [_world(d) for d in (jd, td)]
    assert ids[0] == ids[1]
    return jd, td, ids[0]


def _np(t):
    return u32.to_numpy(t).view(np.int32)


POLICY_FIELDS = ("verdict", "port_class", "class_map", "ep_policy", "auth")


def _tables(loader):
    """A copy of the published policy tables of either package as int32
    numpy (on the CPU a tensor's numpy view would share its memory)."""
    p = loader.state.policy
    out = {}
    for f in POLICY_FIELDS:
        t = getattr(p, f)
        out[f] = (_np(t) if isinstance(t, torch.Tensor)
                  else np.asarray(t).view(np.int32)).copy()
    return out


def _assert_tables_equal(a, b):
    for f in POLICY_FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def _syn_rows(specs, ep, sport0):
    specs = list(specs) + [("10.0.1.1", 5432)] * (STEP_ROWS - len(specs))
    return make_batch([dict(src=src, dst="10.0.2.1", sport=sport0 + i,
                            dport=dport, proto=6, flags=TCP_SYN, ep=ep,
                            dir=0)
                       for i, (src, dport) in enumerate(specs)]).data


def _step(d, specs, ep, sport0, now=10):
    return np.asarray(d.loader.step(_syn_rows(specs, ep, sport0),
                                    now=now)[0])


def _assert_plans_equal(got, want):
    """The port's DeltaPlan against the reference's, array for array."""
    if want is None:
        assert got is None
        return
    assert got is not None
    assert got.changed == want.changed
    assert got.class_structure_changed == want.class_structure_changed
    assert got.policy_index == want.policy_index
    assert sorted(got.slices) == sorted(want.slices)
    for pi, sl in want.slices.items():
        np.testing.assert_array_equal(got.slices[pi], sl)
    gs, ws = got.struct, want.struct
    np.testing.assert_array_equal(gs.port_class, ws.port_class)
    np.testing.assert_array_equal(gs.class_map, ws.class_map)
    assert (gs.n_classes, gs.n_local_padded) == (ws.n_classes,
                                                  ws.n_local_padded)
    assert gs.class_intervals == ws.class_intervals


# -- the compiler (tests/test_churn_gate.py TestDeltaCompile) ----------
class TestDeltaCompile:
    def _world(self):
        """The web + db world's attached policies, row map and a fresh
        compile, on each package: [(daemon, policies, row_map, old)]
        for the reference, then the port."""
        jd = _jdaemon(backend="interpreter")
        td = Daemon(DaemonConfig(ct_capacity=CT), device="cpu")
        out = []
        for d, compile_fn in ((jd, jcompile_policy), (td, compile_policy)):
            _world(d)
            policies = list(d.endpoints._attached_policies)
            assert len(policies) >= 2
            row_map = d.endpoints.row_map
            out.append((d, policies, row_map,
                        compile_fn(policies, row_map)))
        return out

    @staticmethod
    def _shutdown(sides):
        for d, *_ in sides:
            d.shutdown()

    def test_identity_set_change_repaints_only_selecting_policy(self):
        sides = self._world()
        fps_of = (jfingerprint, policy_fingerprint)
        compile_of = (jcompile_policy, compile_policy)
        delta_of = (jdelta_compile, delta_compile)
        # the same contribution and extra identity on both packages
        _d, jpols, _rm, _old = sides[0]
        pi_sel, ci, target = next(
            (pi, i, c) for pi, p in enumerate(jpols)
            for i, c in enumerate(p.ingress.contributions)
            if c.identities)
        extra = next(ident.numeric_id
                     for ident in sides[1][0].allocator.all_identities()
                     if ident.numeric_id not in target.identities)
        plans = []
        for k, (d, policies, row_map, old) in enumerate(sides):
            fps_old = [fps_of[k](p) for p in policies]
            row_map.add(extra)
            old = compile_of[k](policies, row_map)  # rows settled
            c = policies[pi_sel].ingress.contributions[ci]
            assert c.identities == target.identities
            policies[pi_sel].ingress.contributions[ci] = replace(
                c, identities=c.identities | {extra})
            fps_new = [fps_of[k](p) for p in policies]
            plan = delta_of[k](old, policies, row_map, fps_old, fps_new)
            assert plan is not None
            assert plan.changed == [pi_sel]
            assert not plan.class_structure_changed
            # delta result == full recompile, byte for byte
            full = compile_of[k](policies, row_map)
            merged = old.verdict.copy()
            for pi in plan.changed:
                merged[pi] = plan.slices[pi]
            np.testing.assert_array_equal(merged, full.verdict)
            plans.append(plan)
        _assert_plans_equal(plans[1], plans[0])
        self._shutdown(sides)

    def test_port_boundary_change_recomputes_class_structure(self):
        sides = self._world()
        fps_of = (jfingerprint, policy_fingerprint)
        delta_of = (jdelta_compile, delta_compile)
        _d, jpols, _rm, _old = sides[0]
        pi_sel, ci, _target = next(
            (pi, i, c) for pi, p in enumerate(jpols)
            for i, c in enumerate(p.ingress.contributions)
            if 0 < c.hi < 65500)
        plans = []
        for k, (d, policies, row_map, old) in enumerate(sides):
            fps_old = [fps_of[k](p) for p in policies]
            c = policies[pi_sel].ingress.contributions[ci]
            policies[pi_sel].ingress.contributions[ci] = replace(
                c, hi=c.hi + 7)
            fps_new = [fps_of[k](p) for p in policies]
            plans.append(delta_of[k](old, policies, row_map, fps_old,
                                     fps_new))
        assert plans[0] is not None
        assert plans[0].changed == [pi_sel]
        assert plans[0].class_structure_changed
        _assert_plans_equal(plans[1], plans[0])
        # the port's merged tensor answers every lookup as a fresh
        # compile does
        _d, policies, row_map, old = sides[1]
        full = compile_policy(policies, row_map)
        plan = plans[1]
        merged = old.verdict.copy()
        for pi in plan.changed:
            merged[pi] = plan.slices[pi]
        rng = np.random.default_rng(7)
        n = 512
        pr = rng.integers(0, len(policies), n)
        di = rng.integers(0, 2, n)
        rows = rng.integers(0, row_map.n_rows, n)
        proto = rng.choice([6, 17, 1, 47], n)
        dport = rng.integers(0, 65536, n)
        got_cls = plan.struct.class_map[
            pr, plan.struct.port_class[full.proto_table[proto], dport]]
        want_cls = full.class_map[
            pr, full.port_class[full.proto_table[proto], dport]]
        np.testing.assert_array_equal(
            merged[pr, di, rows, got_cls],
            full.verdict[pr, di, rows, want_cls])
        self._shutdown(sides)

    def test_no_change_means_no_repaint(self):
        sides = self._world()
        fps_of = (jfingerprint, policy_fingerprint)
        delta_of = (jdelta_compile, delta_compile)
        plans = []
        for k, (d, policies, row_map, old) in enumerate(sides):
            fps = [fps_of[k](p) for p in policies]
            plans.append(delta_of[k](old, policies, row_map, fps,
                                     list(fps)))
        assert plans[0] is not None and plans[0].changed == []
        _assert_plans_equal(plans[1], plans[0])
        self._shutdown(sides)

    def test_fallback_conditions(self):
        sides = self._world()
        fps_of = (jfingerprint, policy_fingerprint)
        delta_of = (jdelta_compile, delta_compile)
        fresh_map = (JIdentityRowMap, IdentityRowMap)
        for k, (d, policies, row_map, old) in enumerate(sides):
            fps = [fps_of[k](p) for p in policies]
            delta = delta_of[k]
            # policy count changed
            assert delta(old, policies[:-1], row_map, fps, fps[:-1]) is None
            # different row map
            assert delta(old, policies, fresh_map[k](), fps, fps) is None
            # no previous fingerprints
            assert delta(old, policies, row_map, None, fps) is None
        self._shutdown(sides)


# -- the loader (tests/test_churn_gate.py TestLoaderGenerations) --------
def test_reattach_takes_the_delta_path():
    """Re-importing the rules APPENDS them: only db's resolved policy
    changes, so the delta repaints exactly one policy, on both
    packages, and the published tables stay equal bit for bit."""
    jd, td, db = _pair()
    s0 = [d.loader.table_stats() for d in (jd, td)]
    for d in (jd, td):
        d.policy_import(RULES)
    s1 = [d.loader.table_stats() for d in (jd, td)]
    for a, b in zip(s0, s1):
        assert b["delta-attaches"] == a["delta-attaches"] + 1
        assert b["policies-recompiled"] == a["policies-recompiled"] + 1
    for k in ("generation", "full-attaches", "delta-attaches",
              "policies-recompiled"):
        assert s1[1][k] == s1[0][k], k
    _assert_tables_equal(_tables(td.loader), _tables(jd.loader))
    for d in (jd, td):
        d.shutdown()


def test_delta_attach_matches_full_compile_verdicts():
    """A churn mint, then a re-attach: the port's delta tables equal a
    full-compiling port daemon's and the JAX delta daemon's bit for
    bit, and their steps give the same out rows."""
    jd, td, db = _pair()
    tf = Daemon(DaemonConfig(ct_capacity=CT, policy_delta_compile=False),
                device="cpu")
    assert _world(tf) == db
    for d, sc, op in ((jd, JScenario(seed=5, n_slots=4), JChurnOp),
                      (td, IdentityChurnScenario(seed=5, n_slots=4),
                       ChurnOp),
                      (tf, IdentityChurnScenario(seed=5, n_slots=4),
                       ChurnOp)):
        sc.apply(d, op("mint", 1, sc.slot_cidr(1), 0.0), {})
        d.policy_import(RULES)  # re-attach (delta vs full)
    assert td.loader.table_stats()["delta-attaches"] > 0
    assert tf.loader.table_stats()["delta-attaches"] == 0
    want = _tables(jd.loader)
    for d in (td, tf):
        _assert_tables_equal(_tables(d.loader), want)
    sc = IdentityChurnScenario(seed=5, n_slots=4)
    specs = [("10.0.1.1", 5432), ("10.0.1.1", 9999),
             (sc.slot_ip(1), 5432), (sc.slot_ip(2), 5432)]
    outs = [_step(d, specs, db, 21000) for d in (jd, td, tf)]
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[2], outs[0])
    assert outs[1][:4, 0].tolist() == [1, 0, 1, 0]
    for d in (jd, td, tf):
        d.shutdown()


@pytest.mark.parametrize("rules,n_changed", [(BOTH_RULES, 2),
                                             (DB_RANGE_RULES, 1)])
def test_delta_attach_moving_a_port_boundary(rules, n_changed):
    """An edit that adds a port boundary moves the global class
    partition: the delta re-uploads port_class and class_map, and the
    tables still equal the reference's and a full compile's."""
    jd, td, db = _pair()
    tf = Daemon(DaemonConfig(ct_capacity=CT, policy_delta_compile=False),
                device="cpu")
    _world(tf)
    pc0 = _np(td.loader.state.policy.port_class).copy()
    s0 = td.loader.table_stats()
    for d in (jd, td, tf):
        d.policy_import(rules)
    s1 = td.loader.table_stats()
    assert s1["delta-attaches"] == s0["delta-attaches"] + 1
    assert s1["policies-recompiled"] == s0["policies-recompiled"] + n_changed
    assert not np.array_equal(_np(td.loader.state.policy.port_class), pc0)
    want = _tables(jd.loader)
    for d in (td, tf):
        _assert_tables_equal(_tables(d.loader), want)
    port = 7000 if rules is BOTH_RULES else 6005
    specs = [("10.0.1.1", 5432), ("10.0.1.1", port), ("10.0.1.1", 9999)]
    outs = [_step(d, specs, db, 26000) for d in (jd, td, tf)]
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[2], outs[0])
    assert outs[1][:3, 0].tolist() == [1, 1, 0]
    for d in (jd, td, tf):
        d.shutdown()


# -- mid-swap faults (tests/test_churn_gate.py TestMidSwapFaults) ------
@pytest.mark.parametrize("site", ["churn.build", "churn.swap", "mid-chain"])
def test_failed_delta_attach_heals_to_the_pre_edit_tables(site):
    """A delta attach of an edit to both policies that dies at the
    build, at the swap instant, or between its two slice writes (the
    first slice already in the live verdict tensor) leaves the
    generation, the device tables and the host mirrors exactly as
    published; the retry takes the delta path and equals the JAX
    loader after the same edit."""
    jd, td, db = _pair()
    tl = td.loader
    specs = [("10.0.1.1", 5432), ("10.0.1.1", 7000), ("10.0.1.1", 9999)]
    before = _step(td, specs, db, 27000)
    s0, dev0 = tl.table_stats(), _tables(tl)
    mir0 = (tl.tensors.verdict.copy(), tl.tensors.port_class.copy(),
            tl.tensors.class_map.copy(), tl._epp.copy(),
            list(tl._policy_fps))
    # the edit lands in the repository; the attach runs by hand
    td.endpoints.regenerate = lambda: None
    td.policy_import(BOTH_RULES)
    del td.endpoints.regenerate
    real = loader_mod._dus
    calls = {"n": 0}

    def dying(dst, upd, starts):
        calls["n"] += 1
        if calls["n"] == 2:  # after the first slice landed
            raise RuntimeError("chain died mid-delta")
        return real(dst, upd, starts)

    if site == "mid-chain":
        loader_mod._dus = dying
        err = (RuntimeError, "mid-delta")
    else:
        faults.arm(f"{site}=1x1", seed=1)
        err = (faults.InjectedFault, None)
    try:
        with pytest.raises(err[0], match=err[1]):
            td.endpoints._regenerate_all()
    finally:
        loader_mod._dus = real
        faults.disarm()
    if site == "mid-chain":
        assert calls["n"] == 2
    s1 = tl.table_stats()
    assert s1["generation"] == s0["generation"]
    assert s1["failed-builds"] == s0["failed-builds"] + 1
    assert s1["delta-attaches"] == s0["delta-attaches"]
    assert not tl._swap_incomplete
    _assert_tables_equal(_tables(tl), dev0)
    np.testing.assert_array_equal(tl.tensors.verdict, mir0[0])
    np.testing.assert_array_equal(tl.tensors.port_class, mir0[1])
    np.testing.assert_array_equal(tl.tensors.class_map, mir0[2])
    np.testing.assert_array_equal(tl._epp, mir0[3])
    assert tl._policy_fps == mir0[4]
    np.testing.assert_array_equal(_step(td, specs, db, 27100), before)
    # the retry takes the delta path and equals the reference
    td.endpoints._regenerate_all()
    jd.policy_import(BOTH_RULES)
    assert tl.table_stats()["delta-attaches"] == s0["delta-attaches"] + 1
    _assert_tables_equal(_tables(tl), _tables(jd.loader))
    np.testing.assert_array_equal(_step(td, specs, db, 27200),
                                  _step(jd, specs, db, 27200))
    for d in (jd, td):
        d.shutdown()
