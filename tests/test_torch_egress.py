"""The offline egress path end to end: the port's ``Daemon.process_batch``
(device="cpu", the plain PyTorch versions) against the JAX package's
``Daemon.process_batch`` (backend "tpu", JAX on the CPU), with
masquerade, an egress-gateway policy added mid-flow, an endpoint that
joins late, bandwidth limits and a pool small enough to run dry.

Per batch the monitor events are bit-exact (wall-clock timestamps
aside), and the port's verdicts equal the sequential oracle
(``cilium_tpu_torch.testing.oracle``) fed the rows, ``pre_drop`` and
``pre_drop_reason`` the datapath step saw.  At the end the CT row sets,
the NAT tables, the metrics and the ``nat`` status are equal.  Then the
``nat_exhaustion`` scenario at its own shape against the JAX run, and
the config validation.
"""

import ipaddress

import numpy as np
import pytest
import torch

from cilium_tpu.agent import Daemon as JDaemon, DaemonConfig as JConfig
from cilium_tpu.testing import workloads as jwl
from cilium_tpu_torch import u32
from cilium_tpu_torch.agent import Daemon, DaemonConfig
from cilium_tpu_torch.core.packets import (COL_DIR, COL_DPORT, COL_DST_IP3,
                                           COL_EP, COL_FAMILY, COL_FLAGS,
                                           COL_LEN, COL_PROTO, COL_SPORT,
                                           COL_SRC_IP3, N_COLS, TCP_ACK,
                                           TCP_SYN)
from cilium_tpu_torch.datapath.verdict import (OUT_CT, OUT_EVENT, OUT_PROXY,
                                               OUT_REASON, OUT_VERDICT,
                                               REASON_BANDWIDTH,
                                               REASON_NAT_EXHAUSTED)
from cilium_tpu_torch.service.nat import NAT_PORT_MIN
from cilium_tpu_torch.testing import workloads as twl
from cilium_tpu_torch.testing.oracle import OracleDatapath

torch.set_num_threads(1)

CT = 1 << 12
NAT_CAP = 256
B = 128  # every batch holds this many rows (one JAX compile per stage)
NODE, EGW = "192.168.0.1", "192.168.9.9"
GW_NET = "198.51.100.0/24"
WORLD = ["8.8.8.8", "8.8.4.4", "93.184.0.7", "198.51.100.9"]
RULES = [
    {"endpointSelector": {},
     "egress": [{"toEntities": ["world"]}, {"toEndpoints": [{}]}]},
    {"endpointSelector": {"matchLabels": {"app": "web"}},
     "ingress": [{"fromEntities": ["world"],
                  "toPorts": [{"ports": [{"port": "80",
                                          "protocol": "TCP"}]}]}]},
    {"endpointSelector": {"matchLabels": {"app": "db"}},
     "ingress": [{"fromEndpoints": [{"matchLabels": {"app": "web"}}]}]},
]
PODS = {"web": "10.0.1.1", "db": "10.0.2.1", "crawler": "10.0.5.1"}


def _ip(s):
    return int(ipaddress.IPv4Address(s))


def _daemons(**kw):
    cfg = dict(ct_capacity=CT, masquerade=True, node_ip=NODE,
               nat_pool_capacity=NAT_CAP, **kw)
    jd = JDaemon(JConfig(backend="tpu", mesh_auth=False, enable_hubble=False,
                         flow_agg_enabled=False, history_interval=0.0,
                         **cfg))
    td = Daemon(DaemonConfig(**cfg), device="cpu")
    ids = []
    for d in (jd, td):
        d.policy_import(RULES)
        ids.append({name: d.add_endpoint(name, (ip,), [f"k8s:app={name}"]).id
                    for name, ip in PODS.items()})
    assert ids[0] == ids[1]
    return jd, td, ids[1]


class _Oracle:
    """The sequential oracle beside the port's daemon: a spy on the
    loader's step hands it the rows, clock and drop channels the step
    saw; a new attach rebuilds it over the same CT."""

    def __init__(self, td):
        self.td = td
        self.seen = []
        self.oracle = None
        step = td.loader.step

        def spy(hdr, now, pre_drop=None, pre_drop_reason=None, **kw):
            out, row_map = step(hdr, now, pre_drop=pre_drop,
                                pre_drop_reason=pre_drop_reason, **kw)
            self.seen.append((self._np(hdr), now, self._np(pre_drop),
                              self._np(pre_drop_reason), out))
            return out, row_map

        td.loader.step = spy
        td.endpoints.on_attach(lambda pols: self.rebuild())
        self.rebuild()

    @staticmethod
    def _np(t):
        if t is None or isinstance(t, np.ndarray):
            return t
        return t.numpy() if t.dtype == torch.bool else u32.to_numpy(t)

    def rebuild(self):
        eps = self.td.endpoints.list()
        pols = self.td.endpoints._attached_policies
        ct = self.oracle.ct if self.oracle is not None else {}
        self.oracle = OracleDatapath({ep.id: pols[ep.policy_row]
                                      for ep in eps},
                                     self.td.ipcache.to_identity_map())
        self.oracle.ct = ct

    def check(self, batch):
        hdr, now, pre_drop, reason, out = self.seen.pop()
        want = self.oracle.step(hdr, now, pre_drop=pre_drop,
                                pre_drop_reason=reason)
        got = np.stack([out[:, OUT_VERDICT], out[:, OUT_PROXY],
                        out[:, OUT_CT], batch.identity, out[:, OUT_REASON],
                        out[:, OUT_EVENT]], axis=1)
        exp = np.array([[r.verdict, r.proxy, r.ct, r.identity, r.reason,
                         r.event] for r in want], np.int64)
        np.testing.assert_array_equal(got.astype(np.int64), exp)


def _both(jd, td, oracle, rows, now):
    """One batch through both daemons: events bit-exact, the port's
    verdicts equal the oracle's."""
    jb = jd.process_batch(rows.copy(), now=now)
    tb = td.process_batch(rows.copy(), now=now)
    for c in ("msg_type", "verdict", "reason", "ct_state", "identity",
              "proxy_port", "hdr"):
        np.testing.assert_array_equal(getattr(tb, c), getattr(jb, c),
                                      err_msg=c)
    oracle.check(tb)
    return tb


def _egress(rng, ep_ids, srcs, dsts, n, sport0=20000, protos=(6, 17, 1),
            length=(60, 1400)):
    rows = np.zeros((n, N_COLS), np.uint32)
    pick = rng.integers(0, len(ep_ids), n)
    rows[:, COL_SRC_IP3] = np.array([_ip(s) for s in srcs], np.uint32)[pick]
    rows[:, COL_EP] = np.asarray(ep_ids, np.uint32)[pick]
    rows[:, COL_DST_IP3] = [_ip(x) for x in rng.choice(dsts, n)]
    rows[:, COL_SPORT] = sport0 + rng.integers(0, 5000, n)
    rows[:, COL_DPORT] = rng.choice([53, 443, 80], n)
    rows[:, COL_PROTO] = rng.choice(np.asarray(protos, np.uint32), n)
    rows[:, COL_FLAGS] = TCP_SYN
    rows[:, COL_LEN] = rng.integers(length[0], length[1], n)
    rows[:, COL_FAMILY] = 4
    rows[:, COL_DIR] = 1
    return rows


def _replies(events, n, rng):
    """Replies from the world to the node ports the events' rows were
    given (TCP/UDP rows whose source port lies in the pool)."""
    hdr = events.hdr
    ok = np.flatnonzero((hdr[:, COL_SPORT] >= NAT_PORT_MIN)
                        & np.isin(hdr[:, COL_PROTO], [6, 17]))
    sel = hdr[rng.choice(ok, n)]
    rows = sel.copy()
    rows[:, COL_SRC_IP3], rows[:, COL_DST_IP3] = (sel[:, COL_DST_IP3],
                                                  sel[:, COL_SRC_IP3])
    rows[:, COL_SPORT], rows[:, COL_DPORT] = sel[:, COL_DPORT], sel[:, COL_SPORT]
    rows[:, COL_FLAGS] = TCP_ACK
    rows[:, COL_DIR] = 0
    return rows


def test_process_batch_matches_jax_and_the_oracle():
    jd, td, ids = _daemons()
    oracle = _Oracle(td)
    rng = np.random.default_rng(17)
    pods = list(PODS)
    eps = [ids[p] for p in pods]
    srcs = [PODS[p] for p in pods]
    cluster = [PODS["db"], PODS["web"]]
    # 1. new flows to the world and inside the cluster, ICMP among them
    rows0 = _egress(rng, eps, srcs, WORLD + cluster, B)
    b0 = _both(jd, td, oracle, rows0, 10)
    assert (b0.hdr[:, COL_SRC_IP3] == _ip(NODE)).any()
    # 2. replies to the allocated ports, and repeats of the same flows
    rows = np.concatenate([_replies(b0, B // 2, rng),
                           _egress(rng, eps, srcs, WORLD, B // 2)])
    b1 = _both(jd, td, oracle, rows, 11)
    back = b1.hdr[:B // 2]
    assert np.isin(back[:, COL_DST_IP3], [_ip(s) for s in srcs]).all()
    assert (b1.reason[:B // 2] == 0).all()
    # 3. connections from the world into web:80, then web's replies,
    # which keep their source (the reverse CT entry is live)
    inbound = _egress(rng, [ids["web"]], WORLD[:2], [PODS["web"]], B,
                      protos=(6,))
    inbound[:, COL_SRC_IP3], inbound[:, COL_DST_IP3] = (
        inbound[:, COL_DST_IP3], inbound[:, COL_SRC_IP3])
    inbound[:, COL_DPORT], inbound[:, COL_DIR] = 80, 0
    _both(jd, td, oracle, inbound, 12)
    rep = inbound.copy()
    rep[:, COL_SRC_IP3], rep[:, COL_DST_IP3] = (inbound[:, COL_DST_IP3],
                                                inbound[:, COL_SRC_IP3])
    rep[:, COL_SPORT], rep[:, COL_DPORT] = 80, inbound[:, COL_SPORT]
    rep[:, COL_FLAGS], rep[:, COL_DIR] = TCP_ACK, 1
    b3 = _both(jd, td, oracle, rep, 13)
    assert (b3.hdr[:, COL_SRC_IP3] == _ip(PODS["web"])).all()
    # 4. an egress-gateway policy lands mid-flow: the crawler's live
    # flows keep node_ip, its new flows take the gateway
    for d in (jd, td):
        d.add_egress_gateway("gw", {"matchLabels": {"app": "crawler"}},
                             [GW_NET], EGW)
    live = rows0[(rows0[:, COL_EP] == ids["crawler"])
                 & (rows0[:, COL_DST_IP3] == _ip("198.51.100.9"))
                 & (b0.hdr[:, COL_SPORT] >= NAT_PORT_MIN)]
    assert len(live)
    rows = np.concatenate([live, _egress(
        rng, [ids["crawler"]], [PODS["crawler"]],
        ["198.51.100.9", "198.51.100.77"], B - len(live), sport0=30000)])
    b4 = _both(jd, td, oracle, rows, 14)
    assert (b4.hdr[:len(live), COL_SRC_IP3] == _ip(NODE)).all()
    assert (b4.hdr[len(live):, COL_SRC_IP3] == _ip(EGW)).any()
    # 5. an endpoint joins late and falls under the policy; replies to
    # the gateway ports reverse-translate
    for d in (jd, td):
        late = d.add_endpoint("late", ("10.0.5.2",), ["k8s:app=crawler"])
    rows = np.concatenate([
        _egress(rng, [late.id], ["10.0.5.2"], ["198.51.100.5"], B // 2,
                sport0=31000),
        _replies(b4, B // 2, rng)])
    b5 = _both(jd, td, oracle, rows, 15)
    assert (b5.hdr[:B // 2, COL_SRC_IP3] == _ip(EGW)).any()
    # 6. bandwidth limits on web and db, policed over a few seconds
    for d in (jd, td):
        d.set_bandwidth(ids["web"], 20_000)
        d.set_bandwidth(ids["db"], 5_000)
    policed = 0
    for now in (16, 16, 17, 19):
        rows = _egress(rng, [ids["web"], ids["db"], ids["crawler"]],
                       [PODS["web"], PODS["db"], PODS["crawler"]],
                       WORLD + cluster, B, length=(900, 1400))
        b = _both(jd, td, oracle, rows, now)
        policed += int((b.reason == REASON_BANDWIDTH).sum())
    assert policed > 0
    # 7. UDP mappings expire; then the 256-port pool runs dry
    failed = 0
    for k, now in enumerate((300, 301, 302)):
        rows = _egress(rng, [ids["crawler"]], [PODS["crawler"]],
                       [f"93.184.{k}.{i}" for i in range(1, 120)], B,
                       sport0=40000 + 5000 * k, protos=(6,))
        b = _both(jd, td, oracle, rows, now)
        failed += int((b.reason == REASON_NAT_EXHAUSTED).sum())
    assert failed > 0
    # 8. the policy goes away; then everything is compared
    for d in (jd, td):
        assert d.remove_egress_gateway("gw")
        d.set_bandwidth(ids["web"], None)
    _both(jd, td, oracle,
          _egress(rng, eps, srcs, WORLD, B, sport0=50000), 303)
    np.testing.assert_array_equal(td.loader.ct_snapshot(),
                                  jd.loader.ct_snapshot())
    np.testing.assert_array_equal(td.loader.nat_snapshot(),
                                  jd.loader.nat_snapshot())
    np.testing.assert_array_equal(td.loader.metrics(), jd.loader.metrics())
    assert td.loader.nat_status(303) == jd.loader.nat_status(303)
    # every allocation failure dropped its row as NAT_EXHAUSTED (the
    # world's rules allow all egress)
    st = td.status()["nat"]
    assert st["capacity"] == NAT_CAP and st["alloc-failed"] == int(
        td.loader.metrics()[REASON_NAT_EXHAUSTED].sum()) >= failed
    assert td.loader.map_pressure(303)["nat"] == \
        jd.loader.map_pressure(303)["nat"] == {
            "capacity": NAT_CAP, "failures": st["alloc-failed"]}
    for d in (jd, td):
        d.shutdown()


def test_nat_exhaustion_scenario_matches_jax():
    sc = [mod.NatExhaustionScenario(seed=5) for mod in (jwl, twl)]
    assert sc[0].signature() == sc[1].signature()
    jd = JDaemon(JConfig(backend="tpu", mesh_auth=False,
                         enable_hubble=False, flow_agg_enabled=False,
                         history_interval=0.0, **sc[0].daemon_overrides))
    td = Daemon(DaemonConfig(**sc[1].daemon_overrides), device="cpu")
    # one clock for both (run_scenario reads the daemons' wall clocks,
    # which the JAX side's compiles would set apart)
    jd._now = td._now = lambda: 7
    want = jwl.run_scenario(jd, sc[0])
    got = twl.run_scenario(td, sc[1])
    assert got["passed"] and want["passed"]
    for k in ("submitted", "verdicts", "ledger_exact", "nat_failures",
              "drop_frac", "drops_by_reason"):
        assert got["metrics"][k] == want["metrics"][k], k
    assert got["checks"] == want["checks"]
    np.testing.assert_array_equal(td.loader.nat_snapshot(),
                                  jd.loader.nat_snapshot())
    for d in (jd, td):
        d.shutdown()


@pytest.mark.parametrize("cfg,match", [
    ({"masquerade": True}, "node_ip"),
    ({"nat_pool_capacity": 100}, "nat_pool_capacity"),
    ({"nat_pool_capacity": 4}, "nat_pool_capacity"),
    ({"nat_pool_capacity": 1 << 16}, "nat_pool_capacity")])
def test_config_validation(cfg, match):
    with pytest.raises(ValueError, match=match):
        Daemon(DaemonConfig(ct_capacity=CT, **cfg), device="cpu")
    with pytest.raises(ValueError, match=match):
        JDaemon(JConfig(backend="tpu", ct_capacity=CT, **cfg))


def test_gateway_api_validates_before_storing():
    td = Daemon(DaemonConfig(ct_capacity=CT), device="cpu")
    for args in (({"matchLabels": {"app": "x"}}, ["2001:db8::/64"], EGW),
                 ({"matchLabels": {"app": "x"}}, [], EGW),
                 ({"matchLabels": {"app": "x"}}, [GW_NET], "fd00::1"),
                 ({"matchExpressions": [{"key": "a", "operator": "Near"}]},
                  [GW_NET], EGW)):
        with pytest.raises(ValueError):
            td.add_egress_gateway("bad", *args)
    assert td.nat is None and not td.remove_egress_gateway("bad")
    # a gateway without masquerade SNATs only the rows it selects
    td.add_endpoint("c", ("10.0.5.1",), ["k8s:app=c"])
    td.add_egress_gateway("g", {"matchLabels": {"app": "c"}}, [GW_NET], EGW)
    assert td.nat is not None
    assert u32.to_numpy(td.nat.egw_src).tolist() == [_ip("10.0.5.1")]
    assert td.remove_egress_gateway("g") and td.nat is None
    td.shutdown()


def test_egress_entry_points_default_to_the_card():
    from cilium_tpu_torch.datapath.bandwidth import BandwidthState
    from cilium_tpu_torch.service.nat import NATConfig, NATTable

    calls = [lambda: Daemon(DaemonConfig(ct_capacity=CT, masquerade=True,
                                         node_ip=NODE)),
             lambda: NATTable.create(256),
             lambda: NATConfig(node_ip=NODE).compile(),
             lambda: BandwidthState.create()]
    for call in calls:
        if torch.cuda.is_available():
            call()
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
