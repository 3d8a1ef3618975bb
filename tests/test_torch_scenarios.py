"""The port's scenario engine (``cilium_tpu_torch/testing/workloads.py``)
against the JAX package's (``cilium_tpu/testing/workloads.py``) on the CPU:
the registry (the reference's minus ``rotation_storm``, which needs the
process-mode cluster), each scenario's batches and ops, the criteria
evaluation, and the serving leg of ``run_scenario`` on the port's
``Daemon(device="cpu")`` at small sizes, with ``port_scan``'s
deterministic metrics equal to the reference's ``run_scenario``'s."""

import numpy as np
import pytest

from cilium_tpu.testing import workloads as jwl
from cilium_tpu_torch.datapath.verdict import REASON_POLICY_DEFAULT_DENY
from cilium_tpu_torch.testing import workloads as twl

PORTED = [n for n in jwl.SCENARIOS if n != "rotation_storm"]


def test_the_registry_is_the_reference_s_minus_rotation_storm():
    assert list(twl.SCENARIOS) == PORTED
    assert set(jwl.SCENARIOS) - set(twl.SCENARIOS) == {"rotation_storm"}
    with pytest.raises(NotImplementedError, match="ROADMAP A21"):
        twl.make_scenario("rotation_storm")
    with pytest.raises(ValueError, match="syn_flood"):
        twl.make_scenario("no_such_scenario")


@pytest.mark.parametrize("name", PORTED)
def test_declarations_equal_the_reference(name):
    ours, ref = twl.SCENARIOS[name], jwl.SCENARIOS[name]
    assert ours.name == name and ours.__doc__.strip()
    assert ours.criteria == ref.criteria
    assert ours.path == ref.path
    assert ours.daemon_overrides == ref.daemon_overrides
    assert ours.interval_s == ref.interval_s
    sc = ours(seed=7)
    assert sc.seed == 7 and sc.interval_s == ref(seed=7).interval_s


@pytest.mark.parametrize("name", PORTED)
def test_batches_and_ops_equal_the_reference(name):
    for seed in (0, 31):
        ours = twl.make_scenario(name, seed=seed)
        ref = jwl.make_scenario(name, seed=seed)
        assert ours.signature() == ref.signature()
        got, want = list(ours.iter_batches(5)), list(ref.iter_batches(5))
        assert len(got) == len(want) < 10_000
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert [repr(o) for o in ours.ops(128)] == [
            repr(o) for o in ref.ops(128)]
    assert (twl.make_scenario(name, seed=42).signature()
            != twl.make_scenario(name, seed=43).signature())


METRICS = {"ledger_exact": True, "shed_frac": 0.1, "p99_us": 5_000.0,
           "ct_insert_drops": 3, "nat_failures": 0, "drop_frac": 0.7,
           "l7_ledger_exact": False, "l7_redirected": 4, "rotations": 2}
CRITERIA = [
    {"ledger_exact": True}, {"ledger_exact": False},
    {"max_shed_frac": 0.5}, {"max_shed_frac": 0.05},
    {"p99_ms": 10.0}, {"p99_ms": 1.0},
    {"min_ct_insert_drops": 1}, {"min_ct_insert_drops": 9},
    {"min_nat_failures": 1}, {"min_nat_failures": 0},
    {"min_drop_frac": 0.5}, {"min_drop_frac": 0.9},
    {"l7_ledger_exact": True}, {"l7_ledger_exact": False},
    {"min_l7_redirected": 1}, {"min_l7_redirected": 5},
    {"min_rotations": 2}, {"min_rotations": 3},
    {"max_shedd_frac": 0.5},  # unknown: fails loudly
    {"ledger_exact": True, "max_shed_frac": 0.95, "min_drop_frac": 0.5,
     "p99_ms": 120000.0},
]


@pytest.mark.parametrize("i", range(len(CRITERIA)))
def test_evaluate_criteria_equals_the_reference(i):
    crit = CRITERIA[i]
    assert twl.evaluate_criteria(crit, METRICS) == \
        jwl.evaluate_criteria(crit, METRICS)
    # every metric missing
    assert twl.evaluate_criteria(crit, {}) == jwl.evaluate_criteria(crit,
                                                                    {})
    if "max_shedd_frac" in crit:
        assert twl.evaluate_criteria(crit, METRICS) == {
            "max_shedd_frac": False}


def test_every_criterion_of_the_reference_has_a_branch():
    seen = {k for crit in CRITERIA for k in crit}
    for cls in jwl.SCENARIOS.values():
        assert set(cls.criteria) <= seen, cls.name


@pytest.fixture(scope="module")
def reference_port_scan():
    """The reference's ``run_scenario`` of port_scan at 1024 / 256 on the
    CPU, and its metric keys."""
    sc = jwl.make_scenario("port_scan", seed=11, n_packets=1024, batch=256)
    d = jwl.scenario_daemon(sc, map_pressure_interval=0.0,
                            history_interval=0.0)
    d.start()
    try:
        return jwl.run_scenario(d, sc)
    finally:
        d.shutdown()


SERVING = {
    "port_scan": dict(n_packets=1024, batch=256),
    "elephant_mice": dict(n_flows=256, n_packets=4096, batch=512,
                          zipf_a=1.4),
    "endpoint_churn": dict(n_slots=4, rate_hz=100.0, n_batches=16),
    "l7_abuse": dict(n_packets=1024, batch=256),
}


@pytest.mark.parametrize("name", sorted(SERVING))
def test_the_serving_leg_passes(name, reference_port_scan):
    sc = twl.make_scenario(name, seed=11, **SERVING[name])
    d = twl.scenario_daemon(sc, device="cpu", map_pressure_interval=0.0)
    d.start()
    try:
        kw = {}
        if name == "elephant_mice":
            # every forwarded packet events, so the analytics plane sees
            # the whole popularity distribution
            kw = dict(serving_kwargs={"trace_sample": 1})
        r = twl.run_scenario(d, sc, max_ops=16, **kw)
        assert r["passed"], r["checks"]
        m = r["metrics"]
        assert set(m) == set(reference_port_scan["metrics"])
        assert m["ledger_exact"] and m["submitted"] == m["verdicts"]
        a = d.analytics.stats()
        assert a["batches-submitted"] == (a["batches-ingested"]
                                          + a["batches-dropped"])
        assert a["pending"] == 0
        if name == "elephant_mice":
            talkers = d.flows_aggregate(top=8)["top-talkers"]
            assert 1024 in {t["sport"] for t in talkers}  # rank 0
        elif name == "endpoint_churn":
            assert m["ops_applied"] >= 2
            names = {e.name for e in d.endpoints.list()}
            assert not any(n.startswith("ec") and n != "ec-svc"
                           for n in names)
        elif name == "l7_abuse":
            assert m["l7_redirected"] == (
                m["l7_allowed"] + m["l7_denied"] + m["l7_shed"]
                + m["l7_failed"]) > 0
        else:
            assert m["drops_by_reason"].get(REASON_POLICY_DEFAULT_DENY,
                                            0) > 0
    finally:
        d.shutdown()


def test_port_scan_metrics_equal_the_reference(reference_port_scan):
    sc = twl.make_scenario("port_scan", seed=11, n_packets=1024, batch=256)
    d = twl.scenario_daemon(sc, device="cpu", map_pressure_interval=0.0)
    d.start()
    try:
        got = twl.run_scenario(d, sc)
    finally:
        d.shutdown()
    want = reference_port_scan
    for k in ("submitted", "verdicts", "drop_frac", "drops_by_reason",
              "ledger_exact", "shed_frac", "ops_applied", "nat_failures",
              "l7_redirected", "l7_ledger_exact"):
        assert got["metrics"][k] == want["metrics"][k], k
    assert got["checks"] == want["checks"] and got["passed"]


def test_the_offline_leg_has_the_reference_s_metric_keys(
        reference_port_scan):
    sc = twl.make_scenario("nat_exhaustion", seed=3, n_flows=512)
    d = twl.scenario_daemon(sc, device="cpu", map_pressure_interval=0.0)
    try:
        r = twl.run_scenario(d, sc)
    finally:
        d.shutdown()
    assert r["passed"], r["checks"]
    assert set(r["metrics"]) == set(reference_port_scan["metrics"])
    assert r["metrics"]["p99_us"] is None
    assert r["metrics"]["shed_frac"] == 0.0


def test_scenario_daemon_without_a_device_is_the_card():
    """No fallback: without ``device`` the daemon runs on the card, and
    where there is none it raises."""
    import torch

    sc = twl.make_scenario("port_scan", seed=1)
    if torch.cuda.is_available():
        d = twl.scenario_daemon(sc)
        assert d.loader.device.type == "cuda"
        d.shutdown()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            twl.scenario_daemon(sc)
