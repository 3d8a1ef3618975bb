"""The port's ``DaemonConfig`` accepts every field of the reference's
(ROADMAP C6): the reference's defaults construct, the fields whose
default differs on purpose are listed, each field of an unported plane
set off its default raises NotImplementedError naming its ROADMAP item,
and the knobs of the delta attach, mutual authentication, the Hubble
flow plane, policy audit mode, monitor trace aggregation and the flow
analytics plane construct off their defaults and reach their planes."""

import dataclasses

import pytest

from cilium_tpu.agent.daemon import DaemonConfig as JConfig
from cilium_tpu_torch.agent import Daemon, DaemonConfig
from cilium_tpu_torch.agent.daemon import _UNPORTED_KNOBS

# field -> the port's default: its plane is not ported, so the port
# starts with it off (the reference's default turns it on)
DIFFER_ON_PURPOSE = {
    "history_interval": 0.0,  # A14
}

ITEMS = {
    "node_name": "A20",
    "api_socket_path": "A19", "health_probe_interval": "A20",
    "enable_encryption": "A15", "encryption_key_path": "A15",
    "nodeport_addresses": "A20", "identity_lease_ttl": "A20",
    "serving_trace_sample": "A14", "profile_dir": "A14",
    "profile_batches": "A14", "sysdump_dir": "A14",
}
for _k in _UNPORTED_KNOBS:
    for _prefix, _item in (("sysdump_", "A14"), ("history_", "A14"),
                           ("slo_", "A14"), ("cluster_", "A21")):
        if _k.startswith(_prefix):
            ITEMS.setdefault(_k, _item)


def _off_default(value):
    """A value other than ``value`` of the field's kind."""
    if isinstance(value, bool):
        return not value
    if isinstance(value, (int, float)):
        return value + 1
    if isinstance(value, str):
        return value + "-x"
    if isinstance(value, tuple):
        return ("10.1.2.3",)
    return "/nonexistent"  # None: a path or an address


def test_every_reference_field_is_accepted():
    ref = dataclasses.asdict(JConfig())
    port = [f.name for f in dataclasses.fields(DaemonConfig)]
    assert port == list(ref)  # the same fields, in the same order
    for name, value in ref.items():
        want = DIFFER_ON_PURPOSE.get(name, value)
        assert getattr(DaemonConfig(), name) == want, name
    cfg = DaemonConfig(**{**ref, **DIFFER_ON_PURPOSE})
    assert cfg == DaemonConfig()
    d = Daemon(DaemonConfig(**{**ref, **DIFFER_ON_PURPOSE,
                               "ct_capacity": 1 << 12}), device="cpu")
    d.shutdown()


def test_the_unported_table_names_every_unported_field():
    assert set(_UNPORTED_KNOBS) == set(ITEMS)
    assert set(DIFFER_ON_PURPOSE) <= set(_UNPORTED_KNOBS)
    live = {"backend", "state_dir", "ct_snapshot_interval",
            "flow_ring_capacity", "enable_hubble", "export_path",
            "hubble_listen", "policy_audit_mode", "monitor_aggregation",
            "flow_agg_enabled", "flow_agg_window_s", "flow_agg_windows",
            "flow_agg_topk", "flow_agg_queue_depth", "flow_agg_max_duty",
            "spike_factor", "spike_min_drops", "spike_baseline_windows"}
    assert not live & set(_UNPORTED_KNOBS)


@pytest.mark.parametrize("knob", sorted(ITEMS))
def test_unported_field_off_its_default_raises_naming_its_item(knob):
    value = _off_default(getattr(DaemonConfig(), knob))
    with pytest.raises(NotImplementedError,
                       match=f"\\({knob}\\).*ROADMAP {ITEMS[knob]}"):
        Daemon(DaemonConfig(**{knob: value}), device="cpu")


# the knobs of the delta attach, mutual authentication, the Hubble plane,
# audit mode, trace aggregation and flow analytics: each off its default
# constructs, and
# the value reaches its plane (a value of its own where the kind's other
# value would not be a valid setting)
PORTED = {
    "mesh_auth": (None, lambda d: d.auth_manager is None),
    "auth_ttl": (None, lambda d: d.auth_manager.provider.ttl == 3601),
    "auth_gc_interval": (None, lambda d: (
        d.controllers.get("auth-gc") is not None)),
    "policy_delta_compile": (None, lambda d: not d.loader.delta_compile),
    "policy_swap_warn_ms": (None, lambda d: d.loader.tables.warn_ms == 1.0),
    "enable_hubble": (None, lambda d: (
        d.seven is None and {"hubble", "metrics"}.isdisjoint(
            d.monitor._consumers))),
    "export_path": (None, lambda d: (
        d.exporter.path == "/nonexistent"
        and "exporter" in d.monitor._consumers)),
    "hubble_listen": ("unix:{tmp}/hubble.sock", lambda d: (
        d.hubble_server is not None)),
    "policy_audit_mode": (None, lambda d: d.config.policy_audit_mode),
    "monitor_aggregation": ("medium", lambda d: (
        d.config.monitor_aggregation == "medium")),
    "flow_agg_enabled": (None, lambda d: (
        not d.analytics.enabled and "analytics" in d.monitor._consumers
        and d.controllers.get("flow-agg-roll") is None)),
    "flow_agg_window_s": (None, lambda d: (
        d.analytics.windows.window_s == 2.0
        and d.controllers.get("flow-agg-roll") is not None)),
    "flow_agg_windows": (None, lambda d: d.analytics.windows.retention == 9),
    "flow_agg_topk": (None, lambda d: (
        d.analytics.talkers.k == d.analytics.pairs.k == 33)),
    "flow_agg_queue_depth": (None, lambda d: d.analytics.queue_depth == 17),
    "flow_agg_max_duty": (0.5, lambda d: d.analytics.max_duty == 0.5),
    "spike_factor": (None, lambda d: d.analytics.detector.factor == 5.0),
    "spike_min_drops": (None, lambda d: (
        d.analytics.detector.min_drops == 65)),
    "spike_baseline_windows": (None, lambda d: (
        d.analytics.detector._baseline.maxlen == 5)),
}


@pytest.mark.parametrize("knob", sorted(PORTED))
def test_ported_field_off_its_default_constructs(knob, tmp_path):
    assert knob not in _UNPORTED_KNOBS
    value, reaches = PORTED[knob]
    if value is None:
        value = _off_default(getattr(DaemonConfig(), knob))
    elif knob == "hubble_listen":
        pytest.importorskip("grpc")
        value = value.format(tmp=tmp_path)
    d = Daemon(DaemonConfig(ct_capacity=1 << 12, **{knob: value}),
               device="cpu")
    d.start()
    assert reaches(d)
    d.shutdown()


def test_a_negative_swap_warning_is_refused():
    with pytest.raises(ValueError, match="policy_swap_warn_ms"):
        Daemon(DaemonConfig(ct_capacity=1 << 12, policy_swap_warn_ms=-1.0),
               device="cpu")


@pytest.mark.parametrize("backend", ["tpu", "interpreter"])
def test_backend_is_accepted_and_ignored(backend):
    d = Daemon(DaemonConfig(ct_capacity=1 << 12, backend=backend,
                            flow_ring_capacity=1 << 13), device="cpu")
    assert d.loader.device.type == "cpu"
    d.shutdown()


def test_an_unknown_backend_is_refused():
    with pytest.raises(ValueError, match="backend"):
        Daemon(DaemonConfig(ct_capacity=1 << 12, backend="gpu"),
               device="cpu")


@pytest.mark.parametrize("capacity", [0, 3, -4, 4097])
def test_a_flow_ring_capacity_off_a_power_of_two_is_refused(capacity):
    with pytest.raises(ValueError, match="flow_ring_capacity"):
        Daemon(DaemonConfig(ct_capacity=1 << 12,
                            flow_ring_capacity=capacity), device="cpu")
