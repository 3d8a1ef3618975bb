"""The port's ``DaemonConfig`` accepts every field of the reference's
(ROADMAP C6): the reference's defaults construct, the fields whose
default differs on purpose are listed, each field of an unported plane
set off its default raises NotImplementedError naming its ROADMAP item,
and the knobs of the delta attach, mutual authentication, the Hubble
flow plane, policy audit mode and monitor trace aggregation construct
off their defaults and reach their planes."""

import dataclasses

import pytest

from cilium_tpu.agent.daemon import DaemonConfig as JConfig
from cilium_tpu_torch.agent import Daemon, DaemonConfig
from cilium_tpu_torch.agent.daemon import _UNPORTED_KNOBS

# field -> the port's default: their planes are not ported, so the port
# starts with them off (the reference's defaults turn them on)
DIFFER_ON_PURPOSE = {
    "flow_agg_enabled": False,  # A14
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
    for _prefix, _item in (("flow_agg_", "A14"), ("spike_", "A14"),
                           ("sysdump_", "A14"), ("history_", "A14"),
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
            "hubble_listen", "policy_audit_mode", "monitor_aggregation"}
    assert not live & set(_UNPORTED_KNOBS)


@pytest.mark.parametrize("knob", sorted(ITEMS))
def test_unported_field_off_its_default_raises_naming_its_item(knob):
    value = _off_default(getattr(DaemonConfig(), knob))
    with pytest.raises(NotImplementedError,
                       match=f"\\({knob}\\).*ROADMAP {ITEMS[knob]}"):
        Daemon(DaemonConfig(**{knob: value}), device="cpu")


# the knobs of the delta attach, mutual authentication, the Hubble plane,
# audit mode and trace aggregation: each off its default constructs, and
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
