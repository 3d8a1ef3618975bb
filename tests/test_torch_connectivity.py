"""The connectivity-test analogue (BASELINE config #1) on the port: the
two-pod world arrives through the Pod watcher, each scenario imports its
policy as a CiliumNetworkPolicy (a delta attach per import and delete),
and every probe runs through ``process_batch`` on ``device="cpu"``.
Every ``ProbeResult`` must equal the JAX package's
``run_connectivity_tests("tpu")`` (JAX on the CPU), probe for probe."""

import dataclasses

import torch

from cilium_tpu.testing.connectivity import (
    run_connectivity_tests as jrun_connectivity_tests)
from cilium_tpu_torch.agent import Daemon, DaemonConfig
from cilium_tpu_torch.testing.connectivity import (format_results,
                                                   run_connectivity_tests)

torch.set_num_threads(1)

SCENARIOS = {"no-policies", "client-ingress-l3", "client-ingress-l4",
             "all-ingress-deny", "client-egress-l4", "to-entities-world",
             "echo-ingress-l7", "echo-ingress-mutual-auth"}


def test_connectivity_matrix_matches_the_reference_probe_for_probe():
    want = jrun_connectivity_tests("tpu")
    got = run_connectivity_tests("tpu", device="cpu")
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]
    assert all(r.ok for r in got), format_results(got)
    assert {r.scenario for r in got} == SCENARIOS


def test_connectivity_run_takes_the_delta_path_and_grants_once():
    """Each scenario's CNP import and delete re-attaches by delta; the
    mutual-auth scenario grants its one pair and its retry forwards."""
    d = Daemon(DaemonConfig(ct_capacity=1 << 12), device="cpu")
    res = run_connectivity_tests(daemon=d)
    assert all(r.ok for r in res), format_results(res)
    stats = d.loader.table_stats()
    assert stats["delta-attaches"] > 0
    assert stats["failed-builds"] == 0
    auth = d.status()["auth"]
    assert (auth["granted"], auth["failed"]) == (1, 0)
    (entry,) = d.loader.auth_entries()
    server = d.endpoints.lookup_by_ip("10.200.2.10")
    client = d.endpoints.lookup_by_ip("10.200.1.10")
    assert entry["endpoint"] == server.id
    assert entry["remote_identity"] == client.identity.numeric_id
    d.shutdown()
