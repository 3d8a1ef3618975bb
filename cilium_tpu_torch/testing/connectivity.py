"""The `cilium connectivity test` analogue (BASELINE config 1), a copy
of the JAX package's module on the port's daemon.

Reference: cilium-cli's ``cilium connectivity test`` deploys client/
server pods into a kind cluster, applies policy scenarios, probes the
matrix (curl/ping per scenario), and prints per-scenario pass/fail.
Here the cluster is a self-contained daemon: client/server endpoints
arrive through the k8s watcher path, each scenario imports its policy
as a CiliumNetworkPolicy, synthesizes the probe flows, runs them
through the REAL datapath (``process_batch``), and asserts the
expected verdict per probe — the same L3/L4/L7/deny/entity coverage,
minus the kubelet.

Run via :func:`run_connectivity_tests` (the CLI verb is ROADMAP A19).
The daemon runs on ``device`` (None: the card; ``"cpu"`` in the tests).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

CLIENT_IP = "10.200.1.10"
CLIENT2_IP = "10.200.1.11"
SERVER_IP = "10.200.2.10"
WORLD_IP = "198.51.100.99"
NS = "io.kubernetes.pod.namespace"


@dataclass
class Probe:
    name: str
    src: str
    dst: str
    dport: int
    expect: str  # "allow" | "deny" | "auth-then-allow"
    proto: int = 6
    direction: int = 0  # judged at the SERVER (ingress) by default
    l7_path: Optional[str] = None
    l7_expect: Optional[str] = None  # "allow" | "deny"


@dataclass
class Scenario:
    name: str
    policies: List[dict]
    probes: List[Probe]


@dataclass
class ProbeResult:
    scenario: str
    probe: str
    expected: str
    got: str
    ok: bool


def _scenarios() -> List[Scenario]:
    allow = "allow"
    deny = "deny"
    return [
        Scenario("no-policies", [], [
            Probe("client->server:8080", CLIENT_IP, SERVER_IP, 8080,
                  allow),
            Probe("client2->server:8080", CLIENT2_IP, SERVER_IP, 8080,
                  allow),
        ]),
        Scenario("client-ingress-l3", [{
            "endpointSelector": {"matchLabels": {"name": "server"}},
            "ingress": [{"fromEndpoints": [
                {"matchLabels": {"name": "client"}}]}],
        }], [
            Probe("client->server:8080", CLIENT_IP, SERVER_IP, 8080,
                  allow),
            Probe("client2-denied", CLIENT2_IP, SERVER_IP, 8080,
                  deny),
        ]),
        Scenario("client-ingress-l4", [{
            "endpointSelector": {"matchLabels": {"name": "server"}},
            "ingress": [{
                "fromEndpoints": [{"matchLabels": {"name": "client"}}],
                "toPorts": [{"ports": [{"port": "8080",
                                        "protocol": "TCP"}]}],
            }],
        }], [
            Probe("client->server:8080", CLIENT_IP, SERVER_IP, 8080,
                  allow),
            Probe("client->server:9090-denied", CLIENT_IP, SERVER_IP,
                  9090, deny),
        ]),
        Scenario("all-ingress-deny", [{
            "endpointSelector": {"matchLabels": {"name": "server"}},
            "ingressDeny": [{}],
            "ingress": [{}],
        }], [
            Probe("client-denied", CLIENT_IP, SERVER_IP, 8080, deny),
            Probe("client2-denied", CLIENT2_IP, SERVER_IP, 8080,
                  deny),
        ]),
        Scenario("client-egress-l4", [{
            "endpointSelector": {"matchLabels": {"name": "client"}},
            "egress": [{
                "toEndpoints": [{"matchLabels": {"name": "server"}}],
                "toPorts": [{"ports": [{"port": "8080",
                                        "protocol": "TCP"}]}],
            }],
        }], [
            Probe("egress:8080", CLIENT_IP, SERVER_IP, 8080, allow,
                  direction=1),
            Probe("egress:9090-denied", CLIENT_IP, SERVER_IP, 9090,
                  deny, direction=1),
        ]),
        Scenario("to-entities-world", [{
            "endpointSelector": {"matchLabels": {"name": "client"}},
            "egress": [{"toEntities": ["world"],
                        "toPorts": [{"ports": [
                            {"port": "443",
                             "protocol": "TCP"}]}]}],
        }], [
            Probe("egress-world:443", CLIENT_IP, WORLD_IP, 443,
                  allow, direction=1),
            Probe("egress-server-denied", CLIENT_IP, SERVER_IP, 8080,
                  deny, direction=1),
        ]),
        Scenario("echo-ingress-l7", [{
            "endpointSelector": {"matchLabels": {"name": "server"}},
            "ingress": [{
                "fromEndpoints": [{"matchLabels": {"name": "client"}}],
                "toPorts": [{
                    "ports": [{"port": "8080", "protocol": "TCP"}],
                    "rules": {"http": [{"method": "GET",
                                        "path": "/public"}]},
                }],
            }],
        }], [
            Probe("GET /public", CLIENT_IP, SERVER_IP, 8080,
                  "redirect", l7_path="/public", l7_expect="allow"),
            Probe("GET /admin-denied", CLIENT_IP, SERVER_IP, 8080,
                  "redirect", l7_path="/admin", l7_expect="deny"),
        ]),
        Scenario("echo-ingress-mutual-auth", [{
            "endpointSelector": {"matchLabels": {"name": "server"}},
            "ingress": [{
                "fromEndpoints": [{"matchLabels": {"name": "client"}}],
                "authentication": {"mode": "required"},
            }],
        }], [
            Probe("first-connect-authenticates", CLIENT_IP, SERVER_IP,
                  8080, "auth-then-allow"),
        ]),
    ]


def _wrap_cnp(spec: dict, i: int) -> dict:
    return {"kind": "CiliumNetworkPolicy",
            "metadata": {"name": f"conn-test-{i}",
                         "namespace": "test"},
            "spec": spec}


def run_connectivity_tests(backend: str = "interpreter", daemon=None,
                           device=None) -> List[ProbeResult]:
    """Build the two-pod world, run every scenario, return results.
    ``backend`` is accepted and ignored, as the port's DaemonConfig
    ignores it; a given ``daemon`` is used as it is."""
    from ..agent import Daemon, DaemonConfig
    from ..core.packets import TCP_SYN, make_batch
    from ..datapath.verdict import (REASON_AUTH_REQUIRED,
                                    REASON_FORWARDED)
    from ..policy.mapstate import (VERDICT_ALLOW, VERDICT_REDIRECT)

    d = daemon or Daemon(DaemonConfig(backend=backend,
                                      ct_capacity=1 << 12),
                         device=device)
    hub = d.k8s_watchers()

    def pod(name: str, ip: str):
        hub.dispatch("add", {
            "kind": "Pod",
            "metadata": {"name": name, "namespace": "test",
                         "labels": {"name": name}},
            "spec": {"nodeName": d.config.node_name},
            "status": {"podIP": ip}})
        return d.endpoints.lookup_by_ip(ip)

    from ..identity import ID_WORLD

    client = pod("client", CLIENT_IP)
    client2 = pod("client2", CLIENT2_IP)
    server = pod("server", SERVER_IP)
    assert client and client2 and server, "pod watcher must attach"
    d.upsert_ipcache(f"{WORLD_IP}/32", ID_WORLD)

    results: List[ProbeResult] = []
    sport = [40000]

    def run_probe(sc: Scenario, p: Probe, now: int) -> ProbeResult:
        sport[0] += 1
        ep = server if p.direction == 0 else client
        ev = d.process_batch(make_batch([
            dict(src=p.src, dst=p.dst, sport=sport[0], dport=p.dport,
                 proto=p.proto, flags=TCP_SYN, ep=ep.id,
                 dir=p.direction)
        ]).data, now=now)
        verdict, reason = int(ev.verdict[0]), int(ev.reason[0])
        if p.expect == "auth-then-allow":
            # mutual auth: drop AUTH_REQUIRED, then the retry forwards
            first_auth = reason == REASON_AUTH_REQUIRED
            ev2 = d.process_batch(make_batch([
                dict(src=p.src, dst=p.dst, sport=sport[0],
                     dport=p.dport, proto=p.proto, flags=TCP_SYN,
                     ep=ep.id, dir=p.direction)
            ]).data, now=now + 1)
            got = ("auth-then-allow"
                   if first_auth
                   and int(ev2.reason[0]) == REASON_FORWARDED
                   else f"reason={reason},{int(ev2.reason[0])}")
            return ProbeResult(sc.name, p.name, p.expect, got,
                               got == p.expect)
        if p.expect == "redirect":
            ok = verdict == VERDICT_REDIRECT
            got = "redirect" if ok else f"verdict={verdict}"
            if ok and p.l7_path:
                verdicts = d.handle_l7_http(
                    int(ev.proxy_port[0]),
                    [{"method": "GET", "path": p.l7_path,
                      "host": "server"}],
                    src_identity=client.identity.numeric_id)
                l7got = ("allow" if int(verdicts[0]) == 1
                         else "deny")
                ok = l7got == p.l7_expect
                got = f"redirect+l7-{l7got}"
            return ProbeResult(sc.name, p.name,
                               f"redirect+l7-{p.l7_expect}", got, ok)
        allowed = (verdict in (VERDICT_ALLOW, VERDICT_REDIRECT)
                   and reason == REASON_FORWARDED)
        got = "allow" if allowed else "deny"
        return ProbeResult(sc.name, p.name, p.expect, got,
                           got == p.expect)

    now = 100
    for i, sc in enumerate(_scenarios()):
        # replace the previous scenario's policies (the cilium-cli
        # flow: apply, probe, delete)
        for j, spec in enumerate(sc.policies):
            hub.dispatch("add", _wrap_cnp(spec, j))
        for p in sc.probes:
            results.append(run_probe(sc, p, now))
            now += 2
        for j, spec in enumerate(sc.policies):
            hub.dispatch("delete", _wrap_cnp(spec, j))
        now += 100  # age out scenario CT state between scenarios
    return results


def format_results(results: List[ProbeResult]) -> str:
    lines = []
    by_sc: dict = {}
    for r in results:
        by_sc.setdefault(r.scenario, []).append(r)
    npass = sum(r.ok for r in results)
    for sc, rs in by_sc.items():
        ok = all(r.ok for r in rs)
        lines.append(f"  [{'OK' if ok else 'FAIL'}] {sc}")
        for r in rs:
            mark = "+" if r.ok else "!"
            extra = "" if r.ok else f" (expected {r.expected}, " \
                                    f"got {r.got})"
            lines.append(f"      {mark} {r.probe}{extra}")
    lines.append(f"Test Summary: {npass}/{len(results)} probes "
                 f"passed, {len(by_sc)} scenarios")
    return "\n".join(lines)
