"""Seeded service worlds and traffic for the LB stages (K15-K17) and the
service path of ``Daemon.process_batch``.

A world is a list of k8s (Service, Endpoints) object pairs, installed
through :class:`~cilium_tpu_torch.k8s.watchers.ServiceWatcher` as a
user's objects reach the load balancer: ``n`` ClusterIP services on
VIPs from 172.20.0.0 (ports 80 and 443 over TCP, every eighth 53 over
UDP), each backed by ``backends`` pod addresses on port 8080; the first
``n_v6`` dual-stack (a second clusterIP from fd00:20:: and one v6
backend), every ``affinity_every``-th with ``sessionAffinity:
ClientIP``, and the last ``n_empty`` with no ready address (their
frontends select nothing: NO_SERVICE).  Traffic rows mix VIP flows,
non-service flows and v6 rows, with repeats of one flow in a batch.
``tests/test_torch_gpu.py``, ``tests/test_torch_socklb.py`` and
``chip_smoke.py`` feed the same rows to a kernel and to its plain
version.
"""

from __future__ import annotations

import ipaddress
from typing import List, Sequence, Tuple

import numpy as np

from ..core.packets import (COL_DIR, COL_DPORT, COL_DST_IP0, COL_DST_IP3,
                            COL_EP, COL_FAMILY, COL_FLAGS, COL_LEN,
                            COL_PROTO, COL_SPORT, COL_SRC_IP0, COL_SRC_IP3,
                            N_COLS, TCP_SYN, ip_to_words)

VIP4 = int(ipaddress.IPv4Address("172.20.0.0"))
VIP6 = int(ipaddress.IPv6Address("fd00:20::"))
BACKEND_PORT = 8080
AFFINITY_TIMEOUT = 600


def vip4(i: int) -> str:
    return str(ipaddress.IPv4Address(VIP4 + i))


def vip6(i: int) -> str:
    return str(ipaddress.IPv6Address(VIP6 + i))


def port_proto(i: int) -> Tuple[int, str]:
    return (53, "UDP") if i % 8 == 7 else (80 + 363 * (i % 2), "TCP")


def ports_protos(i: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`port_proto` over an array of service indices: (ports,
    protocol numbers)."""
    udp = i % 8 == 7
    return (np.where(udp, 53, 80 + 363 * (i % 2)).astype(np.uint32),
            np.where(udp, 17, 6).astype(np.uint32))


def k8s_objects(pods: Sequence[str], pods6: Sequence[str] = (),
                n: int = 4096, backends: int = 2, n_v6: int = 0,
                affinity_every: int = 16, n_empty: int = 16
                ) -> List[Tuple[dict, dict]]:
    """The world's (Service, Endpoints) pairs; service ``i`` is named
    ``svc<i>`` and backed by ``pods[(backends * i + j) % len(pods)]``."""
    objs = []
    for i in range(n):
        port, proto = port_proto(i)
        meta = {"name": f"svc{i}", "namespace": "default"}
        spec = {"clusterIP": vip4(i),
                "ports": [{"port": port, "protocol": proto,
                           "targetPort": BACKEND_PORT}]}
        addrs = [pods[(backends * i + j) % len(pods)]
                 for j in range(backends)]
        if i < n_v6:
            spec["clusterIPs"] = [vip4(i), vip6(i)]
            addrs.append(pods6[i % len(pods6)])
        if affinity_every and i % affinity_every == 0:
            spec["sessionAffinity"] = "ClientIP"
            spec["sessionAffinityConfig"] = {
                "clientIP": {"timeoutSeconds": AFFINITY_TIMEOUT}}
        if i >= n - n_empty:
            addrs = []
        eps = {"metadata": dict(meta), "subsets": [{
            "addresses": [{"ip": a} for a in addrs],
            "ports": [{"port": BACKEND_PORT, "protocol": proto}]}]}
        objs.append(({"metadata": meta, "spec": spec}, eps))
    return objs


def install(watcher, objs) -> None:
    for svc, eps in objs:
        watcher.on_service_add(svc)
        watcher.on_endpoints_add(eps)


def backends_of(objs) -> List[set]:
    """Per service, its backends as (v4 u32, port) pairs."""
    out = []
    for _svc, eps in objs:
        out.append({(int(ipaddress.IPv4Address(a["ip"])), BACKEND_PORT)
                    for sub in eps["subsets"] for a in sub["addresses"]
                    if ":" not in a["ip"]})
    return out


def rows(rng: np.random.Generator, n: int, n_services: int,
         clients: np.ndarray, others: np.ndarray, vip_frac: float = 0.5,
         v6_frac: float = 0.0, n_v6: int = 0, sports: int = 1 << 16,
         dup_frac: float = 0.05, ep_ids=None) -> np.ndarray:
    """[n, N_COLS] u32 egress rows from ``clients`` (u32 v4 addresses;
    ``ep_ids`` their endpoint ids): a ``vip_frac`` share to a random
    service's VIP, port and protocol; a ``v6_frac`` share to a v6 VIP of
    the first ``n_v6`` services (from fd00:9::/64 sources); the rest to
    ``others`` (u32 addresses) on 8080/TCP, or a wrong port or protocol
    of a VIP; a ``dup_frac`` share repeats earlier rows of the batch."""
    out = np.zeros((n, N_COLS), np.uint32)
    pick = rng.integers(0, len(clients), n)
    out[:, COL_SRC_IP3] = clients[pick]
    if ep_ids is not None:
        out[:, COL_EP] = np.asarray(ep_ids, np.uint32)[pick]
    out[:, COL_SPORT] = 1024 + rng.integers(0, sports, n) % 64000
    out[:, COL_FLAGS] = TCP_SYN
    out[:, COL_LEN] = rng.integers(60, 1500, n)
    out[:, COL_FAMILY], out[:, COL_DIR] = 4, 1
    svc = rng.integers(0, n_services, n)
    out[:, COL_DST_IP3] = VIP4 + svc
    out[:, COL_DPORT], out[:, COL_PROTO] = ports_protos(svc)
    u = rng.random(n)
    other = u >= vip_frac + v6_frac
    out[other, COL_DST_IP3] = rng.choice(others, int(other.sum()))
    out[other, COL_DPORT], out[other, COL_PROTO] = BACKEND_PORT, 6
    # a slice of the non-service rows hits a VIP on a port or protocol
    # no frontend has
    near = other & (rng.random(n) < 0.1)
    out[near, COL_DST_IP3] = VIP4 + svc[near]
    out[near, COL_DPORT] = np.where(rng.random(int(near.sum())) < 0.5,
                                    8443, out[near, COL_DPORT])
    out[near, COL_PROTO] = np.where(out[near, COL_DPORT] == 8443, 6, 132)
    if n_v6:
        six = (u >= vip_frac) & ~other
        k = int(six.sum())
        out[six, COL_FAMILY] = 6
        out[six, COL_SRC_IP0] = int(ipaddress.IPv6Address("fd00:9::")) >> 96
        out[six, COL_SRC_IP3] = rng.integers(1, 1 << 16, k)
        idx = rng.integers(0, n_v6, k)
        out[six, COL_DST_IP0:COL_DST_IP0 + 3] = ip_to_words(vip6(0))[:3]
        out[six, COL_DST_IP3] = ip_to_words(vip6(0))[3] + idx
        out[six, COL_DPORT], out[six, COL_PROTO] = ports_protos(idx)
    dup = np.flatnonzero(rng.random(n) < dup_frac)
    dup = dup[dup > 0]
    out[dup] = out[rng.integers(0, dup)]
    return out


def crowded_rows(n: int, cap: int, clients: np.ndarray,
                 dst: int) -> np.ndarray:
    """``n`` new flows from (the first four of) ``clients`` to ``dst`` on
    8080/TCP whose flow keys share one home slot of a ``cap``-slot cache:
    they contend for one 8-slot window, one winning a slot at each claim
    step."""
    import torch

    from ..service.socklb import _hash

    sports = np.arange(1024, 65536, dtype=np.int64)
    some = np.asarray(clients, np.int64)[:4]  # ~16 keys a slot at 2^14
    src = np.repeat(some, len(sports))
    sport = np.tile(sports, len(some))
    dp = (BACKEND_PORT << 8) | 6
    key = torch.from_numpy(np.stack([src, sport, np.full_like(src, dst),
                                     np.full_like(src, dp)], 1))
    home = _hash(key).numpy() & (cap - 1)
    slot = np.bincount(home).argmax()
    pick = np.flatnonzero(home == slot)[:n]
    assert len(pick) == n, f"no home slot holds {n} flows"
    rows = np.zeros((n, N_COLS), np.uint32)
    rows[:, COL_SRC_IP3], rows[:, COL_SPORT] = src[pick], sport[pick]
    rows[:, COL_DST_IP3], rows[:, COL_DPORT] = dst, BACKEND_PORT
    rows[:, COL_PROTO], rows[:, COL_FLAGS] = 6, TCP_SYN
    rows[:, COL_LEN], rows[:, COL_FAMILY], rows[:, COL_DIR] = 100, 4, 1
    return rows


def force_overflow(fp: np.ndarray, row: np.ndarray, k: int = 3) -> np.ndarray:
    """``fp`` (u32 [P]) with ``k`` slots of the probe window of wide row
    ``row``'s flow key set to its fingerprint: with the flow not cached
    there, the row has more fingerprint candidates than the probe reads,
    and the whole batch takes the full-window probe."""
    import torch

    from ..datapath.conntrack import _fp_mix
    from ..service.socklb import _hash

    dp = (int(row[COL_DPORT]) << 8 | int(row[COL_PROTO])) & 0xFFFFFFFF
    key = torch.tensor([[int(row[COL_SRC_IP3]), int(row[COL_SPORT]),
                         int(row[COL_DST_IP3]), dp]], dtype=torch.int64)
    h = _hash(key)
    key_fp, h = int(_fp_mix(h)[0]), int(h[0])
    fp = fp.copy()
    for s in range(k):
        fp[(h + 1 + s) & (len(fp) - 1)] = key_fp
    return fp


def socklb_steps(rng: np.random.Generator, n_services: int,
                 clients: np.ndarray, others: np.ndarray, n: int,
                 connect: int = 4096, n_connect: int = 1, now0: int = 100,
                 n_v6: int = 0) -> List[Tuple[str, np.ndarray, int, int]]:
    """A sequence of socklb_stage batches whose table state threads
    through: (label, rows, now, overflow row or -1), in order:

    - ``n_connect`` connect batches of ``connect`` fresh flows (at most
      CONNECT_CAP misses: cached);
    - a steady batch of ``n`` rows repeating them (all cached);
    - a burst of ``n`` fresh flows (over CONNECT_CAP when ``n`` is:
      resolved, nothing cached);
    - a steady batch with one fresh row whose probe window the caller
      crowds with its fingerprint (``force_overflow``): the full-window
      probe for every row;
    - a batch of repeats and ``connect // 2`` fresh flows, meant to
      follow a backend change;
    - the same after the affinity pins expired;
    - fresh flows at a clock 100 s before 2^32, then repeats of them and
      of the steady flows after it wrapped (UDP entries expire across
      the wrap, TCP ones live on)."""
    kw = dict(n_services=n_services, clients=clients, others=others,
              n_v6=n_v6, v6_frac=0.1 if n_v6 else 0.0)

    def fresh(k):
        return rows(rng, k, dup_frac=0.0, **kw)

    def draw(pool, k):
        return pool[rng.integers(0, len(pool), k)]

    steps, t = [], now0
    pools = []
    for _ in range(n_connect):
        pools.append(fresh(connect))
        steps.append(("connect", pools[-1], t, -1))
        t += 10
    pool = np.concatenate(pools)
    steps.append(("steady", draw(pool, n), t, -1))
    steps.append(("burst", rows(rng, n, **kw), t + 10, -1))
    ovf = np.concatenate([draw(pool, n - 1), fresh(1)])
    steps.append(("overflow", ovf, t + 20, n - 1))
    mixed = np.concatenate([draw(pool, n - connect // 2), fresh(connect // 2)])
    steps.append(("backend-change", mixed, t + 30, -1))
    t += 30 + AFFINITY_TIMEOUT + 1
    mixed = np.concatenate([draw(pool, n - connect // 2), fresh(connect // 2)])
    steps.append(("affinity-expired", mixed, t, -1))
    late = fresh(connect)
    near = (1 << 32) - 100
    steps.append(("clock-near-2^32", late, near, -1))
    steps.append(("clock-wrapped", np.concatenate([draw(late, n // 2),
                                                   draw(pool, n - n // 2)]),
                  (near + 300) & 0xFFFFFFFF, -1))
    return steps
