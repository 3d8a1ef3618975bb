"""Socket-LB port parity: cilium_tpu_torch.service.socklb
``socklb_stage_plain`` against the JAX package's ``socklb_stage_jit``
over threaded sequences of batches, on the same numpy inputs.

After every batch the rewritten rows, the hit and no-backend masks and
the whole state -- the flow table, the fingerprints and the affinity
pins -- are compared word for word (the same algorithm places rows
identically).  The sequences mirror ``tests/test_socklb.py`` and
``tests/test_affinity.py``: first packets, established packets, a
backend change, the negative cache, rows with no backend, a burst of
``CONNECT_CAP + 512`` new flows, a crafted fingerprint overflow,
affinity pins with their refresh, expiry and prune, a full table and a
clock across 2^32.  Every batch is padded to B rows with family-0 rows
(inert: neither cached nor resolved), so the JAX side compiles once per
table and service-world shape.
"""

import ipaddress

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.service import ServiceManager as JManager
from cilium_tpu.service import socklb as jsl
from cilium_tpu_torch import u32
from cilium_tpu_torch.core.packets import (COL_DIR, COL_DPORT, COL_DST_IP3,
                                           COL_FAMILY, COL_FLAGS, COL_PROTO,
                                           COL_SPORT, COL_SRC_IP3, N_COLS,
                                           TCP_SYN)
from cilium_tpu_torch.service import ServiceManager
from cilium_tpu_torch.service import socklb as tsl
from cilium_tpu_torch.testing import services as sv

torch.set_num_threads(1)

B = tsl.CONNECT_CAP + 512  # every batch holds this many rows
M = 2039
VIP, AFF_VIP, EMPTY_VIP = "172.16.0.10", "172.16.0.20", "172.16.0.99"
BACKENDS = [f"10.0.1.{i + 1}:8080" for i in range(4)]


def _ip(s):
    return int(ipaddress.IPv4Address(s))


def _world_ops():
    return [("web", f"{VIP}:80", BACKENDS, {}),
            ("zz-web-dup", f"{VIP}:80", ["10.0.9.9:1"], {}),
            ("dns", "172.16.0.53:53", ["10.0.2.1:5353"], {"protocol": 17}),
            ("aff", f"{AFF_VIP}:80", BACKENDS, {"affinity_timeout": 60}),
            ("empty", f"{EMPTY_VIP}:80", [], {}),
            ("high", "250.0.0.1:443", ["200.0.0.1:443", "200.0.0.2:443"],
             {"affinity_timeout": 30})]


class _Pair:
    """One flow cache on each side, fed the same batches."""

    def __init__(self, cap=1 << 14, aff_cap=1 << 12):
        self.jm, self.tm = JManager(m=M), ServiceManager(m=M, device="cpu")
        for name, fe, bes, kw in _world_ops():
            self.upsert(name, fe, bes, **kw)
        self.jtbl = jsl.SockLBTable.create(cap, aff_cap)
        self.ttbl = tsl.SockLBTable.create(cap, aff_cap, device="cpu")

    def upsert(self, *args, **kw):
        self.jm.upsert(*args, **kw)
        self.tm.upsert(*args, **kw)

    def prune(self):
        self.jtbl = self.jtbl.prune_affinity(self.jm.backend_set())
        self.ttbl.prune_affinity(self.tm.backend_set())
        self.check_tables()

    def set_fp(self, fp):
        self.jtbl = jsl.SockLBTable(table=self.jtbl.table,
                                    fp=jnp.asarray(fp), aff=self.jtbl.aff)
        self.ttbl.fp.copy_(u32.from_numpy(fp, "cpu"))

    def check_tables(self):
        for f in ("table", "fp", "aff"):
            np.testing.assert_array_equal(
                u32.to_numpy(getattr(self.ttbl, f)),
                np.asarray(getattr(self.jtbl, f)), err_msg=f)

    def step(self, rows, now):
        """Rows through both sides (padded to B): outputs and tables
        equal; -> the port's (rows', hit, no_backend), unpadded."""
        n = len(rows)
        pad = np.zeros((B, N_COLS), np.uint32)
        pad[:n] = rows
        jh, jhit, jnobe, self.jtbl = jsl.socklb_stage_jit(
            self.jtbl, self.jm.tensors(), jnp.asarray(pad), jnp.uint32(now))
        th, thit, tnobe, _ = tsl.socklb_stage(
            self.ttbl, self.tm.tensors(), u32.from_numpy(pad, "cpu"), now)
        np.testing.assert_array_equal(u32.to_numpy(th), np.asarray(jh))
        np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
        np.testing.assert_array_equal(tnobe.numpy(), np.asarray(jnobe))
        self.check_tables()
        return u32.to_numpy(th)[:n], thit.numpy()[:n], tnobe.numpy()[:n]


def _flows(n, dst=VIP, dport=80, proto=6, sport0=41000, src="10.0.9.9"):
    rows = np.zeros((n, N_COLS), np.uint32)
    rows[:, COL_SRC_IP3] = _ip(src)
    rows[:, COL_DST_IP3] = _ip(dst)
    rows[:, COL_SPORT] = sport0 + np.arange(n)
    rows[:, COL_DPORT], rows[:, COL_PROTO] = dport, proto
    rows[:, COL_FLAGS], rows[:, COL_FAMILY], rows[:, COL_DIR] = TCP_SYN, 4, 1
    return rows


def _backend(out):
    return list(zip(out[:, COL_DST_IP3].tolist(), out[:, COL_DPORT].tolist()))


def test_first_packet_then_established_then_backend_change():
    p = _Pair()
    rows = np.concatenate([_flows(48), _flows(8, dst="172.16.0.53",
                                              dport=53, proto=17)])
    first, hit, _ = p.step(rows, 10)
    assert hit.all()
    again, hit, _ = p.step(rows, 20)  # all cached now
    np.testing.assert_array_equal(again, first)
    # a backend leaves: cached flows keep theirs, new flows use the rest
    p.upsert("web", f"{VIP}:80", BACKENDS[:2])
    kept, _, _ = p.step(rows, 21)
    np.testing.assert_array_equal(kept, first)
    fresh, hit, _ = p.step(_flows(64, sport0=55000), 22)
    assert hit.all()
    assert {ip for ip, _ in _backend(fresh)} <= {_ip("10.0.1.1"),
                                                 _ip("10.0.1.2")}


def test_negative_cache_and_no_backend_never_cached():
    p = _Pair()
    other = _flows(16, dst="203.0.113.7", dport=443)
    empty = _flows(8, dst=EMPTY_VIP)
    wrong_proto = _flows(8, dport=80, proto=17, sport0=47000)
    rows = np.concatenate([other, empty, wrong_proto])
    out, hit, nobe = p.step(rows, 10)
    np.testing.assert_array_equal(out, rows)
    assert not hit.any()
    assert nobe[16:24].all() and nobe.sum() == 8
    # negative entries for the non-service flows, none for empty
    entries = tsl.socklb_entries_from_snapshot(u32.to_numpy(p.ttbl.table),
                                               10)
    assert len(entries) == 24 and all(e["backend"] is None for e in entries)
    out, hit, nobe = p.step(rows, 20)
    np.testing.assert_array_equal(out, rows)
    assert nobe.sum() == 8
    # backends arrive: the very same flows resolve on the next batch
    p.upsert("empty", f"{EMPTY_VIP}:80", ["10.0.7.7:80"])
    out, hit, nobe = p.step(rows, 21)
    assert hit[16:24].all() and not nobe.any()
    # an expired negative entry stops masking: the flow resolves again
    p.upsert("other", "203.0.113.7:443", ["10.0.8.8:443"])
    out, hit, _ = p.step(rows, 21 + tsl.LIFETIME_TCP + 1)
    assert hit[:16].all()


def test_burst_over_connect_cap_resolves_without_caching():
    p = _Pair()
    rows = _flows(tsl.CONNECT_CAP + 512, sport0=10000)
    rows[::7, COL_DST_IP3] = _ip("203.0.113.7")  # non-service among them
    rows[::11, COL_DST_IP3] = _ip(AFF_VIP)
    out, hit, _ = p.step(rows, 10)
    assert hit.sum() == len(rows) - len(rows[::7]) + len(rows[::77])
    assert not u32.to_numpy(p.ttbl.fp).any()  # nothing cached
    # the same flows in a batch under the cap are cached this time
    out2, _, _ = p.step(rows[:4096], 11)
    np.testing.assert_array_equal(out2, out[:4096])
    assert (u32.to_numpy(p.ttbl.fp) > 0).sum() > 0


def test_forced_fingerprint_overflow_takes_the_full_probe():
    p = _Pair(cap=1 << 8)
    est = _flows(96)
    p.step(est, 10)
    fresh = _flows(1, sport0=60000)
    p.set_fp(sv.force_overflow(u32.to_numpy(p.ttbl.fp), fresh[0]))
    # the crowded window now hides est rows' fingerprints behind
    # foreign ones for some: every row takes the full-window probe
    rows = np.concatenate([est, fresh])
    out, hit, _ = p.step(rows, 11)
    assert hit.all()
    p.step(rows, 12)


def test_affinity_pin_refresh_expiry_and_prune():
    p = _Pair()
    # two first connects from one client in one batch: the lower row's
    # backend is pinned, the other keeps its own Maglev pick
    out, _, _ = p.step(_flows(2, dst=AFF_VIP, sport0=41000), 100)
    pinned = _backend(out)[0]
    # later flows of that client follow the pin, and refresh it
    for now in (130, 150, 200):
        out, _, _ = p.step(_flows(16, dst=AFF_VIP, sport0=now * 100), now)
        assert set(_backend(out)) == {pinned}
    # other clients pin independently
    many = np.concatenate([_flows(4, dst=AFF_VIP, src=f"10.0.9.{i}",
                                  sport0=43000) for i in range(20, 40)])
    p.step(many, 201)
    # 61 s after the last refresh the pin has expired: Maglev again
    p.step(_flows(64, dst=AFF_VIP, sport0=30000), 262)
    # the pinned backend leaves the service: its pins are pruned
    p.upsert("aff", f"{AFF_VIP}:80",
             [b for b in BACKENDS
              if (_ip(b.split(":")[0]), 8080) != pinned],
             affinity_timeout=60)
    p.prune()
    out, _, _ = p.step(_flows(16, dst=AFF_VIP, sport0=31000), 263)
    assert pinned not in _backend(out)


def test_full_table_resolves_rows_it_cannot_cache():
    p = _Pair(cap=1 << 5, aff_cap=1 << 4)
    rows = np.concatenate([_flows(200), _flows(40, dst=AFF_VIP, src="10.0.9.8"),
                           _flows(30, dst="203.0.113.7")])
    want, _, _ = p.step(rows, 10)
    assert (u32.to_numpy(p.ttbl.fp) > 0).all()  # every slot taken
    out, hit, _ = p.step(rows, 11)
    # cached or resolved again, a flow keeps its backend (the affinity
    # rows follow the pin their client's first row claimed)
    np.testing.assert_array_equal(out[:200], want[:200])
    assert hit[:240].all()
    assert len(set(_backend(out[200:240]))) == 1


@pytest.mark.parametrize("near", [(1 << 32) - 100, (1 << 31) - 100])
def test_clock_across_a_u32_boundary(near):
    p = _Pair()
    tcp = _flows(64)
    udp = _flows(64, dst="172.16.0.53", dport=53, proto=17, sport0=50000)
    aff = _flows(8, dst=AFF_VIP, sport0=52000)
    rows = np.concatenate([tcp, udp, aff])
    first, _, _ = p.step(rows, near)
    for dt in (60, 150, 250, 400):
        out, hit, _ = p.step(rows, (near + dt) & 0xFFFFFFFF)
        assert hit.all()
        np.testing.assert_array_equal(out[:128], first[:128])


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_sequence_matches_jax(seed):
    """``testing.services.socklb_steps``, the sequence the card checks
    at full size, at this file's batch shape and a 24-service world."""
    rng = np.random.default_rng(seed)
    p = _Pair()
    clients = (0x0A000900 + np.arange(1, 9)).astype(np.uint32)
    others = np.array([_ip("10.0.5.5"), _ip("203.0.113.7")], np.uint32)
    # the pair's world plus svc0..17 of the generator's (n_services=18)
    pods = [f"10.0.3.{i}" for i in range(1, 30)]
    for svc, eps in sv.k8s_objects(pods, n=18, n_empty=2):
        port, proto = sv.port_proto(int(svc["metadata"]["name"][3:]))
        p.upsert(svc["metadata"]["name"], f"{svc['spec']['clusterIP']}:{port}",
                 [f"{a['ip']}:8080" for a in eps["subsets"][0]["addresses"]],
                 protocol=6 if proto == "TCP" else 17,
                 affinity_timeout=(sv.AFFINITY_TIMEOUT
                                   if "sessionAffinity" in svc["spec"] else 0))
    for label, rows, now, ovf in sv.socklb_steps(
            rng, 18, clients, others, B, connect=2048, n_connect=2):
        if label == "backend-change":
            p.upsert("svc2", f"{sv.vip4(2)}:80", ["10.0.3.5:8080"])
            p.prune()
        if ovf >= 0:
            p.set_fp(sv.force_overflow(u32.to_numpy(p.ttbl.fp), rows[ovf]))
        p.step(rows, now)


def test_state_carried_across_from_jax():
    """A JAX-compiled service table and a JAX-threaded flow cache carry
    across (``convert``): the port continues the sequence from them and
    stays equal to the JAX run, and its tables convert back equal."""
    from cilium_tpu_torch import convert

    p = _Pair()
    rows = np.concatenate([_flows(64), _flows(32, dst=AFF_VIP, sport0=50000),
                           _flows(16, dst="203.0.113.7")])
    p.step(rows, 10)
    # hand the JAX state to a fresh port side
    jt = p.jm.tensors()
    p.ttbl = convert.socklb_table_from_numpy(
        *(np.asarray(getattr(p.jtbl, f)) for f in ("table", "fp", "aff")),
        device="cpu")
    t = convert.lb_tensors_from_numpy(
        {**{f: np.asarray(getattr(jt, f)) for f in (
            "svc_ip", "svc_port", "svc_proto", "maglev", "backend_ip",
            "backend_port", "svc_aff")}, "m": jt.m}, device="cpu")
    for f in ("svc_ip", "maglev", "svc_aff"):
        assert torch.equal(getattr(t, f), getattr(p.tm.tensors(), f))
    p.step(np.concatenate([rows, _flows(32, sport0=60000)]), 11)
    back = convert.socklb_table_to_numpy(p.ttbl)
    for got, f in zip(back, ("table", "fp", "aff")):
        np.testing.assert_array_equal(got, np.asarray(getattr(p.jtbl, f)))
    jt6 = JManager(m=M)
    jt6.upsert("web6", "[fd00::10]:80", ["fd00:1::1:8080"])
    t6 = jt6.tensors6()
    mine = convert.lb6_tensors_from_numpy(
        {**{f: np.asarray(getattr(t6, f)) for f in (
            "svc_ip", "svc_port", "svc_proto", "maglev", "backend_ip",
            "backend_port")}, "m": t6.m}, device="cpu")
    assert u32.to_numpy(mine.svc_ip).tolist() == np.asarray(
        t6.svc_ip).tolist()


@pytest.mark.parametrize("how", ["created", "restored", "pruned"])
def test_claim_words_free_and_ignored_by_the_plain_version(how):
    """K17's claim words (``SockLBTable.claim``, ``.aclaim``) live with
    the table and are CLAIM_FREE between calls: a table made by
    ``create``, restored from a snapshot (``convert``) or pruned holds
    none in use.  The plain version neither reads nor writes them: with
    every word set in use it gives the same rows, masks and tables, and
    leaves the words as they were."""
    from cilium_tpu_torch import convert
    from cilium_tpu_torch.service.nat import CLAIM_FREE

    p = _Pair()
    rows = np.concatenate([_flows(64), _flows(16, dst=AFF_VIP, sport0=50000),
                           _flows(8, dst="203.0.113.7")])
    p.step(rows, 10)
    if how == "created":
        tbl = tsl.SockLBTable.create(1 << 14, 1 << 12, device="cpu")
    elif how == "restored":
        tbl = convert.socklb_table_from_numpy(
            *convert.socklb_table_to_numpy(p.ttbl), device="cpu")
    else:
        p.upsert("aff", f"{AFF_VIP}:80", BACKENDS[:1], affinity_timeout=60)
        p.prune()
        tbl = p.ttbl
    for words, rows_of in ((tbl.claim, tbl.table), (tbl.aclaim, tbl.aff)):
        assert words.dtype == torch.int32
        assert tuple(words.shape) == (3, rows_of.shape[0])
        assert bool((words == CLAIM_FREE).all())

    def copy(claims_in_use):
        t = tsl.SockLBTable(tbl.table.clone(), tbl.fp.clone(),
                            tbl.aff.clone())
        if claims_in_use:
            t.claim = torch.arange(3 * t.table.shape[0],
                                   dtype=torch.int32).reshape(3, -1)
            t.aclaim = torch.arange(3 * t.aff.shape[0],
                                    dtype=torch.int32).reshape(3, -1)
        return t

    free, busy = copy(False), copy(True)
    batch = u32.from_numpy(np.concatenate([rows, _flows(32, sport0=60000)]),
                           "cpu")
    got = [tsl.socklb_stage_plain(t, p.tm.tensors(), batch, 20)
           for t in (free, busy)]
    for a, b in zip(got[0][:3], got[1][:3]):
        assert torch.equal(a, b)
    for f in ("table", "fp", "aff"):
        assert torch.equal(getattr(free, f), getattr(busy, f))
    assert bool((free.claim == CLAIM_FREE).all())
    assert torch.equal(busy.claim.flatten(),
                       torch.arange(3 * busy.table.shape[0],
                                    dtype=torch.int32))
    assert torch.equal(busy.aclaim.flatten(),
                       torch.arange(3 * busy.aff.shape[0], dtype=torch.int32))
