"""Egress NAT port parity: cilium_tpu_torch.service.nat (and the port's
``apply_masquerade``) against cilium_tpu.service.nat on the same numpy
inputs, bit-exact.

The JAX functions run on the CPU (conftest pins JAX_PLATFORMS=cpu); the
port runs its plain PyTorch versions, the CUDA kernels' yardstick on the
card.  Every output is an integer, so the tolerance is exact equality:
rewritten rows, drop masks, the NAT table, its failure count.  Table
state carries across successive calls.  Batches are padded to one size
with all-zero rows (family 0: inert in every stage), and the pools come
in two sizes, so the JAX side compiles a handful of programs.
"""

import ipaddress

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.datapath import conntrack as jct
from cilium_tpu.datapath.verdict import apply_masquerade_jit
from cilium_tpu.service import nat as jnat
from cilium_tpu_torch import convert, u32
from cilium_tpu_torch.core.packets import (COL_DIR, COL_DPORT, COL_DST_IP3,
                                           COL_FAMILY, COL_PROTO, COL_SPORT,
                                           COL_SRC_IP3, N_COLS)
from cilium_tpu_torch.datapath import conntrack as tct
from cilium_tpu_torch.datapath.verdict import apply_masquerade
from cilium_tpu_torch.service import nat as tnat

torch.set_num_threads(1)

B = 256  # every batch is padded to this many rows
CT_CAP = 1 << 10
NODE, EGW = "192.168.0.1", "192.168.9.9"
POD = [f"10.0.2.{i}" for i in range(1, 9)]
WORLD = ["8.8.8.8", "8.8.4.4", "93.184.0.7", "1.2.3.4"]
GW_RULES = (("10.0.2.3", "8.8.0.0/16", EGW),
            ("10.0.2.3", "0.0.0.0/0", "192.168.9.10"),
            ("10.0.2.5", "93.184.0.0/24", EGW))


def _ip(s):
    return int(ipaddress.IPv4Address(s))


def _rows(entries):
    """(src, dst, sport, dport, proto, dir[, family]) -> [B, N_COLS]."""
    out = np.zeros((B, N_COLS), np.uint32)
    assert len(entries) <= B
    for i, e in enumerate(entries):
        src, dst, sport, dport, proto, dirn = e[:6]
        out[i, COL_SRC_IP3] = _ip(src) if isinstance(src, str) else src
        out[i, COL_DST_IP3] = _ip(dst) if isinstance(dst, str) else dst
        out[i, COL_SPORT], out[i, COL_DPORT] = sport, dport
        out[i, COL_PROTO], out[i, COL_DIR] = proto, dirn
        out[i, COL_FAMILY] = e[6] if len(e) > 6 else 4
    return out


def _random_rows(rng, n=B):
    """Mixed traffic: pods to world, to the cluster and to v6, ingress,
    TCP/UDP/SCTP/ICMP, a few repeated flows."""
    rows = _rows([])
    rows[:n, COL_SRC_IP3] = [_ip(x) for x in rng.choice(POD, n)]
    rows[:n, COL_DST_IP3] = [_ip(x) for x in rng.choice(
        WORLD + ["10.0.1.1", "10.9.0.3"], n)]
    rows[:n, COL_SPORT] = rng.integers(40000, 40064, n)
    rows[:n, COL_DPORT] = rng.choice([53, 443, 80], n)
    rows[:n, COL_PROTO] = rng.choice([6, 6, 17, 17, 1, 132], n)
    rows[:n, COL_DIR] = rng.choice([1, 1, 1, 0], n)
    rows[:n, COL_FAMILY] = rng.choice([4] * 9 + [6], n)
    return rows


def _inbound_ct(inbound, now, cap=CT_CAP):
    """A CT table (table, fp) holding the forward entries of
    ``inbound`` rows, established and live until now + 1000."""
    fwd, _rev = tct.ct_keys_from_headers(u32.from_numpy(inbound, "cpu"))
    rows = np.zeros((len(inbound), tct.ROW_WORDS), np.uint32)
    rows[:, :tct.KEY_WORDS] = u32.to_numpy(fwd)
    rows[:, tct.V_STATE] = tct.ST_ESTABLISHED
    rows[:, tct.V_EXPIRES] = now + 1000
    table, _dropped = tct.ct_table_from_rows(rows, cap)
    return table, tct.ct_fp_from_table(table)


class _Pair:
    """One NAT table on each side, fed the same batches."""

    def __init__(self, cap=256, rules=(), cidrs=("10.0.0.0/8",), ct=None):
        self.set_config(rules, cidrs)
        self.jtbl = jnat.NATTable.create(cap)
        self.ttbl = tnat.NATTable.create(cap, "cpu")
        table, fp = ct if ct is not None else (
            np.zeros((CT_CAP, tct.ROW_WORDS), np.uint32),
            np.zeros(CT_CAP, np.uint32))
        self.jct = jct.CTTable(table=jnp.asarray(table),
                               fp=jnp.asarray(fp), dropped=jnp.uint32(0))
        self.tct = tct.CTTable(table=u32.from_numpy(table, "cpu"),
                               fp=u32.from_numpy(fp, "cpu"),
                               dropped=torch.zeros((), dtype=torch.int32))

    def set_config(self, rules=(), cidrs=("10.0.0.0/8",)):
        cfg = dict(node_ip=NODE, non_masquerade_cidrs=cidrs,
                   egress_rules=rules)
        self.jt = jnat.NATConfig(**cfg).compile()
        self.tt = tnat.NATConfig(**cfg).compile("cpu")

    def egress(self, rows, now):
        jh, self.jtbl, jd = jnat.snat_egress_jit(
            self.jtbl, self.jt, self.jct, jnp.asarray(rows), jnp.uint32(now))
        th, _, td = tnat.snat_egress(self.ttbl, self.tt, self.tct,
                                     u32.from_numpy(rows, "cpu"), now)
        jh, jd = np.asarray(jh), np.asarray(jd)
        np.testing.assert_array_equal(u32.to_numpy(th), jh)
        np.testing.assert_array_equal(td.numpy(), jd)
        self.check_tables()
        return jh, jd

    def reverse(self, rows, now):
        jh, self.jtbl = jnat.snat_reverse_jit(
            self.jtbl, self.jt, jnp.asarray(rows), jnp.uint32(now))
        th, _ = tnat.snat_reverse(self.ttbl, self.tt,
                                  u32.from_numpy(rows, "cpu"), now)
        jh = np.asarray(jh)
        np.testing.assert_array_equal(u32.to_numpy(th), jh)
        self.check_tables()
        return jh

    def check_tables(self):
        table, failed = convert.nat_table_to_numpy(self.ttbl)
        np.testing.assert_array_equal(table, np.asarray(self.jtbl.table))
        assert failed == int(self.jtbl.failed)


# -- NATConfig.compile ----------------------------------------------------

@pytest.mark.parametrize("cfg", [
    {}, {"non_masquerade_cidrs": ()},
    {"non_masquerade_cidrs": ("10.0.0.0/8", "172.16.0.0/12", "fd00::/8")},
    {"egress_rules": GW_RULES}, {"enabled": False}],
    ids=["default", "empty-exclusions", "v4-and-v6-cidrs", "egress-rules",
         "disabled"])
def test_compile_matches_jax(cfg):
    j = jnat.NATConfig(node_ip=NODE, **cfg).compile()
    t = tnat.NATConfig(node_ip=NODE, **cfg).compile("cpu")
    assert t.node_ip == int(j.node_ip) and t.enabled == j.enabled
    for f in ("net", "mask", "egw_src", "egw_net", "egw_mask", "egw_ip"):
        np.testing.assert_array_equal(u32.to_numpy(getattr(t, f)),
                                      np.asarray(getattr(j, f)), err_msg=f)
    # the JAX package's leaves carried across give the same tensors
    c = tnat.NATTensors.from_numpy(
        *(np.asarray(getattr(j, f)) for f in (
            "node_ip", "net", "mask", "egw_src", "egw_net", "egw_mask",
            "egw_ip")), enabled=j.enabled, device="cpu")
    assert all(torch.equal(getattr(c, f), getattr(t, f)) for f in (
        "net", "mask", "egw_src", "egw_net", "egw_mask", "egw_ip"))


# -- snat_egress ----------------------------------------------------------

def test_random_traffic_over_successive_batches():
    """World, internal, v6, ICMP, SCTP and ingress rows, repeats of live
    flows, and a clock that lets UDP mappings expire between batches;
    the table carries across."""
    rng = np.random.default_rng(7)
    pair = _Pair(cap=1 << 10, rules=GW_RULES)
    now = 100
    for _ in range(5):
        hdr, drop = pair.egress(_random_rows(rng), now)
        now += 70
    assert int(np.asarray(pair.jtbl.table)[:, tnat.NV_EXPIRES].astype(
        bool).sum()) > 50


def test_inbound_replies_with_a_live_reverse_ct_keep_their_source():
    now = 500
    inbound = _rows([(w, "10.0.2.1", 5000 + i, 80, 6, 0)
                     for i, w in enumerate(WORLD)])[:len(WORLD)]
    pair = _Pair(ct=_inbound_ct(inbound, now))
    replies = _rows([("10.0.2.1", w, 80, 5000 + i, 6, 1)
                     for i, w in enumerate(WORLD)]
                    + [("10.0.2.1", "8.8.8.8", 80, 6000, 6, 1)])
    hdr, drop = pair.egress(replies, now)
    assert (hdr[:4, COL_SRC_IP3] == _ip("10.0.2.1")).all()
    assert (hdr[:4, COL_SPORT] == 80).all()
    assert hdr[4, COL_SRC_IP3] == _ip(NODE)  # no CT entry: masqueraded
    assert not drop.any()


def test_duplicates_in_one_batch_share_one_port():
    pair = _Pair()
    flows = [("10.0.2.1", "8.8.8.8", 41000 + i, 53, 17, 1) for i in range(4)]
    hdr, _ = pair.egress(_rows(flows + flows[::-1] + flows), 10)
    ports = hdr[:12, COL_SPORT].reshape(3, 4)
    assert (ports[0] == ports[2]).all() and (ports[0] == ports[1][::-1]).all()
    assert len(set(ports[0])) == 4
    # the next batch reuses the mappings
    hdr2, _ = pair.egress(_rows(flows), 11)
    assert (hdr2[:4, COL_SPORT] == ports[0]).all()


def _colliding_sports(src, dst, dport, proto, home, cap, count, start=40000):
    mask = cap - 1
    dp = (dport << 8) | proto
    out = []
    s = start
    while len(out) < count:
        if (tnat._nat_hash_py((_ip(src), s, _ip(dst), dp)) & mask) == home:
            out.append(s)
        s += 1
    return out


@pytest.mark.parametrize("n_flows", [3, 8, 12])
def test_crafted_collisions_award_the_lowest_row(n_flows):
    """Flows of several pods hashed into ONE window (as
    tests/test_nat.py crafts them), in one batch with duplicates; with
    12 flows the 8-slot window overflows and the rest drop."""
    cap = 256
    home = tnat._nat_hash_py((_ip("10.0.2.1"), 40000, _ip("8.8.8.8"),
                              (53 << 8) | 17)) & (cap - 1)
    flows = [("10.0.2.1", "8.8.8.8", 40000, 53, 17, 1)]
    for k, pod in enumerate(POD[1:]):
        for s in _colliding_sports(pod, "8.8.8.8", 53, 17, home, cap, 2,
                                   start=40000 + 3000 * k):
            flows.append((pod, "8.8.8.8", s, 53, 17, 1))
    flows = flows[:n_flows]
    rows = flows[::-1] + flows[:2]  # reversed order, then repeats
    pair = _Pair(cap=cap)
    hdr, drop = pair.egress(_rows(rows), 20)
    n = len(rows)
    # past 8 flows, the flows of the highest rows lose, and so do the
    # repeats of the two first flows (the last rows of the reversal)
    assert int(drop.sum()) == (0 if n_flows <= 8 else n_flows - 8 + 2)
    live = hdr[:n][~drop[:n], COL_SPORT]
    slots = live.astype(np.int64) - tnat.NAT_PORT_MIN
    assert ((slots - home) % cap < tnat.NAT_PROBE).all()


def test_exhaustion_in_a_2_8_pool_drops_and_counts():
    pair = _Pair(cap=256)
    failed = 0
    for b in range(3):
        flows = [("10.0.45.1", f"93.184.{b}.{i % 200 + 1}", 1024 + i, 443, 6,
                  1) for i in range(B)]
        hdr, drop = pair.egress(_rows(flows), 30 + b)
        failed += int(drop.sum())
    assert failed > 0 and failed == int(pair.jtbl.failed)
    # a dropped row keeps its source port (never port-preserving SNAT)
    assert (hdr[drop, COL_SPORT] < tnat.NAT_PORT_MIN).all()


def test_expired_mappings_are_reclaimed():
    pair = _Pair(cap=256)
    flows = [("10.0.2.1", "8.8.8.8", 42000 + i, 53, 17, 1) for i in range(64)]
    pair.egress(_rows(flows), 100)
    # past the UDP lifetime: the same slots serve new flows
    later = [("10.0.2.2", "8.8.4.4", 43000 + i, 53, 17, 1) for i in range(200)]
    hdr, drop = pair.egress(_rows(later), 100 + tnat.NAT_LIFETIME_NONTCP + 1)
    assert not drop.any()


def test_gateway_rows_and_a_live_mapping_keeps_its_ip():
    pair = _Pair()
    flow = [("10.0.2.3", "8.8.8.8", 48000, 443, 6, 1)]
    hdr, _ = pair.egress(_rows(flow), 5)
    assert hdr[0, COL_SRC_IP3] == _ip(NODE)
    pair.set_config(GW_RULES)
    hdr, _ = pair.egress(_rows(flow + [
        ("10.0.2.3", "8.8.8.8", 48001, 443, 6, 1),  # new: the first rule
        ("10.0.2.3", "10.0.1.1", 48002, 443, 6, 1),  # internal: 0.0.0.0/0
        ("10.0.2.5", "93.184.0.7", 48003, 443, 6, 1),
        ("10.0.2.5", "1.2.3.4", 48004, 1, 1, 1),  # ICMP: rewritten, no port
    ]), 6)
    assert [int(x) for x in hdr[:5, COL_SRC_IP3]] == [
        _ip(NODE), _ip(EGW), _ip("192.168.9.10"), _ip(EGW), _ip(NODE)]
    assert hdr[4, COL_SPORT] == 48004


def test_a_per_pod_gateway_table_takes_the_first_match():
    """The rule table one egress-gateway policy compiles to, a rule a
    pod, between overlapping rules ahead and behind it: each row takes
    the first rule it matches."""
    from cilium_tpu_torch.testing import egress as eg

    pods = np.array([_ip(p) for p in POD], np.uint32)
    pair = _Pair(rules=eg.gateway_rules(pods, n=len(pods)))
    hdr, _ = pair.egress(_rows(
        [(p, "93.184.0.7", 47000 + i, 443, 6, 1) for i, p in enumerate(POD)]
        + [(POD[0], "1.2.3.4", 47100, 443, 6, 1)]), 9)
    want = [eg.EGRESS_IP2 if i == 7 else eg.EGRESS_IP for i in range(8)]
    assert [int(x) for x in hdr[:9, COL_SRC_IP3]] == [
        _ip(x) for x in want + [NODE]]


@pytest.mark.parametrize("now", [(1 << 32) - 100, (1 << 31) - 20])
def test_clock_near_a_u32_boundary(now):
    """Expiries wrap past 2^32 (and cross 2^31): every compare must be
    unsigned and every sum wrap."""
    pair = _Pair(cap=256)
    rng = np.random.default_rng(now & 0xFF)
    for step in range(4):
        pair.egress(_random_rows(rng, 128), (now + 60 * step) & 0xFFFFFFFF)


# -- snat_reverse ---------------------------------------------------------

def test_reverse_hits_misses_and_gateway_ips():
    pair = _Pair(rules=GW_RULES)
    flows = [("10.0.2.1", "8.8.8.8", 40000, 53, 17, 1),
             ("10.0.2.3", "8.8.4.4", 40001, 443, 6, 1),  # via EGW
             ("10.0.2.2", "1.2.3.4", 40002, 53, 17, 1)]
    hdr, _ = pair.egress(_rows(flows), 100)
    p = [int(x) for x in hdr[:3, COL_SPORT]]
    replies = [
        ("8.8.8.8", NODE, 53, p[0], 17, 0),  # hit
        ("8.8.4.4", EGW, 443, p[1], 6, 0),  # hit on the gateway IP
        ("8.8.4.4", NODE, 443, p[1], 6, 0),  # wrong IP
        ("9.9.9.9", NODE, 53, p[0], 17, 0),  # wrong peer
        ("8.8.8.8", NODE, 53, p[0], 17, 1),  # egress: untouched
        ("8.8.8.8", NODE, 53, 1000, 17, 0),  # below the pool
        ("1.2.3.4", NODE, 53, p[2], 17, 0),  # hit
    ]
    out = pair.reverse(_rows(replies), 150)
    assert [int(x) for x in out[:7, COL_DST_IP3]] == [
        _ip("10.0.2.1"), _ip("10.0.2.3"), _ip(NODE),
        _ip(NODE), _ip(NODE), _ip(NODE), _ip("10.0.2.2")]
    assert [int(x) for x in out[:7, COL_DPORT]] == [
        40000, 40001, p[1], p[0], p[0], 1000, 40002]
    # the UDP mappings expire; replies past it no longer restore
    late = pair.reverse(_rows(replies), 150 + tnat.NAT_LIFETIME_NONTCP + 1)
    assert late[0, COL_DST_IP3] == _ip(NODE)
    assert late[1, COL_DST_IP3] == _ip("10.0.2.3")  # TCP lives on


def test_reverse_forged_protocol_aliases_the_slot():
    """A protocol word >= 256 can pass the hit test of a TCP slot; two
    such replies in one batch refresh one slot with different expiries,
    and the highest row's stands (the reference's scatter order)."""
    pair = _Pair()
    hdr, _ = pair.egress(_rows([("10.0.2.1", "8.8.8.8", 40000, 443, 6, 1)]),
                         100)
    port = int(hdr[0, COL_SPORT])
    a = ("8.8.8.8", NODE, 443, port, 6, 0)
    b = ("8.8.8.8", NODE, 443 & ~1, port, 6 | 0x100, 0)  # 443 is odd
    pair.reverse(_rows([a, b]), 200)
    pair.reverse(_rows([b, a]), 300)


# -- apply_masquerade and snat_stage ----------------------------------------

@pytest.mark.parametrize("cidrs", [("10.0.0.0/8",), ()],
                         ids=["default", "empty-exclusions"])
def test_apply_masquerade_and_snat_stage_match_jax(cidrs):
    now = 500
    rng = np.random.default_rng(3)
    inbound = _rows([(w, "10.0.2.1", 5000 + i, 80, 6, 0)
                     for i, w in enumerate(WORLD)])[:len(WORLD)]
    pair = _Pair(cidrs=cidrs, ct=_inbound_ct(inbound, now))
    rows = _random_rows(rng)
    rows[:4] = _rows([("10.0.2.1", w, 80, 5000 + i, 6, 1)
                      for i, w in enumerate(WORLD)])[:4]
    want = np.asarray(apply_masquerade_jit(pair.jct, pair.jt,
                                           jnp.asarray(rows),
                                           jnp.uint32(now)))
    got = apply_masquerade(pair.tct, pair.tt, u32.from_numpy(rows, "cpu"),
                           now)
    np.testing.assert_array_equal(u32.to_numpy(got), want)
    assert (want[:4, COL_SRC_IP3] == _ip("10.0.2.1")).all()
    jh, jm = jnat.snat_stage_jit(pair.jt, jnp.asarray(rows))
    th, tm = tnat.snat_stage(pair.tt, u32.from_numpy(rows, "cpu"))
    np.testing.assert_array_equal(u32.to_numpy(th), np.asarray(jh))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tm[:4].all()  # no CT probe in snat_stage


@pytest.mark.parametrize("case", ["fingerprint-overflow", "wrap"])
def test_apply_masquerade_matches_jax_on_crowded_windows(case):
    """The probe's edges: replies whose reverse entries sit behind more
    than N_CAND live entries of their fingerprint (found, expired or
    absent), and replies whose windows wrap the CT's end (entries past
    the wrap), among mixed rows."""
    from cilium_tpu_torch.testing import egress as eg

    now = 500
    rng = np.random.default_rng(23)
    pods = np.array([_ip(p) for p in POD], np.uint32)
    if case == "wrap":
        inbound = eg.wrap_inbound(rng, 8, pods, CT_CAP)
        replies = eg.replies_to(inbound)
    else:
        inbound, replies = eg.inbound_pairs(rng, 32, pods)
    table, fp = eg.crowded_ct(rng, inbound, now, CT_CAP,
                              crowded=0.3 if case == "wrap" else 1.0)
    pair = _Pair(ct=(table, fp))
    rows = _random_rows(rng)
    rows[:len(replies)] = replies
    want = np.asarray(apply_masquerade_jit(pair.jct, pair.jt,
                                           jnp.asarray(rows),
                                           jnp.uint32(now)))
    got = apply_masquerade(pair.tct, pair.tt, u32.from_numpy(rows, "cpu"),
                           now)
    np.testing.assert_array_equal(u32.to_numpy(got), want)
    # the edge is there: a kept reply whose entry lies past N_CAND
    # fingerprint matches, or past the capacity's end
    kept = np.flatnonzero(want[:len(replies), COL_SRC_IP3]
                          == replies[:, COL_SRC_IP3])
    fwd = u32.to_numpy(tct.ct_keys_from_headers(
        u32.from_numpy(inbound, "cpu"))[0])
    h = tct._hash_np(fwd)
    edge = False
    for j in kept:
        win = (h[j] + np.arange(tct.N_PROBE, dtype=np.uint32)) & np.uint32(
            CT_CAP - 1)
        at = int(np.flatnonzero((table[win, :tct.KEY_WORDS] == fwd[j]).all(1))
                 [0])
        edge |= (bool(win[at] < win[0]) if case == "wrap"
                 else int((fp[win[:at]] == fp[win[at]]).sum()) > tct.N_CAND)
    assert edge


def test_disabled_config_is_the_identity():
    pair = _Pair()
    j = jnat.NATConfig(node_ip=NODE, enabled=False).compile()
    t = tnat.NATConfig(node_ip=NODE, enabled=False).compile("cpu")
    rows = _random_rows(np.random.default_rng(1))
    hdr, _tbl, drop = tnat.snat_egress(pair.ttbl, t, pair.tct,
                                       u32.from_numpy(rows, "cpu"), 5)
    np.testing.assert_array_equal(u32.to_numpy(hdr), rows)
    assert not drop.any()
    got = apply_masquerade(pair.tct, t, u32.from_numpy(rows, "cpu"), 5)
    want = apply_masquerade_jit(pair.jct, j, jnp.asarray(rows),
                                jnp.uint32(5))
    np.testing.assert_array_equal(u32.to_numpy(got), np.asarray(want))


def test_live_count_and_entries_decode():
    pair = _Pair()
    flows = [("10.0.2.1", "8.8.8.8", 40000 + i, 53, 17, 1) for i in range(5)]
    pair.egress(_rows(flows), 100)
    assert tnat.nat_live_count(pair.ttbl, 100) == jnat.nat_live_count(
        pair.jtbl, 100) == 5
    assert tnat.nat_live_count(pair.ttbl, 100 + 181) == 0
    table = u32.to_numpy(pair.ttbl.table)
    assert tnat.nat_entries_from_snapshot(table) == \
        jnat.nat_entries_from_snapshot(np.asarray(pair.jtbl.table))


@pytest.mark.parametrize("how", ["created", "restored", "loader-restored"])
def test_claim_words_free_and_ignored_by_the_plain_versions(how):
    """The NAT table's claim words (``NATTable.claim``, K11's and K12's)
    live with the table and are CLAIM_FREE between calls: a table made
    by ``create``, restored from a snapshot (``convert``, or a loader's
    ``nat_restore``) holds none in use.  The plain versions neither read
    nor write them: with every word set in use, egress and reverse give
    the same rows, drops, table and failures, and leave the words as
    they were."""
    from cilium_tpu_torch.datapath.loader import TorchLoader

    rng = np.random.default_rng(7)
    pair = _Pair(cap=256, rules=GW_RULES)
    hdr, _drop = pair.egress(_random_rows(rng), 50)
    if how == "created":
        tbl = tnat.NATTable.create(256, "cpu")
    elif how == "restored":
        tbl = convert.nat_table_from_numpy(
            *convert.nat_table_to_numpy(pair.ttbl), device="cpu")
    else:
        loader = TorchLoader(ct_capacity=1 << 4, device="cpu")
        loader.nat_restore(u32.to_numpy(pair.ttbl.table))
        tbl = loader.nat_state
    assert tbl.claim.dtype == torch.int32
    assert tuple(tbl.claim.shape) == (3, tbl.table.shape[0])
    assert bool((tbl.claim == tnat.CLAIM_FREE).all())

    def copy(claims_in_use):
        t = tnat.NATTable(pair.ttbl.table.clone(), pair.ttbl.failed.clone())
        if claims_in_use:
            t.claim = torch.arange(3 * t.table.shape[0],
                                   dtype=torch.int32).reshape(3, -1)
        return t

    free, busy = copy(False), copy(True)
    rows = u32.from_numpy(_random_rows(rng), "cpu")
    got = [tnat.snat_egress_plain(t, pair.tt, pair.tct, rows, 60)
           for t in (free, busy)]
    assert torch.equal(got[0][0], got[1][0])
    assert torch.equal(got[0][2], got[1][2])
    # replies to the first batch's rewritten rows
    rep = hdr.copy()
    rep[:, COL_SRC_IP3], rep[:, COL_DST_IP3] = hdr[:, COL_DST_IP3], hdr[
        :, COL_SRC_IP3]
    rep[:, COL_SPORT], rep[:, COL_DPORT] = hdr[:, COL_DPORT], hdr[:, COL_SPORT]
    rep[:, COL_DIR] = 0
    back = [tnat.snat_reverse_plain(t, pair.tt, u32.from_numpy(rep, "cpu"),
                                    61)[0] for t in (free, busy)]
    assert torch.equal(back[0], back[1])
    assert bool((back[0][:, COL_DST_IP3] != u32.from_numpy(
        rep, "cpu")[:, COL_DST_IP3]).any())  # some replies restored
    for a, b in ((free.table, busy.table), (free.failed, busy.failed)):
        assert torch.equal(a, b)
    assert bool((free.claim == tnat.CLAIM_FREE).all())
    assert torch.equal(busy.claim.flatten(),
                       torch.arange(3 * busy.table.shape[0],
                                    dtype=torch.int32))
