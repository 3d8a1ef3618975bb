"""The fourth slice: live identity and ipcache churn without
regeneration.  The port's ``TorchLoader`` patch paths (device="cpu",
the plain version of the ``dus`` kernel) against the JAX package's
``TPULoader`` (JAX on the CPU, delta attach off so both sides full-
attach alike) after the same ``patch_identity`` / ``patch_ipcache`` /
``delete_ipcache`` / ``attach`` sequences:

- the verdict and auth tensors bit-exact (exact: integer tables);
- the LPMs equal as lookups over every programmed prefix and its
  neighbours (``lpm_upsert`` may place blocks where a fresh
  ``compile_lpm`` would not) and their entry mirrors equal;
- the ``tables`` counters (generation, patches, full attaches) equal;
- ``step`` outputs and the serving daemon's events bit-exact.

Then what the reference's churn gate pins, on the port: the
TableVersioner contract, no-op mutations, mid-swap faults that publish
nothing (device tables and host mirrors unchanged), and randomized
patch/attach interleavings against live serving whose every verdict
matches a pre- or post-churn oracle (the JAX interpreter backend)."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.agent import Daemon as JDaemon, DaemonConfig as JConfig
from cilium_tpu.core import make_batch
from cilium_tpu.datapath import lpm as jlpm
from cilium_tpu.datapath.tables import TableVersioner as JTableVersioner
from cilium_tpu.labels import LabelSet as JLabelSet
from cilium_tpu.monitor.api import decode_out
from cilium_tpu.testing.workloads import (ChurnOp as JChurnOp,
                                          IdentityChurnScenario as JScenario)
from cilium_tpu_torch import convert, u32
from cilium_tpu_torch.agent import Daemon, DaemonConfig
from cilium_tpu_torch.core.packets import COL_SPORT, TCP_SYN
from cilium_tpu_torch.datapath import loader as loader_mod
from cilium_tpu_torch.datapath import lpm as tlpm
from cilium_tpu_torch.datapath.tables import TableVersioner
from cilium_tpu_torch.datapath.verdict import (REASON_DISPATCH_TIMEOUT,
                                               REASON_INGRESS_OVERFLOW,
                                               REASON_RECOVERY_DROP,
                                               REASON_ROUTE_OVERFLOW)
from cilium_tpu_torch.infra import faults
from cilium_tpu_torch.labels import LabelSet
from cilium_tpu_torch.policy.compiler import IdentityRowMap, compile_policy
from cilium_tpu_torch.testing.workloads import (ChurnOp,
                                                IdentityChurnScenario)

torch.set_num_threads(1)

CT = 1 << 12
# tests/test_churn_gate.py's world: live churn slots are admitted on
# 5432 (the k8s:churn=yes convention), dead slots default-deny
RULES = [{
    "endpointSelector": {"matchLabels": {"app": "db"}},
    "ingress": [
        {"fromEndpoints": [{"matchLabels": {"app": "web"}}],
         "toPorts": [{"ports": [{"port": "5432", "protocol": "TCP"}]}]},
        {"fromEndpoints": [{"matchLabels": {"churn": "yes"}}],
         "toPorts": [{"ports": [{"port": "5432", "protocol": "TCP"}]}]},
    ],
}]
# tests/test_incremental.py's world: role=web allowed, role=banned
# denied, a CIDR allow
INC_RULES = [{
    "endpointSelector": {"matchLabels": {"app": "db"}},
    "ingress": [
        {"fromEndpoints": [{"matchLabels": {"role": "web"}}],
         "toPorts": [{"ports": [{"port": "5432", "protocol": "TCP"}]}]},
        {"fromCIDR": ["192.168.0.0/16"],
         "toPorts": [{"ports": [{"port": "8080", "protocol": "TCP"}]}]},
    ],
    "ingressDeny": [
        {"fromEndpoints": [{"matchLabels": {"role": "banned"}}],
         "toPorts": [{"ports": [{"port": "5432", "protocol": "TCP"}]}]},
    ],
}]
HOST_REASONS = {REASON_INGRESS_OVERFLOW, REASON_DISPATCH_TIMEOUT,
                REASON_RECOVERY_DROP, REASON_ROUTE_OVERFLOW}
STEP_ROWS = 8  # every step of these tests: one JAX executable


@pytest.fixture(autouse=True)
def _disarm_port_faults():
    """No armed injector of the port may leak into the next test."""
    yield
    faults.disarm()


def _jdaemon(backend="tpu", **over):
    cfg = dict(backend=backend, ct_capacity=CT, mesh_auth=False,
               enable_hubble=False, flow_agg_enabled=False,
               history_interval=0.0)
    if backend == "tpu":
        cfg["policy_delta_compile"] = False
    cfg.update(over)
    return JDaemon(JConfig(**cfg))


def _world(d, rules, start=True):
    """web and db endpoints, the rules, start(); returns db's id."""
    d.add_endpoint("web", ("10.0.1.1",), ["k8s:app=web"])
    db = d.add_endpoint("db", ("10.0.2.1",), ["k8s:app=db"])
    d.policy_import(rules)
    if start:
        d.start()
    return db.id


def _pair(rules=RULES, **serving):
    """A JAX daemon and a port daemon built alike (delta attach off on
    both, so both full-attach alike); returns (jd, td, db id)."""
    jd = _jdaemon(**serving)
    td = Daemon(DaemonConfig(ct_capacity=CT, policy_delta_compile=False,
                             **serving), device="cpu")
    ids = [_world(d, rules) for d in (jd, td)]
    assert ids[0] == ids[1]
    return jd, td, ids[0]


def _syn_rows(specs, ep, sport0):
    """Wide rows of one SYN per (src, dport), padded to STEP_ROWS with
    web -> 5432 rows."""
    specs = list(specs) + [("10.0.1.1", 5432)] * (STEP_ROWS - len(specs))
    return make_batch([dict(src=src, dst="10.0.2.1", sport=sport0 + i,
                            dport=dport, proto=6, flags=TCP_SYN, ep=ep,
                            dir=0)
                       for i, (src, dport) in enumerate(specs)]).data


def _step_both(jd, td, specs, ep, sport0, now=10):
    """One ``step`` of the same rows on both loaders: the out rows are
    bit-exact; returns the verdicts of ``specs``."""
    rows = _syn_rows(specs, ep, sport0)
    want = np.asarray(jd.loader.step(rows, now=now)[0])
    got = np.asarray(td.loader.step(rows, now=now)[0])
    np.testing.assert_array_equal(got, want)
    return got[:len(specs), 0].tolist()


def _np(t):
    return u32.to_numpy(t).view(np.int32)


def _assert_tables_match_jax(jl, tl):
    """The port loader's published tables against the JAX loader's."""
    jp, tp = jl.state.policy, tl.state.policy
    np.testing.assert_array_equal(_np(tp.verdict),
                                  np.asarray(jp.verdict))
    np.testing.assert_array_equal(u32.to_numpy(tp.auth),
                                  np.asarray(jp.auth))
    assert tl._lpm_entries == jl._lpm_entries
    jlpm_t = convert.ipcache_from_numpy(
        {k: np.asarray(getattr(jl.state.ipcache, k))
         for k in ("l1", "l2", "l3", "v6_net", "v6_mask", "v6_value",
                   "v6_plen")} | {"default": jl.state.ipcache.default},
        "cpu")
    ips = torch.from_numpy(
        convert.lpm_probe_ips(tl._lpm_entries).view(np.int32))
    lpm = tl.state.ipcache
    np.testing.assert_array_equal(
        tlpm.lookup_v4(lpm.l1, lpm.l2, lpm.l3, ips).numpy(),
        tlpm.lookup_v4(jlpm_t.l1, jlpm_t.l2, jlpm_t.l3, ips).numpy())
    for k in ("v6_net", "v6_mask", "v6_value", "v6_plen"):
        np.testing.assert_array_equal(u32.to_numpy(getattr(lpm, k)),
                                      u32.to_numpy(getattr(jlpm_t, k)))
    js, ts = jl.table_stats(), tl.table_stats()
    for k in ("generation", "patches", "full-attaches", "swaps"):
        assert ts[k] == js[k], (k, ts[k], js[k])


# -- K10's plain version against jax.lax.dynamic_update_slice --------
DUS_CASES = {
    # a verdict row [n_pol, 2, 1, n_cls] into [n_pol, 2, n_rows, n_cls]
    "verdict-row": ((3, 2, 40, 16), (3, 2, 1, 16), (0, 0, 17, 0)),
    # an auth column
    "auth-column": ((3, 40), (3, 1), (0, 39)),
    # an l1 cell, an l2/l3 block row
    "l1-cell": ((1024,), (1,), (1000,)),
    "l3-row": ((8, 256), (1, 256), (5, 0)),
    # the start rule: past the edge writes the last window that fits;
    # a negative start counts from the end once, then clamps
    "clamp-past-edge": ((3, 2, 40, 16), (3, 2, 1, 16), (2, 5, 99, 4)),
    "clamp-negative": ((8, 256), (2, 256), (-3, -1)),
    "clamp-below-minus-dim": ((3, 40), (3, 1), (-7, -41)),
}


@pytest.mark.parametrize("case", sorted(DUS_CASES))
def test_dus_plain_matches_jax_dynamic_update_slice(case):
    dst_shape, upd_shape, starts = DUS_CASES[case]
    rng = np.random.default_rng(len(case))
    dst = rng.integers(-2**31, 2**31, dst_shape, dtype=np.int64).astype(
        np.int32)
    upd = rng.integers(-2**31, 2**31, upd_shape, dtype=np.int64).astype(
        np.int32)
    want = np.asarray(jax.lax.dynamic_update_slice(
        jnp.asarray(dst), jnp.asarray(upd), starts))
    got = torch.from_numpy(dst.copy())
    out = loader_mod._dus(got, torch.from_numpy(upd), starts)
    assert out is got  # in place
    np.testing.assert_array_equal(got.numpy(), want)


# -- K10's runs (loader._dus_runs), applied with numpy ----------------
# (dst shape, update shape, starts, (words a run, runs)) over ranks 1-4:
# config #3's patch shapes cut small, then the start rule's edges
DUS_RUNS_CASES = {
    "verdict-row": ((3, 2, 40, 16), (3, 2, 1, 16), (0, 0, 17, 0), (16, 6)),
    "auth-column": ((3, 40), (3, 1), (0, 39), (1, 3)),
    "l1-cell": ((1024,), (1,), (1000,), (1, 1)),
    "l2-row": ((6, 256), (1, 256), (5, 0), (256, 1)),
    "l3-row": ((8, 256), (1, 256), (3, 0), (256, 1)),
    "l3-rows-full-width": ((8, 256), (3, 256), (2, 0), (768, 1)),
    "past-the-edge": ((3, 2, 40, 16), (3, 2, 1, 16), (2, 5, 99, 4),
                      (16, 6)),
    "negative-starts": ((8, 256), (2, 256), (-3, -1), (512, 1)),
    "below-minus-dim": ((3, 40), (3, 1), (-7, -41), (1, 3)),
    "rank-1-run": ((1000,), (37,), (990,), (37, 1)),
    "rank-2-window": ((9, 11), (4, 5), (3, 2), (5, 4)),
    "rank-3-window": ((5, 6, 7), (2, 3, 4), (1, -2, 2), (4, 6)),
    "rank-4-window": ((4, 5, 6, 8), (2, 3, 2, 8), (1, 1, 3, 0), (16, 6)),
    "rank-4-inner-1": ((4, 5, 6, 8), (2, 3, 4, 1), (0, 2, 1, 7), (1, 24)),
    "rank-4-whole": ((2, 3, 4, 5), (2, 3, 4, 5), (0, 0, 0, 0), (120, 1)),
}


@pytest.mark.parametrize("case", sorted(DUS_RUNS_CASES))
def test_dus_runs_apply_as_dynamic_update_slice(case):
    """The runs K10 copies, applied to a flat copy of the table with
    numpy, give what ``_dus_plain`` and ``jax.lax.dynamic_update_slice``
    give; the verdict row is 2 n_pol runs of a row's width, the auth
    column n_pol runs of one word, a full-width block one run."""
    dst_shape, upd_shape, starts, (run_words, n_runs) = DUS_RUNS_CASES[case]
    rng = np.random.default_rng(len(case) + 7)
    dst = rng.integers(-2**31, 2**31, dst_shape, dtype=np.int64).astype(
        np.int32)
    upd = rng.integers(-2**31, 2**31, upd_shape, dtype=np.int64).astype(
        np.int32)
    r = loader_mod._dus_runs(dst_shape, upd_shape, starts)
    c0, c1, c2 = r.counts
    assert (r.run, c0 * c1 * c2) == (run_words, n_runs)
    got = dst.reshape(-1).copy()
    flat = upd.reshape(-1)
    for q0 in range(c0):
        for q1 in range(c1):
            for q2 in range(c2):
                q = (q0 * c1 + q1) * c2 + q2
                at = (r.base + q0 * r.strides[0] + q1 * r.strides[1]
                      + q2 * r.strides[2])
                got[at:at + r.run] = flat[q * r.run:(q + 1) * r.run]
    want = np.asarray(jax.lax.dynamic_update_slice(
        jnp.asarray(dst), jnp.asarray(upd), starts))
    plain = loader_mod._dus_plain(torch.from_numpy(dst.copy()),
                                  torch.from_numpy(upd), starts)
    np.testing.assert_array_equal(got.reshape(dst_shape), want)
    np.testing.assert_array_equal(plain.numpy(), want)


# -- datapath/tables.py ----------------------------------------------
class TestTableVersioner:
    def test_flip_bumps_generation_and_recycles_slots(self):
        """The reference's slot pair is not kept (nothing reads a
        previous generation in the port): each flip bumps the
        generation, hands it to the build and records both latencies."""
        tv = TableVersioner()
        with tv.building() as b:
            gen = tv.flip(b, time.monotonic())
        assert gen == 1 and tv.generation == 1 and tv.swaps == 1
        assert b.published == 1
        with tv.building() as b:
            tv.flip(b, time.monotonic())
        assert tv.generation == 2 and b.published == 2
        assert tv.last_swap_us is not None
        assert tv.swap_stall.count == 2 and tv.update_visible.count == 2

    def test_failed_build_publishes_nothing(self):
        tv = TableVersioner()
        with tv.building() as b:
            tv.flip(b, time.monotonic())
        with pytest.raises(RuntimeError):
            with tv.building() as b:
                raise RuntimeError("mid-build crash")
        assert tv.generation == 1 and tv.swaps == 1
        assert tv.failed_builds == 1 and b.published is None
        assert tv.update_visible.count == 1
        with tv.building() as b:
            tv.flip(b, time.monotonic())
        assert tv.generation == 2 and tv.failed_builds == 1

    def test_bailout_without_publish_counts_nothing(self):
        tv = TableVersioner()
        with tv.building() as b:
            pass  # a validation `return False` path
        assert b.published is None
        assert tv.generation == 0 and tv.failed_builds == 0
        assert tv.update_visible.count == 0

    def test_snapshot_has_the_reference_keys(self):
        want, got = JTableVersioner().snapshot(), TableVersioner().snapshot()
        assert got == want


# -- lpm_upsert / LPMUndo --------------------------------------------
LPM_CASES = {
    "host-route-into-value-region": ({"10.0.0.0/8": 1},
                                     [("10.1.2.3/32", 7)]),
    "host-route-into-existing-blocks": (
        {"10.0.0.0/8": 1, "10.1.2.0/24": 3},
        [("10.1.2.3/32", 7), ("10.1.2.4/32", 8)]),
    "slash24-upsert": ({"10.0.0.0/8": 1}, [("10.5.6.0/24", 9)]),
    "short-prefix-upsert": ({}, [("172.16.0.0/12", 4)]),
    "short-prefix-over-sibling-value": ({"10.1.0.0/16": 7},
                                        [("10.0.0.0/8", 9)]),
    "host-routes-until-padding-exhausts": (
        {"0.0.0.0/0": 1}, [(f"10.{i}.0.1/32", i + 2) for i in range(40)]),
}


@pytest.mark.parametrize("case", sorted(LPM_CASES))
def test_lpm_upsert_matches_jax_and_a_fresh_compile(case):
    """The same upserts through both packages' ``lpm_upsert`` (a rebuild
    where it answers None) give identical tables and identical patch
    lists, and lookups equal a fresh ``compile_lpm`` of the union."""
    base, upserts = LPM_CASES[case]
    t, j = tlpm.compile_lpm(dict(base)), jlpm.compile_lpm(dict(base))
    merged = dict(base)
    for cidr, val in upserts:
        pt, pj = tlpm.lpm_upsert(t, cidr, val), jlpm.lpm_upsert(j, cidr, val)
        assert (pt is None) == (pj is None)
        for (ft, it, at), (fj, ij, aj) in zip(pt or [], pj or []):
            assert (ft, it) == (fj, ij)
            np.testing.assert_array_equal(at, aj)
        merged[cidr] = val
        if pt is None:
            t, j = tlpm.compile_lpm(merged), jlpm.compile_lpm(merged)
    for k in ("l1", "l2", "l3"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
    fresh = tlpm.compile_lpm(merged)
    ips = torch.from_numpy(convert.lpm_probe_ips(merged).view(np.int32))

    def look(x):
        return tlpm.lookup_v4(*(torch.from_numpy(getattr(x, k))
                                for k in ("l1", "l2", "l3")), ips).numpy()

    np.testing.assert_array_equal(look(t), look(fresh))


def test_lpm_upsert_refusals_leave_the_tables_untouched():
    """A shorter prefix over child blocks, and a fresh /16 whose l3
    block would not fit (l2 has headroom), answer None with no side
    effects, as in the reference."""
    t = tlpm.compile_lpm({"10.1.2.0/24": 3})
    assert tlpm.lpm_upsert(t, "10.0.0.0/8", 5) is None
    t = tlpm.compile_lpm({"10.0.0.1/32": 5, "10.0.1.1/32": 6}, block_pad=2)
    before = [getattr(t, k).copy() for k in ("l1", "l2", "l3")]
    assert tlpm.lpm_upsert(t, "10.9.0.1/32", 7) is None
    for a, k in zip(before, ("l1", "l2", "l3")):
        np.testing.assert_array_equal(getattr(t, k), a)


@pytest.mark.parametrize("cidr", ["10.1.2.9/32", "10.7.0.1/32",
                                  "10.0.0.0/24"])
def test_lpm_undo_restores_the_mirror_after_an_upsert(cidr):
    """Into an existing l3 block, into a fresh /16 (new l2 and l3
    blocks), and a non-/32 (nothing to snapshot): restore() brings the
    mirror back byte for byte, the same cells the reference's undo
    snapshots."""
    base = {"10.0.0.0/8": 1, "10.1.2.0/24": 3, "10.1.2.4/32": 8}
    t, j = tlpm.compile_lpm(base), jlpm.compile_lpm(base)
    before = [getattr(t, k).copy() for k in ("l1", "l2", "l3")]
    undo, jundo = tlpm.LPMUndo(t, cidr), jlpm.LPMUndo(j, cidr)
    assert [(f, i) for f, i, _ in undo.cells] == [
        (f, i) for f, i, _ in jundo.cells]
    tlpm.lpm_upsert(t, cidr, 42)
    undo.restore(t)
    for a, k in zip(before, ("l1", "l2", "l3")):
        np.testing.assert_array_equal(getattr(t, k), a)


def test_lpm_entries_longest_cover_matches_a_scan():
    """The indexed entry mirror answers the covering-prefix query
    exactly as the reference's ``delete_ipcache`` scan of every entry
    does (``cilium_tpu/datapath/loader.py`` delete_ipcache): the longest
    IPv4 prefix wins, the first in dict order among equal prefixes
    spelled differently, IPv6 entries never."""
    import ipaddress

    def scan(entries, addr):
        best_len, best_num = -1, None
        for c, num in entries.items():
            n2 = ipaddress.ip_network(c, strict=False)
            if n2.version != 4 or n2.prefixlen <= best_len:
                continue
            shift = 32 - n2.prefixlen
            if n2.prefixlen == 0 or (addr >> shift) == (
                    int(n2.network_address) >> shift):
                best_len, best_num = n2.prefixlen, num
        return best_num

    rng = np.random.default_rng(12)
    ref = {"10.0.0.0/8": 1, "10.1.2.3/8": 2, "10.1.0.0/16": 3,
           "10.1.2.0/24": 4, "10.1.2.3/32": 5, "10.1.2.3": 6,
           "2001:db8::/32": 7, "192.168.4.0/22": 8}
    for i in range(40):
        plen = int(rng.integers(12, 33))
        ref[f"10.{rng.integers(0, 4)}.{rng.integers(0, 256)}."
            f"{rng.integers(0, 256)}/{plen}"] = 100 + i
    entries = tlpm.LPMEntries(ref)
    for cidr in ("10.1.2.3/32", "10.1.0.0/16", "no-such"):
        assert entries.pop(cidr, None) == ref.pop(cidr, None)
    entries["10.1.0.0/16"] = ref["10.1.0.0/16"] = 9  # re-added: last
    entries["10.0.0.0/8"] = ref["10.0.0.0/8"] = 11  # rebound in place
    assert entries == ref and dict(entries) == ref
    # no mutator but __setitem__ and pop can bypass the index
    for mutate in (lambda: entries.update({"10.9.0.0/16": 1}),
                   lambda: entries.setdefault("10.9.0.0/16", 1),
                   lambda: entries.__delitem__("10.1.2.0/24")):
        with pytest.raises((AttributeError, TypeError)):
            mutate()
    assert entries == ref
    probes = [int(x) for x in convert.lpm_probe_ips(ref)] + [
        int(x) for x in rng.integers(0, 1 << 32, 200, dtype=np.uint64)]
    for addr in probes:
        assert entries.longest_v4_cover(addr) == scan(ref, addr), hex(addr)
    entries["0.0.0.0/0"] = ref["0.0.0.0/0"] = 12
    assert entries.longest_v4_cover(0x08080808) == scan(ref, 0x08080808) \
        == 12


# -- the patch paths against the JAX loader ----------------------------
def _inc_pair():
    """tests/test_incremental.py's daemon on both sides: one db
    endpoint under INC_RULES, started."""
    out = []
    for d in (_jdaemon(), Daemon(DaemonConfig(ct_capacity=CT,
                                              policy_delta_compile=False),
                                 device="cpu")):
        db = d.add_endpoint("db-1", ("10.0.2.1",), ["k8s:app=db"])
        d.policy_import(INC_RULES)
        d.start()
        out.append((d, db.id))
    assert out[0][1] == out[1][1]
    return out[0][0], out[1][0], out[0][1]


def _mint(d, ls, labels, cidr):
    ident = d.allocator.allocate(ls.parse(*labels))
    d.upsert_ipcache(cidr, ident.numeric_id)
    return ident


def test_identity_churn_patches_in_place_like_jax():
    """20 web identities with their /32s, a banned one, a release and a
    delete: no re-attach on either side, tables and step outputs
    bit-exact with the JAX loader, the patched rows verdict (allow,
    wrong port, explicit deny, CIDR allow)."""
    jd, td, db = _inc_pair()
    attaches = (jd.loader.attach_count, td.loader.attach_count)
    for d, ls in ((jd, JLabelSet), (td, LabelSet)):
        web = [_mint(d, ls, (f"k8s:app=w{i}", "k8s:role=web"),
                     f"10.1.0.{i + 1}/32") for i in range(20)]
        _mint(d, ls, ("k8s:app=evil", "k8s:role=banned"), "10.9.0.1/32")
        d.delete_ipcache("10.1.0.3/32")
        d.allocator.release(web[2])
    assert (jd.loader.attach_count, td.loader.attach_count) == attaches
    assert td.loader.table_stats()["patches"] >= 2 * 21 + 2
    _assert_tables_match_jax(jd.loader, td.loader)
    got = _step_both(jd, td, [("10.1.0.1", 5432), ("10.1.0.1", 9999),
                              ("10.9.0.1", 5432), ("192.168.7.7", 8080),
                              ("10.1.0.3", 5432)], db, 40000)
    assert got == [1, 0, 2, 1, 0]
    for d in (jd, td):
        d.shutdown()


def test_patched_rows_equal_a_full_recompile():
    """After patched adds and a removal, the port's device verdict
    tensor equals a from-scratch ``compile_policy`` of the same
    resolved policies and row map."""
    jd, td, _db = _inc_pair()
    for i in range(8):
        ident = _mint(td, LabelSet, (f"k8s:app=w{i}", "k8s:role=web"),
                      f"10.1.0.{i + 1}/32")
    td.delete_ipcache("10.1.0.8/32")
    td.allocator.release(ident)
    fresh = compile_policy(list(td.loader._policies), td.loader.row_map)
    np.testing.assert_array_equal(_np(td.loader.state.policy.verdict),
                                  fresh.verdict)
    np.testing.assert_array_equal(td.loader.tensors.verdict, fresh.verdict)
    for d in (jd, td):
        d.shutdown()


def test_removal_resets_the_row_like_jax():
    jd, td, db = _inc_pair()
    idents = [_mint(d, ls, ("k8s:app=w0", "k8s:role=web"), "10.1.0.1/32")
              for d, ls in ((jd, JLabelSet), (td, LabelSet))]
    assert _step_both(jd, td, [("10.1.0.1", 5432)], db, 40000) == [1]
    attaches = td.loader.attach_count
    for d, ident in zip((jd, td), idents):
        d.allocator.release(ident)
    assert td.loader.attach_count == attaches  # patched, not rebuilt
    # a fresh flow from the released identity's /32 no longer allows
    assert _step_both(jd, td, [("10.1.0.1", 5432)], db, 41000,
                      now=20) == [0]
    _assert_tables_match_jax(jd.loader, td.loader)
    for d in (jd, td):
        d.shutdown()


def test_identity_churn_never_compiles_the_policy(monkeypatch):
    """The point of the patch path: an identity add or remove composes
    one row and never reaches ``compile_policy`` (the reference bounds
    this by time; here the calls are counted)."""
    _jd, td, _db = _inc_pair()
    _jd.shutdown()
    calls = []
    real = loader_mod.compile_policy
    monkeypatch.setattr(loader_mod, "compile_policy",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for i in range(5):
        ident = _mint(td, LabelSet, (f"k8s:app=m{i}", "k8s:role=web"),
                      f"10.2.0.{i + 1}/32")
    td.delete_ipcache("10.2.0.5/32")
    td.allocator.release(ident)
    assert calls == []
    td.endpoints._regenerate_all()  # the control: a regeneration does
    assert calls == [1]
    td.shutdown()


# -- generations (tests/test_churn_gate.py TestLoaderGenerations) ------
def _apply_both(jd, td, op_args, lives):
    jsc, tsc = (JScenario(seed=3, n_slots=4), IdentityChurnScenario(
        seed=3, n_slots=4))
    for (d, sc, op_cls), live in zip(((jd, jsc, JChurnOp),
                                      (td, tsc, ChurnOp)), lives):
        sc.apply(d, op_cls(*op_args), live)


def test_patches_bump_generation_without_attach_like_jax():
    jd, td, db = _pair()
    sc = IdentityChurnScenario(seed=3, n_slots=4)
    g0, a0 = td.loader.tables.generation, td.loader.attach_count
    lives = ({}, {})
    _apply_both(jd, td, ("mint", 0, sc.slot_cidr(0), 0.0), lives)
    assert _step_both(jd, td, [(sc.slot_ip(0), 5432)], db, 30000) == [1]
    _apply_both(jd, td, ("withdraw", 0, sc.slot_cidr(0), 0.0), lives)
    s = td.loader.table_stats()
    assert td.loader.attach_count == a0  # pure patches
    assert s["generation"] == g0 + 4  # 2 publishes per op
    assert s["patches"] == 4 and s["failed-builds"] == 0
    _assert_tables_match_jax(jd.loader, td.loader)
    assert _step_both(jd, td, [(sc.slot_ip(0), 5432)], db, 30100) == [0]
    for d in (jd, td):
        d.shutdown()


def test_noop_mutations_bump_no_generation_like_jax():
    """An unknown-entry delete or an unmapped-identity remove publishes
    nothing, on both packages."""
    jd, td, _db = _pair()
    for d in (jd, td):
        g0 = d.loader.table_stats()["generation"]
        assert d.loader.delete_ipcache("10.200.0.1/32") is True
        assert d.loader.patch_identity(
            "remove", 999999, list(d.endpoints._attached_policies)) is True
        assert d.loader.table_stats()["generation"] == g0
        d.shutdown()


def test_row_map_concurrent_mutation_hands_out_unique_rows():
    """IdentityRowMap.add runs on regeneration threads AND churn patch
    builders at once (outside the dispatch lock): the compound
    free-list / next update never hands one row to two identities."""
    import sys

    rm = IdentityRowMap(capacity=64)  # force growth under the race
    n = 2000
    rows = [None] * (2 * n)

    def worker(base, offset):
        for i in range(n):
            rows[offset + i] = rm.add(base + i)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=worker, args=(1000 + k * n, k * n))
              for k in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert len(set(rows)) == 2 * n, "duplicate row handed out"
    for i in range(2 * n):
        assert rm.numeric(rm.row(1000 + i)) == 1000 + i


# -- mid-swap faults (tests/test_churn_gate.py TestMidSwapFaults) ------
def _mirrors(tl):
    return (tl.tensors.verdict.copy(), dict(tl._lpm_entries),
            [getattr(tl._lpm_tensors, k).copy()
             for k in ("l1", "l2", "l3")])


def _assert_mirrors_equal(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1]
    for x, y in zip(a[2], b[2]):
        np.testing.assert_array_equal(x, y)


def _device_tables(tl):
    p, l = tl.state.policy, tl.state.ipcache
    return [_np(t).copy() for t in (p.verdict, p.auth, l.l1, l.l2, l.l3)]


@pytest.mark.parametrize("site", ["churn.build", "churn.swap"])
def test_failed_patch_leaves_published_tables_and_mirrors_untouched(site):
    """A mint that dies at the build or at the swap instant publishes
    nothing: the device tables, the host mirrors, the generation and
    the row map are exactly as before, on the port as in the
    reference; the same patch succeeds once the fault is gone and the
    tables again equal the JAX loader's."""
    jd, td, db = _pair()
    sc = IdentityChurnScenario(seed=9, n_slots=4)
    lives = ({}, {})
    _apply_both(jd, td, ("mint", 0, sc.slot_cidr(0), 0.0), lives)
    before = _step_both(jd, td, [("10.0.1.1", 5432), (sc.slot_ip(0), 5432),
                                 (sc.slot_ip(1), 5432)], db, 22000)
    assert before == [1, 1, 0]
    s0, dev0, mir0 = (td.loader.table_stats(), _device_tables(td.loader),
                      _mirrors(td.loader))
    inj = faults.arm(f"{site}=1x1", seed=1)
    try:
        with pytest.raises(faults.InjectedFault):
            td.loader.patch_ipcache(sc.slot_cidr(1), 77)
    finally:
        faults.disarm(inj)
    s1 = td.loader.table_stats()
    assert s1["generation"] == s0["generation"]
    assert s1["failed-builds"] == s0["failed-builds"] + 1
    assert td.loader.row_map.row(77) == 0  # the fresh row was recycled
    for a, b in zip(_device_tables(td.loader), dev0):
        np.testing.assert_array_equal(a, b)
    _assert_mirrors_equal(_mirrors(td.loader), mir0)
    # the JAX loader takes the same patch; the port's retry equals it
    for d in (jd, td):
        assert d.loader.patch_ipcache(sc.slot_cidr(1), 77)
    assert td.loader.table_stats()["generation"] == s0["generation"] + 1
    _assert_tables_match_jax(jd.loader, td.loader)
    for d in (jd, td):
        d.shutdown()


def test_partial_dus_chain_heals_from_mirrors():
    """A publish that dies between two ``dus`` launches (the verdict
    row written, the auth column not) has already changed the live
    tables: the builder wrapper re-uploads the published content from
    the mirrors, so the next step serves the pre-patch world."""
    jd, td, db = _pair()
    sc = IdentityChurnScenario(seed=9, n_slots=4)
    lives = ({}, {})
    _apply_both(jd, td, ("mint", 0, sc.slot_cidr(0), 0.0), lives)
    specs = [("10.0.1.1", 5432), (sc.slot_ip(0), 5432),
             (sc.slot_ip(1), 5432)]
    before = _step_both(jd, td, specs, db, 25000)
    g0, dev0 = td.loader.tables.generation, _device_tables(td.loader)
    real = loader_mod._dus
    calls = {"n": 0}

    def dying(dst, upd, starts):
        calls["n"] += 1
        if calls["n"] == 2:  # after the verdict row landed
            raise RuntimeError("chain died mid-patch")
        return real(dst, upd, starts)

    loader_mod._dus = dying
    try:
        with pytest.raises(RuntimeError, match="mid-patch"):
            sc.apply(td, ChurnOp("mint", 1, sc.slot_cidr(1), 0.0), lives[1])
    finally:
        loader_mod._dus = real
    assert td.loader.tables.generation == g0
    assert not td.loader._swap_incomplete
    for a, b in zip(_device_tables(td.loader), dev0):
        np.testing.assert_array_equal(a, b)
    rows = _syn_rows(specs, db, 25100)
    assert np.asarray(td.loader.step(rows, now=10)[0])[:3, 0].tolist() \
        == before
    # churn keeps working afterwards (re-mint, then a regeneration
    # repaints the peer sets the failed op already updated)
    lives[1].pop(1, None)
    sc.apply(td, ChurnOp("mint", 1, sc.slot_cidr(1), 0.0), lives[1])
    td.endpoints.regenerate()
    rows = _syn_rows(specs, db, 25200)
    assert np.asarray(td.loader.step(rows, now=10)[0])[:3, 0].tolist() \
        == [1, 1, 1]
    for d in (jd, td):
        d.shutdown()


def test_slow_build_does_not_stall_dispatches():
    """A hang in the BUILDER (``churn.build~``) holds only the build
    lock: steps keep completing while the patch is stuck."""
    td = Daemon(DaemonConfig(ct_capacity=CT), device="cpu")
    db = _world(td, RULES)
    sc = IdentityChurnScenario(seed=9, n_slots=4)
    rows = _syn_rows([], db, 24000)
    td.loader.step(rows, now=60)
    inj = faults.arm("churn.build=1x1~0.4", seed=1)
    err = []

    def patch():
        try:
            td.loader.patch_ipcache(sc.slot_cidr(0), 5)
        except Exception as e:  # noqa: BLE001 -- reported below
            err.append(e)

    t = threading.Thread(target=patch)
    try:
        t.start()
        deadline = time.monotonic() + 0.25
        done = 0
        while time.monotonic() < deadline:
            td.loader.step(rows, now=61)
            done += 1
        assert t.is_alive(), "the hang should outlive the dispatch window"
        assert done >= 3, f"steps stalled behind a builder hang ({done})"
    finally:
        t.join(timeout=5)
        faults.disarm(inj)
    assert not t.is_alive() and not err
    assert td.loader.table_stats()["patches"] == 1
    td.shutdown()


# -- the serving daemon under churn -----------------------------------
def _events(batches):
    cols = ("msg_type", "verdict", "reason", "ct_state", "identity",
            "proxy_port", "hdr")
    return {c: np.concatenate([getattr(b, c) for b in batches])
            for c in cols}


def test_churn_through_serve_batch_events_match_jax():
    """The scenario's ops interleaved with ``serve_batch`` on both
    daemons at a fixed clock: the monitor events bit-exact, the tables
    equal after every op, and no attach on either side."""
    jd, td, db = _pair()
    sc = IdentityChurnScenario(seed=5, n_slots=6)
    ops = sc.ops(12)
    got = {id(d): [] for d in (jd, td)}
    for d in (jd, td):
        d.monitor.register("churn", got[id(d)].append)
        d.start_serving(ring_capacity=1 << 12, drain_every=1,
                        trace_sample=1)
    attaches = (jd.loader.attach_count, td.loader.attach_count)
    lives = ({}, {})
    specs = [(sc.slot_ip(s), 5432) for s in range(sc.n_slots)] + [
        ("10.0.1.1", 5432), ("10.0.1.1", 9999)]
    for k, op in enumerate(ops):
        _apply_both(jd, td, (op.kind, op.slot, op.cidr, 0.0), lives)
        _assert_tables_match_jax(jd.loader, td.loader)
        rows = _syn_rows(specs, db, 30000 + 16 * k)
        for d in (jd, td):
            d.serve_batch(rows, now=50 + k)
    for d in (jd, td):
        d.stop_serving()
    assert (jd.loader.attach_count, td.loader.attach_count) == attaches
    want, have = _events(got[id(jd)]), _events(got[id(td)])
    assert len(have["verdict"]) == len(ops) * STEP_ROWS
    for c in want:
        np.testing.assert_array_equal(have[c], want[c], err_msg=c)
    assert set(have["verdict"].tolist()) >= {0, 1}
    for d in (jd, td):
        d.shutdown()


def _oracle_keys(batches, n_slots, seed, mint_all):
    """{sport: (msg, verdict, reason)} from ONE JAX interpreter world:
    no slot live, or every slot live."""
    d = _jdaemon(backend="interpreter")
    _world(d, RULES)
    try:
        if mint_all:
            sc, live = JScenario(seed=seed, n_slots=n_slots), {}
            for s in range(n_slots):
                sc.apply(d, JChurnOp("mint", s, sc.slot_cidr(s), 0.0), live)
        out = {}
        for k, wide in enumerate(batches):
            o, row_map = d.loader.step(wide, now=100 + k)
            eb = decode_out(o, wide, row_map.numeric_array(), 0.0)
            for i in range(len(eb)):
                out[int(eb.hdr[i, COL_SPORT])] = (
                    int(eb.msg_type[i]), int(eb.verdict[i]),
                    int(eb.reason[i]))
        return out
    finally:
        d.shutdown()


@pytest.mark.parametrize("tier", ["wide", "packed", "superbatch"])
def test_patch_interleavings_under_serving_match_an_oracle(tier):
    """tests/test_churn_gate.py TestPatchInterleavingProperty on the
    port's daemon: identity churn ops, ipcache remaps between live
    worlds and full re-attaches, interleaved at random with batches
    streaming through ``submit``.  The ledger stays exact and every
    verdicted row matches the pre- or the post-churn oracle (stable
    flows both: any divergence is a torn table).  The superbatch tier
    submits four buckets at a time, so the drain loop dispatches K = 4
    steps under one lock window (tests/test_churn_gate.py
    test_superbatch_k8_generation_pinning)."""
    seed = {"wide": 21, "packed": 22, "superbatch": 23}[tier]
    burst = 4 if tier == "superbatch" else 1
    td = Daemon(DaemonConfig(ct_capacity=CT, serving_queue_depth=4096,
                             serving_bucket_ladder=(64,),
                             serving_max_wait_us=500.0), device="cpu")
    db = _world(td, RULES)
    sc = IdentityChurnScenario(seed=seed, n_slots=5, rate_hz=800.0)
    rng = np.random.default_rng(seed)
    sports = iter(range(30000, 60000))
    batches, kinds = [], {}
    for _ in range(24):
        specs = []
        for i in range(64):
            k = i % 4
            if k == 0:
                specs.append(("10.0.1.1", 5432, "stable-allow"))
            elif k == 1:
                specs.append(("10.0.1.1", 9999, "stable-deny"))
            else:
                slot = i % sc.n_slots
                specs.append((sc.slot_ip(slot), 5432, slot))
        sp = [next(sports) for _ in specs]
        batches.append(make_batch([
            dict(src=s, dst="10.0.2.1", sport=p, dport=dp, proto=6,
                 flags=TCP_SYN, ep=db, dir=0)
            for (s, dp, _), p in zip(specs, sp)]).data)
        kinds.update({p: kind for (_, _, kind), p in zip(specs, sp)})
    got = []
    td.monitor.register("interleave", got.append)
    td.start_serving(ring_capacity=1 << 12, drain_every=2, trace_sample=1,
                     packed=(tier != "wide"), ingress=True,
                     superbatch_k=burst)
    live, ops = {}, iter(sc.iter_ops())
    a0 = td.loader.attach_count
    for i in range(0, len(batches), burst):
        td.submit(np.concatenate(batches[i:i + burst]))
        r = int(rng.integers(0, 3))
        if r == 0:
            sc.apply(td, next(ops), live)
        elif r == 1 and live:
            slot, ident = next(iter(live.items()))
            td.upsert_ipcache(sc.slot_cidr(slot), ident.numeric_id,
                              source="generated")
        else:
            td.policy_import(RULES)
        time.sleep(0.002)
    # every row verdicted by the drain loop before the stop (a stop
    # drains what is left one batch at a time on this thread)
    deadline = time.monotonic() + 60
    while (td.serving_stats()["verdicts"] < 64 * len(batches)
           and time.monotonic() < deadline):
        time.sleep(0.005)
    fe = td.stop_serving()["front-end"]
    ft = fe["fault-tolerance"]
    assert fe["submitted"] == fe["verdicts"] + fe["shed"] + \
        ft["recovery-dropped"] == 64 * len(batches)
    if tier == "superbatch":
        assert fe["dispatch"]["superbatches"] > 0
    stats = td.loader.table_stats()
    assert stats["patches"] > 0 and td.loader.attach_count > a0
    pre = _oracle_keys(batches, sc.n_slots, seed, mint_all=False)
    post = _oracle_keys(batches, sc.n_slots, seed, mint_all=True)
    checked = 0
    for b in got:
        for i in range(len(b)):
            if int(b.reason[i]) in HOST_REASONS:
                continue
            sport = int(b.hdr[i, COL_SPORT])
            key = (int(b.msg_type[i]), int(b.verdict[i]), int(b.reason[i]))
            if isinstance(kinds[sport], str):
                assert pre[sport] == post[sport]
            assert key in {pre[sport], post[sport]}, (
                f"torn verdict for sport {sport} ({kinds[sport]}): {key}")
            checked += 1
    assert checked > 0
    td.shutdown()
