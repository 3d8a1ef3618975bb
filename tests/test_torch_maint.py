"""CT maintenance of the port against the JAX package: the aging sweep
(``ct_gc`` against ``ct_gc_jit``, with expiries on both sides of 2^31
and of ``now``), and ``TorchLoader.gc`` / ``map_pressure`` against
``TPULoader``'s after the same traffic.  Integer and bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.core.packets import pack_rows
from cilium_tpu.datapath import conntrack as jct
from cilium_tpu.datapath.loader import TPULoader
from cilium_tpu.monitor import ring as jring
from cilium_tpu.testing import fixtures as jfix
from cilium_tpu_torch import u32
from cilium_tpu_torch.datapath import conntrack as tct
from cilium_tpu_torch.datapath.loader import (TorchLoader, _ct_occupied,
                                              _ct_occupied_plain)
from cilium_tpu_torch.monitor import ring as tring
from cilium_tpu_torch.testing import fixtures as tfix

torch.set_num_threads(1)

CAP = 1 << 12
EDGES = np.array([0, 1, 5, (1 << 31) - 2, (1 << 31) - 1, 1 << 31,
                  (1 << 31) + 1, (1 << 32) - 2, (1 << 32) - 1], np.uint32)


def _table(rng, now):
    """A placed CT table whose expiries sit on the u32 edges and just
    around ``now``; a few slots keep an expiry but state ST_FREE."""
    n = CAP // 2
    rows = np.zeros((n, tct.ROW_WORDS), np.uint32)
    rows[:, :tct.KEY_WORDS] = rng.integers(0, 1 << 32,
                                           (n, tct.KEY_WORDS),
                                           dtype=np.uint64)
    rows[:, tct.V_STATE] = rng.integers(1, 4, n)
    near = (np.uint64(now) + np.array([-1, 0, 1], np.int64)
            ) % (1 << 32)
    rows[:, tct.V_EXPIRES] = rng.choice(
        np.concatenate([EDGES, near.astype(np.uint32)]), n)
    table, _dropped = tct.ct_table_from_rows(rows, CAP)
    free = rng.random(CAP) < 0.05
    table[free, tct.V_STATE] = tct.ST_FREE
    table[free, tct.V_EXPIRES] = 3
    return table


@pytest.mark.parametrize("now", [100, (1 << 31) - 1, 1 << 31,
                                 (1 << 32) - 1])
def test_ct_gc_matches_jax(now):
    rng = np.random.default_rng(now & 0xFFFF)
    table = _table(rng, now)
    fp = tct.ct_fp_from_table(table)
    np.testing.assert_array_equal(fp, jct.ct_fp_from_table(table))
    jt = jct.CTTable(table=jnp.asarray(table), fp=jnp.asarray(fp),
                     dropped=jnp.uint32(7))
    jt, jn = jct.ct_gc_jit(jt, jnp.uint32(now))
    tt = tct.CTTable(table=u32.from_numpy(table, "cpu"),
                     fp=u32.from_numpy(fp, "cpu"),
                     dropped=torch.tensor(7, dtype=torch.int32))
    n = tct.ct_gc(tt, now)
    assert int(n) == int(jn) > 0
    np.testing.assert_array_equal(u32.to_numpy(tt.table),
                                  np.asarray(jt.table))
    np.testing.assert_array_equal(u32.to_numpy(tt.fp), np.asarray(jt.fp))
    assert int(tt.dropped) == 7
    # a second sweep finds nothing left to expire
    assert int(tct.ct_gc(tt, now)) == 0


def test_ct_occupied_counts_nonzero_fingerprints():
    fp = u32.from_numpy(np.array([0, 1, 0xFFFFFFFF, 0, 0x80000000, 7],
                                 np.uint32), "cpu")
    assert int(_ct_occupied(fp)) == int(_ct_occupied_plain(fp)) == 4


def _loaders():
    w = tfix.build_world(256, 8, ct_capacity=CAP, n_v6=16, device="cpu")
    jw = jfix.build_world(256, 8, ct_capacity=CAP, n_v6=16)
    tl = TorchLoader(ct_capacity=CAP, device="cpu")
    jl = TPULoader(ct_capacity=CAP)
    eps = {0: 0, 1: 0}
    tl.attach(w.policies, w.ipcache, eps, w.row_map)
    jl.attach(jw.policies, jw.ipcache, eps, jw.row_map)
    return w, tl, jl


def test_loader_gc_and_map_pressure_match_tpu_loader():
    """Serve the same packed batches through both loaders, then sample
    map pressure, sweep at a clock past the SYN lifetime, and sample
    again: every count equal."""
    w, tl, jl = _loaders()
    tr_ = tring.EventRing.create(CAP, "cpu")
    jr_ = jring.EventRing.create(CAP)
    rng = np.random.default_rng(11)
    pool = tfix.steady_flow_pool(w, 256, rng)
    now = 100
    for b in range(3):
        hdr = pool if b == 0 else tfix.steady_traffic(pool, 512, rng)
        hdr = np.concatenate([hdr, tfix.bench_traffic(w, 512 - len(hdr),
                                                      rng)])
        packed = pack_rows(hdr)
        valid = rng.random(len(packed)) < 0.95
        tr_, _ = tl.serve_packed(tr_, packed, now, b, 0, 0, valid=valid)
        jr_, _ = jl.serve_packed(jr_, packed, now, b, 0, 0, valid=valid)
        now += 20
    before = tl.map_pressure(now)
    assert before == jl.map_pressure(now)
    assert before["ct"]["occupied"] > 0
    assert before["lpm"]["entries"] == len(w.ipcache)
    assert before["nat"] == {"capacity": None, "failures": 0}
    # nothing has expired yet; then past every SYN and non-TCP lifetime
    assert tl.gc(now) == jl.gc(now) == 0
    later = now + tct.LIFETIME_SYN + 1
    n = tl.gc(later)
    assert n == jl.gc(later) and n > 0
    np.testing.assert_array_equal(tl.ct_snapshot(), jl.ct_snapshot())
    after = tl.map_pressure(later)
    assert after == jl.map_pressure(later)
    assert after["ct"]["occupied"] == before["ct"]["occupied"] - n


# -- the fingerprint invariant ------------------------------------------
# K7's sweep on the card reads only the slots whose fingerprint is not 0,
# so every CT writer must leave a slot's fingerprint 0 exactly when its
# state is ST_FREE.

def _fp_marks_live(table, fp):
    table, fp = np.asarray(table), np.asarray(fp)
    np.testing.assert_array_equal(fp != 0,
                                  table[:, tct.V_STATE] != tct.ST_FREE)


def _tcp_rows(rng, n, flags, dport=443):
    """``n`` egress TCP flows (IPv4, one flag set each), 10.x to one
    server, and their replies as a second array."""
    from cilium_tpu_torch.core import packets as pk

    rows = np.zeros((n, pk.N_COLS), np.uint32)
    rows[:, pk.COL_SRC_IP3] = 0x0A000000 + rng.choice(1 << 20, n,
                                                      replace=False)
    rows[:, pk.COL_DST_IP3] = 0x0AC80001
    rows[:, pk.COL_SPORT] = rng.integers(1024, 60000, n)
    rows[:, pk.COL_DPORT] = dport
    rows[:, pk.COL_PROTO] = 6
    rows[:, pk.COL_FLAGS] = flags
    rows[:, pk.COL_LEN] = rng.integers(60, 1500, n)
    rows[:, pk.COL_FAMILY] = 4
    rows[:, pk.COL_DIR] = 1
    rep = rows.copy()
    rep[:, pk.COL_SRC_IP3] = rows[:, pk.COL_DST_IP3]
    rep[:, pk.COL_DST_IP3] = rows[:, pk.COL_SRC_IP3]
    rep[:, pk.COL_SPORT] = rows[:, pk.COL_DPORT]
    rep[:, pk.COL_DPORT] = rows[:, pk.COL_SPORT]
    rep[:, pk.COL_DIR] = 0
    rep[:, pk.COL_FLAGS] = pk.TCP_ACK
    return rows, rep


def _port_round(c, hdr, now):
    """One lookup + update of the port's CT (the plain versions) over
    ``hdr``, every row allowed."""
    th = u32.from_numpy(hdr, "cpu")
    f, r = tct.ct_keys_from_headers(th)
    res, slot, rep = tct.ct_lookup(c, f, r, now)
    n = len(hdr)
    tct.ct_update(c, tct.ct_l4_from_headers(th), f, res, slot, rep,
                  torch.ones(n, dtype=torch.bool),
                  torch.zeros(n, dtype=torch.int32), now)
    return c


def _rounds(cap, check):
    """The port's CT through a SYN batch (TCP and forged-protocol
    flows), the replies, a close (FIN and RST), and a batch more than
    the table holds (a full window: dropped inserts); ``check(table, fp)``
    after each.  -> the CT."""
    from cilium_tpu_torch.core import packets as pk

    rng = np.random.default_rng(cap)
    c = tct.CTTable.create(cap, "cpu")
    syn, rep = _tcp_rows(rng, cap // 4, pk.TCP_SYN)
    syn[::7, pk.COL_PROTO] = 17
    syn[::11, pk.COL_PROTO] = 6 | 0x100
    for hdr, now in ((syn, 100), (rep, 101)):
        _port_round(c, hdr, now)
        check(u32.to_numpy(c.table), u32.to_numpy(c.fp))
    close = syn[: cap // 8].copy()
    close[::2, pk.COL_FLAGS] = pk.TCP_FIN | pk.TCP_ACK
    close[1::2, pk.COL_FLAGS] = pk.TCP_RST
    _port_round(c, close, 102)
    check(u32.to_numpy(c.table), u32.to_numpy(c.fp))
    full, _rep = _tcp_rows(rng, cap, pk.TCP_SYN, dport=80)
    _port_round(c, full, 103)
    assert int(c.dropped) > 0  # windows ran full
    check(u32.to_numpy(c.table), u32.to_numpy(c.fp))
    return c


@pytest.mark.parametrize("writer", ["ct_update", "ct_gc",
                                    "ct_restore_dense", "ct_restore_hashed",
                                    "jax_ct_update_converted"])
def test_fingerprint_is_zero_exactly_on_free_slots(writer):
    """After every CT writer a slot's fingerprint is 0 exactly when its
    state is ST_FREE: ct_update's rounds (SYN, reply, close, a full
    window), the aging sweep, a restore of a dense and of a hashed
    snapshot (into a smaller table: some rows find no slot), and a JAX
    table after ``ct_update_jit`` carried across by ``convert``."""
    from cilium_tpu_torch import convert

    if writer == "ct_update":
        _rounds(1 << 8, _fp_marks_live)
        return
    c = _rounds(1 << 8, lambda t, f: None)
    if writer == "ct_gc":
        for now in (100 + tct.LIFETIME_SYN + 1, 1 << 31, (1 << 32) - 1):
            tct.ct_gc(c, now)
            _fp_marks_live(u32.to_numpy(c.table), u32.to_numpy(c.fp))
        assert not u32.to_numpy(c.fp).any()
        return
    if writer.startswith("ct_restore"):
        snap = u32.to_numpy(c.table)
        if writer == "ct_restore_dense":
            snap = tct.ct_rows_from_table(snap)
        w = tfix.build_world(16, 2, ct_capacity=1 << 6, device="cpu")
        tl = TorchLoader(ct_capacity=1 << 6, device="cpu")
        tl.attach(w.policies, w.ipcache, {0: 0}, w.row_map)
        tl.ct_restore(snap)
        assert int(tl.state.ct.dropped) > 0
        _fp_marks_live(u32.to_numpy(tl.state.ct.table),
                       u32.to_numpy(tl.state.ct.fp))
        return
    # the JAX package's update over the same rounds' rows, carried across
    jw = jfix.build_world(16, 2, ct_capacity=CAP)
    rng = np.random.default_rng(3)
    from cilium_tpu_torch.core import packets as pk

    syn, rep = _tcp_rows(rng, 96, pk.TCP_SYN)
    syn[::5, pk.COL_FLAGS] = pk.TCP_FIN
    js = jw.state
    jc = js.ct
    for hdr, now in ((syn, 100), (rep, 101), (syn[::-1], 102)):
        jh = jnp.asarray(hdr)
        jf, jr = jct.ct_keys_jit(jh)
        res, slot, isrep = jct.ct_lookup_jit(jc, jf, jr, jnp.uint32(now))
        jc = jct.ct_update_jit(jc, jh, jf, res, slot, isrep,
                               do_create=jnp.ones(len(hdr), bool),
                               proxy_port=jnp.zeros(len(hdr), jnp.uint32),
                               now=jnp.uint32(now),
                               valid=jnp.ones(len(hdr), bool))
    arrays = {g: {f: (v if f == "default" else np.array(v))
                  for f, v in vars(getattr(js, g)).items()}
              for g in ("policy", "ipcache")}
    arrays["ct"] = {"table": np.array(jc.table), "fp": np.array(jc.fp),
                    "dropped": np.array(jc.dropped)}
    arrays["metrics"] = np.array(js.metrics)
    ts = convert.datapath_state_from_numpy(arrays, "cpu")
    assert int((u32.to_numpy(ts.ct.fp) != 0).sum()) > 0
    _fp_marks_live(u32.to_numpy(ts.ct.table), u32.to_numpy(ts.ct.fp))
