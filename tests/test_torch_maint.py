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
