"""The port's sharded serving pieces (``cilium_tpu_torch/parallel``)
against the JAX package's ``cilium_tpu.parallel`` on the CPU mesh.

- The host routing copies (``flow_shard_ids``, ``ct_rows_slot_ids``,
  ``route_by_flow`` with ``out=`` buffers and overflow) equal the
  reference's bit for bit on seeded numpy batches, a skewed one that
  overflows one shard among them.
- ``make_sharded_step`` and ``make_sharded_serve_step`` (wide and
  packed, padding, proxy ports) through the port's plain path over 3
  batches with replies equal the JAX steps on a 4-device mesh: the
  global CT table, fingerprints, drop count, metrics, out rows, ring
  buffer and cursors are bit-exact, and the CT row sets agree.  Mirrors
  ``tests/test_parallel.py:117-158``.

The JAX steps are module-scoped: each sharded compile costs seconds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.core.packets import pack_eligibility, pack_rows
from cilium_tpu.datapath.conntrack import ct_rows_from_table
from cilium_tpu.monitor import ring as jring
from cilium_tpu.parallel import mesh as jm
from cilium_tpu.testing import fixtures as jfix
from cilium_tpu_torch import u32
from cilium_tpu_torch.datapath.verdict import REASON_ROUTE_OVERFLOW
from cilium_tpu_torch.monitor import ring as tring
from cilium_tpu_torch.parallel import mesh as tm
from cilium_tpu_torch.testing import fixtures as tfix

torch.set_num_threads(1)

S = 4
CAP = 1 << 12
RING = 1 << 10
B = 256  # rows a batch before routing
BLOCK = 128  # headroom 2
PROXY = np.array([10000], np.uint32)


@pytest.fixture(scope="module")
def jmesh():
    return jm.make_mesh(S)


@pytest.fixture(scope="module")
def jsteps(jmesh):
    """The reference's sharded steps, built once for the module."""
    return {
        "offline": jm.make_sharded_step(jmesh),
        True: jm.make_sharded_serve_step(jmesh, packed=True,
                                         trace_sample=64),
        False: jm.make_sharded_serve_step(jmesh, packed=False,
                                          trace_sample=64),
    }


def _worlds():
    kw = dict(n_identities=256, n_rules=8, ct_capacity=CAP, n_v6=16)
    return tfix.build_world(**kw, device="cpu"), jfix.build_world(**kw)


def _batches(w, rng, packed, n=3):
    """Three batches of B rows from one flow pool: SYNs, then steady
    draws with replies (wide pools carry IPv6 and ICMP errors)."""
    if packed:
        pool = tfix.steady_flow_pool(w, B, rng)
        rest = [tfix.steady_traffic(pool, B, rng) for _ in range(n - 1)]
    else:
        pool = tfix.wide_flow_pool(w, B, rng)
        rest = [tfix.wide_traffic(pool, B, rng) for _ in range(n - 1)]
    return [pool] + rest


def _eq(name, got, want):
    np.testing.assert_array_equal(u32.to_numpy(got),
                                  np.asarray(want).astype(np.uint32),
                                  err_msg=name)


def _assert_state(ts, js):
    _eq("ct.table", ts.ct.table, js.ct.table)
    _eq("ct.fp", ts.ct.fp, js.ct.fp)
    _eq("ct.dropped", ts.ct.dropped, js.ct.dropped)
    _eq("metrics", ts.metrics, js.metrics)
    got = ct_rows_from_table(u32.to_numpy(ts.ct.table))
    want = ct_rows_from_table(np.asarray(js.ct.table))
    assert sorted(map(bytes, got)) == sorted(map(bytes, want))


# -- host routing ------------------------------------------------------


@pytest.mark.parametrize("n_shards", [2, 4, 8, 16])
def test_flow_shard_ids_match_the_reference(n_shards):
    rng = np.random.default_rng(n_shards)
    w, _jw = _worlds()
    rows = np.concatenate([tfix.bench_traffic(w, 512, rng),
                           tfix.wide_traffic(tfix.wide_flow_pool(w, 64, rng),
                                             512, rng)])
    got = tm.flow_shard_ids(rows, n_shards)
    np.testing.assert_array_equal(got, jm.flow_shard_ids(rows, n_shards))
    assert np.bincount(got, minlength=n_shards).min() > 0


def test_ct_rows_slot_ids_match_the_reference():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 1 << 32, (2048, 17), dtype=np.uint64)
    rows = rows.astype(np.uint32)
    for n in (2, 8):
        np.testing.assert_array_equal(tm.ct_rows_slot_ids(rows, n),
                                      jm.ct_rows_slot_ids(rows, n))
    with pytest.raises(ValueError):
        tm.ct_rows_slot_ids(rows[:, :5], 2)


@pytest.mark.parametrize("skewed", [False, True], ids=["spread", "skewed"])
@pytest.mark.parametrize("with_out", [False, True], ids=["alloc", "out"])
def test_route_by_flow_matches_the_reference(skewed, with_out):
    """Routed rows, valid mask, original indices and the overflow count
    equal the reference's; the skewed batch (one elephant flow on a
    quarter of the rows) overflows its shard alone."""
    rng = np.random.default_rng(5)
    w, _jw = _worlds()
    rows = tfix.bench_traffic(w, B, rng)
    if skewed:
        rows[: B // 4] = rows[0]
    block = B // S  # headroom 1: the skew must overflow
    kw = {}
    if with_out:
        kw["out"] = (np.full((S * block, 16), 7, np.uint32),
                     np.ones(S * block, bool),
                     np.zeros(S * block, np.int64))
    got = tm.route_by_flow(rows, S, block, **kw)
    want = jm.route_by_flow(rows, S, block)
    for g, x in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, x)
    assert got[3] == want[3]
    ids = tm.flow_shard_ids(rows, S)
    over = np.bincount(ids, minlength=S) - block
    assert got[3] == int(np.maximum(over, 0).sum())
    if skewed:
        assert got[3] > 0 and (over > 0).sum() == 1
    if with_out:
        assert got[0] is kw["out"][0]


def test_route_overflow_counts_under_its_reason():
    w, _jw = _worlds()
    batch = np.repeat(tfix.bench_traffic(w, 1, np.random.default_rng(0)),
                      64, axis=0)
    routed, valid, orig, n_ovf = tm.route_by_flow(batch, 8, block=4)
    assert n_ovf == 60 and int(valid.sum()) == 4
    assert (orig[valid] >= 0).all()
    before = u32.to_numpy(w.state.metrics).astype(np.int64)
    tm.add_route_overflow(w.state, n_ovf)
    delta = u32.to_numpy(w.state.metrics).astype(np.int64) - before
    assert delta[REASON_ROUTE_OVERFLOW, 0] == 60 and delta.sum() == 60


def test_make_mesh_and_shard_state():
    mesh = tm.make_mesh(4, "cpu")
    assert mesh.n_shards == 4 and mesh.device == torch.device("cpu")
    for bad in (0, 3, 16):
        with pytest.raises(ValueError):
            tm.make_mesh(bad, "cpu")
    w, _jw = _worlds()
    assert tm.shard_state(w.state, mesh) is w.state
    w.state.ct.table = w.state.ct.table[: 3 * CAP // 4]
    with pytest.raises(ValueError, match="slices of 2"):
        tm.shard_state(w.state, mesh)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.make_mesh(4)
    ring = tm.make_sharded_ring(mesh, RING)
    assert tuple(ring.buf.shape) == (S * RING, 2)
    assert tuple(ring.cursor.shape) == (S, 2)
    assert bool((ring.buf == -1).all()) and not ring.cursor.any()


# -- the sharded steps against the reference's -------------------------


def test_sharded_step_matches_the_reference(jmesh, jsteps):
    """``make_sharded_step``: wide routed batches with replies; out rows
    in routed order, the global CT and the counters bit-exact."""
    w, jw = _worlds()
    js = jm.shard_state(jw.state, jmesh)
    step = tm.make_sharded_step(tm.make_mesh(S, "cpu"))
    rng = np.random.default_rng(11)
    now = 5000
    for hdr in _batches(w, rng, packed=False):
        routed, valid, orig, _ovf = jm.route_by_flow(hdr, S, BLOCK)
        jout, js = jsteps["offline"](js, jnp.asarray(routed),
                                     jnp.uint32(now), jnp.asarray(valid))
        tout, ts = step(w.state, u32.from_numpy(routed, "cpu"), now,
                        torch.from_numpy(valid))
        _eq("out", tout, jout)
        now += 3
    _assert_state(ts, js)
    total = int(u32.to_numpy(ts.metrics).sum())
    assert total == 3 * B  # every real packet counted once


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "wide"])
def test_sharded_serve_step_matches_the_reference(jmesh, jsteps, packed):
    """``make_sharded_serve_step`` with padding (headroom 2), a proxy
    port table and batch ids past the 13-bit wrap: CT, counters, ring
    buffer and per-shard cursors bit-exact after each batch, and the
    round-robin drain of both rings equal."""
    w, jw = _worlds()
    js = jm.shard_state(jw.state, jmesh)
    step = tm.make_sharded_serve_step(tm.make_mesh(S, "cpu"), packed=packed,
                                      trace_sample=64)
    jr = jm.make_sharded_ring(jmesh, RING)
    tr = tm.make_sharded_ring(tm.make_mesh(S, "cpu"), RING)
    rng = np.random.default_rng(21 + packed)
    pp = u32.from_numpy(PROXY, "cpu")
    for b, hdr in enumerate(_batches(w, rng, packed)):
        bid, now = 8190 + b, 100 + b
        routed, valid, _orig, _ovf = jm.route_by_flow(hdr, S, BLOCK)
        if packed:
            ok, ep, dirn = pack_eligibility(hdr)
            assert ok
            rows = pack_rows(routed)
            js, jr = jsteps[True](js, jr, jnp.asarray(rows), jnp.uint32(now),
                                  jnp.uint32(bid), jnp.asarray(valid),
                                  jnp.asarray(PROXY), jnp.uint32(ep),
                                  jnp.uint32(dirn))
            step(w.state, tr, u32.from_numpy(rows, "cpu"), now, bid,
                 torch.from_numpy(valid), pp, ep, dirn)
        else:
            js, jr = jsteps[False](js, jr, jnp.asarray(routed),
                                   jnp.uint32(now), jnp.uint32(bid),
                                   jnp.asarray(valid), jnp.asarray(PROXY))
            step(w.state, tr, u32.from_numpy(routed, "cpu"), now, bid,
                 torch.from_numpy(valid), pp)
        _eq("ring.buf", tr.buf, jr.buf)
        _eq("ring.cursor", tr.cursor, jr.cursor)
    _assert_state(w.state, js)
    got = tring.sharded_ring_drain(u32.to_numpy(tr.buf),
                                   u32.to_numpy(tr.cursor), PROXY)
    want = jring.sharded_ring_drain(np.asarray(jr.buf),
                                    np.asarray(jr.cursor), PROXY)
    for g, x in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, x)
    assert got[2:] == want[2:] and got[2] > 0 and got[3] == 0
    assert set(np.unique(got[1])) == set(range(S))
    # shard-local packet indices
    assert int(got[0][:, tring.COL_PKT_IDX].max()) < BLOCK


def test_one_shard_equals_the_unsharded_step():
    """S = 1: the sharded plain step is today's serve step."""
    from cilium_tpu_torch.monitor.ring import EventRing, serve_step_packed

    w, _jw = _worlds()
    w2, _ = _worlds()
    rng = np.random.default_rng(9)
    hdr = tfix.steady_flow_pool(w, B, rng)
    ok, ep, dirn = pack_eligibility(hdr)
    rows = u32.from_numpy(pack_rows(hdr), "cpu")
    valid = torch.from_numpy(rng.random(B) < 0.8)
    mesh = tm.make_mesh(1, "cpu")
    ring1 = tm.make_sharded_ring(mesh, RING)
    tm.make_sharded_serve_step(mesh, packed=True)(
        w.state, ring1, rows, 7, 3, valid, None, ep, dirn)
    ring2 = EventRing.create(RING, "cpu")
    serve_step_packed(w2.state, ring2, rows, 7, 3, ep, dirn, valid=valid)
    for a, b in ((ring1.buf, ring2.buf), (ring1.cursor[0], ring2.cursor),
                 (w.state.ct.table, w2.state.ct.table),
                 (w.state.metrics, w2.state.metrics)):
        assert torch.equal(a, b)
