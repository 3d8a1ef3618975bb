"""Event ring port parity: cilium_tpu_torch.monitor.ring against
cilium_tpu.monitor.ring — compaction, trace sampling, newest-wins
overflow, listener indices, the 64-bit cursor carry and the host
decode, bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.datapath.verdict import (EV_DROP, EV_TRACE, EV_VERDICT,
                                         N_OUT, OUT_EVENT, OUT_PROXY)
from cilium_tpu.monitor import ring as jr
from cilium_tpu_torch import convert, u32
from cilium_tpu_torch.monitor import ring as tr

torch.set_num_threads(1)

PORTS = np.array([10000, 10001, 15001], np.uint32)


def _out(rng, n, trace_frac=0.8):
    out = rng.integers(0, 1 << 32, (n, N_OUT), dtype=np.uint64)
    out = out.astype(np.uint32)
    out[:, OUT_EVENT] = np.where(rng.random(n) < trace_frac, EV_TRACE,
                                 rng.choice([EV_DROP, EV_VERDICT], n))
    out[:, OUT_PROXY] = rng.choice(
        np.array([0, 0, 10000, 15001, 10001, 7], np.uint32), n)
    return out


def _run(cap, batches, trace_sample, cursor=(0, 0), proxy=True,
         valid_frac=None, seed=0):
    rng = np.random.default_rng(seed)
    jring = jr.EventRing.create(cap)
    jring = jr.EventRing(buf=jring.buf,
                         cursor=jnp.asarray(np.array(cursor, np.uint32)))
    tring = convert.event_ring_from_numpy(np.asarray(jring.buf),
                                          np.asarray(jring.cursor), "cpu")
    pp = PORTS if proxy else None
    for b, n in enumerate(batches):
        out = _out(rng, n)
        valid = None if valid_frac is None else rng.random(n) < valid_frac
        jring = jr.ring_append_jit(
            jring, jnp.asarray(out), jnp.uint32(b + 8190),
            trace_sample=trace_sample,
            valid=None if valid is None else jnp.asarray(valid),
            proxy_ports=None if pp is None else jnp.asarray(pp))
        tr.ring_append(
            tring, u32.from_numpy(out, "cpu"), b + 8190,
            trace_sample=trace_sample,
            valid=None if valid is None else torch.from_numpy(valid),
            proxy_ports=None if pp is None else u32.from_numpy(pp, "cpu"))
    buf, cur = convert.event_ring_to_numpy(tring)
    np.testing.assert_array_equal(buf, np.asarray(jring.buf))
    np.testing.assert_array_equal(cur, np.asarray(jring.cursor))
    want = jr.ring_drain(jring, pp)
    got = tr.ring_drain(tring, pp)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    return got


@pytest.mark.parametrize("trace_sample", [0, 1024, 7])
def test_compaction_and_sampling(trace_sample):
    rows, total, lost = _run(1 << 12, [1500, 700, 2100], trace_sample)
    assert lost == 0 and len(rows) == total


def test_overflow_keeps_the_newest_events():
    rows, total, lost = _run(256, [1200, 900], 1024)
    assert lost == total - 256 > 0


def test_listener_index_round_trip_and_valid_mask():
    _run(1 << 11, [800, 800], 1024, valid_frac=0.6, seed=3)
    _run(1 << 11, [800], 0, proxy=False, seed=4)


def test_cursor_carries_into_the_high_word():
    # lo starts 256 short of 2^32 and the batches keep ~600 events
    rows, total, lost = _run(1 << 10, [1500, 1500], 0,
                             cursor=(0xFFFFFF00, 2), seed=5)
    assert total >> 32 == 3


def test_serve_step_packed_appends_through_the_ring():
    from cilium_tpu_torch.core.packets import pack_rows
    from cilium_tpu_torch.datapath.verdict import build_state
    from cilium_tpu_torch.testing import fixtures as tfix

    w = tfix.build_world(64, 4, ct_capacity=1 << 10, device="cpu")
    state = build_state(w.tensors, w.lpm, w.ep_policy, 1 << 10, "cpu")
    ring = tr.EventRing.create(1 << 10, "cpu")
    rng = np.random.default_rng(1)
    hdr = tfix.bench_traffic(w, 300, rng)
    state, ring = tr.serve_step_packed(state, ring,
                                       u32.from_numpy(pack_rows(hdr), "cpu"),
                                       100, 3, 0, 0, trace_sample=0)
    rows, total, lost = tr.ring_drain(ring)
    assert total == len(rows) > 0 and lost == 0
    assert set(rows[:, tr.COL_BATCH]) == {3}


@pytest.mark.parametrize("case", ["empty", "capacity_plus_one"])
def test_plain_version_matches_jax_at_the_edges(case):
    """``ring_append_plain`` against the JAX ``ring_append`` on the same
    numpy inputs: an empty batch (the cursor, 256 short of 2^32, stays
    where it was) and a batch that keeps exactly capacity + 1 rows (the
    oldest kept row is the one overwritten)."""
    cap = 256
    rng = np.random.default_rng(11)
    n = 0 if case == "empty" else 1000
    out = _out(rng, n)
    out[:, OUT_EVENT] = EV_TRACE
    if n:
        kept = np.sort(rng.choice(np.arange(1, n), cap + 1, replace=False))
        out[kept, OUT_EVENT] = rng.choice([EV_DROP, EV_VERDICT], cap + 1)
    cursor = np.array([0xFFFFFF00, 2], np.uint32)
    jring = jr.EventRing(buf=jr.EventRing.create(cap).buf,
                         cursor=jnp.asarray(cursor))
    tring = convert.event_ring_from_numpy(np.asarray(jring.buf), cursor,
                                          "cpu")
    jring = jr.ring_append_jit(jring, jnp.asarray(out), jnp.uint32(77),
                               trace_sample=0,
                               proxy_ports=jnp.asarray(PORTS))
    tr.ring_append_plain(tring, u32.from_numpy(out, "cpu"), 77,
                         trace_sample=0,
                         proxy_ports=u32.from_numpy(PORTS, "cpu"))
    buf, cur = convert.event_ring_to_numpy(tring)
    np.testing.assert_array_equal(buf, np.asarray(jring.buf))
    np.testing.assert_array_equal(cur, np.asarray(jring.cursor))
    total = int(cur[0]) | int(cur[1]) << 32
    assert total == 0xFFFFFF00 + (2 << 32) + (0 if n == 0 else cap + 1)
    rows, t, lost = tr.ring_drain(tring, PORTS)
    want = jr.ring_drain(jring, PORTS)
    np.testing.assert_array_equal(rows, want[0])
    assert (t, lost) == tuple(want[1:])
    if n:
        # every slot written once; the first kept row is the one lost
        assert len(rows) == cap
        assert sorted(rows[:, tr.COL_PKT_IDX]) == list(kept[1:])
