"""Conntrack port parity: cilium_tpu_torch.datapath.conntrack against
cilium_tpu.datapath.conntrack on the same numpy inputs, bit-exact.

The JAX functions run on the CPU (conftest pins JAX_PLATFORMS=cpu); the
port runs its plain PyTorch versions, which are also the CUDA kernels'
yardstick on the card.  Every output is an integer, so the tolerance
is exact equality.  Batches are padded to one size with rows that
``valid`` masks, and tables come in three capacities, so the JAX side
compiles a handful of programs for the whole file.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.core import TCP_ACK, TCP_FIN, make_batch
from cilium_tpu.core.packets import COL_FLAGS, COL_LEN, FLAG_RELATED
from cilium_tpu.datapath import conntrack as jct
from cilium_tpu_torch import u32
from cilium_tpu_torch.datapath import conntrack as tct
from cilium_tpu_torch.testing import fixtures as tfix

torch.set_num_threads(1)


def _flows(n, seed=0, proto=6, dst="10.200.0.1"):
    rng = np.random.default_rng(seed)
    rows = [dict(src=f"10.{rng.integers(0, 200)}.{i // 250}.{i % 250 + 1}",
                 dst=dst, sport=int(rng.integers(1024, 60000)),
                 dport=443, proto=proto, dir=int(rng.integers(0, 2)),
                 length=int(rng.integers(60, 1500)))
            for i in range(n)]
    return make_batch(rows).data


def _t(a):
    return u32.from_numpy(a, "cpu")


def _tbool(a):
    return torch.from_numpy(np.asarray(a, dtype=bool).copy())


def _jax_ct(table, fp, dropped=0):
    return jct.CTTable(table=jnp.asarray(table, dtype=jnp.uint32),
                       fp=jnp.asarray(fp, dtype=jnp.uint32),
                       dropped=jnp.uint32(dropped))


def _torch_ct(table, fp, dropped=0):
    return tct.CTTable(table=_t(table), fp=_t(fp),
                       dropped=_t(np.uint32(dropped)).reshape(()))


BATCH = 128  # every batch is padded to this many rows


def _pad(hdr):
    """Rows beyond the batch are all-zero headers (masked by ``valid``)."""
    out = np.zeros((BATCH, hdr.shape[1]), np.uint32)
    out[:len(hdr)] = hdr
    return out


def _both_step(table, fp, hdr, now, do_create=None, proxy=None,
               valid=None, dropped=0, stats=None):
    """One lookup + update through both packages from the same table;
    asserts the lookups agree, returns both resulting states as numpy.
    JAX always gets a ``valid`` mask (False on the padding); the port
    gets None where the caller gave none and nothing was padded.  A
    ``stats`` dict gets the port's insert-round counts
    (``ct_update_plain``'s ``stats``)."""
    n = len(hdr)
    assert n <= BATCH
    mask = np.zeros(BATCH, bool)
    mask[:n] = True if valid is None else valid
    port_valid = mask if valid is not None or n < BATCH else None
    hdr = _pad(hdr)
    do_create = np.ones(BATCH, bool) if do_create is None else np.resize(
        do_create, BATCH)
    proxy = np.zeros(BATCH, np.uint32) if proxy is None else np.resize(
        proxy, BATCH)
    jc = _jax_ct(table, fp, dropped)
    jh = jnp.asarray(hdr)
    jf, jr = jct.ct_keys_jit(jh)
    jres, jslot, jrep = jct.ct_lookup_jit(jc, jf, jr, jnp.uint32(now))
    jc = jct.ct_update_jit(
        jc, jh, jf, jres, jslot, jrep, do_create=jnp.asarray(do_create),
        proxy_port=jnp.asarray(proxy), now=jnp.uint32(now),
        valid=jnp.asarray(mask))

    tc = _torch_ct(table, fp, dropped)
    th = _t(hdr)
    tf, tr = tct.ct_keys_from_headers(th)
    tres, tslot, trep = tct.ct_lookup(tc, tf, tr, now)
    np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(trep.numpy(), np.asarray(jrep))
    update = (tct.ct_update if stats is None
              else functools.partial(tct.ct_update_plain, stats=stats))
    update(tc, tct.ct_l4_from_headers(th), tf, tres, tslot, trep,
           _tbool(do_create), _t(proxy), now,
           valid=None if port_valid is None else _tbool(port_valid))
    j = (np.array(jc.table), np.array(jc.fp), int(jc.dropped))
    t = (u32.to_numpy(tc.table), u32.to_numpy(tc.fp),
         int(u32.to_numpy(tc.dropped)))
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])
    assert t[2] == j[2]
    return j


def _empty(cap):
    return (np.zeros((cap, jct.ROW_WORDS), np.uint32),
            np.zeros(cap, np.uint32))


class TestKeysAndHash:
    def test_keys_match_jax_across_protos_dirs_and_related(self):
        rng = np.random.default_rng(3)
        hdr = np.concatenate([_flows(40, 1, proto=6), _flows(20, 2, proto=17),
                              _flows(20, 3, proto=1), _flows(10, 4, proto=58)])
        hdr[::7, COL_FLAGS] |= FLAG_RELATED
        # wide rows may carry any u32 in the port and dir columns
        hdr[5, 8] = 0xFFFFFFFF
        hdr[6, 15] = 7
        rng.shuffle(hdr)
        jf, jr = jct.ct_keys_jit(jnp.asarray(hdr))
        tf, tr = tct.ct_keys_from_headers(_t(hdr))
        np.testing.assert_array_equal(u32.to_numpy(tf), np.asarray(jf))
        np.testing.assert_array_equal(u32.to_numpy(tr), np.asarray(jr))

    def test_hash_and_fingerprint_match_host_mirrors(self):
        rng = np.random.default_rng(5)
        keys = rng.integers(0, 1 << 32, (512, jct.KEY_WORDS),
                            dtype=np.uint64).astype(np.uint32)
        keys[0] = 0xFFFFFFFF
        keys[1] = 0
        h = tct._hash(_t(keys))
        np.testing.assert_array_equal(h.numpy(), jct._hash_np(keys))
        np.testing.assert_array_equal(
            tct._fp_mix(h).numpy(), jct._fp_mix_np(jct._hash_np(keys)))

    def test_u32_multiply_wraps_like_numpy(self):
        rng = np.random.default_rng(9)
        a = rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
        a[:2] = [0xFFFFFFFF, 0x80000000]
        for b in (0x01000193, 0x85EBCA6B, 0xC2B2AE35, 0xFFFFFFFF):
            with np.errstate(over="ignore"):
                want = a.astype(np.uint32) * np.uint32(b)
            got = u32.mul(torch.from_numpy(a.astype(np.int64)), b)
            np.testing.assert_array_equal(got.numpy(), want)


class TestLookup:
    def test_forced_fingerprint_overflow_falls_back_per_row(self):
        # the trap: the live entry of key K sits at window position
        # N_CAND+1 behind N_CAND+1 EXPIRED entries of K itself, so every
        # fingerprint candidate is stale and the filtered probe alone
        # misses.  The port reruns the full probe for that row only,
        # JAX for the whole batch — the results must agree row for row
        cap, now = 1 << 9, 1000
        table, fp = _empty(cap)
        others = _flows(64, seed=11)
        table, fp, _ = _both_step(table, fp, others, now)
        trap = _flows(1, seed=99, dst="10.201.0.9")
        key = np.asarray(jct.ct_keys_jit(jnp.asarray(trap))[0])[0]
        h = int(jct._hash_np(key[None])[0])
        kfp = jct._fp_mix_np(jct._hash_np(key[None]))[0]
        for pos in range(jct.N_CAND + 2):
            s = (h + pos) % cap
            table[s] = 0
            table[s, :jct.KEY_WORDS] = key
            table[s, jct.V_STATE] = jct.ST_ESTABLISHED
            table[s, jct.V_EXPIRES] = now - 1 if pos <= jct.N_CAND else now + 50
            fp[s] = kfp
        live_slot = (h + jct.N_CAND + 1) % cap
        hdr = np.concatenate([others, trap, others[:BATCH - 65]])
        jc = _jax_ct(table, fp)
        tf, tr = tct.ct_keys_from_headers(_t(hdr))
        _f, _s, ovf = tct._probe_fp(_t(table), _t(fp), tf, now)
        assert bool(ovf[64]) and int(ovf.sum()) == 1  # the trap springs
        jf, jr = jct.ct_keys_jit(jnp.asarray(hdr))
        want = jct.ct_lookup_jit(jc, jf, jr, jnp.uint32(now))
        got = tct.ct_lookup(_torch_ct(table, fp), tf, tr, now)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert int(got[0][64]) == jct.CT_ESTABLISHED
        assert int(got[1][64]) == live_slot

    def test_probe_equals_full_probe_through_a_lifecycle(self):
        rng = np.random.default_rng(42)
        cap, now = 1 << 9, 100
        table, fp = _empty(cap)
        universe = _flows(300, seed=7)
        for step in range(6):
            pick = rng.choice(300, BATCH, replace=False)  # port: no mask
            table, fp, _ = _both_step(table, fp, universe[pick], now)
            now += int(rng.integers(1, 40))


class TestUpdate:
    def test_duplicate_tuples_collapse_to_highest_row(self):
        hdr = _flows(24, seed=1)
        dup = np.repeat(hdr[:1], 4, axis=0)
        dup[:, COL_LEN] = [100, 200, 300, 400]
        batch = np.concatenate([hdr[1:12], dup, hdr[12:]])
        table, fp = _empty(1 << 9)
        table, fp, _ = _both_step(table, fp, batch, 100)
        live = table[table[:, jct.V_STATE] != 0]
        assert len(live) == 24
        # the highest batch row's counters stand
        assert 400 in live[:, jct.V_TX_BYTES]

    def test_window_contention_runs_the_full_rounds(self):
        # 56 flows into 64 slots: windows overlap everywhere, so inserts
        # lose candidates to racers and ride the 16 full-window rounds
        table, fp = _empty(64)
        _both_step(table, fp, _flows(56, seed=21), 100)

    def test_expired_slots_are_reclaimed_without_gc(self):
        table, fp = _empty(16)
        table, fp, _ = _both_step(table, fp, _flows(8, seed=1), 100)
        later = 100 + jct.LIFETIME_SYN + 1
        table, fp, dropped = _both_step(table, fp, _flows(6, seed=2), later)
        assert dropped == 0

    def test_full_window_counts_dropped_inserts(self):
        table, fp = _empty(16)
        _t_, _f, dropped = _both_step(table, fp, _flows(24, seed=4), 100)
        assert dropped == 24 - 16

    def test_valid_mask_and_do_create_gate_every_write(self):
        rng = np.random.default_rng(8)
        hdr = _flows(96, seed=8)
        table, fp = _empty(1 << 9)
        table, fp, _ = _both_step(table, fp, hdr[:48], 100)
        _both_step(table, fp, hdr, 101, do_create=rng.random(96) < 0.7,
                   proxy=rng.integers(0, 3, 96).astype(np.uint32) * 10000,
                   valid=rng.random(96) < 0.8)

    def test_state_machine_and_counters_wrap_at_2_32(self):
        hdr = _flows(32, seed=6)
        table, fp = _empty(1 << 9)
        table, fp, _ = _both_step(table, fp, hdr, 100)
        live = table[:, jct.V_STATE] != 0
        for col in (jct.V_TX_PKTS, jct.V_RX_PKTS, jct.V_TX_BYTES,
                    jct.V_RX_BYTES):
            table[live, col] = 0xFFFFFFFF - 3
        # replies (swapped tuples, flipped dir) and FIN/ACK duplicates
        rep = hdr.copy()
        rep[:, [0, 1, 2, 3]], rep[:, [4, 5, 6, 7]] = hdr[:, 4:8], hdr[:, 0:4]
        rep[:, [8, 9]] = hdr[:, [9, 8]]
        rep[:, 15] = 1 - hdr[:, 15]
        rep[:, COL_FLAGS] = TCP_ACK
        fin = hdr[:8].copy()
        fin[:, COL_FLAGS] = TCP_FIN | TCP_ACK
        batch = np.concatenate([rep, hdr[:16], fin, rep[:4]])
        batch[:, COL_LEN] = np.arange(len(batch), dtype=np.uint32) + 60
        table, fp, _ = _both_step(table, fp, batch, 150)
        assert (table[live, jct.V_RX_BYTES] < 0xFFFFFFFF - 3).any()  # wrapped
        assert (table[:, jct.V_STATE] == jct.ST_CLOSING).any()
        assert (table[:, jct.V_STATE] == jct.ST_ESTABLISHED).any()

    @pytest.mark.parametrize("order", [(0, 1), (1, 0)])
    def test_refresh_writers_disagreeing_on_tcp_leave_the_last_row(self,
                                                                   order):
        # a forged protocol number aliases the key word proto | dir << 8:
        # proto 0x106 on ingress and TCP (6) on egress hit one entry but
        # disagree on its lifetime; the highest batch row's expiry stands
        a = _flows(1, seed=13)
        a[:, 15] = 1
        b = a.copy()
        b[:, 10], b[:, 15] = 0x106, 0
        table, fp = _empty(64)
        table, fp, _ = _both_step(table, fp, a, 100)
        table[table[:, jct.V_STATE] != 0, jct.V_STATE] = jct.ST_ESTABLISHED
        pair = np.concatenate([a, b])[list(order)]
        pair[:, COL_FLAGS] = TCP_ACK
        table, _fp, _ = _both_step(table, fp, pair, 110)
        life = 110 + (jct.LIFETIME_NONTCP if order[1] else jct.LIFETIME_TCP)
        assert table[table[:, jct.V_STATE] != 0, jct.V_EXPIRES] == [life]

    def test_icmp_and_udp_lifetimes(self):
        hdr = np.concatenate([_flows(16, 2, proto=17), _flows(16, 3, proto=1)])
        table, fp = _empty(1 << 9)
        table, fp, _ = _both_step(table, fp, hdr, 100)
        _both_step(table, fp, hdr, 100 + jct.LIFETIME_NONTCP - 1)


def _apart_flows(cap, n, seed):
    """``n`` flows whose 16-slot windows in a ``cap``-slot table are
    pairwise 32 slots apart or more, so that each one's insert settles
    alone."""
    hdr = _flows(4 * n, seed=seed)
    keys = u32.to_numpy(tct.ct_keys_from_headers(_t(hdr))[0])
    homes = jct._hash_np(keys).astype(np.int64) % cap
    keep = []
    for i, h in enumerate(homes):
        if all(min((h - homes[j]) % cap, (homes[j] - h) % cap) >= 32
               for j in keep):
            keep.append(i)
    assert len(keep) >= n
    return hdr[keep[:n]]


# the insert round in which the batch's last pending row settles; None:
# it is still pending after the last round (dropped)
SETTLE = {"round0": 0, "round3": 3, "round4": 4, "round19": 19,
          "dropped": None, "none_pending": "none"}


@pytest.mark.parametrize("case", list(SETTLE))
def test_insert_rounds_end_where_the_last_pending_row_settles(case):
    """The kernel stops its insert rounds once no row is pending; these
    batches pin, against JAX, that rounds with no pending row change
    nothing: the last pending row settles in candidate round 0 or 3, in
    the first full-window round (4) or the last (19), or never (a
    dropped insert), or no row is pending at all.  The port's plain
    version counts the rows pending entering each round."""
    cap, now = 1 << 9, 100
    hdr = _apart_flows(cap, 8, seed=31)
    settle = SETTLE[case]
    if settle == "none":
        table, fp = _empty(cap)
        table, fp, _ = _both_step(table, fp, hdr, now)  # all inserted
        stats = {}
        _both_step(table, fp, hdr, now + 1, stats=stats)  # all hits
        assert stats["rounds"] == 0 and not any(stats["pending"])
        return
    key = u32.to_numpy(tct.ct_keys_from_headers(_t(hdr[:1]))[0])[0]
    table, fp = tfix.ct_round_table(key, settle, cap, now,
                                    np.random.default_rng(3))
    stats = {}
    t2, _fp2, dropped = _both_step(table, fp, hdr, now, stats=stats)
    pend = stats["pending"]
    assert len(pend) == tct.N_ROUNDS + 1 and pend[0] == len(hdr)
    if settle is None:
        assert stats["rounds"] == tct.N_ROUNDS and pend[-1] == dropped == 1
        assert not (t2[:, :jct.KEY_WORDS] == key).all(axis=1).any()
        return
    assert dropped == 0 and pend[-1] == 0
    assert stats["rounds"] == settle + 1
    # the other rows settle in round 0, the crafted one in its round
    assert pend[settle + 1] == 0
    assert pend[1:settle + 1] == [1] * settle
    h = int(jct._hash_np(key[None])[0])
    pos = settle if settle < tct.N_CAND_INS else settle - tct.N_CAND_INS
    np.testing.assert_array_equal(
        t2[(h + pos) % cap, :jct.KEY_WORDS], key)


def test_snapshot_rows_round_trip_matches_jax():
    hdr = _flows(64, seed=12)
    table, fp = _empty(1 << 9)
    table, _fp, _ = _both_step(table, fp, hdr, 100)
    rows = tct.ct_rows_from_table(table)
    np.testing.assert_array_equal(rows, jct.ct_rows_from_table(table))
    t2, d2 = tct.ct_table_from_rows(rows, 1 << 10)
    j2, jd2 = jct.ct_table_from_rows(rows, 1 << 10)
    np.testing.assert_array_equal(t2, j2)
    assert d2 == jd2
    np.testing.assert_array_equal(tct.ct_fp_from_table(t2),
                                  jct.ct_fp_from_table(j2))
