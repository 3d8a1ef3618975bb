"""The occupancy-bounded ring drain of the port against the JAX
package's: ``ring_gather`` (plain version) and the ``AsyncRingDrainer``
swap -> fetch path, over unlapped, lapped and empty windows, in gather
and full-copy modes.  Every comparison is integer and bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.monitor import ring as jr
from cilium_tpu_torch import convert, u32
from cilium_tpu_torch.monitor import ring as tr

torch.set_num_threads(1)

CAP = 1 << 12
PORTS = np.array([10000, 10001], np.uint32)


def _words(rng, n_slots, empty_frac=0.05):
    """Ring words: random event rows, some slots left EMPTY (event bits
    0b11), as a fresh-per-window ring has them past its occupancy."""
    w = rng.integers(0, 1 << 32, (n_slots, 2), dtype=np.uint64).astype(
        np.uint32)
    w[:, 0] &= ~np.uint32(0x18)  # event bits 0..2: a real event
    w[rng.random(n_slots) < empty_frac] = 0xFFFFFFFF
    return w


def _cursor(total):
    return np.array([total & 0xFFFFFFFF, total >> 32], np.uint32)


def _rings(words, total):
    cur = _cursor(total)
    jring = jr.EventRing(buf=jnp.asarray(words), cursor=jnp.asarray(cur))
    tring = convert.event_ring_from_numpy(words, cur, "cpu")
    return jring, tring


# lapped: each shard's window from a random slot; "odd": from an odd
# slot (the last one, CAP - 1, for shard 0), every window wrapping
@pytest.mark.parametrize("n_shards", [1, 2, 8])
@pytest.mark.parametrize("rung", [64, 512, CAP])
@pytest.mark.parametrize("lapped", [False, True, "odd"])
def test_ring_gather_matches_jax(n_shards, rung, lapped):
    rng = np.random.default_rng(rung + n_shards + 7 * (lapped is True)
                                + 13 * (lapped == "odd"))
    buf = _words(rng, n_shards * CAP, empty_frac=0.0)
    if lapped == "odd":
        starts = rng.integers(0, CAP // 2, n_shards) * 2 + 1
        starts[0] = CAP - 1
    elif lapped:
        starts = rng.integers(0, CAP, n_shards)
    else:
        starts = np.zeros(n_shards, np.int64)
    starts = starts.astype(np.uint32)
    want = np.asarray(jr.ring_gather(jnp.asarray(buf), jnp.asarray(starts),
                                     rung, CAP))
    got = tr.ring_gather(u32.from_numpy(buf, "cpu"), starts, rung, CAP)
    np.testing.assert_array_equal(u32.to_numpy(got), want)


# (events appended in the window, empty fraction); 0 is the empty
# window, 3 * CAP + 123 a ring the host let lap three times
WINDOWS = [(0, 0.0), (37, 0.0), (1000, 0.1), (CAP, 0.0),
           (3 * CAP + 123, 0.02), ((1 << 32) + 5, 0.0)]


@pytest.mark.parametrize("gather", [True, False])
@pytest.mark.parametrize("total,empty", WINDOWS)
def test_swap_window_fetch_matches_jax(total, empty, gather):
    rng = np.random.default_rng(total % 1000)
    words = _words(rng, CAP, empty)
    if total < CAP:
        words[total:] = 0xFFFFFFFF  # never written this window
    jring, tring = _rings(words, total)
    jd = jr.AsyncRingDrainer(CAP, proxy_ports=PORTS, gather=gather)
    td = tr.AsyncRingDrainer(CAP, proxy_ports=PORTS, gather=gather,
                             device="cpu")
    jw, jfresh = jd.swap_window(jring)
    tw, tfresh = td.swap_window(tring)
    for f in ("d2h_bytes", "rung", "appended", "lost", "gathered"):
        assert getattr(tw, f) == getattr(jw, f), f
    np.testing.assert_array_equal(tw.cursor, np.asarray(jw.cursor))
    got, want = tw.fetch(), jw.fetch()
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] is None and want[1] is None
    assert got[2:] == want[2:]
    for f in ("windows", "events", "lost"):
        assert getattr(td, f) == getattr(jd, f), f
    # the next window starts on a fresh, empty ring
    assert u32.to_numpy(tfresh.cursor).tolist() == [0, 0]
    np.testing.assert_array_equal(u32.to_numpy(tfresh.buf),
                                  np.asarray(jfresh.buf))


@pytest.mark.parametrize("kept,rung", [(0, 64), (1, 64), (64, 64),
                                       (65, 128), (CAP - 1, CAP),
                                       (5 * CAP, CAP)])
def test_gather_rung_ladder(kept, rung):
    assert tr._gather_rung(kept, CAP) == jr._gather_rung(kept, CAP) == rung
