"""Bandwidth policing port parity: cilium_tpu_torch.datapath.bandwidth
against cilium_tpu.datapath.bandwidth on the same numpy inputs.

The JAX ``bw_stage`` runs on the CPU (conftest pins JAX_PLATFORMS=cpu)
and computes its keep-fraction and per-row hash fraction in f32; the
port's plain version repeats that arithmetic in f32 and the u32 words in
int64, so the reasons, the token buckets and the clock must agree bit
for bit, with state carried across successive batches.  Batches are
padded to one size with all-zero rows (ingress, endpoint 0: never
policed), so the JAX side compiles one program.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.datapath import bandwidth as jbw
from cilium_tpu_torch import convert, u32
from cilium_tpu_torch.core.packets import (COL_DIR, COL_EP, COL_FAMILY,
                                           COL_LEN, COL_PROTO, COL_SPORT,
                                           COL_SRC_IP3, N_COLS)
from cilium_tpu_torch.datapath import bandwidth as tbw
from cilium_tpu_torch.datapath.verdict import MAX_ENDPOINTS

torch.set_num_threads(1)

B = 512


def _rows(rng, eps, n=B, egress_frac=0.8, length=(40, 1500)):
    out = np.zeros((B, N_COLS), np.uint32)
    out[:n, COL_SRC_IP3] = 0x0A000000 + rng.integers(1, 64, n)
    out[:n, COL_SPORT] = rng.integers(1024, 65535, n)
    out[:n, COL_PROTO] = 6
    out[:n, COL_LEN] = rng.integers(length[0], length[1], n)
    out[:n, COL_FAMILY] = 4
    out[:n, COL_EP] = rng.choice(np.asarray(eps, np.uint32), n)
    out[:n, COL_DIR] = rng.random(n) < egress_frac
    return out


class _Pair:
    def __init__(self, limits, tokens=None, last=0):
        self.rates_np = tbw.rates_array(limits)
        np.testing.assert_array_equal(self.rates_np,
                                      jbw.rates_array(limits))
        tokens = (np.zeros(MAX_ENDPOINTS, np.uint32) if tokens is None
                  else np.asarray(tokens, np.uint32))
        self.j = jbw.BandwidthState(tokens=jnp.asarray(tokens),
                                    last=jnp.uint32(last))
        self.t = convert.bandwidth_state_from_numpy(tokens, last, "cpu")
        self.jr = jnp.asarray(self.rates_np)
        self.tr = u32.from_numpy(self.rates_np, "cpu")

    def police(self, rows, now):
        jr, self.j = jbw.bw_stage_jit(self.j, jnp.asarray(rows),
                                      jnp.uint32(now), self.jr)
        tr = tbw.bw_stage(self.t, u32.from_numpy(rows, "cpu"), now, self.tr)
        jr = np.asarray(jr)
        np.testing.assert_array_equal(u32.to_numpy(tr), jr)
        tokens, last = convert.bandwidth_state_to_numpy(self.t)
        np.testing.assert_array_equal(tokens, np.asarray(self.j.tokens))
        assert last == int(self.j.last)
        return jr


def test_rates_array_clamps_and_skips():
    limits = {1: 16_000, 2: 0, 3: 1 << 40, MAX_ENDPOINTS: 5, -1: 7}
    got = tbw.rates_array(limits)
    np.testing.assert_array_equal(got, jbw.rates_array(limits))
    assert got[3] == 0x7FFFFFFF and got[2] == 0 and got.sum() == \
        16_000 + 0x7FFFFFFF


@pytest.mark.parametrize("gaps", [(0, 0, 0), (1, 1, 1), (1, 0, 5000),
                                  (3, 100_000, 1)],
                         ids=["dt-0", "dt-1", "long-gap", "idle-then-1"])
def test_successive_batches_match_jax(gaps):
    """dt 0, 1 and long gaps (clamped to the burst window) over limited,
    unlimited and out-of-range endpoints, with ingress rows mixed in."""
    rng = np.random.default_rng(sum(gaps))
    pair = _Pair({1: 16_000, 2: 400_000, 7: 90_000, 4095: 1_000})
    now = 10
    dropped = 0
    for gap in gaps + (1, 1):
        now += gap
        rows = _rows(rng, [1, 2, 3, 7, 4095, 5000])
        reasons = pair.police(rows, now)
        dropped += int((reasons == tbw.REASON_BANDWIDTH).sum())
        # ingress rows and unlimited endpoints are never policed
        free = (rows[:, COL_DIR] == 0) | np.isin(rows[:, COL_EP], [0, 3])
        assert not reasons[free].any()
    assert dropped > 0


def test_rates_at_the_clamp_and_tokens_near_u32_limits():
    rng = np.random.default_rng(4)
    tokens = np.zeros(MAX_ENDPOINTS, np.uint32)
    tokens[[1, 2, 3]] = [0x7FFFFFFF, 0xFFFFFFF0, 12345]
    pair = _Pair({1: 1 << 40, 2: 0x7FFFFFFF, 3: 1}, tokens=tokens, last=5)
    for now in (6, 6, 7, 100):
        pair.police(_rows(rng, [1, 2, 3], length=(1 << 20, 1 << 30)), now)


@pytest.mark.parametrize("last,now", [(0xFFFFFFF0, 0xFFFFFFFF),
                                      (0xFFFFFFFF, 3), (1 << 31, 5),
                                      (10, 0xFFFFFFFE)])
def test_clock_near_2_32(last, now):
    """``now - last`` wraps, and the dt clamp must be an unsigned min."""
    rng = np.random.default_rng(last & 0xFF)
    tokens = np.zeros(MAX_ENDPOINTS, np.uint32)
    tokens[[1, 2]] = 3000
    pair = _Pair({1: 16_000, 2: 200_000}, tokens=tokens, last=last)
    pair.police(_rows(rng, [1, 2]), now)
    pair.police(_rows(rng, [1, 2]), (now + 1) & 0xFFFFFFFF)


def test_one_flow_keeps_or_drops_together():
    """The row hash is per flow: repeats of one (src, sport, ep) in a
    batch share their fate."""
    rng = np.random.default_rng(9)
    rows = _rows(rng, [1])
    rows[:, COL_DIR] = 1
    rows[B // 2:, COL_SRC_IP3] = rows[:B // 2, COL_SRC_IP3]
    rows[B // 2:, COL_SPORT] = rows[:B // 2, COL_SPORT]
    pair = _Pair({1: 50_000}, tokens=np.full(MAX_ENDPOINTS, 50_000))
    reasons = pair.police(rows, 1)
    np.testing.assert_array_equal(reasons[:B // 2], reasons[B // 2:])
    assert 0 < int((reasons != 0).sum()) < B
