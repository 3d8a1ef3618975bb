"""Verdict step port parity: cilium_tpu_torch.datapath.verdict against
cilium_tpu.datapath.verdict, wide and packed, across every optional
channel (valid, pre_drop, pre_drop_reason, lb_drop, audit), over
several batches with the clock advancing — out rows, metrics, CT table,
fingerprints and drop count bit-exact.  The port's state starts as the
JAX world's state carried across with cilium_tpu_torch.convert."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.core.packets import (COL_DIR, COL_DPORT, COL_EP,
                                     COL_FAMILY, COL_PROTO, pack_rows)
from cilium_tpu.datapath import verdict as jv
from cilium_tpu.datapath.conntrack import CTTable, LIFETIME_SYN
from cilium_tpu.datapath.lpm import DeviceLPM
from cilium_tpu.testing import fixtures as jfix
from cilium_tpu_torch import convert, u32
from cilium_tpu_torch.datapath import verdict as tv

torch.set_num_threads(1)

_GROUPS = {"policy": jv.DevicePolicy, "ipcache": DeviceLPM, "ct": CTTable}


def flatten(state):
    """A JAX DatapathState -> the nested numpy dict convert.py takes."""
    out = {g: {f: (getattr(getattr(state, g), f) if f == "default" else
                   np.array(getattr(getattr(state, g), f)))
               for f in cls.__dataclass_fields__}
           for g, cls in _GROUPS.items()}
    out["metrics"] = np.array(state.metrics)
    return out


def jax_state(arrays):
    parts = {g: cls(**{f: (v if f == "default" else jnp.asarray(v))
                       for f, v in arrays[g].items()})
             for g, cls in _GROUPS.items()}
    return jv.DatapathState(metrics=jnp.asarray(arrays["metrics"]), **parts)


def assert_state_equal(tstate, jstate):
    t, j = convert.datapath_state_to_numpy(tstate), flatten(jstate)
    for g in _GROUPS:
        for f, v in j[g].items():
            np.testing.assert_array_equal(t[g][f], v, err_msg=f"{g}.{f}")
            assert np.asarray(t[g][f]).dtype == np.asarray(v).dtype
    np.testing.assert_array_equal(t["metrics"], j["metrics"])


@pytest.fixture(scope="module")
def world():
    w = jfix.build_world(256, 8, ct_capacity=1 << 10, n_v6=16)
    arrays = flatten(w.state)
    arrays["policy"]["ep_policy"][5] = -1  # endpoint 5: an lxcmap miss
    rng = np.random.default_rng(0)
    # live auth grants for half the identity rows, expired for the rest
    auth = arrays["policy"]["auth"]
    auth[:] = np.where(rng.random(auth.shape) < 0.5, 10_000, 50)
    return w, arrays


def _edge_rows(base):
    """Forged and out-of-range fields: each must read the cells the JAX
    step reads (XLA's clamp/normalize rule) and count like it."""
    rows = np.repeat(base[:1], 8, axis=0)
    rows[0, COL_EP] = 5
    rows[1, COL_EP] = 5000
    rows[2, COL_EP] = 0xFFFFFFFF
    rows[3, COL_DIR] = 2
    rows[4, COL_DIR] = 0xFFFFFFFF
    rows[5, COL_PROTO] = 300
    rows[6, COL_DPORT] = 0x10000 + 80
    rows[7, COL_FAMILY] = 5
    return rows


def _batches(w, rng, n_batches=3, n=256):
    pool = jfix.wide_flow_pool(w, 128, rng)
    out = []
    for b in range(n_batches):
        hdr = (jfix.wide_traffic(pool, n - 8, rng) if b else pool[:n - 8])
        hdr = np.concatenate([hdr, _edge_rows(hdr)])
        hdr[::5, COL_DIR] = 1  # egress rows too
        out.append(hdr)
    return out


CHANNELS = {
    "none": {},
    "valid": {"valid"},
    "pre_drop": {"pre_drop"},
    "pre_drop_reason": {"pre_drop_reason"},
    "lb_drop": {"lb_drop"},
    "audit": {"audit"},
    "all": {"valid", "pre_drop", "pre_drop_reason", "lb_drop", "audit"},
}


@pytest.mark.parametrize("channels", list(CHANNELS))
def test_wide_step_matches_jax(world, channels):
    w, arrays = world
    on = CHANNELS[channels]
    rng = np.random.default_rng(len(channels))
    js = jax_state(arrays)
    ts = convert.datapath_state_from_numpy(arrays, "cpu")
    now = 100
    for hdr in _batches(w, rng):
        n = len(hdr)
        ch = {}
        if "valid" in on:
            ch["valid"] = rng.random(n) < 0.85
        if "pre_drop" in on:
            ch["pre_drop"] = rng.random(n) < 0.1
        if "pre_drop_reason" in on:
            r = np.where(rng.random(n) < 0.1, 6, 0).astype(np.uint32)
            r[:3] = [13, 0xFFFFFFFF, 0x80000001]  # out of the metrics table
            ch["pre_drop_reason"] = r
        if "lb_drop" in on:
            ch["lb_drop"] = rng.random(n) < 0.05
        audit = "audit" in on
        # JAX gets every channel, neutral where the port's is None: the
        # same verdicts, and one compiled step per audit value
        neutral = {"valid": np.ones(n, bool), "pre_drop": np.zeros(n, bool),
                   "pre_drop_reason": np.zeros(n, np.uint32),
                   "lb_drop": np.zeros(n, bool)}
        jout, js = jv.datapath_step_jit(
            js, jnp.asarray(hdr), jnp.uint32(now), audit=audit,
            **{k: jnp.asarray(ch.get(k, v)) for k, v in neutral.items()})
        tch = {k: (u32.from_numpy(v, "cpu") if v.dtype == np.uint32
                   else torch.from_numpy(v)) for k, v in ch.items()}
        tout, ts = tv.datapath_step(ts, u32.from_numpy(hdr, "cpu"), now,
                                    audit=audit, **tch)
        np.testing.assert_array_equal(u32.to_numpy(tout), np.asarray(jout))
        now += LIFETIME_SYN // 2 + 1  # SYN entries expire mid-run
    assert_state_equal(ts, js)


# audit is a static flag of the JAX step, so each value is a compile of
# its own: the wide cases cover it, the packed ones share one program
@pytest.mark.parametrize("ep,dirn,audit", [(0, 0, False), (0, 1, False),
                                           (5, 0, False)])
def test_packed_step_matches_jax(world, ep, dirn, audit):
    w, arrays = world
    rng = np.random.default_rng(7 + ep + dirn)
    js = jax_state(arrays)
    ts = convert.datapath_state_from_numpy(arrays, "cpu")
    pool = jfix.steady_flow_pool(w, 256, rng)  # one batch shape
    for b, now in enumerate((100, 101, 100 + LIFETIME_SYN + 5)):
        hdr = jfix.steady_traffic(pool, 256, rng) if b else pool
        packed = pack_rows(hdr)
        valid = rng.random(len(packed)) < 0.9
        jout, js = jv.datapath_step_packed_jit(
            js, jnp.asarray(packed), jnp.uint32(now), jnp.uint32(ep),
            jnp.uint32(dirn), valid=jnp.asarray(valid), audit=audit)
        tout, ts = tv.datapath_step_packed(
            ts, u32.from_numpy(packed, "cpu"), now, ep, dirn,
            valid=torch.from_numpy(valid), audit=audit)
        np.testing.assert_array_equal(u32.to_numpy(tout), np.asarray(jout))
    assert_state_equal(ts, js)


def _one_cell_or_out_of_range(w, rng, case, n=4096):
    """``n`` wide rows: one flow repeated (every row lands in one metrics
    cell), or steady traffic whose directions and pre-drop reasons fall
    outside the [13, 2] table on a third of the rows (those rows are
    dropped from the metrics, as XLA's scatter drops them)."""
    pool = jfix.steady_flow_pool(w, 512, rng)
    if case == "one_cell":
        return np.repeat(pool[:1], n, axis=0), None
    hdr = jfix.steady_traffic(pool, n, rng)
    hdr[0::6, COL_DIR] = 2
    hdr[1::6, COL_DIR] = 0xFFFFFFFD  # -3: -1 after the wrap, still out
    hdr[2::6, COL_DIR] = 0xFFFFFFFF  # -1: direction 1
    reason = np.zeros(n, np.uint32)
    reason[3::6] = 13
    reason[4::6] = 0xFFFFFFFF
    return hdr, reason


@pytest.mark.parametrize("kind", ["packed", "wide"])
@pytest.mark.parametrize("case", ["one_cell", "out_of_range"])
def test_metrics_at_4096_rows_match_jax(world, kind, case):
    """The verdict kernel adds its metrics once a cell a block: at the
    trainer's 4096 rows, every row in one cell, and rows whose reason or
    direction falls outside the table, the counts equal JAX's (two
    batches: the flows' first packets, then their repeats)."""
    w, arrays = world
    rng = np.random.default_rng(41)
    js = jax_state(arrays)
    ts = convert.datapath_state_from_numpy(arrays, "cpu")
    hdr, reason = _one_cell_or_out_of_range(w, rng, case)
    n = len(hdr)
    m0 = np.array(js.metrics)
    # a packed stream's direction is one scalar: out of range for the
    # whole first batch, -1 (direction 1) for the second
    dirns = (2, 0xFFFFFFFF) if case == "out_of_range" else (0, 0)
    for now, dirn in zip((100, 101), dirns):
        if kind == "packed":
            packed = pack_rows(hdr)
            jout, js = jv.datapath_step_packed_jit(
                js, jnp.asarray(packed), jnp.uint32(now), jnp.uint32(0),
                jnp.uint32(dirn), valid=jnp.ones(n, bool), audit=False)
            tout, ts = tv.datapath_step_packed(
                ts, u32.from_numpy(packed, "cpu"), now, 0, dirn)
        else:
            neutral = {"valid": np.ones(n, bool),
                       "pre_drop": np.zeros(n, bool),
                       "pre_drop_reason": (np.zeros(n, np.uint32)
                                           if reason is None else reason),
                       "lb_drop": np.zeros(n, bool)}
            jout, js = jv.datapath_step_jit(
                js, jnp.asarray(hdr), jnp.uint32(now), audit=False,
                **{k: jnp.asarray(v) for k, v in neutral.items()})
            tout, ts = tv.datapath_step(
                ts, u32.from_numpy(hdr, "cpu"), now,
                pre_drop_reason=(None if reason is None
                                 else u32.from_numpy(reason, "cpu")))
        np.testing.assert_array_equal(u32.to_numpy(tout), np.asarray(jout))
    assert_state_equal(ts, js)
    added = u32.to_numpy(ts.metrics).astype(np.int64) - m0
    if case == "one_cell":
        assert (added != 0).sum() <= 2 and added.sum() == 2 * n
    elif kind == "packed":
        assert added.sum() == n and added[:, 0].sum() == 0
    else:
        assert 0 < added.sum() < 2 * n
