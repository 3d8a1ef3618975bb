"""The K-batch superbatch of the port against the JAX package's
(``TPULoader.serve_superbatch`` -> ``serve_superbatch_jit`` /
``serve_superbatch_packed_jit``), packed and wide, with partial valid
masks and an all-false trailing step; and against K sequential
``serve_packed`` / ``serve`` calls of the port itself.  Ring rows, CT
rows and metrics are bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.core.packets import pack_eligibility, pack_rows
from cilium_tpu.datapath.loader import TPULoader
from cilium_tpu.monitor import ring as jring
from cilium_tpu.testing import fixtures as jfix
from cilium_tpu_torch.datapath.loader import TorchLoader
from cilium_tpu_torch.monitor import ring as tring
from cilium_tpu_torch.testing import fixtures as tfix

torch.set_num_threads(1)

CAP = 1 << 12
K, B = 4, 256
PROXY = np.array([10000], np.uint32)


def _world():
    w = tfix.build_world(256, 8, ct_capacity=CAP, n_v6=16, device="cpu")
    jw = jfix.build_world(256, 8, ct_capacity=CAP, n_v6=16)
    return w, jw


def _loaders(w, jw):
    tl = TorchLoader(ct_capacity=CAP, device="cpu")
    jl = TPULoader(ct_capacity=CAP)
    eps = {0: 0, 1: 0}
    tl.attach(w.policies, w.ipcache, eps, w.row_map)
    jl.attach(jw.policies, jw.ipcache, eps, jw.row_map)
    return tl, jl


def _steps(w, packed, rng):
    """K batches of B rows (IPv4 single-stream for packed, v6 and ICMP
    errors for wide); step K-2 partly masked, step K-1 all masked."""
    if packed:
        pool = tfix.steady_flow_pool(w, B, rng)
        hdrs = np.stack([pool if k == 0 else
                         np.concatenate([
                             tfix.steady_traffic(pool, B // 2, rng),
                             tfix.bench_traffic(w, B - B // 2, rng)])
                         for k in range(K)])
    else:
        pool = tfix.wide_flow_pool(w, B, rng)
        hdrs = np.stack([tfix.wide_traffic(pool, B, rng)
                         for _ in range(K)])
    valid = np.ones((K, B), dtype=bool)
    valid[K - 2] = rng.random(B) < 0.7
    valid[K - 1] = False
    return hdrs, valid


def _drain_all(tl, jl, tr_, jr_):
    got = tring.ring_drain(tr_, PROXY)
    want = jring.ring_drain(jr_, PROXY)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(tl.metrics(), jl.metrics())
    np.testing.assert_array_equal(tl.ct_snapshot(), jl.ct_snapshot())
    return got


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "wide"])
def test_superbatch_matches_jax(packed):
    w, jw = _world()
    tl, jl = _loaders(w, jw)
    rng = np.random.default_rng(4 + packed)
    tr_ = tring.EventRing.create(CAP, "cpu")
    jr_ = jring.EventRing.create(CAP)
    for rep, bid0 in enumerate((8190, 3)):  # ids wrap past the 13 bits
        hdrs, valid = _steps(w, packed, rng)
        now = 100 + 10 * rep
        kw = dict(trace_sample=64, valid=valid, packed=packed)
        if packed:
            metas = [pack_eligibility(h) for h in hdrs]
            assert all(m[0] for m in metas)
            rows = np.stack([pack_rows(h) for h in hdrs])
            kw.update(eps=np.array([m[1] for m in metas]),
                      dirns=np.array([m[2] for m in metas]))
        else:
            rows = hdrs
        tr_, trm = tl.serve_superbatch(tr_, rows, now, bid0,
                                       proxy_ports=PROXY, **kw)
        jr_, _ = jl.serve_superbatch(jr_, rows, now, bid0,
                                     proxy_ports=jnp.asarray(PROXY), **kw)
        assert trm is w.row_map
    rows, total, lost = _drain_all(tl, jl, tr_, jr_)
    assert total > 0 and lost == 0
    assert set(np.unique(rows[:, tring.COL_BATCH])) <= {
        8190, 8191, 0, 3, 4, 5}  # no event from an all-false step
    assert tl.metrics().sum() == jl.metrics().sum() > 0


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "wide"])
def test_superbatch_equals_sequential_steps(packed):
    """One superbatch == K sequential single-batch calls with batch ids
    bid0 + k, the last under an all-false mask."""
    w, _jw = _world()
    rng = np.random.default_rng(9)
    hdrs, valid = _steps(w, packed, rng)
    loaders = [TorchLoader(ct_capacity=CAP, device="cpu") for _ in "ab"]
    for l in loaders:
        l.attach(w.policies, w.ipcache, {0: 0}, w.row_map)
    rings = [tring.EventRing.create(CAP, "cpu") for _ in "ab"]
    if packed:
        metas = [pack_eligibility(h) for h in hdrs]
        rows = np.stack([pack_rows(h) for h in hdrs])
        rings[0], _ = loaders[0].serve_superbatch(
            rings[0], rows, 100, 40, eps=[m[1] for m in metas],
            dirns=[m[2] for m in metas], valid=valid, packed=True)
        for k in range(K):
            rings[1], _ = loaders[1].serve_packed(
                rings[1], rows[k], 100, 40 + k, metas[k][1], metas[k][2],
                valid=valid[k])
    else:
        rings[0], _ = loaders[0].serve_superbatch(rings[0], hdrs, 100, 40,
                                                  valid=valid)
        for k in range(K):
            rings[1], _ = loaders[1].serve(rings[1], hdrs[k], 100, 40 + k,
                                           valid=valid[k])
    got = [tring.ring_drain(r) for r in rings]
    np.testing.assert_array_equal(got[0][0], got[1][0])
    assert got[0][1:] == got[1][1:]
    np.testing.assert_array_equal(loaders[0].metrics(),
                                  loaders[1].metrics())
    np.testing.assert_array_equal(loaders[0].ct_snapshot(),
                                  loaders[1].ct_snapshot())


def test_superbatch_requires_valid_masks():
    w, _jw = _world()
    tl = TorchLoader(ct_capacity=CAP, device="cpu")
    tl.attach(w.policies, w.ipcache, {0: 0}, w.row_map)
    ring = tring.EventRing.create(CAP, "cpu")
    hdrs = np.zeros((2, 8, 16), np.uint32)
    with pytest.raises(ValueError, match="valid masks"):
        tl.serve_superbatch(ring, hdrs, 100, 0)
