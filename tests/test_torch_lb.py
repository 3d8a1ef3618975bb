"""Service LB port parity: cilium_tpu_torch.service (Maglev, the
ServiceManager, lb_stage / lb6_stage) and cilium_tpu_torch.k8s.watchers
ServiceWatcher against the JAX package's, on the same inputs.

The JAX stages run on the CPU (conftest pins JAX_PLATFORMS=cpu); the
port runs its plain PyTorch versions, the kernels' yardstick on the
card.  Every output is an integer, so the tolerance is exact equality:
Maglev tables, compiled tensors, rewritten rows, hit and no-backend
masks.  Batches have one shape (B rows) and the stage tests one
service world, so the JAX side compiles each stage once.
"""

import ipaddress

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.k8s.watchers import ServiceWatcher as JWatcher
from cilium_tpu.service import ServiceManager as JManager
from cilium_tpu.service import lb6_stage_jit, lb_stage_jit
from cilium_tpu.service import maglev_table as jmaglev
from cilium_tpu_torch import u32
from cilium_tpu_torch.core.packets import (COL_DPORT, COL_DST_IP0,
                                           COL_DST_IP3, COL_FAMILY,
                                           COL_PROTO, COL_SPORT,
                                           COL_SRC_IP0, COL_SRC_IP3, N_COLS)
from cilium_tpu_torch.k8s.watchers import ServiceWatcher
from cilium_tpu_torch.service import (M_DEFAULT, ServiceManager, lb4_index,
                                      lb6_index, lb6_index_hash, lb6_stage,
                                      lb_stage, maglev_table)

torch.set_num_threads(1)

B = 256  # every batch holds this many rows
M = 2039  # a smaller prime for the stage tests' Maglev tables


def _ip(s):
    return int(ipaddress.IPv4Address(s))


MAGLEV_CASES = {
    "plain": ([f"10.0.0.{i}:80" for i in range(5)], None, M),
    "weighted": ([f"10.0.0.{i}:80" for i in range(3)], [1, 2, 3], M),
    "zero-weight": ([f"10.0.0.{i}:80" for i in range(3)], [1, 0, 1], M),
    "all-drained": (["10.0.0.1:80", "10.0.0.2:80"], [0, 0], M),
    "huge-weights": (["10.0.0.1:80", "10.0.0.2:80"], [30000, 10000], M),
    "one-backend": (["10.0.0.1:80"], None, M),
    "one-live-of-three": ([f"10.0.0.{i}:80" for i in range(3)], [0, 5, 0],
                          M_DEFAULT),
    "empty": ([], None, M),
    "default-size": (["10.1.0.1:8080", "10.1.0.2:8080"], None, M_DEFAULT),
    "v6-keys": (["fd00:1::1:8080", "fd00:1::2:8080", "fd00:1::3:8080"],
                [2, 1, 1], 1021),
}


@pytest.mark.parametrize("case", sorted(MAGLEV_CASES))
def test_maglev_table_matches_jax(case):
    keys, weights, m = MAGLEV_CASES[case]
    got = maglev_table(keys, m, weights=weights)
    want = jmaglev(keys, m, weights=weights)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_maglev_table_rejects_bad_weights_like_jax():
    for weights in ([1], [1, -1]):
        for fn in (maglev_table, jmaglev):
            with pytest.raises(ValueError):
                fn(["a:1", "b:2"], M, weights=weights)


def _check_tensors(jt, tt, fields):
    for f in fields:
        np.testing.assert_array_equal(u32.to_numpy(getattr(tt, f)),
                                      np.asarray(getattr(jt, f)).astype(
                                          np.uint32), err_msg=f)
    assert jt.m == tt.m


V4_FIELDS = ("svc_ip", "svc_port", "svc_proto", "maglev", "backend_ip",
             "backend_port", "svc_aff")
V6_FIELDS = ("svc_ip", "svc_port", "svc_proto", "maglev", "backend_ip",
             "backend_port")


def _both(ops, m=M):
    """Apply (method, args, kwargs) ops to a JAX and a port manager."""
    jm, tm = JManager(m=m), ServiceManager(m=m, device="cpu")
    for mgr in (jm, tm):
        for name, args, kw in ops:
            getattr(mgr, name)(*args, **kw)
    return jm, tm


def test_service_manager_tensors_match_jax_after_upserts_and_deletes():
    ops = [
        ("upsert", ("web", "172.16.0.10:80",
                    ["10.0.1.1:8080", "10.0.1.2:8080"]), {}),
        ("upsert", ("dns", "172.16.0.53:53", ["10.0.2.1:5353"]),
         {"protocol": 17, "affinity_timeout": 60}),
        ("upsert", ("empty", "172.16.0.99:80", []), {}),
        ("upsert", ("weighted", "200.1.2.3:443",
                    ["10.0.3.1:443", "10.0.3.2:443", "10.0.3.3:443"]),
         {"weights": [3, 0, 1]}),
        ("upsert", ("web6", "[fd00::10]:80",
                    ["fd00:1::1:8080", "10.0.1.1:8080", "fd00:1::2:8080"]),
         {}),
        ("upsert", ("empty6", "fd00::11:80", ["10.0.1.1:8080"]), {}),
    ]
    jm, tm = _both(ops)
    _check_tensors(jm.tensors(), tm.tensors(), V4_FIELDS)
    _check_tensors(jm.tensors6(), tm.tensors6(), V6_FIELDS)
    assert jm.version == tm.version and len(jm) == len(tm)
    assert jm.backend_set() == tm.backend_set()
    assert jm.any_affinity == tm.any_affinity
    assert ([s.to_dict() for s in jm.list()]
            == [s.to_dict() for s in tm.list()])
    # a backend leaves, a service goes, one changes only its weights:
    # the recompile keeps the unchanged services' Maglev rows
    more = [("upsert", ("web", "172.16.0.10:80", ["10.0.1.2:8080"]), {}),
            ("delete", ("dns",), {}),
            ("upsert", ("weighted", "200.1.2.3:443",
                        ["10.0.3.1:443", "10.0.3.2:443", "10.0.3.3:443"]),
             {"weights": [1, 1, 1]}),
            ("delete", ("web6",), {}), ("delete", ("empty6",), {}),
            ("delete", ("nothing",), {})]
    for mgr in (jm, tm):
        for name, args, kw in more:
            getattr(mgr, name)(*args, **kw)
    _check_tensors(jm.tensors(), tm.tensors(), V4_FIELDS)
    assert jm.tensors6() is None and tm.tensors6() is None
    assert jm.version == tm.version
    assert jm.any_affinity == tm.any_affinity is False
    # no service at all: one all-miss frontend row on both sides
    for mgr in (jm, tm):
        for s in list(mgr.list()):
            mgr.delete(s.name)
    _check_tensors(jm.tensors(), tm.tensors(), V4_FIELDS)


def test_service_manager_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServiceManager()


def _stage_world():
    """One service world for the stage tests: duplicate frontends (the
    lower name wins), a UDP service, an empty and a drained one, VIPs
    and backends above 2^31, v6 frontends with mixed-family backends."""
    ops = [("upsert", ("a-web", "172.16.0.10:80",
                       ["10.0.1.1:8080", "10.0.1.2:8080", "10.0.1.3:8080"]),
            {}),
           ("upsert", ("b-web-dup", "172.16.0.10:80", ["10.0.9.9:1"]), {}),
           ("upsert", ("dns", "172.16.0.53:53", ["10.0.2.1:5353"]),
            {"protocol": 17}),
           ("upsert", ("empty", "172.16.0.99:80", []), {}),
           ("upsert", ("drained", "172.16.0.98:80", ["10.0.4.1:80"]),
            {"weights": [0]}),
           ("upsert", ("high", "250.0.0.1:443",
                       ["200.0.0.1:443", "200.0.0.2:8443"]), {}),
           ("upsert", ("web6", "[fd00::10]:80",
                       ["fd00:1::1:8080", "fd00:1::2:8080", "10.0.1.1:80"]),
            {}),
           ("upsert", ("web6-dup", "[fd00::10]:80", ["fd00:9::9:1"]), {}),
           ("upsert", ("empty6", "[fd00::11]:443", ["10.0.1.1:80"]), {})]
    return _both(ops)


def _stage_rows(rng):
    v4_dsts = ["172.16.0.10", "172.16.0.53", "172.16.0.99", "172.16.0.98",
               "250.0.0.1", "10.0.1.1", "8.8.8.8"]
    rows = np.zeros((B, N_COLS), np.uint32)
    rows[:, COL_SRC_IP3] = rng.integers(0, 1 << 32, B, dtype=np.uint64)
    rows[:, COL_SPORT] = rng.integers(1024, 65536, B)
    rows[:, COL_DST_IP3] = [_ip(x) for x in rng.choice(v4_dsts, B)]
    rows[:, COL_DPORT] = rng.choice([80, 443, 53, 8080], B)
    rows[:, COL_PROTO] = rng.choice([6, 6, 17, 132], B)
    rows[:, COL_FAMILY] = rng.choice([4, 4, 4, 6, 0], B)
    six = rows[:, COL_FAMILY] == 6
    k = int(six.sum())
    rows[six, COL_SRC_IP0:COL_SRC_IP0 + 4] = rng.integers(
        0, 1 << 32, (k, 4), dtype=np.uint64)
    vip = int(ipaddress.IPv6Address("fd00::10"))
    rows[six, COL_DST_IP0:COL_DST_IP0 + 3] = [vip >> 96 & 0xFFFFFFFF,
                                              vip >> 64 & 0xFFFFFFFF,
                                              vip >> 32 & 0xFFFFFFFF]
    rows[six, COL_DST_IP3] = (vip & 0xFFFFFFFF) + rng.integers(0, 3, k)
    # rows for the empty and drained frontends and for live ones, v4
    # and v6
    for i, (fam, dst, port) in enumerate([(4, "172.16.0.99", 80),
                                          (4, "172.16.0.98", 80),
                                          (6, "fd00::11", 443),
                                          (4, "172.16.0.10", 80),
                                          (4, "250.0.0.1", 443),
                                          (6, "fd00::10", 80)]):
        rows[10 + i, COL_FAMILY], rows[10 + i, COL_PROTO] = fam, 6
        rows[10 + i, COL_DST_IP0:COL_DST_IP0 + 4] = _words(dst)
        rows[10 + i, COL_DPORT] = port
    # the same flow twice in a batch
    rows[B // 2:B // 2 + 16] = rows[:16]
    return rows


def _words(ip):
    n = int(ipaddress.ip_address(ip))
    return [n >> 96 & 0xFFFFFFFF, n >> 64 & 0xFFFFFFFF, n >> 32 & 0xFFFFFFFF,
            n & 0xFFFFFFFF]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("family", [4, 6])
def test_lb_stages_match_jax(family, seed):
    jm, tm = _stage_world()
    rows = _stage_rows(np.random.default_rng(seed))
    if family == 4:
        want = lb_stage_jit(jm.tensors(), jnp.asarray(rows))
        got = lb_stage(tm.tensors(), u32.from_numpy(rows, "cpu"))
    else:
        want = lb6_stage_jit(jm.tensors6(), jnp.asarray(rows))
        got = lb6_stage(tm.tensors6(), u32.from_numpy(rows, "cpu"))
    np.testing.assert_array_equal(u32.to_numpy(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # the branches the batch must reach
    assert got[1].any() and got[2].any()
    changed = (u32.to_numpy(got[0]) != rows).any(axis=1)
    np.testing.assert_array_equal(changed, got[1].numpy())


def _probe6(index, keys, key):
    """K16's probe (``csrc/lb.cuh`` ``lb_find6``) over host copies: the
    frontend of the first slot from ``key``'s home whose frontend has
    ``key``'s words, -1 at an empty slot."""
    mask = len(index) - 1
    h = int(lb6_index_hash(key[None])[0]) & mask
    while index[h] >= 0:
        if (keys[index[h]] == key).all():
            return int(index[h])
        h = (h + 1) & mask
    return -1


def _lowest(keys, key):
    hit = np.flatnonzero((keys == key).all(axis=1))
    return int(hit[0]) if len(hit) else -1


def _index_keys(case, rng):
    """[S, 6] u32 v6 frontend keys (address words, port, protocol)."""
    def rand(n):
        k = rng.integers(0, 1 << 32, (n, 6), dtype=np.uint64).astype(
            np.uint32)
        k[:, 4] = rng.choice([53, 80, 443, 8080], n)
        k[:, 5] = rng.choice([6, 17], n)
        return k

    if case == "none":
        return np.zeros((0, 6), np.uint32)
    if case == "random":
        return rand(300)
    if case == "duplicates":  # a third name a key already named
        k = rand(300)
        dup = np.flatnonzero(rng.random(300) < 0.33)
        dup = dup[dup > 0]
        k[dup] = k[rng.integers(0, dup)]
        return k
    if case == "one-vip":  # every frontend on one address
        k = rand(512)
        k[:, :4] = k[0, :4]
        k[:, 4] = rng.integers(1, 1024, 512)
        return k
    # "crowded": 64 keys whose home is one of the last two of the 128
    # slots, so their probes run long and wrap past the end
    k = rand(20000)
    home = lb6_index_hash(k) & np.uint32(127)
    return k[home >= 126][:64]


@pytest.mark.parametrize("case", ["random", "duplicates", "one-vip",
                                  "crowded", "none"])
def test_lb6_index_probe_finds_the_lowest_matching_frontend(case):
    """The host-built v6 index K16 probes: a power of two of slots at
    least twice the frontends, each distinct key in exactly one slot,
    at its lowest frontend; the probe finds, for every key of the
    frontends and for near misses (another port, protocol or last
    address word) and random keys, the lowest matching frontend, as a
    brute-force scan does, or none."""
    rng = np.random.default_rng(7)
    keys = _index_keys(case, rng)
    s = len(keys)
    if case == "crowded":
        assert s == 64
    index = lb6_index(keys[:, :4], keys[:, 4], keys[:, 5])
    cap = len(index)
    assert index.dtype == np.int32 and cap & (cap - 1) == 0
    assert cap >= max(2, 2 * s)
    held = index[index >= 0]
    distinct = {bytes(k) for k in keys}
    assert len(held) == len(set(held.tolist())) == len(distinct)
    for q in held:
        assert _lowest(keys, keys[q]) == q
    near = keys.copy()
    if s:
        near[0::3, 4] += 1
        near[1::3, 5] ^= 23
        near[2::3, 3] += 1
    queries = np.concatenate([keys, near, _index_keys("random", rng)])
    found = 0
    for key in queries:
        want = _lowest(keys, key)
        assert _probe6(index, keys, key) == want
        found += want >= 0
    assert found >= s


def test_lb6_index_hash_wraps_as_u32_arithmetic():
    """The host's vectorised ``lb6_index_hash`` wraps as u32 arithmetic
    does: it equals the same steps on Python integers masked to 32 bits.
    Whether the host's index and the kernel's probe agree (the constants'
    one source is ``csrc/lb.cuh`` ``lb6_index_hash``) shows on the card,
    where K16 against ``lb6_stage_plain`` misses every frontend whose
    home slot differs."""
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 1 << 32, (64, 6), dtype=np.uint64).astype(
        np.uint32)
    keys[0] = 0xFFFFFFFF
    mask = 0xFFFFFFFF
    for key, got in zip(keys.tolist(), lb6_index_hash(keys).tolist()):
        h = 0
        for w, c in zip(key, (0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35,
                              0x27D4EB2F, 0x165667B1, 1)):
            h ^= (w * c) & mask
        h ^= h >> 16
        h = (h * 0x7FEB352D) & mask
        assert got == h ^ (h >> 15)


@pytest.mark.parametrize("seed", [0, 1])
def test_lb6_tensors_from_jax_carry_the_index_and_match_jax(seed):
    """JAX ``LBTensors6`` leaves through ``convert.lb6_tensors_from_numpy``
    get the index the ServiceManager builds (two names share a VIP:port:
    the lower is indexed); ``lb6_stage`` on them matches the JAX
    package, and the index's probe picks the frontend the plain
    version's [N, S] compare picks for every v6 row."""
    from cilium_tpu_torch import convert

    jm, tm = _stage_world()
    jt6 = jm.tensors6()
    mine = convert.lb6_tensors_from_numpy(
        {**{f: np.asarray(getattr(jt6, f)) for f in (
            "svc_ip", "svc_port", "svc_proto", "maglev", "backend_ip",
            "backend_port")}, "m": jt6.m}, device="cpu")
    assert torch.equal(mine.index, tm.tensors6().index)
    keys = np.concatenate([u32.to_numpy(mine.svc_ip),
                           u32.to_numpy(mine.svc_port)[:, None],
                           u32.to_numpy(mine.svc_proto)[:, None]], 1)
    assert len({bytes(k) for k in keys}) < len(keys)  # a shared key
    rows = _stage_rows(np.random.default_rng(seed))
    want = lb6_stage_jit(jt6, jnp.asarray(rows))
    got = lb6_stage(mine, u32.from_numpy(rows, "cpu"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(u32.to_numpy(g) if g.dtype
                                      == torch.int32 else g.numpy(),
                                      np.asarray(w))
    index = mine.index.numpy()
    six = np.flatnonzero(rows[:, COL_FAMILY] == 6)
    hits = 0
    for i in six:
        key = rows[i, [COL_DST_IP0, COL_DST_IP0 + 1, COL_DST_IP0 + 2,
                       COL_DST_IP3, COL_DPORT, COL_PROTO]]
        svc = _probe6(index, keys, key)
        assert svc == _lowest(keys, key)
        hits += svc >= 0
    assert hits and got[1].any()


def _probe4(index, ip, port, proto):
    """K15's probe (``csrc/lb.cuh`` ``lb_find4``) over a host copy of the
    v4 index: from the key's home (``lb6_index_hash`` with the address in
    word 3), the frontend of the first slot holding the key, -1 at an
    empty slot."""
    mask = len(index) - 1
    u = index.view(np.uint32)
    key = np.array([[0, 0, 0, ip, port, proto]], np.uint32)
    h = int(lb6_index_hash(key)[0]) & mask
    while index[h, 3] >= 0:
        if (u[h, :3] == (ip, port, proto)).all():
            return int(index[h, 3])
        h = (h + 1) & mask
    return -1


def _v4_keys(case, rng):
    """[S, 3] u32 v4 frontend keys (address, port, protocol)."""
    if case != "crowded":
        return np.ascontiguousarray(_index_keys(case, rng)[:, 3:])
    # 64 keys whose home is one of the last two of the 128 slots
    k = np.concatenate([_index_keys("random", rng) for _ in range(80)])
    k[:, :3] = 0
    home = lb6_index_hash(k) & np.uint32(127)
    return np.ascontiguousarray(k[home >= 126][:64, 3:])


@pytest.mark.parametrize("case", ["random", "duplicates", "one-vip",
                                  "crowded", "none"])
def test_lb4_index_probe_finds_the_lowest_matching_frontend(case):
    """The host-built v4 index K15 probes: a power of two of 16-byte
    slots at least twice the frontends, each distinct key in exactly one
    slot with its lowest frontend, the rest empty (-1); the probe finds,
    for every key of the frontends, for near misses (another port,
    protocol or address) and for random keys, the lowest matching
    frontend, as a brute-force scan does, or none."""
    rng = np.random.default_rng(11)
    keys = _v4_keys(case, rng)
    s = len(keys)
    if case == "crowded":
        assert s == 64
    index = lb4_index(keys[:, 0], keys[:, 1], keys[:, 2])
    cap = len(index)
    assert index.dtype == np.int32 and index.shape[1] == 4
    assert cap & (cap - 1) == 0 and cap >= max(2, 2 * s)
    held = index[index[:, 3] >= 0]
    assert len(held) == len({bytes(k) for k in keys})
    assert (index[index[:, 3] < 0, :3] == 0).all()
    for slot in held:
        assert _lowest(keys, slot[:3].view(np.uint32)) == slot[3]
    near = keys.copy()
    if s:
        near[0::3, 1] += 1
        near[1::3, 2] ^= 23
        near[2::3, 0] += 1
    queries = np.concatenate([keys, near, _v4_keys("random", rng)])
    found = 0
    for key in queries:
        want = _lowest(keys, key)
        assert _probe4(index, *key.tolist()) == want
        found += want >= 0
    assert found >= s


@pytest.mark.parametrize("seed", [0, 1])
def test_lb_tensors_from_jax_carry_the_v4_index_and_match_jax(seed):
    """JAX ``LBTensors`` leaves through ``convert.lb_tensors_from_numpy``
    get the index the ServiceManager builds (two names share a VIP:port:
    the lower is indexed); ``lb_stage`` on them matches the JAX package,
    and the index's probe picks the frontend the plain version's [N, S]
    compare picks for every v4 row."""
    from cilium_tpu_torch import convert

    jm, tm = _stage_world()
    jt = jm.tensors()
    mine = convert.lb_tensors_from_numpy(
        {**{f: np.asarray(getattr(jt, f)) for f in V4_FIELDS}, "m": jt.m},
        device="cpu")
    assert torch.equal(mine.index, tm.tensors().index)
    keys = np.stack([u32.to_numpy(mine.svc_ip), u32.to_numpy(mine.svc_port),
                     u32.to_numpy(mine.svc_proto)], 1)
    assert len({bytes(k) for k in keys}) < len(keys)  # a shared key
    rows = _stage_rows(np.random.default_rng(seed))
    want = lb_stage_jit(jt, jnp.asarray(rows))
    got = lb_stage(mine, u32.from_numpy(rows, "cpu"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(u32.to_numpy(g) if g.dtype
                                      == torch.int32 else g.numpy(),
                                      np.asarray(w))
    index = mine.index.numpy()
    hits = 0
    for i in np.flatnonzero(rows[:, COL_FAMILY] == 4):
        key = rows[i, [COL_DST_IP3, COL_DPORT, COL_PROTO]]
        svc = _probe4(index, *key.tolist())
        assert svc == _lowest(keys, key)
        hits += svc >= 0
    assert hits and got[1].any()


def test_service_manager_rebuilds_the_v4_index_after_upserts_and_deletes():
    """Every compile rebuilds the v4 index from the frontends it
    compiles: after upserts, a shared VIP:port, a port change and
    deletes, each frontend key's probe finds its lowest frontend and a
    deleted frontend's key finds none."""
    tm = ServiceManager(m=M, device="cpu")
    tm.upsert("a", "172.16.0.10:80", ["10.0.1.1:8080"])
    tm.upsert("b", "172.16.0.11:53", ["10.0.1.2:53"], protocol=17)
    tm.upsert("c", "172.16.0.10:80", ["10.0.1.3:8080"])
    first = tm.tensors()
    tm.upsert("b", "172.16.0.11:5353", ["10.0.1.2:53"], protocol=17)
    tm.delete("a")
    tm.upsert("d", "172.16.0.12:443", [])
    t = tm.tensors()
    assert t is not first
    keys = np.stack([u32.to_numpy(t.svc_ip), u32.to_numpy(t.svc_port),
                     u32.to_numpy(t.svc_proto)], 1)
    np.testing.assert_array_equal(
        t.index.numpy(), lb4_index(keys[:, 0], keys[:, 1], keys[:, 2]))
    for key in keys:
        assert _probe4(t.index.numpy(), *key.tolist()) == _lowest(keys, key)
    assert _probe4(t.index.numpy(), _ip("172.16.0.11"), 53, 17) == -1
    assert _probe4(first.index.numpy(), _ip("172.16.0.11"), 53, 17) >= 0


def test_lb_stage_lowest_name_wins_a_shared_frontend():
    _jm, tm = _stage_world()
    rows = _stage_rows(np.random.default_rng(5))
    rows[:, COL_FAMILY], rows[:, COL_PROTO] = 4, 6
    rows[:, COL_DST_IP3], rows[:, COL_DPORT] = _ip("172.16.0.10"), 80
    out, hit, _nobe = lb_stage(tm.tensors(), u32.from_numpy(rows, "cpu"))
    assert bool(hit.all())
    assert set(u32.to_numpy(out)[:, COL_DST_IP3].tolist()) <= {
        _ip("10.0.1.1"), _ip("10.0.1.2"), _ip("10.0.1.3")}


NODE_IP = "192.168.7.7"


def _svc_obj(stype="ClusterIP", node_port=None, external_ips=(),
             lb_ips=(), ext_policy=None, int_policy=None, affinity=False,
             affinity_timeout=None, cluster_ips=None):
    spec = {"type": stype, "clusterIP": "172.20.0.10",
            "ports": [{"port": 80, "protocol": "TCP", "targetPort": 8080,
                       **({"nodePort": node_port} if node_port else {})}]}
    if cluster_ips:
        spec["clusterIPs"] = list(cluster_ips)
    if external_ips:
        spec["externalIPs"] = list(external_ips)
    if ext_policy:
        spec["externalTrafficPolicy"] = ext_policy
    if int_policy:
        spec["internalTrafficPolicy"] = int_policy
    if affinity:
        spec["sessionAffinity"] = "ClientIP"
        if affinity_timeout is not None:
            spec["sessionAffinityConfig"] = {
                "clientIP": {"timeoutSeconds": affinity_timeout}}
    obj = {"metadata": {"name": "web", "namespace": "default"},
           "spec": spec}
    if lb_ips:
        obj["status"] = {"loadBalancer": {
            "ingress": [{"ip": ip} for ip in lb_ips]}}
    return obj


def _eps_obj(ips=("10.0.1.1", "10.0.1.2")):
    return {"metadata": {"name": "web", "namespace": "default"},
            "subsets": [{"addresses": [{"ip": ip} for ip in ips],
                         "ports": [{"port": 8080, "protocol": "TCP"}]}]}


# case -> (watcher kwargs, [(event, object)], the reference's facts)
WATCHER_CASES = {
    "nodeport": ({}, [("service_add", _svc_obj("NodePort", 30080)),
                      ("endpoints_add", _eps_obj())]),
    "nodeport-addresses": (
        {"nodeport_addresses": ("192.168.7.8", "10.44.0.7")},
        [("service_add", _svc_obj("NodePort", 30080)),
         ("endpoints_add", _eps_obj())]),
    "no-node-ip": ({"node_ip": None},
                   [("service_add", _svc_obj("NodePort", 30080)),
                    ("endpoints_add", _eps_obj())]),
    "external-and-lb": ({}, [
        ("service_add", _svc_obj("LoadBalancer", 30080,
                                 external_ips=("198.51.100.5",),
                                 lb_ips=("203.0.113.9",))),
        ("endpoints_add", _eps_obj())]),
    "type-downgrade": ({}, [("service_add", _svc_obj("NodePort", 30080)),
                            ("endpoints_add", _eps_obj()),
                            ("service_update", _svc_obj("ClusterIP"))]),
    "external-local": ({"local": {"10.0.1.1"}}, [
        ("service_add", _svc_obj("NodePort", 30080, ext_policy="Local")),
        ("endpoints_add", _eps_obj())]),
    "internal-local": ({"local": {"10.0.1.2"}}, [
        ("service_add", _svc_obj(int_policy="Local")),
        ("endpoints_add", _eps_obj())]),
    "local-none": ({"local": set()}, [
        ("service_add", _svc_obj("NodePort", 30080, ext_policy="Local")),
        ("endpoints_add", _eps_obj())]),
    "affinity-default": ({}, [("service_add", _svc_obj(affinity=True)),
                              ("endpoints_add", _eps_obj())]),
    "affinity-explicit": ({}, [
        ("service_add", _svc_obj(affinity=True, affinity_timeout=60)),
        ("endpoints_add", _eps_obj())]),
    "dual-stack": ({}, [
        ("service_add", _svc_obj(cluster_ips=("172.20.0.10", "fd00::10"))),
        ("endpoints_add", _eps_obj(("10.0.1.1", "fd00:1::1")))]),
    "endpoints-first-then-deleted": ({}, [
        ("endpoints_add", _eps_obj()),
        ("service_add", _svc_obj("NodePort", 30080)),
        ("endpoints_delete", _eps_obj()),
        ("service_delete", _svc_obj())]),
}


def _drive(cls, mgr, kw, events):
    kw = dict(kw)
    local = kw.pop("local", None)
    w = cls(mgr, node_ip=kw.pop("node_ip", NODE_IP),
            local_ips=lambda: set(local or ()), **kw)
    changed = []
    w.on_change = changed.append
    for ev, obj in events:
        getattr(w, "on_" + ev)(obj)
    return changed


@pytest.mark.parametrize("case", sorted(WATCHER_CASES))
def test_service_watcher_matches_jax(case):
    kw, events = WATCHER_CASES[case]
    jm, tm = JManager(m=M), ServiceManager(m=M, device="cpu")
    assert (_drive(JWatcher, jm, kw, events)
            == _drive(ServiceWatcher, tm, kw, events))
    assert ([s.to_dict() for s in jm.list()]
            == [s.to_dict() for s in tm.list()])
    assert jm.version == tm.version
    _check_tensors(jm.tensors(), tm.tensors(), V4_FIELDS)
    by_kind = {}
    for s in tm.list():
        by_kind.setdefault(s.kind, []).append(s)
    # the reference tests' own facts, on the port
    if case == "nodeport":
        assert set(by_kind) == {"ClusterIP", "NodePort"}
        assert by_kind["NodePort"][0].frontend_ip == NODE_IP
        assert by_kind["NodePort"][0].frontend_port == 30080
    elif case == "nodeport-addresses":
        assert {s.frontend_ip for s in by_kind["NodePort"]} == {
            NODE_IP, "192.168.7.8", "10.44.0.7"}
    elif case in ("no-node-ip", "type-downgrade"):
        assert set(by_kind) == {"ClusterIP"}
    elif case == "external-and-lb":
        assert set(by_kind) == {"ClusterIP", "NodePort", "ExternalIP",
                                "LoadBalancer"}
    elif case == "external-local":
        assert [b.ip for b in by_kind["NodePort"][0].backends] == ["10.0.1.1"]
        assert len(by_kind["ClusterIP"][0].backends) == 2
    elif case == "internal-local":
        assert [b.ip for b in by_kind["ClusterIP"][0].backends] == [
            "10.0.1.2"]
    elif case == "local-none":
        assert by_kind["NodePort"][0].backends == []
    elif case == "affinity-default":
        assert tm.list()[0].affinity_timeout == 10800
    elif case == "affinity-explicit":
        assert int(tm.tensors().svc_aff[0]) == 60
    elif case == "dual-stack":
        assert {s.frontend_ip for s in by_kind["ClusterIP"]} == {
            "172.20.0.10", "fd00::10"}
        _check_tensors(jm.tensors6(), tm.tensors6(), V6_FIELDS)
    else:
        assert tm.list() == []


def test_service_watcher_peer_views_match_jax():
    jm, tm = JManager(m=M), ServiceManager(m=M, device="cpu")
    ws = [cls(mgr, node_ip=NODE_IP) for cls, mgr in ((JWatcher, jm),
                                                       (ServiceWatcher, tm))]
    svc = _svc_obj()
    svc["metadata"]["labels"] = {"app": "web", "tier": "front"}
    for w in ws:
        w.on_service_add(svc)
        w.on_endpoints_add(_eps_obj())
    assert ws[0].service_peer_ips("default", "web") == ws[1].service_peer_ips(
        "default", "web") == {"172.20.0.10", "10.0.1.1", "10.0.1.2"}
    for sel in ({"matchLabels": {"app": "web"}},
                {"matchExpressions": [{"key": "tier", "operator": "In",
                                       "values": ["front"]}]},
                {"matchExpressions": [{"key": "tier",
                                       "operator": "Bogus"}]}):
        assert ws[0].select_peer_ips(sel) == ws[1].select_peer_ips(sel)
