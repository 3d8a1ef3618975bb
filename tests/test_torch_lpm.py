"""ipcache LPM port parity: cilium_tpu_torch.datapath.lpm against
cilium_tpu.datapath.lpm on the same numpy inputs, bit-exact (plain
PyTorch versions on the CPU; the CUDA kernel is held to them on the
card by chip_smoke.py)."""

import ipaddress

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.datapath import lpm as jlpm
from cilium_tpu_torch import u32
from cilium_tpu_torch.datapath import lpm as tlpm

torch.set_num_threads(1)


def _entries(rng, n_v4=300, n_v6=40):
    ent = {"0.0.0.0/0": 1, "::/0": 1}
    for i in range(n_v4):
        plen = int(rng.choice([8, 12, 16, 20, 24, 28, 32]))
        net = ipaddress.ip_network(
            (int(rng.integers(0, 1 << 32)) & ~((1 << (32 - plen)) - 1), plen))
        ent[str(net)] = 2 + i
    for i in range(n_v6):
        plen = int(rng.choice([32, 48, 64, 96, 128]))
        base = (0x20010DB8 << 96) | (int(rng.integers(0, 1 << 62)) << 32)
        net = ipaddress.ip_network(
            (base & ~((1 << (128 - plen)) - 1), plen))
        ent[str(net)] = 1000 + i
    return ent


def _addresses(rng, ent, n=2048):
    words = np.zeros((n, 4), np.uint32)
    words[:, 3] = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    fam = np.full(n, 4, np.uint32)
    # half the rows inside a known prefix, v6 rows in and out of 2001:db8
    nets = [ipaddress.ip_network(c) for c in ent]
    for i in range(0, n, 2):
        net = nets[int(rng.integers(0, len(nets)))]
        addr = int(net.network_address) + int(
            rng.integers(0, min(net.num_addresses, 1 << 62)))
        if net.version == 4:
            words[i, 3] = addr
        else:
            fam[i] = 6
            words[i] = [(addr >> s) & 0xFFFFFFFF for s in (96, 64, 32, 0)]
    fam[1::8] = 6  # v6 rows whose address matches only ::/0 (or nothing)
    return words, fam


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lookup_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ent = _entries(rng)
    t = jlpm.compile_lpm(ent, default=0)
    words, fam = _addresses(rng, ent)
    want = np.asarray(jlpm.lpm_lookup_jit(jlpm.DeviceLPM.from_tensors(t),
                                          jnp.asarray(words),
                                          jnp.asarray(fam)))
    got = tlpm.lpm_lookup(tlpm.DeviceLPM.from_tensors(t, "cpu"),
                          u32.from_numpy(words, "cpu"),
                          u32.from_numpy(fam, "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)


def test_v4_walk_and_default_on_a_miss():
    t = jlpm.compile_lpm({"10.0.0.0/8": 3, "10.1.0.0/16": 4,
                          "10.1.2.0/24": 5, "10.1.2.3/32": 6}, default=9)
    ips = np.array([0x0A010203, 0x0A010204, 0x0A010304, 0x0A020304,
                    0x0B000000, 0xFFFFFFFF], np.uint32)
    want = np.asarray(jlpm.lookup_v4(jnp.asarray(t.l1), jnp.asarray(t.l2),
                                     jnp.asarray(t.l3), jnp.asarray(ips)))
    d = tlpm.DeviceLPM.from_tensors(t, "cpu")
    got = tlpm.lookup_v4(d.l1, d.l2, d.l3, u32.from_numpy(ips, "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert list(want) == [6, 5, 4, 3, 9, 9]


def test_v6_ties_take_the_first_entry_and_misses_the_default():
    # equal prefix lengths that both match: argmax keeps the first
    # (two spellings of one network are two entries of the same length)
    t = jlpm.compile_lpm({"2001:db8::/32": 7, "2001:0db8::/32": 8,
                          "2001:db8:1::/48": 9, "2001:db8:1:0::/48": 10},
                         default=2)
    words = np.array([[0x20010DB8, 0x00010000, 0, 1],
                      [0x20010DB8, 0x00020000, 0, 1],
                      [0x20020000, 0, 0, 1]], np.uint32)
    want = np.asarray(jlpm.lookup_v6(
        jnp.asarray(t.v6_net), jnp.asarray(t.v6_mask),
        jnp.asarray(t.v6_value), jnp.asarray(t.v6_plen),
        jnp.asarray(words), t.default))
    d = tlpm.DeviceLPM.from_tensors(t, "cpu")
    got = tlpm.lookup_v6(d.v6_net, d.v6_mask, d.v6_value, d.v6_plen,
                         u32.from_numpy(words, "cpu"), d.default)
    np.testing.assert_array_equal(got.numpy(), want)
    assert list(want) == [9, 7, 2]


def test_empty_v6_set_pads_to_the_default():
    t = jlpm.compile_lpm({"10.0.0.0/8": 3}, default=5)
    words = np.array([[0x20010DB8, 0, 0, 1]], np.uint32)
    fam = np.array([6], np.uint32)
    want = np.asarray(jlpm.lpm_lookup_jit(jlpm.DeviceLPM.from_tensors(t),
                                          jnp.asarray(words),
                                          jnp.asarray(fam)))
    got = tlpm.lpm_lookup(tlpm.DeviceLPM.from_tensors(t, "cpu"),
                          u32.from_numpy(words, "cpu"),
                          u32.from_numpy(fam, "cpu"))
    assert got.tolist() == want.tolist() == [5]


def test_compile_and_upsert_match_jax():
    rng = np.random.default_rng(4)
    ent = _entries(rng, n_v4=200, n_v6=20)
    a, b = jlpm.compile_lpm(ent), tlpm.compile_lpm(ent)
    for f in ("l1", "l2", "l3", "v6_net", "v6_mask", "v6_value", "v6_plen"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for cidr in ("10.9.8.7/32", "10.9.8.8/32", "172.16.0.1/32", "10.0.0.0/8"):
        pa, pb = jlpm.lpm_upsert(a, cidr, 77), tlpm.lpm_upsert(b, cidr, 77)
        assert (pa is None) == (pb is None)
        for x, y in zip(pa or [], pb or []):
            assert x[:2] == y[:2]
            np.testing.assert_array_equal(x[2], y[2])
    np.testing.assert_array_equal(a.l3, b.l3)


# -- the v6 TCAM's index (the kernels' probe) ---------------------------


def _probe_index(groups, slots, words, default):
    """K1's and K2's v6 probe (``csrc/lpm.cuh`` ``lpm_v6``) over host
    copies of the index, a row at a time: each group in order, stopping
    once the best plen exceeds the group's largest; the largest plen
    wins, the lowest entry on a tie."""
    cap = len(slots)
    out = []
    for ip in np.asarray(words, np.uint32):
        best, entry, value = -1, 0, default
        for g in range(len(groups)):
            if best > groups[g, 4]:
                break
            key = ip & groups[g, :4].view(np.uint32)
            h = int(tlpm.lpm6_index_hash(key[None], np.array([g]))[0])
            h &= cap - 1
            while slots[h, 4] != tlpm.LPM6_FREE:
                s = slots[h]
                if s[4] == g and (s[:4].view(np.uint32) == key).all():
                    if s[6] > best or (s[6] == best and s[5] < entry):
                        best, entry, value = int(s[6]), int(s[5]), int(s[7])
                    break
                h = (h + 1) & (cap - 1)
        out.append(value if best >= 0 else default)
    return np.asarray(out, np.int32)


def _jax_v6(t, words):
    return np.asarray(jlpm.lookup_v6(
        jnp.asarray(t.v6_net), jnp.asarray(t.v6_mask),
        jnp.asarray(t.v6_value), jnp.asarray(t.v6_plen),
        jnp.asarray(words), t.default))


def _check_index(t, groups, slots):
    """The index's shape rules: groups in descending order of their
    largest plen; a power of two of slots, at least twice the keys;
    each key once, at its best entry."""
    assert groups.dtype == slots.dtype == np.int32
    assert groups.shape[1] == slots.shape[1] == 8
    assert (np.diff(groups[:, 4]) <= 0).all()
    cap = len(slots)
    held = slots[slots[:, 4] != tlpm.LPM6_FREE]
    assert cap & (cap - 1) == 0 and cap >= max(2, 2 * len(held))
    keys = {(int(s[4]), s[:4].tobytes()) for s in held}
    assert len(keys) == len(held)
    for s in held:
        e = int(s[5])
        assert (t.v6_net[e] == s[:4].view(np.uint32)).all()
        assert (t.v6_mask[e] == groups[s[4], :4].view(np.uint32)).all()
        assert t.v6_plen[e] == s[6] and t.v6_value[e] == s[7]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_index_probe_matches_jax_lookup_v6(seed):
    """compile_lpm tables with several prefix lengths, two spellings of
    one network and v6 rows that hit nothing (no ::/0 in odd seeds): the
    probe over the index equals the reference's TCAM scan."""
    rng = np.random.default_rng(seed)
    ent = _entries(rng, n_v4=20, n_v6=60)
    ent.update({"2001:db8:77::/48": 5, "2001:0db8:77:0::/48": 6})
    if seed % 2:
        del ent["::/0"]
    t = jlpm.compile_lpm(ent, default=3)
    words, fam = _addresses(rng, ent, n=512)
    words = words[fam == 6]
    words[::5] = [0x20010DB8, 0x770000, 9, 9]  # the twice-spelled /48
    groups, slots = tlpm.lpm6_index(t.v6_net, t.v6_mask, t.v6_value,
                                    t.v6_plen)
    _check_index(t, groups, slots)
    want = _jax_v6(t, words)
    np.testing.assert_array_equal(
        _probe_index(groups, slots, words, t.default), want)
    assert (want == 5).any() and (want == 3).any() == bool(seed % 2)


def test_index_of_the_padded_empty_table_takes_the_default():
    t = jlpm.compile_lpm({"10.0.0.0/8": 3}, default=5)
    groups, slots = tlpm.lpm6_index(t.v6_net, t.v6_mask, t.v6_value,
                                    t.v6_plen)
    assert groups.shape == (0, 8) and slots.shape == (2, 8)
    assert (slots[:, 4] == tlpm.LPM6_FREE).all()
    words = np.array([[0x20010DB8, 0, 0, 1], [0, 0, 0, 0]], np.uint32)
    assert _probe_index(groups, slots, words, 5).tolist() == [5, 5] \
        == _jax_v6(t, words).tolist()


def _hand_built(case):
    """Hand-built v6 arrays the compiler never makes: a non-prefix mask;
    a net with bits outside its mask (never matches); a plen of -1
    (never wins); one key under two entries of different plens; and two
    masks of the same largest plen where the lower entry sits in the
    group probed second (the early stop must not skip it)."""
    F = 0xFFFFFFFF
    rows = {
        # (net, mask, value, plen)
        "non-prefix": [([0x20010DB8, 0, 0, 0x00000007], [F, 0, 0, 0xF], 11,
                        64),
                       ([0x20010DB8, 0, 0, 0], [F, 0, 0, 0], 12, 32)],
        "outside-mask": [([0x20010DB8, 0, 1, 0], [F, 0, 0, 0], 21, 128),
                         ([0, 0, 0, 0], [0, 0, 0, 0], 22, 0)],
        "negative-plen": [([0x20010DB8, 0, 0, 0], [F, 0, 0, 0], 31, -1),
                          ([0x20010DB8, 0, 0, 0], [F, F, 0, 0], 32, -1)],
        "same-key": [([0x20010DB8, 0, 0, 0], [F, 0, 0, 0], 41, 40),
                     ([0x20010DB8, 0, 0, 0], [F, 0, 0, 0], 42, 90),
                     ([0x20010DB8, 0, 0, 0], [F, 0, 0, 0], 43, 90),
                     ([0, 0, 0, 0], [0, 0, 0, 0], 44, 0)],
        "equal-top": [([0x20010DB8, 0, 0, 0], [F, 0xFFFF0000, 0, 0], 51, 64),
                      ([0x20010DB8, 0, 0, 0], [F, 0, 0, 0], 52, 64),
                      ([0x20010DB8, 0x10000, 0, 0], [F, F, 0, 0], 53, 64)],
    }[case]
    net, mask, value, plen = zip(*rows)
    return jlpm.LPMTensors(
        l1=np.zeros(1 << 16, np.int32), l2=np.zeros((8, 256), np.int32),
        l3=np.zeros((8, 256), np.int32), v6_net=np.array(net, np.uint32),
        v6_mask=np.array(mask, np.uint32),
        v6_value=np.array(value, np.int32),
        v6_plen=np.array(plen, np.int32), default=9)


@pytest.mark.parametrize("case", ["non-prefix", "outside-mask",
                                  "negative-plen", "same-key", "equal-top"])
def test_index_probe_matches_jax_on_hand_built_tensors(case):
    rng = np.random.default_rng(5)
    t = _hand_built(case)
    groups, slots = tlpm.lpm6_index(t.v6_net, t.v6_mask, t.v6_value,
                                    t.v6_plen)
    _check_index(t, groups, slots)
    words = np.concatenate([
        (t.v6_net[rng.integers(0, len(t.v6_net), 64)]
         | (rng.integers(0, 1 << 32, (64, 4), dtype=np.uint64).astype(
             np.uint32) & ~t.v6_mask[rng.integers(0, len(t.v6_net), 64)])),
        rng.integers(0, 1 << 32, (16, 4), dtype=np.uint64).astype(np.uint32),
        t.v6_net, t.v6_net | np.uint32(0x10)])
    want = _jax_v6(t, words)
    np.testing.assert_array_equal(
        _probe_index(groups, slots, words, t.default), want)
    held = set(slots[slots[:, 4] != tlpm.LPM6_FREE, 5].tolist())
    if case == "outside-mask":
        assert held == {1}  # the net with a bit outside its mask is left out
    if case == "negative-plen":
        assert groups.shape[0] == 0 and (want == 9).all()
    if case == "same-key":
        assert held == {1, 3}  # plen 90's lowest entry, and ::/0
        assert (want == 42).any()
    if case == "equal-top":
        assert (want == 51).any()


def test_lpm6_index_hash_wraps_as_u32_arithmetic():
    """The host's vectorised hash equals the same steps on Python
    integers masked to 32 bits (the kernel's constants are in
    ``csrc/lpm.cuh``; a disagreement shows on the card as K2 against
    its plain version)."""
    rng = np.random.default_rng(9)
    words = rng.integers(0, 1 << 32, (64, 4), dtype=np.uint64).astype(
        np.uint32)
    words[0] = 0xFFFFFFFF
    group = rng.integers(0, 200, 64)
    group[0] = 0xFFFF
    mask = 0xFFFFFFFF
    got = tlpm.lpm6_index_hash(words, group).tolist()
    for w, g, h_got in zip(words.tolist(), group.tolist(), got):
        h = (g * 0x165667B1) & mask
        for x, c in zip(w, (0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35,
                            0x27D4EB2F)):
            h ^= (x * c) & mask
        h ^= h >> 16
        h = (h * 0x7FEB352D) & mask
        assert h_got == h ^ (h >> 15)


@pytest.mark.parametrize("seed", [0, 1])
def test_device_lpm_and_convert_carry_the_index(seed):
    """``DeviceLPM.from_tensors`` and ``convert.ipcache_from_numpy`` (the
    JAX leaves by field name) both carry the index of their v6 arrays;
    the lookup through either equals the JAX one, and so does the probe
    over the index they carry."""
    from cilium_tpu_torch import convert

    rng = np.random.default_rng(seed)
    ent = _entries(rng, n_v4=100, n_v6=30)
    t = jlpm.compile_lpm(ent, default=0)
    jd = jlpm.DeviceLPM.from_tensors(t)
    words, fam = _addresses(rng, ent, n=256)
    want = np.asarray(jlpm.lpm_lookup_jit(jd, jnp.asarray(words),
                                          jnp.asarray(fam)))
    groups, slots = tlpm.lpm6_index(t.v6_net, t.v6_mask, t.v6_value,
                                    t.v6_plen)
    leaves = {f: (getattr(jd, f) if f == "default" else
                  np.asarray(getattr(jd, f)))
              for f in jd.__dataclass_fields__}
    for d in (tlpm.DeviceLPM.from_tensors(t, "cpu"),
              convert.ipcache_from_numpy(leaves, "cpu")):
        np.testing.assert_array_equal(d.v6_groups.numpy(), groups)
        np.testing.assert_array_equal(d.v6_index.numpy(), slots)
        got = tlpm.lpm_lookup(d, u32.from_numpy(words, "cpu"),
                              u32.from_numpy(fam, "cpu"))
        np.testing.assert_array_equal(got.numpy(), want)
        six = fam == 6
        np.testing.assert_array_equal(
            _probe_index(d.v6_groups.numpy(), d.v6_index.numpy(),
                         words[six], d.default), want[six])
