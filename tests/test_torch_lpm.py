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
