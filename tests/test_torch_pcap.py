"""The port's capture path against the JAX package's: ``core/pcap.py``
(a copy that parses in Python), ``core/packets.py`` ``HeaderBatch`` /
``make_batch``, and the label sidecars of ``ml/evaluate.py``.  The same
files and numpy rows go through both packages; every comparison is
exact (bytes, u32 words, float32 labels).

Mirrors of the reference's ``tests/test_anomaly_eval.py``
``test_csv_label_loader`` and ``test_npz_sidecar_restores_ingest_metadata``
and ``tests/test_real_pcap_eval.py`` ``test_csv_labels_align_through_the_
pcap_reader`` and ``test_main_gates_on_env_files`` run through the port.
"""

import os
import struct

import numpy as np
import pytest

from cilium_tpu import native as jnative
from cilium_tpu.core import packets as jpk
from cilium_tpu.core import pcap as jpcap
from cilium_tpu.ml import evaluate as jeval
from cilium_tpu.testing import fixtures as jfix
from cilium_tpu_torch.core import packets as tpk
from cilium_tpu_torch.core import pcap as tpcap
from cilium_tpu_torch.ml import evaluate as teval
from cilium_tpu_torch.testing import fixtures as tfix

DATA = os.path.join(os.path.dirname(__file__), "data")
PCAP = os.path.join(DATA, "golden_cic.pcap")
CSV = os.path.join(DATA, "golden_cic.csv")


def _rows(rng, n):
    """Header rows of every shape write_pcap emits: IPv4 and IPv6,
    TCP/UDP/SCTP/ICMP/ICMPv6 and a portless protocol, lengths below and
    above the headers' own."""
    rows = np.zeros((n, tpk.N_COLS), np.uint32)
    v6 = rng.random(n) < 0.3
    rows[:, tpk.COL_SRC_IP3] = rng.integers(1, 1 << 32, n, dtype=np.uint64)
    rows[:, tpk.COL_DST_IP3] = rng.integers(1, 1 << 32, n, dtype=np.uint64)
    for c in (0, 1, 2, 4, 5, 6):
        rows[v6, c] = rng.integers(0, 1 << 32, int(v6.sum()),
                                   dtype=np.uint64)
    rows[v6, 0] |= 0x20010000
    rows[:, tpk.COL_FAMILY] = np.where(v6, 6, 4)
    proto = rng.choice(np.array([6, 6, 17, 132, 1, 47], np.uint32), n)
    proto[v6 & (proto == 1)] = 58
    rows[:, tpk.COL_PROTO] = proto
    ports = np.isin(proto, (6, 17, 132))
    rows[:, tpk.COL_SPORT] = np.where(ports, rng.integers(1, 65536, n), 0)
    rows[:, tpk.COL_DPORT] = np.where(
        ports, rng.integers(1, 65536, n),
        np.where(np.isin(proto, (1, 58)), rng.choice([0, 3, 8, 11], n), 0))
    rows[:, tpk.COL_FLAGS] = np.where(proto == 6, rng.integers(0, 64, n), 0)
    rows[:, tpk.COL_LEN] = rng.integers(20, 1600, n)
    return rows


def _eth(ip, vlan=False):
    hdr = b"\x02" * 6 + b"\x04" * 6
    if vlan:
        hdr += b"\x81\x00\x00\x2a"
    return hdr + (b"\x86\xdd" if ip[0] >> 4 == 6 else b"\x08\x00") + ip


def _ipv4(proto, l4, ident=1, frag=0, src=b"\x0a\x00\x00\x01",
          dst=b"\x0a\x00\x00\x02"):
    return struct.pack("!BBHHHBBH4s4s", 0x45, 0, 20 + len(l4), ident, frag,
                       64, proto, 0, src, dst) + l4


def _tcp(sport, dport, flags):
    return struct.pack("!HHIIBBHHH", sport, dport, 0, 0, 0x50, flags,
                       65535, 0, 0)


def _crafted_frames():
    """Ethernet frames through every branch of the parser: VLAN tags,
    non-IP and runt frames, IPv4 fragments (first, mid, and a mid one
    whose first never came), a VXLAN-wrapped packet, an ICMP error
    quoting a TCP header, IPv6 UDP."""
    udp = struct.pack("!HHHH", 5353, 53, 8, 0)
    inner = _ipv4(6, _tcp(1111, 443, 0x02), src=b"\x0a\x01\x00\x05")
    vxlan = struct.pack("!HHHH", 40000, 8472, 8 + 8 + 14 + len(inner), 0) \
        + b"\x08\x00\x00\x00\x00\x00\x01\x00" + _eth(inner)
    icmp_err = struct.pack("!BBHI", 3, 3, 0, 0) + _ipv4(
        6, _tcp(2222, 80, 0x02), src=b"\x0a\x00\x00\x02",
        dst=b"\x0a\x00\x00\x01")
    v6 = struct.pack("!IHBB16s16s", 0x60000000, len(udp), 17, 64,
                     b"\x20\x01" + b"\x00" * 13 + b"\x01",
                     b"\x20\x01" + b"\x00" * 13 + b"\x02") + udp
    return [
        _eth(_ipv4(6, _tcp(1000, 80, 0x12)), vlan=True),
        b"\x02" * 12 + b"\x08\x06" + b"\x00" * 28,  # ARP
        b"\x02" * 10,  # runt
        _eth(_ipv4(6, _tcp(3000, 22, 0x02) + b"x" * 8, ident=77,
                   frag=0x2000)),  # first fragment
        _eth(_ipv4(6, b"y" * 16, ident=77, frag=3)),  # its mid fragment
        _eth(_ipv4(17, b"z" * 16, ident=78, frag=5)),  # orphan
        _eth(_ipv4(17, vxlan)),
        _eth(_ipv4(1, icmp_err)),
        _eth(v6),
    ]


def _pcap_bytes(frames, endian="<", truncate_last=False):
    out = struct.pack(endian + "IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1)
    for i, f in enumerate(frames):
        caplen = len(f) + (10 if truncate_last and i == len(frames) - 1
                           else 0)
        out += struct.pack(endian + "IIII", i, 0, caplen, caplen) + f
    return out


def _jax_python_read(monkeypatch, path, **kw):
    """The reference's read_pcap through its Python parser (the one the
    port copied), its native parser switched off."""
    with monkeypatch.context() as m:
        m.setattr(jnative, "parse_pcap_bytes", lambda *a, **k: None)
        return jpcap.read_pcap(path, **kw).data


def test_read_pcap_golden_capture_equals_the_reference():
    want = jpcap.read_pcap(PCAP).data
    got = tpcap.read_pcap(PCAP).data
    assert got.dtype == np.uint32 and got.shape == (6144, tpk.N_COLS)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tpcap.read_pcap(PCAP, ep=3,
                                                  direction=1).data,
                                  jpcap.read_pcap(PCAP, ep=3,
                                                  direction=1).data)


@pytest.mark.parametrize("endian", ["<", ">"])
def test_read_pcap_crafted_frames_equal_the_reference(tmp_path, endian,
                                                      monkeypatch):
    path = str(tmp_path / "crafted.pcap")
    with open(path, "wb") as f:
        frames = _crafted_frames()
        f.write(_pcap_bytes(frames + frames[:1], endian,
                            truncate_last=True))
    got = tpcap.read_pcap(path, ep=2, direction=1).data
    want = _jax_python_read(monkeypatch, path, ep=2, direction=1)
    np.testing.assert_array_equal(got, want)
    # VLAN, first fragment, mid fragment, VXLAN inner, ICMP error
    # (RELATED), IPv6; the truncated last record ends the parse
    assert len(got) == 6
    assert got[2, tpk.COL_DPORT] == 22  # the mid fragment's ports
    assert got[3, tpk.COL_SRC_IP3] == 0x0A010005  # the decapsulated tuple
    assert got[4, tpk.COL_FLAGS] == tpk.FLAG_RELATED
    assert got[5, tpk.COL_FAMILY] == 6
    with open(path, "wb") as f:
        f.write(b"\x00" * 64)
    with pytest.raises(ValueError):
        tpcap.read_pcap(path)


def test_write_pcap_is_byte_identical_and_round_trips(tmp_path):
    rows = _rows(np.random.default_rng(11), 512)
    tp, jp = str(tmp_path / "t.pcap"), str(tmp_path / "j.pcap")
    tpcap.write_pcap(tp, tpk.HeaderBatch(rows.copy()))
    jpcap.write_pcap(jp, jpk.HeaderBatch(rows.copy()))
    with open(tp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()
    back = tpcap.read_pcap(tp).data
    np.testing.assert_array_equal(back, jpcap.read_pcap(jp).data)
    for c in (tpk.COL_SRC_IP3, tpk.COL_DST_IP3, tpk.COL_PROTO,
              tpk.COL_FAMILY):
        np.testing.assert_array_equal(back[:, c], rows[:, c])


def test_make_batch_and_header_batch_equal_the_reference():
    spec = [dict(src="10.0.0.1", dst="10.0.0.2", sport=1111, dport=80),
            dict(src="2001:db8::1", dst="2001:db8::2", proto=17,
                 sport=53, dport=5353, length=90, ep=3, dir=1),
            dict(src="10.0.0.9", dst="10.0.0.2", proto=1, dport=8,
                 flags=0)]
    tb, jb = tpk.make_batch(spec), jpk.make_batch(spec)
    np.testing.assert_array_equal(tb.data, jb.data)
    assert len(tb) == 3
    np.testing.assert_array_equal(tb.col(tpk.COL_DPORT),
                                  jb.col(jpk.COL_DPORT))
    assert [tb.describe(i) for i in range(3)] == [
        jb.describe(i) for i in range(3)]


def test_csv_labels_equal_the_reference_on_the_golden_capture():
    hdr = tpcap.read_pcap(PCAP).data
    got = teval.load_labels(CSV, hdr)
    want = jeval.load_labels(CSV, jpcap.read_pcap(PCAP).data)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # the reference's test_csv_labels_align_through_the_pcap_reader
    assert len(got) == len(hdr)
    assert 0.25 < float(got.mean()) < 0.40  # the golden mix is ~30% attack


def test_csv_label_loader(tmp_path):
    """CIC-IDS2017-style flow CSV maps 5-tuples to labels; a reply packet
    inherits its flow's label; an unknown flow is benign."""
    batch = tpk.make_batch([
        dict(src="10.0.0.1", dst="10.0.0.2", sport=1111, dport=80, proto=6),
        dict(src="10.0.0.3", dst="10.0.0.2", sport=2222, dport=22, proto=6),
        dict(src="10.0.0.9", dst="10.0.0.2", sport=3333, dport=443,
             proto=6),
        dict(src="10.0.0.2", dst="10.0.0.3", sport=22, dport=2222, proto=6),
    ])
    csv_path = tmp_path / "labels.csv"
    csv_path.write_text(
        "Source IP, Destination IP, Source Port, Destination Port,"
        " Protocol, Label\n"
        "10.0.0.1,10.0.0.2,1111,80,6,BENIGN\n"
        "10.0.0.3,10.0.0.2,2222,22,6,SSH-Patator\n"
        "not-an-ip,10.0.0.2,1,2,6,DoS\n")
    labels = teval.load_labels(str(csv_path), batch.data)
    assert list(labels) == [0.0, 1.0, 0.0, 1.0]
    np.testing.assert_array_equal(
        labels, jeval.load_labels(str(csv_path), batch.data.copy()))


def test_synth_capture_and_npz_sidecar_equal_the_reference(tmp_path):
    """synth_labeled_capture writes the same pcap and sidecar in both
    packages (same world, same seed), and the sidecar restores the
    direction the wire bytes cannot carry."""
    tw = tfix.build_world(n_identities=64, n_rules=4, ct_capacity=1 << 12,
                          device="cpu")
    jw = jfix.build_world(n_identities=64, n_rules=4, ct_capacity=1 << 12)
    paths = {}
    for name, mod, w in (("t", teval, tw), ("j", jeval, jw)):
        paths[name] = (str(tmp_path / f"{name}.pcap"),
                       str(tmp_path / f"{name}.npz"))
        mod.synth_labeled_capture(*paths[name], w, n=2048, seed=3)
    with open(paths["t"][0], "rb") as a, open(paths["j"][0], "rb") as b:
        assert a.read() == b.read()
    hdr = tpcap.read_pcap(paths["t"][0]).data
    assert hdr[:, tpk.COL_DIR].max() == 0  # wire bytes carry no direction
    labels = teval.load_labels(paths["t"][1], hdr)
    assert len(labels) == 2048 and labels.sum() > 0
    assert hdr[:, tpk.COL_DIR].max() == 1  # the sidecar restored egress
    jhdr = jpcap.read_pcap(paths["j"][0]).data
    np.testing.assert_array_equal(
        labels, jeval.load_labels(paths["j"][1], jhdr))
    np.testing.assert_array_equal(hdr, jhdr)
    with pytest.raises(ValueError):
        teval.load_labels(paths["t"][1], hdr[:10])


def test_main_gates_on_env_files(monkeypatch):
    monkeypatch.setenv("CILIUM_TPU_CIC_PCAP", PCAP)
    monkeypatch.setenv("CILIUM_TPU_CIC_LABELS", CSV)
    assert teval._find_real_dataset() == (PCAP, CSV)
    assert jeval._find_real_dataset() == (PCAP, CSV)
    monkeypatch.setenv("CILIUM_TPU_CIC_LABELS", CSV + ".missing")
    assert teval._find_real_dataset() == (None, None)
    monkeypatch.delenv("CILIUM_TPU_CIC_PCAP")
    monkeypatch.delenv("CILIUM_TPU_CIC_LABELS")
    assert teval._find_real_dataset() == (None, None)
