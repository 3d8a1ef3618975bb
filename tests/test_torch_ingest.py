"""The port's packet ingest (``core/ingest.py``, ``native/ingest.cpp``
through ``native/__init__.py``, ``core/pcap.py`` ``read_pcap``) against
the JAX package's.  The same seeded header rows render to the same
frame bytes; the port's native parse, the port's Python parse and the
reference's native and Python parses give the same rows, bit for bit,
over frames of every branch the parser has (VLAN tags, runts, IPv4
fragments, VXLAN and Geneve, ICMP errors, IPv6), the golden CIC capture
and a capture whose last record is truncated.

Mirrors ``tests/test_native_ingest.py`` and the host half of
``tests/test_packed_ingest.py`` (the packed entry point itself is not in
the port: its encrypted ingress is ROADMAP A15).
"""

import os
import struct
import time

import numpy as np
import pytest

from cilium_tpu import native as jnative
from cilium_tpu.core import ingest as jingest
from cilium_tpu.core import packets as jpk
from cilium_tpu.core import pcap as jpcap
from cilium_tpu_torch import native as tnative
from cilium_tpu_torch.core import ingest as tingest
from cilium_tpu_torch.core import packets as tpk
from cilium_tpu_torch.core import pcap as tpcap
from test_torch_pcap import _crafted_frames, _eth, _ipv4, _pcap_bytes, _tcp

DATA = os.path.join(os.path.dirname(__file__), "data")
PCAP = os.path.join(DATA, "golden_cic.pcap")


def _stream(frames):
    return b"".join(struct.pack("<I", len(f)) + f for f in frames)


def _geneve(inner):
    """A Geneve-wrapped IPv4 packet (one 4-byte option)."""
    payload = b"\x01\x00\x65\x58\x00\x00\x01\x00" + b"\x00" * 4 \
        + _eth(inner)
    return _ipv4(17, struct.pack("!HHHH", 40001, 6081, 8 + len(payload), 0)
                 + payload)


def _wide_rows(seed, n=512):
    """v4 and v6 rows and FLAG_RELATED rows of both families: what
    ``wide_frames_from_batch`` renders."""
    rng = np.random.default_rng(seed)
    rows = jpk.synth_batch(n, rng).data.copy()
    v6 = rng.random(n) < 0.3
    rows[v6, :3] = rng.integers(0, 1 << 32, (int(v6.sum()), 3),
                                dtype=np.uint64)
    rows[v6, 4:7] = rng.integers(0, 1 << 32, (int(v6.sum()), 3),
                                 dtype=np.uint64)
    rows[v6, 0] |= 0x20010000
    rows[v6, 4] |= 0x20010000
    rows[:, tpk.COL_FAMILY] = np.where(v6, 6, 4)
    # the v6 renderer writes ports, not an ICMP type: v6 rows are UDP
    rows[v6 & (rows[:, tpk.COL_PROTO] == 1), tpk.COL_PROTO] = 17
    rel = (rng.random(n) < 0.15) & np.isin(rows[:, tpk.COL_PROTO], (6, 17))
    rows[rel, tpk.COL_FLAGS] = tpk.FLAG_RELATED
    rows[:, tpk.COL_LEN] = np.where(v6, np.maximum(rows[:, tpk.COL_LEN], 40),
                                    rows[:, tpk.COL_LEN])
    return rows


SOURCES = {
    "frames_from_batch": lambda: tingest.frames_from_batch(
        jpk.synth_batch(1024, np.random.default_rng(8)).data),
    "wide_frames_from_batch": lambda: tingest.wide_frames_from_batch(
        _wide_rows(9)),
    "crafted": lambda: _stream(_crafted_frames()),
    "fragments": lambda: _stream([
        _eth(_ipv4(6, _tcp(3100, 5432, 0x02) + b"x" * 8, ident=901,
                   frag=0x2000)),
        _eth(_ipv4(6, b"y" * 16, ident=901, frag=0x2000 | 3)),
        _eth(_ipv4(6, b"y" * 16, ident=901, frag=6)),
        _eth(_ipv4(17, b"z" * 16, ident=902, frag=5))]),
    "overlays": lambda: _stream([
        _eth(_geneve(_ipv4(6, _tcp(4000, 8443, 0x02),
                           src=b"\x0a\x02\x00\x07"))),
        _eth(_geneve(_geneve(_ipv4(17, struct.pack("!HHHH", 53, 5353, 8, 0)
                                   ))))]),
}


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_native_and_python_parses_equal_the_reference(source):
    buf = SOURCES[source]()
    before = tnative.parse_counts().get("native", 0)
    got = tingest.parse_frames(buf, ep=3, direction=1)
    assert tnative.parse_counts()["native"] == before + 1
    np.testing.assert_array_equal(got, tnative.parse_frames_py(buf, 3, 1))
    np.testing.assert_array_equal(got, jnative.parse_frames(buf, 3, 1))
    np.testing.assert_array_equal(got, jnative.parse_frames_py(buf, 3, 1))
    assert got.dtype == np.uint32 and len(got) > 0
    # a reused out buffer returns a view of it
    out = np.empty((len(got) + 8, tpk.N_COLS), np.uint32)
    view = tingest.parse_frames(buf, 3, 1, out=out)
    assert view.base is out
    np.testing.assert_array_equal(view, got)


def test_native_builds_into_the_build_directory():
    assert tnative.available()
    so = tnative._so_path()
    assert so.exists() and so.parent.name == "_build"


def test_frames_render_like_the_reference_and_round_trip():
    rows = jpk.synth_batch(4096, np.random.default_rng(7)).data
    buf = tingest.frames_from_batch(rows)
    assert buf == jingest.frames_from_batch(rows)
    got = tingest.parse_frames(buf)
    want = rows.copy()
    want[:, tpk.COL_EP] = 0  # EP/DIR are stream metadata, not wire bytes
    want[:, tpk.COL_DIR] = 0
    np.testing.assert_array_equal(got, want)
    wide = _wide_rows(10)
    wbuf = tingest.wide_frames_from_batch(wide)
    assert wbuf == jingest.wide_frames_from_batch(wide)
    back = tingest.parse_frames(wbuf)
    tuple_cols = [tpk.COL_SRC_IP0 + i for i in range(8)] + [
        tpk.COL_SPORT, tpk.COL_DPORT, tpk.COL_PROTO, tpk.COL_FAMILY]
    np.testing.assert_array_equal(back[:, tuple_cols], wide[:, tuple_cols])
    rel = (wide[:, tpk.COL_FLAGS] & tpk.FLAG_RELATED) != 0
    assert (back[rel, tpk.COL_FLAGS] == tpk.FLAG_RELATED).all()


def test_vlan_and_junk_frames_skip_alike():
    frame = tingest.frames_from_batch(
        jpk.synth_batch(1, np.random.default_rng(9)).data)[4:]
    tagged = frame[:12] + b"\x81\x00\x00\x2a" + frame[12:]
    buf = _stream([tagged, frame[:12] + b"\x08\x06" + b"\x00" * 28,
                   frame[:10], frame])
    got = tnative.parse_frames(buf)
    np.testing.assert_array_equal(got, jnative.parse_frames(buf))
    assert got.shape[0] == 2
    np.testing.assert_array_equal(got[0], got[1])


@pytest.mark.parametrize("capture", ["golden", "synth", "truncated"])
def test_read_pcap_native_equals_python_and_the_reference(tmp_path,
                                                          capture):
    """read_pcap goes through the native parser; its rows equal the
    port's Python parse and the reference's native and Python ones: the
    golden CIC capture, write_pcap's bytes (identical to the
    reference's), and a capture whose last record is truncated."""
    if capture == "golden":
        path = PCAP
    elif capture == "synth":
        rows = _wide_rows(11, 256)
        rows[:, tpk.COL_FLAGS] &= 0xFF
        path = str(tmp_path / "t.pcap")
        tpcap.write_pcap(path, tpk.HeaderBatch(rows.copy()))
        jp = str(tmp_path / "j.pcap")
        jpcap.write_pcap(jp, jpk.HeaderBatch(rows.copy()))
        assert open(path, "rb").read() == open(jp, "rb").read()
    else:
        path = str(tmp_path / "trunc.pcap")
        frames = _crafted_frames()
        with open(path, "wb") as f:
            f.write(_pcap_bytes(frames + frames[:1], ">",
                                truncate_last=True))
    data = open(path, "rb").read()
    before = tnative.parse_counts().get("native", 0)
    got = tpcap.read_pcap(path, ep=1, direction=1).data
    assert tnative.parse_counts()["native"] == before + 1
    np.testing.assert_array_equal(got, tpcap.parse_pcap_py(data, 1, 1))
    np.testing.assert_array_equal(got, jnative.parse_pcap_bytes(data, 1, 1))
    np.testing.assert_array_equal(got, jpcap.read_pcap(path, 1, 1).data)
    if capture == "golden":
        assert got.shape == (6144, tpk.N_COLS)
    if capture == "synth":
        want = rows.copy()
        want[:, tpk.COL_EP] = 1
        want[:, tpk.COL_DIR] = 1
        np.testing.assert_array_equal(got, want)
    if capture == "truncated":
        assert len(got) == 6  # the truncated last record ends the parse


def test_pcap_bad_magic():
    with pytest.raises(ValueError):
        tnative.parse_pcap_bytes(b"\x00" * 64)
    with pytest.raises(ValueError):
        tpcap.parse_pcap_py(b"\x00" * 64)


def test_python_path_without_a_compiler(tmp_path, monkeypatch):
    """Where the native library cannot be built, parse_frames and
    read_pcap take the Python copy, and the counts say so."""
    rows = jpk.synth_batch(64, np.random.default_rng(12)).data
    buf = tingest.frames_from_batch(rows)
    path = str(tmp_path / "p.pcap")
    tpcap.write_pcap(path, tpk.HeaderBatch(rows.copy()))
    want_frames = tingest.parse_frames(buf)
    want_pcap = tpcap.read_pcap(path).data
    monkeypatch.setattr(tnative, "_load", lambda: None)
    tnative.reset_parse_counts()
    np.testing.assert_array_equal(tingest.parse_frames(buf), want_frames)
    np.testing.assert_array_equal(tpcap.read_pcap(path).data, want_pcap)
    assert tnative.parse_counts() == {"python": 2}


def test_native_ingest_rate():
    """The native parser sustains well past Python rates (the
    reference's floor: 2M packets/s)."""
    rows = jpk.synth_batch(1 << 16, np.random.default_rng(11)).data
    buf = tingest.frames_from_batch(rows)
    tnative.parse_frames(buf)  # warm
    best = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        got = tnative.parse_frames(buf)
        best = max(best, got.shape[0] / (time.perf_counter() - t0))
    assert got.shape[0] == 1 << 16
    assert best > 2e6


# -- the host half of tests/test_packed_ingest.py ------------------------
def _icmp_error_frame():
    """Eth + IPv4 ICMP dest-unreachable embedding an original UDP
    packet 10.0.0.9:5353 -> 10.0.0.7:53."""
    inner = struct.pack("!BBHHHBBH4s4s", 0x45, 0, 28, 0, 0, 64, 17, 0,
                        bytes([10, 0, 0, 9]), bytes([10, 0, 0, 7]))
    inner += struct.pack("!HHHH", 5353, 53, 8, 0)
    icmp = struct.pack("!BBHI", 3, 1, 0, 0) + inner
    ip = struct.pack("!BBHHHBBH4s4s", 0x45, 0, 20 + len(icmp), 0, 0, 64,
                     1, 0, bytes([10, 0, 0, 7]), bytes([10, 0, 0, 9]))
    return _stream([b"\x00" * 12 + b"\x08\x00" + ip + icmp])


def test_packed_rows_of_the_wide_parse_equal_the_reference_packed_parse():
    """pack_rows over the port's wide parse equals the reference's
    native packed parse (v4 rows and an ICMP error's RELATED bit), and
    unpacking restores the wide rows."""
    rows = jpk.synth_batch(1024, np.random.default_rng(3)).data
    for buf in (tingest.frames_from_batch(rows), _icmp_error_frame()):
        wide = tingest.parse_frames(buf)
        packed = tpk.pack_rows(wide)
        want, n, skipped = jnative.parse_frames_packed(buf)
        assert (n, skipped) == (len(wide), 0)
        np.testing.assert_array_equal(packed, np.asarray(want))
        np.testing.assert_array_equal(tpk.unpack_rows_np(packed, 0, 0),
                                      wide)
    assert int(wide[0, tpk.COL_SRC_IP3]) == 0x0A000009  # embedded tuple
    assert int(wide[0, tpk.COL_PROTO]) == 17
    assert int(wide[0, tpk.COL_FLAGS]) == tpk.FLAG_RELATED
    assert int(packed[0, 3]) & (1 << 15) and int(packed[0, 3]) >> 24 == 17
