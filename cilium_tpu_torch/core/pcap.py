"""pcap ingest/egest: raw capture files <-> header tensors.

A copy of the JAX package's ``core/pcap.py``: a classic libpcap file
parses straight into the ``[N, N_COLS]`` header tensor (the datapath's
wire format), and a HeaderBatch can be written back out as a valid pcap
for interop with tcpdump/wireshark.

Host-only (``struct`` and numpy over ``HeaderBatch.data``): the capture
path of the anomaly evaluation and of the flow plane's pcap replay.  As
in the reference, ``read_pcap`` hands the file to the native C++ parser
(``cilium_tpu_torch/native``) and keeps the Python parser here
(:func:`parse_pcap_py`) as the oracle the native one is held to and as
the path on a host without a compiler.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from .packets import (
    COL_DIR,
    COL_DPORT,
    COL_DST_IP0,
    COL_EP,
    COL_FAMILY,
    COL_FLAGS,
    COL_LEN,
    COL_PROTO,
    COL_SPORT,
    COL_SRC_IP0,
    N_COLS,
    HeaderBatch,
)

PCAP_MAGIC = 0xA1B2C3D4
PCAP_MAGIC_SWAPPED = 0xD4C3B2A1
LINKTYPE_ETHERNET = 1
LINKTYPE_RAW = 101

ETH_P_IP = 0x0800
ETH_P_IPV6 = 0x86DD


def _parse_l4(proto: int, payload: bytes) -> Tuple[int, int, int]:
    """Return (sport, dport, tcp_flags)."""
    if proto in (6, 17, 132) and len(payload) >= 4:
        sport, dport = struct.unpack_from("!HH", payload, 0)
        flags = payload[13] if proto == 6 and len(payload) >= 14 else 0
        return sport, dport, flags
    if proto in (1, 58) and len(payload) >= 2:
        return 0, payload[0], 0  # ICMP: dport column carries the type
    return 0, 0, 0


class FragTracker:
    """IPv4 fragment association (reference: the datapath fragmap,
    ``bpf/lib/ipv4.h ipv4_handle_fragmentation`` + ``pkg/maps/fragmap``).

    The first fragment of a datagram carries the L4 header; later
    fragments don't — without tracking they'd parse with garbage
    ports.  The first fragment records (src, dst, proto, ipid) ->
    l4-prefix; mid-fragments resolve through it; a miss is a skip
    (upstream: DROP_FRAG_NOT_FOUND).  Bounded FIFO like the
    reference's LRU fragmap."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._map: dict = {}

    def record(self, key: tuple, l4_prefix: bytes) -> None:
        if key not in self._map and len(self._map) >= self.capacity:
            self._map.pop(next(iter(self._map)))  # FIFO evict
        self._map[key] = l4_prefix

    def lookup(self, key: tuple) -> Optional[bytes]:
        return self._map.get(key)


# module-level tracker: fragments of one datagram may straddle parse
# calls (the kernel fragmap is long-lived for the same reason)
_FRAGS = FragTracker()


def _parse_ip_one(pkt: bytes, frags=None
                  ) -> Optional[Tuple[int, bytes, bytes, int, bytes, int]]:
    """Parse ONE IP header (no decap) -> (family, src16, dst16, proto,
    l4payload, ip_total_len).  IPv4 fragments resolve their L4 ports
    through the fragment tracker; an unresolvable mid-fragment returns
    None (parse-stage drop).  ``frags=False`` disables fragment
    tracking entirely — REQUIRED for ICMP-quoted inner headers, which
    are attacker-controlled bytes: recording them would let a forged
    ICMP error poison the tracker with chosen ports."""
    if len(pkt) < 20:
        return None
    ver = pkt[0] >> 4
    if ver == 4:
        ihl = (pkt[0] & 0xF) * 4
        if ihl < 20 or len(pkt) < ihl:
            return None
        proto = pkt[9]
        total = struct.unpack_from("!H", pkt, 2)[0]
        src = b"\x00" * 12 + pkt[12:16]
        dst = b"\x00" * 12 + pkt[16:20]
        l4 = pkt[ihl:]
        fo_field = struct.unpack_from("!H", pkt, 6)[0]
        frag_off = fo_field & 0x1FFF
        more = bool(fo_field & 0x2000)
        if (frag_off or more) and proto in (6, 17, 132) \
                and frags is not False:
            frags = frags if frags is not None else _FRAGS
            key = (pkt[12:16], pkt[16:20], proto, pkt[4:6])
            if frag_off == 0:  # first fragment: carries the L4 header
                # zero-pad to 8 bytes: the native tracker stores a
                # fixed 8-byte prefix, and a shorter record would make
                # mid-fragment port parsing diverge between parsers
                frags.record(key, (l4[:8] + b"\x00" * 8)[:8])
            else:  # mid/last fragment: no L4 header on the wire
                prefix = frags.lookup(key)
                if prefix is None:
                    return None  # DROP_FRAG_NOT_FOUND analogue
                l4 = prefix
        return 4, src, dst, proto, l4, total
    if ver == 6 and len(pkt) >= 40:
        proto = pkt[6]
        payload_len = struct.unpack_from("!H", pkt, 4)[0]
        return 6, pkt[8:24], pkt[24:40], proto, pkt[40:], 40 + payload_len
    return None


def _decap_overlay(proto: int, l4: bytes) -> Optional[bytes]:
    """UDP VXLAN/Geneve payload -> inner IP packet bytes, or None.

    Reference: ``bpf_overlay.c`` decap — the datapath verdicts the
    INNER packet; the outer header is transport."""
    from .packets import GENEVE_PORT, VXLAN_PORT

    if proto != 17 or len(l4) < 8:
        return None
    dport = struct.unpack_from("!H", l4, 2)[0]
    payload = l4[8:]
    if dport == VXLAN_PORT:
        if len(payload) < 8 + 14:
            return None
        inner_eth = payload[8:]  # 8B VXLAN header (flags + VNI)
    elif dport == GENEVE_PORT:
        if len(payload) < 8:
            return None
        optlen = (payload[0] & 0x3F) * 4
        if len(payload) < 8 + optlen + 14:
            return None
        inner_eth = payload[8 + optlen:]
    else:
        return None
    ethertype = struct.unpack_from("!H", inner_eth, 12)[0]
    if ethertype not in (ETH_P_IP, ETH_P_IPV6):
        return None
    return inner_eth[14:]


# ICMP error types whose payload embeds the original packet's header
# (reference: icmp_is_error / bpf conntrack related handling)
_ICMP4_ERRORS = (3, 4, 5, 11, 12)
_ICMP6_ERRORS = (1, 2, 3, 4)


def _related_tuple(fam: int, proto: int, l4: bytes):
    """For ICMP errors: -> (src16, dst16, inner_proto, sport, dport)
    of the EMBEDDED original packet, or None."""
    if len(l4) < 8 + 20:
        return None
    t = l4[0]
    if not ((proto == 1 and t in _ICMP4_ERRORS)
            or (proto == 58 and t in _ICMP6_ERRORS)):
        return None
    # frags=False: the quoted header is attacker-controlled — fragment
    # tracking on it would be a poisoning vector (and the native parser
    # likewise parses quoted headers without fragment logic)
    inner = _parse_ip_one(l4[8:], frags=False)
    if inner is None:
        return None
    ifam, isrc, idst, iproto, il4, _ = inner
    if ifam != fam:
        return None
    isport = idport = 0
    if iproto in (6, 17, 132) and len(il4) >= 4:
        isport, idport = struct.unpack_from("!HH", il4, 0)
    elif iproto in (1, 58) and len(il4) >= 2:
        idport = il4[0]
    return isrc, idst, iproto, isport, idport


def _parse_ip(pkt: bytes
              ) -> Optional[Tuple[int, bytes, bytes, int, bytes, int]]:
    """Parse an IP packet, decapsulating VXLAN/Geneve overlays ->
    (family, src16, dst16, proto, l4payload, ip_total_len).
    ``ip_total_len`` is the header-declared IP length (COL_LEN)."""
    parsed = _parse_ip_one(pkt)
    if parsed is None:
        return None
    for _ in range(2):  # bounded decap depth
        fam, src, dst, proto, l4, total = parsed
        inner = _decap_overlay(proto, l4)
        if inner is None:
            return parsed
        deeper = _parse_ip_one(inner)
        if deeper is None:
            return parsed
        parsed = deeper
    return parsed


def build_row(parsed, ep: int, direction: int,
              related: bool = True) -> np.ndarray:
    """(family, src16, dst16, proto, l4, total) -> one header row,
    including the CT_RELATED transform: an ICMP error row carries the
    EMBEDDED packet's tuple + FLAG_RELATED (reference: conntrack
    relates ICMP errors to the original flow).  ``related=False``
    keeps the OUTER tuple (the packed fast path's semantics — the
    16 B wire format has no RELATED bit, see packets.FLAG_RELATED)."""
    from .packets import FLAG_RELATED

    fam, src, dst, proto, l4, ip_len = parsed
    sport, dport, flags = _parse_l4(proto, l4)
    rel = _related_tuple(fam, proto, l4) if related else None
    if rel is not None:
        src, dst, proto, sport, dport = rel
        flags = FLAG_RELATED
    row = np.zeros(N_COLS, dtype=np.uint32)
    row[COL_SRC_IP0:COL_SRC_IP0 + 4] = np.frombuffer(
        src, dtype=">u4").astype(np.uint32)
    row[COL_DST_IP0:COL_DST_IP0 + 4] = np.frombuffer(
        dst, dtype=">u4").astype(np.uint32)
    row[COL_SPORT] = sport
    row[COL_DPORT] = dport
    row[COL_PROTO] = proto
    row[COL_FLAGS] = flags
    row[COL_LEN] = ip_len
    row[COL_FAMILY] = fam
    row[COL_EP] = ep
    row[COL_DIR] = direction
    return row


def read_pcap(path: str, ep: int = 0, direction: int = 0) -> HeaderBatch:
    """Parse a pcap file into a HeaderBatch (non-IP frames are skipped;
    a truncated last record ends the parse): the native parser when the
    host can build it, else :func:`parse_pcap_py`."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 24:
        return HeaderBatch(np.zeros((0, N_COLS), dtype=np.uint32))
    from .. import native

    try:
        rows = native.parse_pcap_bytes(data, ep, direction)
    except ValueError:
        raise ValueError(f"{path}: not a pcap file") from None
    if rows is None:
        rows = parse_pcap_py(data, ep, direction, path)
    return HeaderBatch(rows)


def parse_pcap_py(data: bytes, ep: int = 0, direction: int = 0,
                  path: str = "<bytes>") -> np.ndarray:
    """The Python parse of pcap file bytes -> [N, N_COLS] rows, one
    record at a time (the native parser's oracle)."""
    from ..native import count_parse

    count_parse("python")
    if len(data) < 24:
        return np.zeros((0, N_COLS), dtype=np.uint32)
    magic = struct.unpack_from("<I", data, 0)[0]
    if magic == PCAP_MAGIC:
        endian = "<"
    elif magic == PCAP_MAGIC_SWAPPED:
        endian = ">"
    else:
        raise ValueError(f"{path}: not a pcap file (magic {magic:#x})")
    linktype = struct.unpack_from(endian + "I", data, 20)[0]
    rows: List[np.ndarray] = []
    off = 24
    while off + 16 <= len(data):
        _, _, caplen, origlen = struct.unpack_from(endian + "IIII", data, off)
        off += 16
        if off + caplen > len(data):  # truncated record: stop
            break
        frame = data[off:off + caplen]
        off += caplen
        if linktype == LINKTYPE_ETHERNET:
            if len(frame) < 14:
                continue
            ethertype = struct.unpack_from("!H", frame, 12)[0]
            # skip VLAN tags
            l3off = 14
            while ethertype in (0x8100, 0x88A8) and len(frame) >= l3off + 4:
                ethertype = struct.unpack_from("!H", frame, l3off + 2)[0]
                l3off += 4
            if ethertype not in (ETH_P_IP, ETH_P_IPV6):
                continue
            ip = frame[l3off:]
        elif linktype == LINKTYPE_RAW:
            ip = frame
        else:
            continue
        parsed = _parse_ip(ip)
        if parsed is None:
            continue
        rows.append(build_row(parsed, ep, direction))
    if not rows:
        return np.zeros((0, N_COLS), dtype=np.uint32)
    return np.stack(rows)


def write_pcap(path: str, batch: HeaderBatch) -> None:
    """Write a HeaderBatch as a LINKTYPE_RAW pcap (synthetic payloads)."""
    out = bytearray()
    out += struct.pack("<IHHiIII", PCAP_MAGIC, 2, 4, 0, 0, 65535,
                       LINKTYPE_RAW)
    for i in range(len(batch)):
        r = batch.data[i]
        fam = int(r[COL_FAMILY])
        proto = int(r[COL_PROTO])
        # declare the batch's LEN in the IP header (truncated capture
        # style: caplen < origlen) so read_pcap round-trips COL_LEN
        if fam == 4:
            total = max(int(r[COL_LEN]), 20 + _l4_len(proto))
            ip = struct.pack("!BBHHHBBH4s4s",
                             0x45, 0, total, i & 0xFFFF, 0, 64, proto, 0,
                             int(r[COL_SRC_IP0 + 3]).to_bytes(4, "big"),
                             int(r[COL_DST_IP0 + 3]).to_bytes(4, "big"))
            origlen = total
        else:
            src = b"".join(int(r[COL_SRC_IP0 + j]).to_bytes(4, "big")
                           for j in range(4))
            dst = b"".join(int(r[COL_DST_IP0 + j]).to_bytes(4, "big")
                           for j in range(4))
            origlen = max(int(r[COL_LEN]), 40 + _l4_len(proto))
            ip = struct.pack("!IHBB16s16s", 0x60000000, origlen - 40,
                             proto, 64, src, dst)
        ip += _l4_bytes(proto, int(r[COL_SPORT]), int(r[COL_DPORT]),
                        int(r[COL_FLAGS]))
        out += struct.pack("<IIII", 0, 0, len(ip), max(len(ip), origlen))
        out += ip
    with open(path, "wb") as f:
        f.write(bytes(out))


def _l4_len(proto: int) -> int:
    if proto == 6:
        return 20
    if proto in (17, 132, 1, 58):
        return 8
    return 0


def _l4_bytes(proto: int, sport: int, dport: int, flags: int) -> bytes:
    if proto == 6:
        return struct.pack("!HHIIBBHHH", sport, dport, 0, 0, 0x50, flags,
                           65535, 0, 0)
    if proto in (17, 132):
        return struct.pack("!HHHH", sport, dport, 8, 0)
    if proto in (1, 58):
        return struct.pack("!BBHI", dport, 0, 0, 0)
    return b""
