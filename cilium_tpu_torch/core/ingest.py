"""Host ingest: raw wire frames <-> header tensors, at line rate.

A copy of the JAX package's ``core/ingest.py``.  Cilium's packets
arrive as kernel skbs and are parsed by native code (bpf/lib/eth.h,
ipv4.h, l4.h); here raw frames arrive on the host, are parsed natively
(``cilium_tpu_torch/native/ingest.cpp``), and fixed-size header tensors
go to the device.  This module provides:

- :func:`frames_from_batch` — render a header tensor as length-prefixed
  ethernet frames (vectorized; the benchmark's packet source, and the
  inverse of the ingest parser — used to prove parse fidelity).
- :func:`parse_frames` — frames -> header rows, native C++ fast path
  with a Python fallback.
"""

from __future__ import annotations

import numpy as np

from .packets import (
    COL_DPORT,
    COL_DST_IP3,
    COL_FLAGS,
    COL_LEN,
    COL_PROTO,
    COL_SPORT,
    COL_SRC_IP3,
    N_COLS,
)

# fixed ipv4 frame: 4B length prefix + 14B eth + 20B ip + 20B l4 room
FRAME_LEN = 54
_REC_LEN = 4 + FRAME_LEN


def frames_from_batch(hdr: np.ndarray) -> bytes:
    """Header tensor [N, N_COLS] (IPv4 rows) -> length-prefixed
    ethernet frame stream.

    The IP header declares COL_LEN as the total length while the frame
    carries only headers (truncated-capture style, like a snaplen'd
    pcap), so ``parse -> frames -> parse`` round-trips every column the
    datapath reads.  EP/DIR are ingest-side metadata, not wire bytes —
    the parser stamps them per stream."""
    hdr = np.ascontiguousarray(hdr, dtype=np.uint32)
    n = hdr.shape[0]
    assert hdr.shape[1] == N_COLS
    buf = np.zeros((n, _REC_LEN), dtype=np.uint8)
    # u32le length prefix
    buf[:, 0] = FRAME_LEN
    # ethernet: zero macs, ethertype 0x0800
    buf[:, 4 + 12] = 0x08
    buf[:, 4 + 13] = 0x00
    ip = buf[:, 18:38]
    ip[:, 0] = 0x45
    total = hdr[:, COL_LEN].astype(np.uint16)
    ip[:, 2] = (total >> 8).astype(np.uint8)
    ip[:, 3] = (total & 0xFF).astype(np.uint8)
    ip[:, 8] = 64  # ttl
    ip[:, 9] = hdr[:, COL_PROTO].astype(np.uint8)
    src = hdr[:, COL_SRC_IP3]
    dst = hdr[:, COL_DST_IP3]
    for b in range(4):
        ip[:, 12 + b] = ((src >> (8 * (3 - b))) & 0xFF).astype(np.uint8)
        ip[:, 16 + b] = ((dst >> (8 * (3 - b))) & 0xFF).astype(np.uint8)
    l4 = buf[:, 38:58]
    proto = hdr[:, COL_PROTO]
    sport = hdr[:, COL_SPORT].astype(np.uint16)
    dport = hdr[:, COL_DPORT].astype(np.uint16)
    has_ports = (proto == 6) | (proto == 17) | (proto == 132)
    l4[:, 0] = np.where(has_ports, sport >> 8, 0).astype(np.uint8)
    l4[:, 1] = np.where(has_ports, sport & 0xFF, 0).astype(np.uint8)
    l4[:, 2] = np.where(has_ports, dport >> 8, 0).astype(np.uint8)
    l4[:, 3] = np.where(has_ports, dport & 0xFF, 0).astype(np.uint8)
    # tcp flags byte; icmp type byte
    l4[:, 13] = np.where(proto == 6, hdr[:, COL_FLAGS] & 0xFF, 0
                         ).astype(np.uint8)
    is_icmp = (proto == 1) | (proto == 58)
    l4[:, 0] = np.where(is_icmp, dport & 0xFF, l4[:, 0]).astype(np.uint8)
    return buf.tobytes()


def wide_frames_from_batch(hdr: np.ndarray) -> bytes:
    """Header tensor -> frames, WIDE-path edition: renders IPv4 rows,
    IPv6 rows (COL_FAMILY == 6, full 128-bit addresses), and
    FLAG_RELATED rows as ICMPv4 destination-unreachable errors whose
    payload EMBEDS the row's tuple — the inverse of the parser's
    RELATED transform (core/pcap.py build_row), so
    ``parse_frames(wide_frames_from_batch(h))`` reproduces the tuple
    columns.  Vectorized: per-class fixed-size records scattered into a
    ragged stream via a length mask (no per-packet Python)."""
    from .packets import COL_DST_IP0, COL_FAMILY, COL_SRC_IP0, FLAG_RELATED

    hdr = np.ascontiguousarray(hdr, dtype=np.uint32)
    n = hdr.shape[0]
    fam6 = hdr[:, COL_FAMILY] == 6
    rel = (hdr[:, COL_FLAGS] & FLAG_RELATED) != 0
    related = rel & ~fam6
    related6 = rel & fam6
    is_v6 = fam6 & ~rel
    is_v4 = ~fam6 & ~rel

    V4_REC, V6_REC, REL_REC = 4 + 54, 4 + 74, 4 + 70
    REL6_REC = 4 + 110  # eth + outer v6 + icmp6 + embedded v6 + l4
    buf = np.zeros((n, REL6_REC), dtype=np.uint8)
    lens = np.select([related6, is_v6, related],
                     [REL6_REC, V6_REC, REL_REC], V4_REC)

    # plain IPv4 rows reuse the single-family renderer
    if is_v4.any():
        v4 = np.frombuffer(frames_from_batch(hdr[is_v4]),
                           dtype=np.uint8).reshape(-1, V4_REC)
        buf[is_v4, :V4_REC] = v4

    def _be16(x):
        return (x >> 8).astype(np.uint8), (x & 0xFF).astype(np.uint8)

    if is_v6.any():
        h = hdr[is_v6]
        m = buf[is_v6]
        m[:, 0] = 74  # length prefix (u32le, low byte)
        m[:, 4 + 12], m[:, 4 + 13] = 0x86, 0xDD
        ip = m[:, 18:58]
        ip[:, 0] = 0x60
        pay = np.maximum(h[:, COL_LEN], 40) - 40
        ip[:, 4], ip[:, 5] = _be16(pay.astype(np.uint16))
        ip[:, 6] = h[:, COL_PROTO].astype(np.uint8)
        ip[:, 7] = 64
        for w in range(4):
            for b in range(4):
                sh = 8 * (3 - b)
                ip[:, 8 + 4 * w + b] = ((h[:, COL_SRC_IP0 + w] >> sh)
                                        & 0xFF).astype(np.uint8)
                ip[:, 24 + 4 * w + b] = ((h[:, COL_DST_IP0 + w] >> sh)
                                         & 0xFF).astype(np.uint8)
        l4 = m[:, 58:78]
        l4[:, 0], l4[:, 1] = _be16(h[:, COL_SPORT].astype(np.uint16))
        l4[:, 2], l4[:, 3] = _be16(h[:, COL_DPORT].astype(np.uint16))
        l4[:, 13] = np.where(h[:, COL_PROTO] == 6,
                             h[:, COL_FLAGS] & 0xFF, 0).astype(np.uint8)
        buf[is_v6] = m

    if related.any():
        h = hdr[related]
        m = buf[related]
        m[:, 0] = 70
        m[:, 4 + 12], m[:, 4 + 13] = 0x08, 0x00
        out_ip = m[:, 18:38]  # outer: some router -> the row's dst
        out_ip[:, 0] = 0x45
        out_ip[:, 2], out_ip[:, 3] = 0, 56  # 20 + 8 icmp + 20 + 8
        out_ip[:, 8], out_ip[:, 9] = 64, 1  # ICMP
        out_ip[:, 12:16] = [10, 0, 99, 99]  # the erroring router
        for b in range(4):
            out_ip[:, 16 + b] = ((h[:, COL_SRC_IP3] >> (8 * (3 - b)))
                                 & 0xFF).astype(np.uint8)
        m[:, 38] = 3  # ICMP type 3 (dest unreachable), code 0
        emb = m[:, 46:66]  # embedded original IPv4 header
        emb[:, 0] = 0x45
        emb[:, 2], emb[:, 3] = 0, 28
        emb[:, 8], emb[:, 9] = 64, h[:, COL_PROTO].astype(np.uint8)
        for b in range(4):
            sh = 8 * (3 - b)
            emb[:, 12 + b] = ((h[:, COL_SRC_IP3] >> sh) & 0xFF
                              ).astype(np.uint8)
            emb[:, 16 + b] = ((h[:, COL_DST_IP3] >> sh) & 0xFF
                              ).astype(np.uint8)
        el4 = m[:, 66:74]
        el4[:, 0], el4[:, 1] = _be16(h[:, COL_SPORT].astype(np.uint16))
        el4[:, 2], el4[:, 3] = _be16(h[:, COL_DPORT].astype(np.uint16))
        buf[related] = m

    if related6.any():
        h = hdr[related6]
        m = buf[related6]
        m[:, 0] = 110
        m[:, 4 + 12], m[:, 4 + 13] = 0x86, 0xDD

        def _v6hdr(dst_slice, nxt, paylen, src_words, dst_words):
            dst_slice[:, 0] = 0x60
            dst_slice[:, 4], dst_slice[:, 5] = _be16(
                np.full(len(h), paylen, dtype=np.uint16))
            dst_slice[:, 6] = nxt
            dst_slice[:, 7] = 64
            for w in range(4):
                for b in range(4):
                    sh = 8 * (3 - b)
                    dst_slice[:, 8 + 4 * w + b] = (
                        (src_words[:, w] >> sh) & 0xFF).astype(np.uint8)
                    dst_slice[:, 24 + 4 * w + b] = (
                        (dst_words[:, w] >> sh) & 0xFF).astype(np.uint8)

        src_w = h[:, COL_SRC_IP0:COL_SRC_IP0 + 4]
        dst_w = h[:, COL_DST_IP0:COL_DST_IP0 + 4]
        router = np.zeros_like(src_w)
        router[:, 0], router[:, 3] = 0x20010DB8, 0x9999  # the router
        # outer: router -> original sender, next header 58 (ICMPv6),
        # payload = 8 icmp6 + 40 embedded v6 + 8 l4
        _v6hdr(m[:, 18:58], 58, 56, router, src_w)
        m[:, 58] = 1  # ICMPv6 type 1 (dest unreachable), code 0
        nxt = h[:, COL_PROTO].astype(np.uint8)
        _v6hdr(m[:, 66:106], 0, 8, src_w, dst_w)
        m[:, 66 + 6] = nxt  # embedded next header = original proto
        el4 = m[:, 106:114]
        el4[:, 0], el4[:, 1] = _be16(h[:, COL_SPORT].astype(np.uint16))
        el4[:, 2], el4[:, 3] = _be16(h[:, COL_DPORT].astype(np.uint16))
        buf[related6] = m

    keep = np.arange(REL6_REC)[None, :] < lens[:, None]
    return buf[keep].tobytes()


def parse_frames(buf: bytes, ep: int = 0, direction: int = 0,
                 out: np.ndarray = None) -> np.ndarray:
    """Length-prefixed frame stream -> [N, N_COLS] header rows.

    Native C++ when available, Python fallback otherwise.  ``out``: a
    reused [max_rows, N_COLS] u32 buffer for transfer-bound callers
    (page-registration cache; the return is then a VIEW of it)."""
    from .. import native

    rows = native.parse_frames(buf, ep, direction, out=out)
    if rows is None:
        rows = native.parse_frames_py(buf, ep, direction)
        if out is not None:
            out[:len(rows)] = rows
            rows = out[:len(rows)]
    return rows
