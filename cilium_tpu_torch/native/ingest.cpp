// Native packet ingest: raw frames -> header-tensor rows.
//
// Reference: upstream cilium parses packets in native code on the hot
// path (bpf/lib/eth.h, ipv4.h, ipv6.h, l4.h compiled to eBPF).  The
// port's hot path is the device pipeline; THIS is the
// host-side ingest stage that feeds it — the one part of the ingest
// path where Python-per-packet cost would dominate the end-to-end
// verdict rate (SURVEY.md §7 hard part #4: ingest bandwidth).
//
// Row layout mirrors cilium_tpu_torch/core/packets.py exactly:
//   0-3 SRC_IP0-3 | 4-7 DST_IP0-3 | 8 SPORT | 9 DPORT/ICMP-type
//   10 PROTO | 11 TCP FLAGS | 12 IP LEN | 13 FAMILY | 14 EP | 15 DIR
//
// Build: g++ -O3 -shared -fPIC (driven by cilium_tpu_torch/native/
// __init__.py into cilium_tpu_torch/_build/, loaded via ctypes; no
// pybind11 dependency).  The JAX package's copy also carries the packed
// IPv4 entry point (parse_frames_packed) of the encrypted ingress, which
// the port does not have yet.

#include <cstdint>
#include <cstring>
#include <mutex>

namespace {

constexpr int N_COLS = 16;

inline uint32_t be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
           (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

inline uint16_t be16(const uint8_t* p) {
    return uint16_t((p[0] << 8) | p[1]);
}

constexpr uint32_t FLAG_RELATED = 0x100;  // core/packets.py
constexpr uint16_t VXLAN_PORT = 8472;
constexpr uint16_t GENEVE_PORT = 6081;

// VXLAN/Geneve UDP payload -> inner IP packet, or nullptr.
const uint8_t* decap_overlay(uint32_t proto, const uint8_t* l4,
                             long l4_len, long* inner_len) {
    if (proto != 17 || l4_len < 8) return nullptr;
    const uint16_t dport = be16(l4 + 2);
    const uint8_t* p = l4 + 8;
    long n = l4_len - 8;
    long hdr;
    if (dport == VXLAN_PORT) {
        hdr = 8;  // flags + VNI
    } else if (dport == GENEVE_PORT) {
        if (n < 8) return nullptr;
        hdr = 8 + (p[0] & 0x3F) * 4;
    } else {
        return nullptr;
    }
    if (n < hdr + 14) return nullptr;
    const uint8_t* eth = p + hdr;
    const uint16_t ethertype = be16(eth + 12);
    if (ethertype != 0x0800 && ethertype != 0x86DD) return nullptr;
    *inner_len = n - hdr - 14;
    return eth + 14;
}

// --- IPv4 fragment tracking (reference: bpf/lib/ipv4.h
// ipv4_handle_fragmentation + pkg/maps/fragmap).  The first fragment
// records (src, dst, proto, ipid) -> its L4 prefix; later fragments
// (which carry no L4 header) resolve ports through it; a miss is a
// parse-stage drop (upstream: DROP_FRAG_NOT_FOUND).  Mirrors
// core/pcap.py FragTracker.
uint64_t fnv64_bytes(const uint8_t* p, int n) {
    uint64_t h = 0xCBF29CE484222325ull;
    for (int i = 0; i < n; ++i) h = (h ^ p[i]) * 0x100000001B3ull;
    return h;
}

constexpr int FRAG_KEY_LEN = 11;  // src4 + dst4 + proto + ipid2

struct FragSlot {
    uint8_t kb[FRAG_KEY_LEN];  // the EXACT key: hash collisions must
    uint8_t pre[8];            // not alias distinct datagrams
    bool used;
};
constexpr int FRAG_CAP = 4096;
FragSlot g_frags[FRAG_CAP];
std::mutex g_frags_mu;

inline void frag_key(const uint8_t* ip4, uint8_t* kb) {
    std::memcpy(kb, ip4 + 12, 8);  // src + dst
    kb[8] = ip4[9];                // proto
    std::memcpy(kb + 9, ip4 + 4, 2);  // identification
}

void frag_record(const uint8_t* kb, const uint8_t* l4, long l4_len) {
    std::lock_guard<std::mutex> lk(g_frags_mu);
    const size_t h =
        size_t(fnv64_bytes(kb, FRAG_KEY_LEN)) % FRAG_CAP;
    size_t slot = h;
    for (int i = 0; i < 8; ++i) {
        const size_t s = (h + i) % FRAG_CAP;
        if (!g_frags[s].used ||
            !std::memcmp(g_frags[s].kb, kb, FRAG_KEY_LEN)) {
            slot = s;
            break;
        }
    }
    std::memcpy(g_frags[slot].kb, kb, FRAG_KEY_LEN);
    g_frags[slot].used = true;
    std::memset(g_frags[slot].pre, 0, 8);
    std::memcpy(g_frags[slot].pre, l4, l4_len < 8 ? l4_len : 8);
}

bool frag_lookup(const uint8_t* kb, uint8_t* out8) {
    std::lock_guard<std::mutex> lk(g_frags_mu);
    const size_t h =
        size_t(fnv64_bytes(kb, FRAG_KEY_LEN)) % FRAG_CAP;
    for (int i = 0; i < 8; ++i) {
        const size_t s = (h + i) % FRAG_CAP;
        if (g_frags[s].used &&
            !std::memcmp(g_frags[s].kb, kb, FRAG_KEY_LEN)) {
            std::memcpy(out8, g_frags[s].pre, 8);
            return true;
        }
    }
    return false;
}

// Resolve IPv4 fragmentation for one packet: returns false when the
// packet is an unresolvable mid-fragment (drop).  On a resolved
// mid-fragment, *l4 / *l4_len point at the recorded 8-byte prefix in
// scratch8.
bool resolve_fragment(const uint8_t* ip4, uint32_t proto,
                      const uint8_t** l4, long* l4_len,
                      uint8_t* scratch8) {
    const uint16_t fo = be16(ip4 + 6);
    const uint16_t frag_off = fo & 0x1FFF;
    const bool more = fo & 0x2000;
    if (!(frag_off || more)) return true;  // not fragmented
    if (!(proto == 6 || proto == 17 || proto == 132)) return true;
    uint8_t kb[FRAG_KEY_LEN];
    frag_key(ip4, kb);
    if (frag_off == 0) {  // first fragment carries the L4 header
        frag_record(kb, *l4, *l4_len);
        return true;
    }
    if (!frag_lookup(kb, scratch8)) return false;  // FRAG_NOT_FOUND
    *l4 = scratch8;
    *l4_len = 8;
    return true;
}

inline bool icmp_is_error(uint32_t proto, uint8_t type) {
    if (proto == 1)
        return type == 3 || type == 4 || type == 5 || type == 11 ||
               type == 12;
    if (proto == 58) return type >= 1 && type <= 4;
    return false;
}

// Parse one IP packet (no link header) into a header row.
// Returns true when the row was produced.  depth bounds overlay decap
// recursion to match the Python reference (core/pcap.py: 2 levels).
bool parse_ip(const uint8_t* pkt, long len, uint32_t* row, uint32_t ep,
              uint32_t dir, int depth = 0) {
    if (len < 20) return false;
    const int ver = pkt[0] >> 4;
    uint32_t proto, ip_len, fam;
    const uint8_t* l4;
    long l4_len;
    if (ver == 4) {
        const int ihl = (pkt[0] & 0xF) * 4;
        if (len < ihl || ihl < 20) return false;
        proto = pkt[9];
        ip_len = be16(pkt + 2);
        fam = 4;
        row[0] = row[1] = row[2] = 0;
        row[3] = be32(pkt + 12);
        row[4] = row[5] = row[6] = 0;
        row[7] = be32(pkt + 16);
        l4 = pkt + ihl;
        l4_len = len - ihl;
        uint8_t scratch[8];
        if (!resolve_fragment(pkt, proto, &l4, &l4_len, scratch))
            return false;  // mid-fragment with no tracked first frag
        if (l4 == scratch) {
            // the prefix must outlive this frame's scope: parse ports
            // now and short-circuit (a resolved mid-fragment is never
            // an overlay or an ICMP error)
            row[8] = be16(scratch);
            row[9] = be16(scratch + 2);
            row[10] = proto;
            row[11] = 0;  // no TCP flags on a headerless fragment
            row[12] = ip_len;
            row[13] = fam;
            row[14] = ep;
            row[15] = dir;
            return true;
        }
    } else if (ver == 6 && len >= 40) {
        proto = pkt[6];
        ip_len = 40 + be16(pkt + 4);
        fam = 6;
        for (int w = 0; w < 4; ++w) row[w] = be32(pkt + 8 + 4 * w);
        for (int w = 0; w < 4; ++w) row[4 + w] = be32(pkt + 24 + 4 * w);
        l4 = pkt + 40;
        l4_len = len - 40;
    } else {
        return false;
    }
    // overlay decap: the row carries the INNER packet (bounded depth)
    if (depth < 2) {
        long inner_len;
        const uint8_t* inner = decap_overlay(proto, l4, l4_len,
                                             &inner_len);
        if (inner) {
            if (parse_ip(inner, inner_len, row, ep, dir, depth + 1))
                return true;
            // unparseable inner: fall through to the outer row,
            // matching the Python reference
        }
    }
    uint32_t sport = 0, dport = 0, flags = 0;
    if ((proto == 6 || proto == 17 || proto == 132) && l4_len >= 4) {
        sport = be16(l4);
        dport = be16(l4 + 2);
        if (proto == 6 && l4_len >= 14) flags = l4[13];
    } else if ((proto == 1 || proto == 58) && l4_len >= 2) {
        dport = l4[0];  // ICMP type rides the dport column
        // ICMP ERROR: relate to the embedded original packet — the
        // row carries the INNER tuple + FLAG_RELATED (matches
        // core/pcap.py build_row)
        if (icmp_is_error(proto, l4[0]) && l4_len >= 8 + 20) {
            const uint8_t* in = l4 + 8;
            const long in_len = l4_len - 8;
            const int iver = in[0] >> 4;
            if (iver == 4 && fam == 4 && in_len >= 20) {
                const int iihl = (in[0] & 0xF) * 4;
                if (iihl >= 20 && in_len >= iihl) {
                    const uint32_t iproto = in[9];
                    uint32_t isp = 0, idp = 0;
                    const uint8_t* il4 = in + iihl;
                    const long il4_len = in_len - iihl;
                    if ((iproto == 6 || iproto == 17 || iproto == 132)
                        && il4_len >= 4) {
                        isp = be16(il4);
                        idp = be16(il4 + 2);
                    } else if ((iproto == 1 || iproto == 58)
                               && il4_len >= 2) {
                        idp = il4[0];
                    }
                    row[0] = row[1] = row[2] = 0;
                    row[3] = be32(in + 12);
                    row[4] = row[5] = row[6] = 0;
                    row[7] = be32(in + 16);
                    row[8] = isp;
                    row[9] = idp;
                    row[10] = iproto;
                    row[11] = FLAG_RELATED;
                    row[12] = ip_len;
                    row[13] = fam;
                    row[14] = ep;
                    row[15] = dir;
                    return true;
                }
            } else if (iver == 6 && fam == 6 && in_len >= 40) {
                const uint32_t iproto = in[6];
                uint32_t isp = 0, idp = 0;
                const uint8_t* il4 = in + 40;
                const long il4_len = in_len - 40;
                if ((iproto == 6 || iproto == 17 || iproto == 132)
                    && il4_len >= 4) {
                    isp = be16(il4);
                    idp = be16(il4 + 2);
                } else if ((iproto == 1 || iproto == 58)
                           && il4_len >= 2) {
                    idp = il4[0];
                }
                for (int w = 0; w < 4; ++w) row[w] = be32(in + 8 + 4 * w);
                for (int w = 0; w < 4; ++w)
                    row[4 + w] = be32(in + 24 + 4 * w);
                row[8] = isp;
                row[9] = idp;
                row[10] = iproto;
                row[11] = FLAG_RELATED;
                row[12] = ip_len;
                row[13] = fam;
                row[14] = ep;
                row[15] = dir;
                return true;
            }
        }
    }
    row[8] = sport;
    row[9] = dport;
    row[10] = proto;
    row[11] = flags;
    row[12] = ip_len;
    row[13] = fam;
    row[14] = ep;
    row[15] = dir;
    return true;
}

// Ethernet frame -> IP payload (skipping VLAN tags); nullptr if non-IP.
const uint8_t* eth_payload(const uint8_t* frame, long len, long* ip_len) {
    if (len < 14) return nullptr;
    uint16_t ethertype = be16(frame + 12);
    long off = 14;
    while ((ethertype == 0x8100 || ethertype == 0x88A8) &&
           len >= off + 4) {
        ethertype = be16(frame + off + 2);
        off += 4;
    }
    if (ethertype != 0x0800 && ethertype != 0x86DD) return nullptr;
    *ip_len = len - off;
    return frame + off;
}

}  // namespace

extern "C" {

// Length-prefixed frame stream: [u32le frame_len][frame bytes]...
// Writes up to max_rows rows into out ([max_rows * N_COLS] u32);
// returns the number of rows produced.
long parse_frames(const uint8_t* buf, long buf_len, uint32_t* out,
                  long max_rows, uint32_t ep, uint32_t dir) {
    long off = 0, rows = 0;
    while (off + 4 <= buf_len && rows < max_rows) {
        uint32_t flen;
        std::memcpy(&flen, buf + off, 4);  // little-endian host
        off += 4;
        if (off + flen > buf_len) break;
        long ip_len;
        const uint8_t* ip = eth_payload(buf + off, flen, &ip_len);
        if (ip && parse_ip(ip, ip_len, out + rows * N_COLS, ep, dir))
            ++rows;
        off += flen;
    }
    return rows;
}

// Classic libpcap file buffer -> rows.  Handles both byte orders and
// LINKTYPE_ETHERNET (1) / LINKTYPE_RAW (101).
long parse_pcap(const uint8_t* buf, long buf_len, uint32_t* out,
                long max_rows, uint32_t ep, uint32_t dir) {
    if (buf_len < 24) return 0;
    uint32_t magic;
    std::memcpy(&magic, buf, 4);
    bool swapped;
    if (magic == 0xA1B2C3D4u) swapped = false;
    else if (magic == 0xD4C3B2A1u) swapped = true;
    else return -1;  // not a pcap
    auto rd32 = [&](long off) {
        uint32_t v;
        std::memcpy(&v, buf + off, 4);
        if (swapped) v = __builtin_bswap32(v);
        return v;
    };
    const uint32_t linktype = rd32(20);
    long off = 24, rows = 0;
    while (off + 16 <= buf_len && rows < max_rows) {
        const uint32_t caplen = rd32(off + 8);
        off += 16;
        if (off + caplen > buf_len) break;
        const uint8_t* frame = buf + off;
        off += caplen;
        const uint8_t* ip = nullptr;
        long ip_len = 0;
        if (linktype == 1) {
            ip = eth_payload(frame, caplen, &ip_len);
        } else if (linktype == 101) {
            ip = frame;
            ip_len = caplen;
        } else {
            continue;
        }
        if (ip && parse_ip(ip, ip_len, out + rows * N_COLS, ep, dir))
            ++rows;
    }
    return rows;
}

}  // extern "C"
