"""The shard mesh, flow routing, and the sharded datapath step.

Reference: the JAX package's ``parallel/mesh.py``.  Upstream cilium
scales per-packet work across CPUs (per-CPU eBPF execution, RSS steering
flows to CPUs); the reference maps that onto a JAX device mesh, with a
``shard_map`` of the datapath step over the ``data`` axis: policy and
ipcache replicated, each chip a private CT shard, the batch split into
flow-routed blocks, and the drop and metric counters ``psum``-ed.

The port's mesh is S shards on ONE card (:class:`ShardMesh`).  The
device arrays are the reference's global arrays: the CT stays one
[C, ROW_WORDS] table whose shard s owns rows [s*C/S, (s+1)*C/S), the
event ring one [S*cap, RING_WORDS] buffer with an [S, 2] cursor, and
the psum is the sum of the per-shard deltas.  On the card one launch
sequence serves every shard: the verdict kernel (K1s), the CT update
(K4s) and the ring append (K5s) take the shard as a grid dimension
(``csrc/verdict.cu``, ``csrc/conntrack.cu``, ``csrc/ring.cu``).  The
plain version (:func:`sharded_serve_plain`) loops over the shards and
runs the single-shard plain versions on slice views; it runs for CPU
tensors and as the kernels' yardstick, never on the card's path.

The host routing (``_flow_hash_mix`` .. ``route_by_flow``) is a copy of
the reference's numpy code.  A mesh that spans several cards (NCCL) is
not ported (ROADMAP).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..core.packets import (COL_DPORT, COL_DST_IP0, COL_PROTO, COL_SPORT,
                            COL_SRC_IP0, N_COLS, normalize_ports)
from ..datapath.conntrack import CTTable
from ..datapath.verdict import DatapathState
from ..device import resolve_device
from ..kernels import shard_block
from ..u32 import MASK, narrow, widen

AXIS = "data"
# the drain's ring_gather kernel (K6) takes up to 8 shards
MAX_SHARDS = 8


@dataclass(frozen=True)
class ShardMesh:
    """S shards of the serving step on one device (the reference's 1-D
    ``data`` mesh over chips)."""

    n_shards: int
    device: torch.device


def make_mesh(n_shards: int, device=None) -> ShardMesh:
    """An S-shard mesh on ``device`` (None: the card; raises without
    one).  S is a power of two up to :data:`MAX_SHARDS`, so every CT
    slice of a 2^k table is 2^k slots."""
    n = int(n_shards)
    if not 1 <= n <= MAX_SHARDS or n & (n - 1):
        raise ValueError(f"n_shards must be a power of two in [1, "
                         f"{MAX_SHARDS}], got {n_shards}")
    return ShardMesh(n, resolve_device(device))


def _flow_hash_mix(src: np.ndarray, dst: np.ndarray,
                   sport: np.ndarray, dport: np.ndarray,
                   proto: np.ndarray, n_shards: int) -> np.ndarray:
    """The ONE symmetric flow-hash definition (uint64 inputs).

    Commutative combines of src/dst words and ports, so forward and
    reply orientations hash identically — shared by the header path
    (:func:`flow_shard_ids`) and the CT-snapshot path
    (:func:`ct_rows_slot_ids`): a CT row MUST land on the same slot
    as the packets that created it."""
    h = np.zeros(len(proto), dtype=np.uint64)
    for w in range(4):
        h = h * 31 + (src[:, w] + dst[:, w])
        h ^= (src[:, w] ^ dst[:, w]) * np.uint64(0x9E3779B97F4A7C15)
    h += (sport + dport) * np.uint64(0x85EBCA6B)
    h ^= (sport ^ dport) * np.uint64(0xC2B2AE35)
    h += proto
    h ^= h >> 33
    h *= np.uint64(0xFF51AFD7ED558CCD)
    h ^= h >> 33
    return (h % np.uint64(n_shards)).astype(np.int64)


def flow_shard_ids(data: np.ndarray, n_shards: int) -> np.ndarray:
    """Symmetric flow hash -> shard id per packet (host numpy).

    Direction-invariant: uses commutative combines of src/dst words and
    ports so a flow's forward and reply packets hash identically."""
    d = data.astype(np.uint64)
    src = d[:, COL_SRC_IP0:COL_SRC_IP0 + 4]
    dst = d[:, COL_DST_IP0:COL_DST_IP0 + 4]
    # same tuple normalization as ct_keys_from_headers, or a flow's
    # packets would land on a shard that doesn't own its CT entry
    sport, dport = normalize_ports(np, d[:, COL_PROTO], d[:, COL_SPORT],
                                   d[:, COL_DPORT])
    return _flow_hash_mix(src, dst, sport, dport, d[:, COL_PROTO],
                          n_shards)


def ct_rows_slot_ids(rows: np.ndarray, n_shards: int) -> np.ndarray:
    """Dense CT snapshot rows ([n, ROW_WORDS], conntrack layout) ->
    the same flow slot :func:`flow_shard_ids` assigns the flow's
    packets.

    The CT key already carries NORMALIZED ports (word 8 =
    sport << 16 | dport after ``normalize_ports``) and the proto in
    word 9's low byte, and the hash mix is commutative in both the
    address pair and the port pair — so hashing straight from the
    key words reproduces the header-side slot regardless of which
    direction created the entry."""
    d = np.asarray(rows).astype(np.uint64)
    if d.ndim != 2 or d.shape[1] < 10:
        raise ValueError(
            f"want dense CT rows [n, ROW_WORDS], got {d.shape}")
    src = d[:, 0:4]
    dst = d[:, 4:8]
    ports = d[:, 8]
    sport = ports >> np.uint64(16)
    dport = ports & np.uint64(0xFFFF)
    proto = d[:, 9] & np.uint64(0xFF)
    return _flow_hash_mix(src, dst, sport, dport, proto, n_shards)


def route_by_flow(data: np.ndarray, n_shards: int,
                  block: Optional[int] = None,
                  out: Optional[Tuple[np.ndarray, np.ndarray,
                                      np.ndarray]] = None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Steer packets into equal-size per-shard blocks (host side).

    Returns (routed [n_shards*block, N_COLS], valid [...] bool,
    orig_idx [...] int64 — original row index, -1 on padding,
    n_overflow — packets dropped because their shard's block was full).
    The RSS analogue: an overflow is an RSS queue overflow and MUST be
    accounted (:func:`add_route_overflow`).

    ``block`` (per-shard rows) should be FIXED by the caller across
    batches.  Default: 2x the fair share, rounded to a power of two.
    ``out`` is an optional preallocated ``(routed, valid, orig)``
    triple with shapes ``[n_shards*block, N_COLS] u32 /
    [n_shards*block] bool / int64``; contents are fully overwritten."""
    ids = flow_shard_ids(data, n_shards)
    if block is None:
        fair = max(-(-len(data) // n_shards), 1)
        block = 1
        while block < 2 * fair:
            block *= 2
    # one stable argsort groups packets by shard; a packet's slot is
    # shard*block + its rank within the shard, ranks >= block are the
    # RSS-queue-overflow drops
    n = len(data)
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    counts = np.bincount(ids, minlength=n_shards)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    rank = np.arange(n, dtype=np.int64) - starts[sorted_ids]
    keep = rank < block
    n_overflow = int(n - keep.sum())
    dest = sorted_ids[keep] * block + rank[keep]
    src_rows = order[keep]
    if out is None:
        routed = np.zeros((n_shards * block, N_COLS), dtype=np.uint32)
        valid = np.zeros(n_shards * block, dtype=bool)
        orig = np.full(n_shards * block, -1, dtype=np.int64)
    else:
        routed, valid, orig = out
        assert routed.shape[0] == valid.shape[0] == orig.shape[0] \
            == n_shards * block, "out buffers must match the routed shape"
        routed[:] = 0
        valid[:] = False
        orig[:] = -1
    routed[dest] = data[src_rows]
    valid[dest] = True
    orig[dest] = src_rows
    return routed, valid, orig, n_overflow


def add_host_drops(state: DatapathState, reason: int,
                   n: int) -> DatapathState:
    """Account host-side drops in the metricsmap (ingress column), in
    place: flow-router overflow (REASON_ROUTE_OVERFLOW) and the serving
    recovery plane's lost batches.  ``TorchLoader.add_host_drops`` is
    the daemon's lock-aware entry."""
    if n == 0:
        return state
    m = state.metrics
    m[int(reason), 0] = narrow(widen(m[int(reason), 0]) + int(n))
    return state


def add_route_overflow(state: DatapathState, n: int) -> DatapathState:
    """RSS-queue-overflow accounting: see :func:`add_host_drops`."""
    from ..datapath.verdict import REASON_ROUTE_OVERFLOW

    return add_host_drops(state, REASON_ROUTE_OVERFLOW, n)


def shard_state(state: DatapathState, mesh: ShardMesh) -> DatapathState:
    """Check that ``state`` splits over ``mesh``: C divisible by S and
    each CT slice 2^k slots (the reference's probe mask is per shard).
    Nothing moves: the slices are row ranges of the one table."""
    shard_block(0, mesh.n_shards, "shard_state", state.ct.capacity)
    return state


def make_sharded_ring(mesh: ShardMesh, capacity: int):
    """Per-shard private event rings as ONE ring: ``buf``
    [n_shards * capacity, RING_WORDS] (shard s owns its contiguous
    block), ``cursor`` [n_shards, 2]."""
    from ..monitor.ring import RING_WORDS, EventRing

    assert capacity & (capacity - 1) == 0, "capacity must be 2^k"
    s = mesh.n_shards
    return EventRing(
        buf=torch.full((s * capacity, RING_WORDS), -1, dtype=torch.int32,
                       device=mesh.device),
        cursor=torch.zeros((s, 2), dtype=torch.int32, device=mesh.device))


def _shard_part(state: DatapathState, s: int, n_shards: int
                ) -> DatapathState:
    """Shard s's view of ``state``: its CT slice (row views of the one
    table, written through) with fresh counters for its deltas."""
    ct, cs = state.ct, state.ct.capacity // n_shards
    part = CTTable(table=ct.table[s * cs:(s + 1) * cs],
                   fp=ct.fp[s * cs:(s + 1) * cs],
                   dropped=torch.zeros_like(ct.dropped))
    return DatapathState(policy=state.policy, ipcache=state.ipcache,
                         ct=part, metrics=torch.zeros_like(state.metrics))


def _psum(total: torch.Tensor, deltas) -> None:
    """``total`` += the per-shard deltas, in shard order, u32 wrapping
    (the reference's psum), in place."""
    acc = widen(total)
    for d in deltas:
        acc = (acc + widen(d)) & MASK
    total.copy_(narrow(acc))


def sharded_verdict_plain(state: DatapathState, hdr: torch.Tensor,
                          now: int, n_shards: int,
                          valid: Optional[torch.Tensor] = None, ep=None,
                          dirn=None, audit: bool = False):
    """K1s, plain version: each shard's block through the single-shard
    plain verdict stage against its CT slice, then the metric deltas
    summed in shard order.  -> (out [S*block, N_OUT], the ``ct_update``
    inputs with slots local to each slice).  ``ep``/``dirn`` given:
    ``hdr`` is packed."""
    from ..core.packets import unpack_hdr
    from ..datapath.verdict import CTUpdateInput, verdict_stage_plain

    now = int(now) & MASK
    S = int(n_shards)
    block = shard_block(hdr.shape[0], S, "datapath", state.ct.capacity)
    outs, ctins, deltas = [], [], []
    for s in range(S):
        rows = hdr[s * block:(s + 1) * block]
        v = None if valid is None else valid[s * block:(s + 1) * block]
        part = _shard_part(state, s, S)
        h = rows if ep is None else unpack_hdr(rows, ep, dirn)
        out, c = verdict_stage_plain(part, h, now, valid=v, audit=audit)
        outs.append(out)
        ctins.append(c)
        deltas.append(part.metrics)
    _psum(state.metrics, deltas)
    ctin = CTUpdateInput(**{f: torch.cat([getattr(c, f) for c in ctins])
                            for f in ("l4", "fwd", "result", "slot",
                                      "is_reply", "do_create",
                                      "proxy_port")})
    return torch.cat(outs), ctin


def sharded_ct_update_plain(ct: CTTable, c, now: int, n_shards: int,
                            valid: Optional[torch.Tensor] = None) -> CTTable:
    """K4s, plain version: each shard's rows through the single-shard
    plain ``ct_update`` on its slice; the drop deltas summed in shard
    order.  ``c`` holds the verdict stage's ``ct_update`` inputs."""
    from ..datapath.conntrack import ct_update_plain

    now = int(now) & MASK
    S = int(n_shards)
    block = shard_block(c.fwd.shape[0], S, "ct_update", ct.capacity)
    cs = ct.capacity // S
    deltas = []
    for s in range(S):
        r = slice(s * block, (s + 1) * block)
        part = CTTable(table=ct.table[s * cs:(s + 1) * cs],
                       fp=ct.fp[s * cs:(s + 1) * cs],
                       dropped=torch.zeros_like(ct.dropped))
        ct_update_plain(part, c.l4[r], c.fwd[r], c.result[r], c.slot[r],
                        c.is_reply[r], c.do_create[r], c.proxy_port[r],
                        now, None if valid is None else valid[r])
        deltas.append(part.dropped)
    _psum(ct.dropped, deltas)
    return ct


def sharded_ring_append_plain(ring, out: torch.Tensor, batch_id: int,
                              n_shards: int, trace_sample: int = 1024,
                              valid: Optional[torch.Tensor] = None,
                              proxy_ports: Optional[torch.Tensor] = None):
    """K5s, plain version: each shard's block of out rows appended to
    its own ring (a [cap, RING_WORDS] slice of the buffer and its row of
    the [S, 2] cursor) by the single-ring plain ``ring_append``, with
    shard-local packet indices."""
    from ..monitor.ring import EventRing, ring_append_plain

    S = int(n_shards)
    block = shard_block(out.shape[0], S, "ring_append")
    cap = ring.buf.shape[0] // S
    for s in range(S):
        r = slice(s * block, (s + 1) * block)
        ring_append_plain(EventRing(buf=ring.buf[s * cap:(s + 1) * cap],
                                    cursor=ring.cursor[s]),
                          out[r], batch_id, trace_sample,
                          None if valid is None else valid[r], proxy_ports)
    return ring


def sharded_serve_plain(state: DatapathState, ring, hdr: torch.Tensor,
                        now: int, batch_id: int, n_shards: int,
                        valid: Optional[torch.Tensor] = None,
                        proxy_ports: Optional[torch.Tensor] = None,
                        trace_sample: int = 1024, ep=None, dirn=None,
                        audit: bool = False) -> torch.Tensor:
    """The sharded step, plain version (over any device's tensors): the
    three per-shard loops above, the ring append only with a ``ring``.
    Updates ``state`` and ``ring`` in place; returns the out rows
    [S * block, N_OUT].  It runs for CPU tensors and as the kernels'
    yardstick, never on the card's serving path."""
    out, c = sharded_verdict_plain(state, hdr, now, n_shards, valid, ep,
                                   dirn, audit)
    sharded_ct_update_plain(state.ct, c, now, n_shards, valid)
    if ring is not None:
        sharded_ring_append_plain(ring, out, batch_id, n_shards,
                                  trace_sample, valid, proxy_ports)
    return out


def sharded_serve_launch(state: DatapathState, ring, hdr: torch.Tensor,
                         now: int, batch_id: int, n_shards: int,
                         valid: Optional[torch.Tensor] = None,
                         proxy_ports: Optional[torch.Tensor] = None,
                         trace_sample: int = 1024, ep=None, dirn=None,
                         audit: bool = False) -> torch.Tensor:
    """The sharded step on the card: K1s, K4s and (with a ``ring``) K5s,
    one launch sequence for all shards; arguments as
    :func:`sharded_serve_plain`."""
    from ..kernels import (launch_ct_update, launch_datapath,
                           launch_ring_append)

    now = int(now) & MASK
    out, c = launch_datapath(state, hdr, now, ep, dirn, valid, None, None,
                             None, audit, n_shards=n_shards)
    launch_ct_update(state.ct, c.l4, c.fwd, c.result, c.slot, c.is_reply,
                     c.do_create, c.proxy_port, now, valid,
                     n_shards=n_shards)
    if ring is not None:
        launch_ring_append(ring, out, batch_id, trace_sample, valid,
                           proxy_ports, n_shards=n_shards)
    return out


def sharded_serve(state: DatapathState, ring, hdr: torch.Tensor,
                  now: int, batch_id: int, n_shards: int,
                  valid: Optional[torch.Tensor] = None,
                  proxy_ports: Optional[torch.Tensor] = None,
                  trace_sample: int = 1024, ep=None, dirn=None,
                  audit: bool = False) -> torch.Tensor:
    """The sharded step, arguments as :func:`sharded_serve_plain`: CUDA
    tensors launch the sharded kernels (:func:`sharded_serve_launch`),
    CPU tensors take :func:`sharded_serve_plain`."""
    if proxy_ports is not None and proxy_ports.shape[0] == 0:
        proxy_ports = None  # an empty table: no listeners
    args = (state, ring, hdr, now, batch_id, n_shards)
    kw = dict(valid=valid, proxy_ports=proxy_ports,
              trace_sample=trace_sample, ep=ep, dirn=dirn, audit=audit)
    if hdr.is_cuda:
        return sharded_serve_launch(*args, **kw)
    if hdr.device.type != "cpu":
        raise ValueError(f"sharded step: no kernel for {hdr.device}")
    return sharded_serve_plain(*args, **kw)


def make_sharded_serve_step(mesh: ShardMesh, packed: bool = False,
                            trace_sample: int = 1024,
                            audit: bool = False) -> Callable:
    """The sharded SERVING step: per shard, datapath + event-ring append
    on its flow-routed block, its CT slice and its private ring (see
    :func:`make_sharded_ring`), counters summed over the shards.

    ``step(state, ring, hdr, now, batch_id, valid, proxy_ports[, ep,
    dirn]) -> (state, ring)``, both updated in place; ``hdr`` is the
    routed [S*block, N_COLS] tensor, or [S*block, 4] packed rows with
    ``packed=True`` (``ep``/``dirn`` the stream scalars).
    ``proxy_ports`` may be None or empty (no listeners)."""
    S = mesh.n_shards

    def step(state, ring, hdr, now, batch_id, valid, proxy_ports,
             ep=None, dirn=None):
        if packed and ep is None:
            raise ValueError("the packed sharded step needs ep and dirn")
        sharded_serve(state, ring, hdr, now, batch_id, S, valid,
                      proxy_ports, trace_sample, ep if packed else None,
                      dirn if packed else None, audit)
        return state, ring

    return step


def make_sharded_step(mesh: ShardMesh) -> Callable:
    """The sharded offline step over wide routed rows, no ring:
    ``step(state, hdr, now, valid) -> (out, state)``, ``out``
    [S*block, N_OUT] in routed order, ``state`` updated in place."""
    S = mesh.n_shards

    def step(state, hdr, now, valid):
        out = sharded_serve(state, None, hdr, now, 0, S, valid,
                            trace_sample=0)
        return out, state

    return step
