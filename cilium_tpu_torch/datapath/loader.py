"""The Loader seam: agent-facing datapath interface + the torch backend.

Reference: upstream cilium ``pkg/datapath`` — the ``Loader`` /
``Datapath`` interfaces that ``daemon`` drives ("compile + attach"
eBPF).  "compile+attach" becomes "compile policy/ipcache tensors + bind
device buffers".  The :class:`Loader` ABC is a copy of the JAX
package's; :class:`TorchLoader` is the CUDA backend.

Policy/ipcache updates swap tensors while KEEPING the live conntrack
table and metric counters — the analogue of cilium replacing pinned
BPF programs while maps persist in bpffs.

Stream ordering replaces JAX's donation: every step updates CT, ring
and metrics in place on the current CUDA stream, and ``attach`` builds
the new policy/ipcache tensors off the lock and swaps the references
under it.  A step enqueued before the swap keeps reading the tensors it
was handed: the caching allocator reuses their memory only after the
stream has passed that step, so the swap needs no device sync.  A
step on ANOTHER stream would break that ordering; the loader launches
everything on the current stream.

Staging: a batch given as a C-contiguous u32 (or bool) numpy array goes
to the card as ONE ``non_blocking`` copy straight from its memory.  The
serving batcher hands out slots of pinned host memory (serving/
batcher.py), so that copy is truly asynchronous: the caller must leave
the array alone until the copy has run, which the batcher's recycling
horizon guarantees.  A pageable array is copied before the call
returns, as CUDA stages pageable memory itself.
"""

from __future__ import annotations

import abc
import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..policy.compiler import IdentityRowMap, compile_policy
from ..policy.resolve import EndpointPolicy
from ..u32 import from_numpy, narrow, to_numpy, widen
from .conntrack import CTTable, ct_gc, ct_rows_from_table
from .lpm import DeviceLPM, compile_lpm
from .verdict import (MAX_ENDPOINTS, DatapathState, DevicePolicy,
                      datapath_step)


def _ct_occupied_plain(fp: torch.Tensor) -> torch.Tensor:
    """Occupied CT slots (live + expired-but-unswept): fp != 0, the
    per-slot fingerprint's free marker doubling as the occupancy
    bitmap, so the sample reads 4 B a slot instead of the 68 B rows
    (plain version)."""
    return (fp != 0).sum()


def _ct_occupied(fp: torch.Tensor) -> torch.Tensor:
    """See :func:`_ct_occupied_plain`.  CUDA tensors launch the
    ``ct_occupied`` kernel; the count stays on the card until read."""
    if fp.is_cuda:
        from ..kernels import launch_ct_occupied

        return launch_ct_occupied(fp)
    if fp.device.type != "cpu":
        raise ValueError(f"_ct_occupied: no kernel for {fp.device}")
    return _ct_occupied_plain(fp)


class Loader(abc.ABC):
    """What the agent needs from a datapath (pkg/datapath.Loader)."""

    @abc.abstractmethod
    def attach(self, policies: Sequence[EndpointPolicy],
               ipcache: Dict[str, int], ep_policy: Dict[int, int],
               row_map: IdentityRowMap) -> None:
        """Full (re)compile + swap — endpoint regeneration's final step.

        ``ipcache`` maps cidr -> NUMERIC identity; ``ep_policy`` maps
        endpoint id -> row index into ``policies``."""

    @abc.abstractmethod
    def step(self, hdr: np.ndarray, now: int, pre_drop=None,
             pre_drop_reason=None, lb_drop=None, audit=False):
        """Verdict one batch.

        Returns ``(out, row_map)``: the out tensor [N, N_OUT] plus the
        IdentityRowMap snapshot that produced it.  The snapshot is
        taken under the same lock as the device step so a concurrent
        ``attach`` can never make the caller decode OUT_ID_ROW values
        through the wrong row table.  ``pre_drop`` ([N] bool) is the
        SNAT stage's exhaustion mask from :meth:`masquerade`."""

    @abc.abstractmethod
    def gc(self, now: int) -> int:
        """Expire CT entries; returns eviction count."""

    # -- mutual authentication (pkg/auth authmap analogue) ------------
    @abc.abstractmethod
    def auth_upsert(self, ep_id: int, remote_id: int,
                    expires: int) -> bool:
        """Grant (subject endpoint's identity, remote identity) until
        ``expires``.  Entries are identity-granular: endpoints sharing
        a policy row (same labels) share the grant, exactly upstream's
        {local identity, remote identity} authmap key."""

    @abc.abstractmethod
    def auth_entries(self) -> list:
        """Live grants for `cilium-tpu bpf auth list`."""

    @abc.abstractmethod
    def auth_gc(self, now: int) -> int:
        """Drop expired grants; returns eviction count."""

    @abc.abstractmethod
    def metrics(self) -> np.ndarray:
        """[N_REASONS, 2] per-reason/direction packet counters."""

    @abc.abstractmethod
    def ct_snapshot(self) -> np.ndarray:
        """CT table contents for checkpoint / `bpf ct list`."""

    @abc.abstractmethod
    def ct_restore(self, table: np.ndarray) -> None:
        """Reload a CT snapshot (agent restart keeps connections)."""

    # -- incremental updates (SURVEY.md §7 hard part #3) --------------
    # Identity churn must NOT cost a full compile_policy + upload; the
    # default False sends callers down the full-attach path, backends
    # that can patch in place override.

    def patch_identity(self, kind: str, numeric_id: int,
                       policies) -> bool:
        """Patch one identity's verdict row in place (peer sets in
        ``policies`` must already reflect the change — see
        policy.incremental.update_contributions).  Returns False when
        a full attach is required instead."""
        return False

    def patch_ipcache(self, cidr: str, numeric_id: int) -> bool:
        """Patch one ipcache prefix -> identity mapping in place."""
        return False

    def delete_ipcache(self, cidr: str) -> bool:
        """Remove one ipcache prefix in place (fqdn TTL expiry)."""
        return False

    # -- map pressure (pkg/maps ctmap pressure analogue; the
    # sample reaches beyond CT: LPM/ipcache prefix
    # occupancy and policy-table row occupancy ride the same
    # snapshot, feeding cilium_lpm_occupancy /
    # cilium_policy_map_occupancy and the map-headroom SLO) ----------
    def map_pressure(self, now: int) -> dict:
        """Point-in-time map-pressure snapshot: CT occupancy +
        cumulative insert drops, NAT pool failures, LPM/ipcache and
        policy-table occupancy.  Backends override; the default
        reports an unmeasurable world (the monitor then keys on the
        counters alone)."""
        return {"ct": {"capacity": 0, "occupied": 0,
                       "occupancy": None, "insert-drops": 0},
                "nat": {"capacity": None, "failures": 0},
                "lpm": {"capacity": 0, "entries": 0,
                        "occupancy": None},
                "policy": {"capacity": 0, "rows": 0,
                           "occupancy": None}}


class TorchLoader(Loader):
    """The datapath on torch tensors: the verdict step and the event
    ring run in the hand-written kernels on the card (``device`` None
    or "cuda"), or in their plain versions on the CPU (``device="cpu"``).

    Ported: full ``attach``, ``step``, ``serve``, ``serve_packed``,
    ``serve_superbatch``, ``gc``, ``map_pressure``, ``add_host_drops``,
    ``metrics`` and ``ct_snapshot``.  The in-place patches answer False
    (a full attach is required), as the Loader contract allows.  The
    rest raises NotImplementedError naming its ROADMAP item."""

    def __init__(self, ct_capacity: int = 1 << 20, device=None):
        self.device = resolve_device(device)
        self.ct_capacity = ct_capacity
        self.state: Optional[DatapathState] = None
        self.row_map: Optional[IdentityRowMap] = None
        self.attach_count = 0
        # programmed ipcache prefixes (the map-pressure sample's LPM
        # entry count), set by attach
        self._lpm_entries = 0
        # the lock covers the step enqueue + state swap only; host
        # compile and h2d staging happen before it is taken
        self._lock = threading.Lock()
        # host-side drop counts waiting for a free lock (add_host_drops)
        self._host_drops: Dict[int, int] = {}
        self._host_drops_lock = threading.Lock()

    def _to_device(self, a) -> Optional[torch.Tensor]:
        """A host batch on the loader's device: one copy from the
        array's own memory, asynchronous from pinned memory (module
        doc); other dtypes and layouts go through ``u32.from_numpy``."""
        if a is None or isinstance(a, torch.Tensor):
            return None if a is None else a.to(self.device)
        a = np.asarray(a)
        if a.dtype == np.bool_:
            view = a
        elif a.dtype in (np.uint32, np.int32):
            view = a.view(np.int32)
        else:
            return from_numpy(a, self.device)
        if not (view.flags.c_contiguous and view.flags.writeable):
            view = view.copy()
        t = torch.from_numpy(view)
        if self.device.type == "cpu":
            return t.clone()
        return t.to(self.device, non_blocking=True)

    def attach(self, policies, ipcache, ep_policy, row_map) -> None:
        """Full (re)compile + swap: new tensors are built and uploaded
        off the lock, and only the reference swap takes it.  Live CT
        and metrics carry over."""
        policies = list(policies)
        # -1 = lxcmap-miss sentinel: a packet with an unregistered
        # endpoint id DROPS (REASON_NO_ENDPOINT)
        epp = np.full(MAX_ENDPOINTS, -1, dtype=np.int32)
        for ep_id, pol_row in ep_policy.items():
            if not 0 <= ep_id < MAX_ENDPOINTS:
                raise ValueError(
                    f"endpoint id {ep_id} out of range "
                    f"[0, {MAX_ENDPOINTS})")
            epp[ep_id] = pol_row
        tensors = compile_policy(policies, row_map)
        # no grants yet: the authmap plane is a later slice
        auth = np.zeros((len(policies), tensors.verdict.shape[2]),
                        dtype=np.uint32)
        policy = DevicePolicy.from_tensors(tensors, epp, auth,
                                           device=self.device)
        lpm = compile_lpm({c: row_map.row(i) for c, i in ipcache.items()})
        ipc = DeviceLPM.from_tensors(lpm, self.device)
        ct = None
        if self.state is None:
            ct = CTTable.create(self.ct_capacity, device=self.device)
        with self._lock:
            if self.state is None:
                self.state = DatapathState.create(policy, ipc, ct)
            else:
                self.state = DatapathState(
                    policy=policy, ipcache=ipc, ct=self.state.ct,
                    metrics=self.state.metrics)
            self.row_map = row_map
            self._lpm_entries = len(ipcache)
            self.attach_count += 1

    def step(self, hdr, now: int, pre_drop=None, pre_drop_reason=None,
             lb_drop=None, audit=False):
        """Verdict one batch of wide rows [N, N_COLS]; returns the out
        rows as a host u32 array and the row map that produced them."""
        hdr = self._to_device(hdr)
        pre_drop = self._to_device(pre_drop)
        pre_drop_reason = self._to_device(pre_drop_reason)
        lb_drop = self._to_device(lb_drop)
        with self._lock:
            out, self.state = datapath_step(
                self.state, hdr, now, pre_drop=pre_drop,
                pre_drop_reason=pre_drop_reason, lb_drop=lb_drop,
                audit=audit)
            row_map = self.row_map
        return to_numpy(out), row_map

    def serve(self, ring, hdr, now: int, batch_id: int,
              trace_sample: int = 1024, proxy_ports=None,
              audit: bool = False, valid=None):
        """The serving-path step over wide rows: datapath + event-ring
        append, no host fetch.  Returns (ring, row_map); the ring is
        updated in place."""
        from ..infra import faults
        from ..monitor.ring import serve_step

        faults.check(faults.SITE_LOADER_SERVE)
        hdr = self._to_device(hdr)
        valid = self._to_device(valid)
        proxy_ports = self._to_device(proxy_ports)
        with self._lock:
            self.state, ring = serve_step(
                self.state, ring, hdr, now, batch_id,
                trace_sample=trace_sample, valid=valid,
                proxy_ports=proxy_ports, audit=audit)
            row_map = self.row_map
        return ring, row_map

    def serve_packed(self, ring, packed, now: int, batch_id: int,
                     ep: int, dirn: int, trace_sample: int = 1024,
                     proxy_ports=None, audit: bool = False,
                     valid=None):
        """The packed serving fast path: [N, 4] u32 rows (16 B/packet),
        unpacked inside the verdict kernel.  ``ep``/``dirn`` are
        per-batch stream scalars; ``valid`` masks padding rows."""
        from ..infra import faults
        from ..monitor.ring import serve_step_packed

        faults.check(faults.SITE_LOADER_SERVE_PACKED)
        packed = self._to_device(packed)
        valid = self._to_device(valid)
        proxy_ports = self._to_device(proxy_ports)
        with self._lock:
            self.state, ring = serve_step_packed(
                self.state, ring, packed, now, batch_id, ep, dirn,
                trace_sample=trace_sample, valid=valid,
                proxy_ports=proxy_ports, audit=audit)
            row_map = self.row_map
        return ring, row_map

    def serve_superbatch(self, ring, hdr, now: int, batch_id0: int,
                         eps=None, dirns=None, trace_sample: int = 1024,
                         proxy_ports=None, audit: bool = False,
                         valid=None, packed: bool = False):
        """The K-batch superbatch: ``hdr`` is [K, bucket, 4] packed rows
        (``packed=True``, with ``eps``/``dirns`` the K per-step stream
        scalars) or [K, bucket, N_COLS] wide rows; ``valid`` [K,
        bucket] masks padding rows AND whole empty trailing steps.  One
        staging copy each for the rows and the masks, one lock window,
        then K steps on the stream (monitor/ring.py serve_superbatch*).
        All K steps serve the one table generation the lock window
        sees."""
        from ..infra import faults
        from ..monitor.ring import (serve_superbatch,
                                    serve_superbatch_packed)

        faults.check(faults.SITE_LOADER_SERVE_SUPER)
        hdr = self._to_device(hdr)
        valid = self._to_device(valid)
        proxy_ports = self._to_device(proxy_ports)
        if packed:
            eps = [int(e) for e in np.asarray(eps, dtype=np.uint32)]
            dirns = [int(d) for d in np.asarray(dirns, dtype=np.uint32)]
        with self._lock:
            if packed:
                self.state, ring = serve_superbatch_packed(
                    self.state, ring, hdr, now, batch_id0, eps, dirns,
                    trace_sample=trace_sample, valid=valid,
                    proxy_ports=proxy_ports, audit=audit)
            else:
                self.state, ring = serve_superbatch(
                    self.state, ring, hdr, now, batch_id0,
                    trace_sample=trace_sample, valid=valid,
                    proxy_ports=proxy_ports, audit=audit)
            row_map = self.row_map
        return ring, row_map

    def add_host_drops(self, reason: int, n: int) -> None:
        # thread-affinity: any
        """Account host-side drops (recovery drops, dispatch timeouts)
        under ``reason`` in the device metricsmap.  NEVER BLOCKS on the
        dispatch lock: the caller may be the serving watchdog
        accounting a dispatch hung inside that very lock.  When the
        lock is busy the count waits in a host buffer that
        :meth:`metrics` folds into every read and later calls flush."""
        if n == 0:
            return
        with self._host_drops_lock:
            r = int(reason)
            self._host_drops[r] = self._host_drops.get(r, 0) + int(n)
        self._flush_host_drops()

    def _flush_host_drops(self) -> None:
        if not self._lock.acquire(blocking=False):
            return
        try:
            with self._host_drops_lock:
                pending, self._host_drops = self._host_drops, {}
            m = self.state.metrics
            for reason, n in pending.items():
                m[reason, 0] = narrow(widen(m[reason, 0]) + n)
        finally:
            self._lock.release()

    def metrics(self) -> np.ndarray:
        with self._lock:
            out = to_numpy(self.state.metrics).copy()
        # fold in host drops still waiting for a free lock (display
        # only: the flush stays the one writer)
        with self._host_drops_lock:
            for reason, n in self._host_drops.items():
                out[reason, 0] += np.uint32(n)
        return out

    def ct_snapshot(self) -> np.ndarray:
        """Dense live rows — the placement-free snapshot format."""
        with self._lock:
            table = self.state.ct.table
        return ct_rows_from_table(to_numpy(table))

    def gc(self, now: int) -> int:
        # thread-affinity: api, offline -- the ct-gc controller
        """The CT aging sweep (``ct_gc``), enqueued under the dispatch
        lock so it never lands between the K steps of a superbatch;
        the count is read after the lock is released."""
        with self._lock:
            n = ct_gc(self.state.ct, now)
        return int(n.sum())

    def map_pressure(self, now: int) -> dict:
        # thread-affinity: api, offline -- the map-pressure controller;
        # never the drain thread (reading the counts waits on the card)
        """The map-pressure sample (datapath/pressure.py): occupied CT
        slots from the fingerprints, cumulative insert drops, LPM
        prefixes and policy-table rows.  The device reads are enqueued
        under the dispatch lock and read after it.  NAT is not ported
        (ROADMAP B12): its pool reads as absent."""
        from .lpm import LPM_NOMINAL_CAPACITY

        with self._lock:
            ct = self.state.ct
            occupied = _ct_occupied(ct.fp)
            drops = ct.dropped.clone()
            lpm_entries = self._lpm_entries
            rows, rows_cap = (self.row_map.row_occupancy()
                              if self.row_map is not None else (0, 0))
        occupied = int(occupied.sum())
        drops = int(drops) & 0xFFFFFFFF
        return {
            "ct": {"capacity": self.ct_capacity,
                   "occupied": occupied,
                   "occupancy": round(occupied / self.ct_capacity, 4),
                   "insert-drops": drops},
            "nat": {"capacity": None, "failures": 0},
            "lpm": {"capacity": LPM_NOMINAL_CAPACITY,
                    "entries": lpm_entries,
                    "occupancy": round(
                        lpm_entries / LPM_NOMINAL_CAPACITY, 6)},
            "policy": {"capacity": rows_cap, "rows": rows,
                       "occupancy": (round(rows / rows_cap, 4)
                                     if rows_cap else None)},
        }

    def ct_restore(self, table: np.ndarray) -> None:
        raise NotImplementedError(
            "CT restore is not ported yet (ROADMAP A4: CT snapshot and "
            "restore)")

    def auth_upsert(self, ep_id: int, remote_id: int,
                    expires: int) -> bool:
        raise NotImplementedError(
            "the authmap plane is not ported yet (ROADMAP A5: auth "
            "grants)")

    def auth_entries(self) -> list:
        raise NotImplementedError(
            "the authmap plane is not ported yet (ROADMAP A5: auth "
            "grants)")

    def auth_gc(self, now: int) -> int:
        raise NotImplementedError(
            "the authmap plane is not ported yet (ROADMAP A5: auth "
            "grants)")

    # patch_identity / patch_ipcache / delete_ipcache: the Loader
    # defaults answer False ("a full attach is required"), and callers
    # regenerate; the in-place patches are ROADMAP B11.

    def masquerade(self, nat, hdr, now: int):
        raise NotImplementedError(
            "masquerade and NAT are not ported yet (ROADMAP B12)")

