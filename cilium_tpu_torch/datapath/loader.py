"""The Loader seam: agent-facing datapath interface + the torch backend.

Reference: upstream cilium ``pkg/datapath`` — the ``Loader`` /
``Datapath`` interfaces that ``daemon`` drives ("compile + attach"
eBPF).  "compile+attach" becomes "compile policy/ipcache tensors + bind
device buffers".  The :class:`Loader` ABC is a copy of the JAX
package's; :class:`TorchLoader` is the CUDA backend.

Policy/ipcache updates swap tensors while KEEPING the live conntrack
table and metric counters — the analogue of cilium replacing pinned
BPF programs while maps persist in bpffs.

TABLE GENERATIONS (``datapath/tables.py``): every table mutation —
``attach``, ``patch_identity``, ``patch_ipcache``, ``delete_ipcache``,
``auth_upsert`` — is a BUILDER.  It compiles and uploads holding only
the builder lock and publishes through ``_publish_tables``, which takes
the dispatch lock for the generation flip (and, for a patch or a delta
attach, the ``dus`` launches).  The host mirrors (``tensors``,
``_lpm_tensors``, ``_lpm_entries``, ``_policies``, ``_policy_fps``,
``_epp``) are painted after the flip, so a build that dies before it
leaves the published tables and the mirrors as they were.

Stream ordering replaces JAX's donation: every step updates CT, ring
and metrics in place on the current CUDA stream, which on every thread
of the daemon is the device's default stream.  ``attach`` builds the
new tensors off the lock and swaps the references under it; a step
enqueued before the swap keeps reading the tensors it was handed (the
caching allocator reuses their memory only after the stream has passed
that step).  A patch writes the live tensors IN PLACE (``_dus``, kernel
K10), so it must land in the stream's order: the loader enters its own
stream (``_stream``, the default stream) for every upload and launch of
a builder, whatever thread calls it — an FQDN mint runs on an L7 worker
inside the proxy's stream.  A patch launched under the dispatch lock
then runs after every step enqueued before it and before every step
enqueued after it, so no batch (and no superbatch, whose K steps share
one lock window) sees a half-patched table.

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
import contextlib
import ipaddress
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..policy.compiler import IdentityRowMap, compile_policy
from ..policy.resolve import EndpointPolicy
from ..u32 import from_numpy, narrow, to_numpy, widen
from .conntrack import CTTable, ct_gc, ct_rows_from_table
from .lpm import DeviceLPM, LPMEntries, LPMUndo, compile_lpm, lpm_upsert
from .tables import TableVersioner
from .verdict import (MAX_ENDPOINTS, DatapathState, DevicePolicy,
                      datapath_step)


def _dus_starts(dst_shape, upd_shape, starts) -> list:
    """``jax.lax.dynamic_update_slice``'s start rule: a negative start
    counts from the end once (``allow_negative_indices``), then XLA
    clamps it into [0, dst - upd], so the update always fits."""
    return [min(max(int(s) + d if int(s) < 0 else int(s), 0), d - u)
            for s, d, u in zip(starts, dst_shape, upd_shape)]


class DusRuns(NamedTuple):
    """An update cut into runs: ``counts[0] * counts[1] * counts[2]``
    pieces of ``run`` words, each contiguous in the update and in the
    table.  Run (q0, q1, q2) is the update's ((q0 c1 + q1) c2 + q2)-th
    and lands at ``base + q0 t0 + q1 t1 + q2 t2`` (t = ``strides``), all
    in words of the row-major table."""

    run: int
    counts: Tuple[int, int, int]
    strides: Tuple[int, int, int]
    base: int


def _dus_runs(dst_shape, upd_shape, starts) -> DusRuns:
    """The runs K10 copies for ``upd_shape`` written into ``dst_shape``
    at ``starts`` (:func:`_dus_starts`' rule).  The update's dimensions
    of size 1 drop out; a dimension merges into the next inner one
    where the update spans the inner one's full width (its table stride
    is the inner size times the inner stride); the innermost, if its
    table stride is 1, is the run, else a run is one word.  At most
    three dimensions are left (a rank-4 update with no dimension of 1
    has a stride-1 innermost), padded outermost with counts of 1."""
    strides, s = [], 1
    for d in reversed(dst_shape):
        strides.insert(0, s)
        s *= int(d)
    base = sum(a * t for a, t in zip(
        _dus_starts(dst_shape, upd_shape, starts), strides))
    dims = []  # (size, table stride), outermost first
    for u, t in zip(upd_shape, strides):
        u = int(u)
        if u == 1:
            continue
        if dims and dims[-1][1] == u * t:
            dims[-1] = (dims[-1][0] * u, t)
        else:
            dims.append((u, t))
    run = dims.pop()[0] if dims and dims[-1][1] == 1 else 1
    dims = [(1, 0)] * (3 - len(dims)) + dims
    return DusRuns(run, tuple(u for u, _ in dims),
                   tuple(t for _, t in dims), base)


def _dus_plain(dst: torch.Tensor, upd: torch.Tensor,
               starts) -> torch.Tensor:
    """``upd`` written into ``dst`` in place at ``starts``, taken as
    :func:`_dus_starts` takes them (plain version: a slice ``copy_``)."""
    if dst.dim() != upd.dim() or len(starts) != dst.dim():
        raise ValueError(f"dus: ranks dst {dst.dim()}, upd {upd.dim()}, "
                         f"starts {len(starts)}")
    idx = tuple(slice(s, s + u) for s, u in zip(
        _dus_starts(dst.shape, upd.shape, starts), upd.shape))
    dst[idx].copy_(upd)
    return dst


def _dus(dst: torch.Tensor, upd: torch.Tensor, starts) -> torch.Tensor:
    """The table patches' in-place ``dynamic_update_slice``: O(update),
    never a copy of the table.  CUDA tensors launch the ``dus`` kernel
    (K10) on the current stream; CPU tensors take :func:`_dus_plain`."""
    if dst.is_cuda:
        from ..kernels import launch_dus

        launch_dus(dst, upd, starts)
        return dst
    if dst.device.type != "cpu":
        raise ValueError(f"_dus: no kernel for {dst.device}")
    return _dus_plain(dst, upd, starts)


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
    """The datapath on torch tensors: the verdict step, the event ring
    and the table patches run in the hand-written kernels on the card
    (``device`` None or "cuda"), or in their plain versions on the CPU
    (``device="cpu"``).

    Ported: ``attach`` (a delta attach that repaints only the policies
    whose fingerprints changed when ``delta_compile`` and the shapes
    allow, else a full compile), the in-place patches
    ``patch_identity``, ``patch_ipcache`` and ``delete_ipcache``, the
    authmap plane ``auth_upsert``, ``auth_entries`` and ``auth_gc``,
    ``step``, ``serve``, ``serve_packed``, ``serve_superbatch``, sharded
    serving (``serving_shard``, ``serve_sharded``, ``serving_unshard``,
    ``add_route_overflow``), ``gc``, ``map_pressure``,
    ``add_host_drops``, ``metrics``, ``ct_snapshot``, ``ct_restore``,
    ``table_stats`` and the NAT pool's ``masquerade``, ``reverse_nat``,
    ``nat_status``, ``nat_snapshot`` and ``nat_restore``."""

    def __init__(self, ct_capacity: int = 1 << 20, device=None,
                 nat_capacity: Optional[int] = None,
                 delta_compile: bool = True, swap_warn_ms: float = 0.0):
        self.device = resolve_device(device)
        self.ct_capacity = ct_capacity
        # SNAT port-pool size (service/nat.py NATTable); None: the
        # NAT_DEFAULT_CAPACITY.  The table lives with the loader like
        # the CT does, made on the first masquerade
        self.nat_capacity = nat_capacity
        self.nat_state = None
        self.state: Optional[DatapathState] = None
        self.row_map: Optional[IdentityRowMap] = None
        self.attach_count = 0
        # mutual-auth grants, host-authoritative and guarded by the
        # dispatch lock: (ep_id, remote numeric identity) -> expires.
        # The device [n_pol, n_rows] table is their projection, rebuilt
        # on every attach (rows and policy indices shift; the keys stay)
        self._auth: Dict[Tuple[int, int], int] = {}
        # the lock covers the step enqueue + state swap only; host
        # compile and h2d staging happen before it is taken
        self._lock = threading.Lock()
        # the stream of the serve steps: every builder upload and patch
        # launch runs on it (module doc)
        self._stream = (torch.cuda.default_stream(self.device)
                        if self.device.type == "cuda" else None)
        # the published generation + the builder lock (lock order:
        # table-builder BEFORE the dispatch lock)
        self.tables = TableVersioner(warn_ms=swap_warn_ms)
        # delta attach (policy.incremental.delta_compile): repaint only
        # the policies whose fingerprints changed; _policy_fps is the
        # last attach's fingerprints (None until the first)
        self.delta_compile = bool(delta_compile)
        self._policy_fps: Optional[List[tuple]] = None
        # set while a publish is inside the dispatch lock: a builder
        # that dies there re-uploads from the mirrors (_building)
        self._swap_incomplete = False
        # host mirrors of the published tables, painted after each flip
        self.tensors = None  # PolicyTensors
        self._lpm_tensors = None  # LPMTensors
        self._lpm_entries = LPMEntries()  # cidr -> numeric
        self._policies = None
        self._epp = None  # endpoint -> policy row
        # host-side drop counts waiting for a free lock (add_host_drops)
        self._host_drops: Dict[int, int] = {}
        self._host_drops_lock = threading.Lock()
        # sharded serving (parallel/mesh.py): the mesh while serve_sharded
        # dispatches
        self._serving_mesh = None

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

    # -- table generations (datapath/tables.py) -------------------------
    def _on_stream(self):
        """Enter the loader's stream (module doc); nothing on the CPU."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _stage(self, a: np.ndarray) -> torch.Tensor:
        """A patch payload (int32 or u32 words) on the loader's device,
        uploaded off the dispatch lock on the loader's stream, so the
        ``dus`` launch that reads it comes after the copy.  From pinned
        memory and asynchronous: the caching host allocator keeps the
        pinned block until the copy has run."""
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
        if self._stream is None:
            return t.clone()
        with self._on_stream():
            return t.pin_memory().to(self.device, non_blocking=True)

    def _preload_dus(self) -> None:
        """Build and load K10 before the dispatch lock is taken: a first
        launch must never run ``nvcc`` inside the publish window."""
        if self._stream is not None:
            from ..kernels import preload

            preload("dus")

    @contextlib.contextmanager
    def _building(self):
        """``tables.building()`` plus recovery: a builder that dies
        INSIDE the locked publish window (after some ``dus`` launches
        wrote the live tables, or after the swap but before the flip)
        re-uploads the published content from the host mirrors, which
        the builder's own rollback has just restored."""
        with self.tables.building() as b:
            try:
                yield b
            except BaseException:
                self._heal_incomplete_swap()
                raise

    def _project_auth(self, epp, row_map, n_pol: int,
                      n_rows: int) -> np.ndarray:
        """The host grants projected onto the device [n_pol, n_rows]
        table: ONE definition for the full attach, the delta attach and
        the recovery, so a world republished from the mirrors carries
        the same grants as an attach.  ``row_map`` is explicit: an
        attach projects through its argument (``self.row_map`` is still
        the previous one before the publish)."""
        auth = np.zeros((n_pol, n_rows), dtype=np.uint32)
        with self._lock:  # _auth shares the dispatch lock
            items = list(self._auth.items())
        for (ep, rem), exp in items:
            pr = (epp[ep] if epp is not None and 0 <= ep < MAX_ENDPOINTS
                  else -1)
            r = row_map.row(rem) if row_map is not None else 0
            if pr >= 0 and 0 < r < n_rows:
                auth[pr, r] = max(auth[pr, r], exp)
        return auth

    def _project_auth_column(self, kind: str, numeric_id: int,
                             n_pol: int) -> np.ndarray:
        """One identity's auth column [n_pol]: a recycled row must not
        hand its previous occupant's grants to the newcomer (a forward
        with no handshake), so a patch rewrites the column from this
        identity's own grants, and zeros it on remove."""
        col = np.zeros(n_pol, dtype=np.uint32)
        if kind != "add" or self._epp is None:
            return col
        with self._lock:  # _auth shares the dispatch lock
            items = list(self._auth.items())
        for (ep, rem), exp in items:
            if rem != numeric_id:
                continue
            pr = self._epp[ep] if 0 <= ep < MAX_ENDPOINTS else -1
            if pr >= 0:
                col[pr] = max(col[pr], exp)
        return col

    def _heal_incomplete_swap(self) -> None:
        """No-op unless a publish died inside the dispatch lock (the
        ``_swap_incomplete`` flag).  Uploads the device tables afresh
        from the host mirrors — pre-patch by the rollback contract — so
        the datapath serves exactly the published generation again,
        whatever a partial chain of ``dus`` launches left behind."""
        if not self._swap_incomplete:
            return
        if self.tensors is None or self._published_state() is None:
            self._swap_incomplete = False
            return
        t = self.tensors
        with self._on_stream():
            policy = DevicePolicy.from_tensors(
                t, self._epp,
                self._project_auth(self._epp, self.row_map,
                                   t.verdict.shape[0], t.verdict.shape[2]),
                device=self.device)
            lpm = DeviceLPM.from_tensors(self._lpm_tensors, self.device)
        with self._lock:
            self.state = DatapathState(
                policy=policy, ipcache=lpm, ct=self.state.ct,
                metrics=self.state.metrics)
            self._swap_incomplete = False

    def _published_state(self) -> Optional[DatapathState]:
        """Locked point read of the published state (builders read the
        active tables through it; they stay put until the builder
        itself publishes, as every publisher holds the build lock)."""
        with self._lock:
            return self.state

    def _publish_tables(self, build, policy=None, lpm=None,
                        device_patch=None, row_map=None, mirrors=None,
                        attach: bool = False) -> int:
        """THE swap: the only place a new table generation becomes
        visible to dispatches.  Under the dispatch lock: the
        ``churn.swap`` fault site, the in-place ``device_patch``
        launches on the loader's stream (microseconds of enqueue; a
        patch may return the successor ``DevicePolicy``), the state
        swap and the generation flip.  The mirrors are painted after it
        (build lock still held).  Callers are inside ``_building()``."""
        from ..infra import faults

        with self._lock:
            # the mid-swap crash site: a raise here publishes nothing
            faults.check(faults.SITE_CHURN_SWAP)
            t_lock = time.monotonic()
            if row_map is not None:
                self.row_map = row_map
            # from here to the flip a failure may leave the live tables
            # half patched: _building heals them from the mirrors
            self._swap_incomplete = True
            if device_patch is not None:
                with self._on_stream():
                    patched = device_patch(self.state)
                if patched is not None:
                    policy = patched
            if policy is None:
                policy = self.state.policy
            if lpm is None:
                lpm = self.state.ipcache
            if self.state is None:  # keep live CT + counters otherwise
                with self._on_stream():
                    ct = CTTable.create(self.ct_capacity,
                                        device=self.device)
                self.state = DatapathState.create(policy, lpm, ct)
            else:
                self.state = DatapathState(
                    policy=policy, ipcache=lpm, ct=self.state.ct,
                    metrics=self.state.metrics)
            if attach:
                self.attach_count += 1
            gen = self.tables.flip(build, t_lock)
            self._swap_incomplete = False
        if mirrors is not None:
            mirrors()
        return gen

    def table_stats(self) -> dict:
        """The ``tables`` stats block: generation, swap and
        update-visible latency, attach and patch counts."""
        return self.tables.snapshot()

    def attach(self, policies, ipcache, ep_policy, row_map) -> None:
        """(Re)compile + swap: new tensors are built and uploaded off
        the dispatch lock and published through ``_publish_tables``.
        Live CT and metrics carry over.  When the last attach's
        per-policy fingerprints are known and the shapes still fit, only
        the policies whose fingerprints changed are repainted
        (``policy.incremental.delta_compile``): their slices are staged
        off the lock and written into the live verdict tensor by one
        ``dus`` launch each under it, so rule and selector churn costs
        O(changed policies), not O(world)."""
        from ..infra import faults
        from ..policy.compiler import policy_fingerprint
        from ..policy.incremental import delta_compile

        with self._building() as build:
            policies = list(policies)
            fps = [policy_fingerprint(p) for p in policies]
            plan = None
            if (self.delta_compile and self._published_state() is not None
                    and row_map is self.row_map):
                plan = delta_compile(self.tensors, policies, row_map,
                                     self._policy_fps, fps)
            # -1 = lxcmap-miss sentinel: a packet with an unregistered
            # endpoint id DROPS (REASON_NO_ENDPOINT)
            epp = np.full(MAX_ENDPOINTS, -1, dtype=np.int32)
            for ep_id, pol_row in ep_policy.items():
                if not 0 <= ep_id < MAX_ENDPOINTS:
                    raise ValueError(
                        f"endpoint id {ep_id} out of range "
                        f"[0, {MAX_ENDPOINTS})")
                epp[ep_id] = pol_row
            tensors = None
            if plan is None:
                # compile first: it may GROW the row map's capacity,
                # which sizes the auth projection
                tensors = compile_policy(policies, row_map)
                n_rows = tensors.verdict.shape[2]
            else:
                n_rows = self.tensors.verdict.shape[2]
            auth = self._project_auth(epp, row_map, len(policies), n_rows)
            # the LPM recompiles every attach (/32 churn goes through
            # patch_ipcache, never here): milliseconds, never a policy
            # compile
            lpm = compile_lpm({c: row_map.row(i)
                               for c, i in ipcache.items()})
            entries = LPMEntries(ipcache)  # cidr -> numeric
            policy = device_patch = None
            with self._on_stream():
                if plan is None:
                    policy = DevicePolicy.from_tensors(
                        tensors, epp, auth, device=self.device)
                else:
                    device_patch = self._delta_patch(plan, epp, auth)
                device_lpm = DeviceLPM.from_tensors(lpm, self.device)
            faults.check(faults.SITE_CHURN_BUILD)

            def mirrors():
                self._epp = epp
                self._policies = policies
                self._policy_fps = fps
                self._lpm_entries = entries
                self._lpm_tensors = lpm
                if plan is None:
                    self.tensors = tensors
                else:
                    for pi in plan.changed:
                        self.tensors.verdict[pi] = plan.slices[pi]
                    self.tensors = plan.apply_structure(self.tensors)

            self._publish_tables(build, policy=policy, lpm=device_lpm,
                                 device_patch=device_patch,
                                 row_map=row_map, mirrors=mirrors,
                                 attach=True)
            # counted only after the publish: a fault-aborted attach is
            # a failed build, never a completed (full or delta) attach
            if plan is None:
                self.tables.full_attaches += 1
                self.tables.policies_recompiled += len(policies)
            else:
                self.tables.delta_attaches += 1
                self.tables.policies_recompiled += len(plan.changed)

    def _delta_patch(self, plan, epp: np.ndarray, auth: np.ndarray):
        """A delta attach's device half: the changed policies' slices
        [1, 2, n_rows, width], the class maps when the global partition
        moved, and the fresh ``ep_policy`` and ``auth`` are staged now,
        off the dispatch lock; the returned ``device_patch`` writes each
        slice into the live verdict tensor with K10 under it and hands
        back the successor ``DevicePolicy``."""
        slices = {pi: self._stage(plan.slices[pi][None])
                  for pi in plan.changed}
        port_class = class_map = None
        if plan.class_structure_changed:
            port_class = self._stage(plan.struct.port_class)
            class_map = self._stage(plan.struct.class_map)
        epp_dev = self._stage(epp)
        auth_dev = self._stage(auth)
        self._preload_dus()

        def device_patch(state):
            pol = state.policy
            for pi, sl in slices.items():
                _dus(pol.verdict, sl, (pi, 0, 0, 0))
            return DevicePolicy(
                proto_table=pol.proto_table,
                port_class=(pol.port_class if port_class is None
                            else port_class),
                class_map=pol.class_map if class_map is None else class_map,
                verdict=pol.verdict, ep_policy=epp_dev, auth=auth_dev)

        return device_patch

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

    # -- sharded serving (parallel/mesh.py) ------------------------------
    def serving_shard(self, mesh) -> None:
        # thread-affinity: drain, api
        """Enter sharded serving: later :meth:`serve_sharded` dispatches
        run the sharded step over ``mesh``'s S shards, each with its
        CT slice.  Nothing moves on the card (the slices are row ranges
        of the one table); ``attach``, ``gc`` and ``ct_restore`` keep
        working on the whole table until :meth:`serving_unshard`."""
        from ..parallel.mesh import shard_state

        if mesh.device != self.device:
            raise ValueError(f"mesh on {mesh.device}, loader on "
                             f"{self.device}")
        with self._lock:
            shard_state(self.state, mesh)
            self._serving_mesh = mesh

    def serving_unshard(self) -> None:
        # thread-affinity: drain, api
        """Leave sharded serving (the single-shard steps serve again).
        CT entries keep their positions, as the reference's gather back
        to one device keeps them."""
        with self._lock:
            self._serving_mesh = None

    def serve_sharded(self, ring, hdr, now: int, batch_id: int,
                      trace_sample: int = 1024, proxy_ports=None,
                      audit: bool = False, valid=None,
                      packed_meta=None):
        # thread-affinity: drain, api
        """One flow-routed batch through the sharded serve step.

        ``hdr`` is the ``route_by_flow`` output — wide [S*block,
        N_COLS], or packed [S*block, 4] with ``packed_meta=(ep, dirn)``
        — and ``ring`` a :func:`parallel.mesh.make_sharded_ring` ring.
        Each shard runs datapath + ring append on its own block and CT
        slice; the counters take the sum of the per-shard deltas.
        Returns (ring, row_map); the ring is updated in place."""
        from ..infra import faults
        from ..parallel.mesh import sharded_serve

        # the shard-unavailable failure mode: the sharded dispatch
        # raising is where the degraded-mode ladder catches it
        faults.check(faults.SITE_LOADER_SERVE_SHARDED)
        mesh = self._serving_mesh
        if mesh is None:
            raise RuntimeError("serving_shard(mesh) first")
        hdr = self._to_device(hdr)
        valid = self._to_device(valid)
        proxy_ports = self._to_device(proxy_ports)
        ep = dirn = None
        if packed_meta is not None:
            ep, dirn = map(int, packed_meta)
        with self._lock:
            sharded_serve(self.state, ring, hdr, now, batch_id,
                          mesh.n_shards, valid, proxy_ports, trace_sample,
                          ep, dirn, audit)
            row_map = self.row_map
        return ring, row_map

    def add_route_overflow(self, n: int) -> None:
        # thread-affinity: any
        """Account host-side flow-router overflow in the metricsmap
        (REASON_ROUTE_OVERFLOW), the RSS-queue-overflow counter."""
        from .verdict import REASON_ROUTE_OVERFLOW

        self.add_host_drops(REASON_ROUTE_OVERFLOW, n)

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
        prefixes, policy-table rows and SNAT pool failures.  The device
        reads are enqueued under the dispatch lock and read after it."""
        from .lpm import LPM_NOMINAL_CAPACITY

        with self._lock:
            ct = self.state.ct
            occupied = _ct_occupied(ct.fp)
            drops = ct.dropped.clone()
            nat = self.nat_state
            nat_failed = nat.failed.clone() if nat is not None else None
            # host mirrors only from here down
            lpm_entries = len(self._lpm_entries)
            rows, rows_cap = (self.row_map.row_occupancy()
                              if self.row_map is not None else (0, 0))
        occupied = int(occupied.sum())
        drops = int(drops) & 0xFFFFFFFF
        return {
            "ct": {"capacity": self.ct_capacity,
                   "occupied": occupied,
                   "occupancy": round(occupied / self.ct_capacity, 4),
                   "insert-drops": drops},
            "nat": {"capacity": nat.capacity if nat is not None else None,
                    "failures": (int(nat_failed) & 0xFFFFFFFF
                                 if nat is not None else 0)},
            "lpm": {"capacity": LPM_NOMINAL_CAPACITY,
                    "entries": lpm_entries,
                    "occupancy": round(
                        lpm_entries / LPM_NOMINAL_CAPACITY, 6)},
            "policy": {"capacity": rows_cap, "rows": rows,
                       "occupancy": (round(rows / rows_cap, 4)
                                     if rows_cap else None)},
        }

    def ct_restore(self, table: np.ndarray) -> None:
        # thread-affinity: drain, api, offline
        """Reload a CT snapshot: dense rows or a full hashed table (the
        live rows are taken either way), re-placed with the device hash
        at this loader's capacity; rows that find no slot in their probe
        window are dropped and counted in ``ct.dropped``.  Under sharded
        serving the restored entries keep their global positions: a flow
        whose entry lands outside its shard's slice re-establishes as
        NEW, as on the reference."""
        from .conntrack import (ROW_WORDS, ct_fp_from_table,
                                ct_table_from_rows)

        table = np.asarray(table)
        if table.ndim != 2 or table.shape[1] != ROW_WORDS:
            raise ValueError(f"want CT rows [n, {ROW_WORDS}], got "
                             f"{table.shape}")
        table, n_dropped = ct_table_from_rows(ct_rows_from_table(table),
                                              self.ct_capacity)
        fp = ct_fp_from_table(table)
        with self._lock, self._on_stream():
            ct = CTTable.create(self.ct_capacity, device=self.device)
            ct.table.copy_(from_numpy(table, self.device))
            ct.fp.copy_(from_numpy(fp, self.device))
            ct.dropped.copy_(narrow(torch.tensor(n_dropped)))
            self.state = DatapathState(
                policy=self.state.policy, ipcache=self.state.ipcache,
                ct=ct, metrics=self.state.metrics)

    # -- the authmap plane (pkg/auth authmap analogue) -----------------
    def auth_upsert(self, ep_id: int, remote_id: int,
                    expires: int) -> bool:
        """Record a grant in the host dict (under the dispatch lock it
        shares) and write its one [1, 1] cell of the device auth table
        with K10.  A grant for an endpoint or an identity with no row
        yet stays host-side and lands at the next attach (False)."""
        with self._building() as build:
            with self._lock:
                self._auth[(int(ep_id), int(remote_id))] = int(expires)
            published = self._published_state()
            if published is None or self._epp is None:
                return False
            pr = int(self._epp[ep_id]) if 0 <= ep_id < MAX_ENDPOINTS else -1
            r = self.row_map.row(remote_id) if self.row_map else 0
            if pr < 0 or not 0 < r < published.policy.auth.shape[1]:
                return False
            exp_dev = self._stage(np.full((1, 1), expires, dtype=np.uint32))
            self._preload_dus()

            def device_patch(state):
                _dus(state.policy.auth, exp_dev, (pr, r))

            self._publish_tables(build, device_patch=device_patch)
        return True

    def auth_entries(self) -> list:
        with self._lock:
            return [{"endpoint": ep, "remote_identity": rem,
                     "expires": exp}
                    for (ep, rem), exp in sorted(self._auth.items())]

    def auth_gc(self, now: int) -> int:
        """Drop the expired grants from the host dict.  The device cells
        need no write: the verdict kernel compares each expiry with the
        batch's clock, and the next projection leaves them out."""
        with self._lock:
            dead = [k for k, exp in self._auth.items() if exp <= now]
            for k in dead:
                del self._auth[k]
        return len(dead)

    # -- in-place patches (identity and ipcache churn) ----------------
    def patch_identity(self, kind: str, numeric_id: int,
                       policies) -> bool:
        """Patch one identity's verdict rows and auth column in place:
        the row is composed on the host (``compose_row``, from peer
        sets ``update_contributions`` already updated), uploaded off the
        lock and written by two ``dus`` launches under it.  The mirror
        row is painted only after the flip, and a freshly allocated row
        is recycled if the build fails."""
        with self._building() as build:
            if self._published_state() is None or self.row_map is None:
                return False
            if len(policies) != self.tensors.verdict.shape[0]:
                return False  # policy list changed shape: full attach
            if kind == "remove" and self.row_map.row(numeric_id) == 0:
                return True  # identity never had a row; nothing to patch
            fresh_row = self.row_map.row(numeric_id) == 0
            row = self.row_map.add(numeric_id)
            if row >= self.tensors.verdict.shape[2]:
                if fresh_row:
                    self.row_map.remove(numeric_id)
                return False  # row capacity grew past the tensor
            try:
                return self._patch_identity_build(build, kind, numeric_id,
                                                  policies, row)
            except BaseException:
                # a failed build must not leak a row per aborted op
                if fresh_row:
                    self.row_map.remove(numeric_id)
                raise

    def _patch_identity_build(self, build, kind, numeric_id, policies,
                              row) -> bool:
        """patch_identity's builder body (split out so the row-map
        rollback wraps it)."""
        from ..infra import faults
        from ..policy.incremental import compose_row

        vals = compose_row(policies, numeric_id, self.tensors)
        # staged as the [n_pol, 2, 1, n_cls] row slice one launch writes
        vals_dev = self._stage(vals[:, :, None, :])
        auth_dev = self._stage(self._project_auth_column(
            kind, numeric_id, len(policies))[:, None])
        self._preload_dus()
        faults.check(faults.SITE_CHURN_BUILD)

        def device_patch(state):
            _dus(state.policy.verdict, vals_dev, (0, 0, row, 0))
            _dus(state.policy.auth, auth_dev, (0, row))

        def mirrors():
            self.tensors.verdict[:, :, row, :] = vals
            self._policies = list(policies)
            if (kind == "remove"
                    and numeric_id not in self._lpm_entries.values()):
                # the row is back to defaults and nothing maps to it:
                # recycle (unbounded churn must not grow rows)
                self.row_map.remove(numeric_id)

        self._publish_tables(build, device_patch=device_patch,
                             mirrors=mirrors)
        self.tables.patches += 1
        return True

    def patch_ipcache(self, cidr: str, numeric_id: int) -> bool:
        """Map one prefix to an identity.  A /32 patches the LPM in
        place (``lpm_upsert``: up to an l3 row, an l2 row and an l1
        cell, children first, one ``dus`` launch each); anything else,
        or a full block padding, recompiles the LPM alone (never the
        policy).  The /32 path paints the host mirror before the
        publish, so a failed build rolls it back (``LPMUndo``)."""
        from ..infra import faults

        with self._building() as build:
            if self._published_state() is None or self.row_map is None:
                return False
            fresh_row = self.row_map.row(numeric_id) == 0
            row = self.row_map.add(numeric_id)
            if row >= self.tensors.verdict.shape[2]:
                if fresh_row:
                    self.row_map.remove(numeric_id)
                return False
            undo = LPMUndo(self._lpm_tensors, cidr)
            had_entry = cidr in self._lpm_entries
            prev_entry = self._lpm_entries.get(cidr)
            self._lpm_entries[cidr] = numeric_id
            try:
                patches = lpm_upsert(self._lpm_tensors, cidr, row)
                staged_t = new_lpm = device_patch = None
                if patches is None:
                    staged_t = compile_lpm(
                        {c: self.row_map.row(i)
                         for c, i in self._lpm_entries.items()})
                    with self._on_stream():
                        new_lpm = DeviceLPM.from_tensors(staged_t,
                                                         self.device)
                else:
                    staged = [(f, i, self._stage(
                        np.atleast_1d(p) if f == "l1"
                        else np.atleast_1d(p)[None]))
                        for f, i, p in patches]
                    self._preload_dus()

                    def device_patch(state):
                        for field, idx, payload in staged:
                            _dus(getattr(state.ipcache, field), payload,
                                 (idx,) if field == "l1" else (idx, 0))
                faults.check(faults.SITE_CHURN_BUILD)

                def mirrors():
                    if staged_t is not None:
                        self._lpm_tensors = staged_t

                self._publish_tables(build, lpm=new_lpm,
                                     device_patch=device_patch,
                                     mirrors=mirrors)
            except BaseException:
                # the flip never happened: the mirror rolls back to
                # exactly the published state
                if had_entry:
                    self._lpm_entries[cidr] = prev_entry
                else:
                    self._lpm_entries.pop(cidr, None)
                undo.restore(self._lpm_tensors)
                if fresh_row:
                    self.row_map.remove(numeric_id)
                raise
            self.tables.patches += 1
        return True

    def delete_ipcache(self, cidr: str) -> bool:
        """Remove one prefix (fqdn TTL expiry).  A /32 that owns an l3
        slot is patched in place — the slot reverts to the longest
        remaining covering prefix's value, from the host entry mirror;
        anything else recompiles the LPM (never the policy)."""
        from ..infra import faults

        with self._building() as build:
            if self._published_state() is None or self.row_map is None:
                return False
            if cidr not in self._lpm_entries:
                return True  # unknown entry: nothing to do
            prev_entry = self._lpm_entries.pop(cidr)
            net = ipaddress.ip_network(cidr, strict=False)
            saved_row = None  # (blk3, row copy) for rollback
            try:
                in_place = net.version == 4 and net.prefixlen == 32
                if in_place:
                    addr = int(net.network_address)
                    t = self._lpm_tensors
                    hi16, mid8, lo8 = (addr >> 16, (addr >> 8) & 0xFF,
                                       addr & 0xFF)
                    cur1 = int(t.l1[hi16])
                    cur2 = (int(t.l2[-cur1 - 1, mid8]) if cur1 < 0
                            else 0)
                    if cur1 >= 0 or cur2 >= 0:
                        # the /32 was never expanded into an l3 slot
                        # (merged by a full compile, or shadowed): too
                        # ambiguous to patch, rebuild
                        in_place = False
                staged_t = new_lpm = device_patch = None
                if in_place:
                    # longest remaining covering v4 prefix -> value
                    best_num = self._lpm_entries.longest_v4_cover(addr)
                    value = (t.default if best_num is None
                             else self.row_map.row(best_num))
                    blk3 = -cur2 - 1
                    saved_row = (blk3, t.l3[blk3].copy())
                    t.l3[blk3, lo8] = value
                    row_dev = self._stage(t.l3[blk3][None])
                    self._preload_dus()

                    def device_patch(state):
                        _dus(state.ipcache.l3, row_dev, (blk3, 0))
                else:
                    staged_t = compile_lpm(
                        {c: self.row_map.row(i)
                         for c, i in self._lpm_entries.items()})
                    with self._on_stream():
                        new_lpm = DeviceLPM.from_tensors(staged_t,
                                                         self.device)
                faults.check(faults.SITE_CHURN_BUILD)

                def mirrors():
                    if staged_t is not None:
                        self._lpm_tensors = staged_t

                self._publish_tables(build, lpm=new_lpm,
                                     device_patch=device_patch,
                                     mirrors=mirrors)
            except BaseException:
                self._lpm_entries[cidr] = prev_entry
                if saved_row is not None:
                    self._lpm_tensors.l3[saved_row[0]] = saved_row[1]
                raise
            self.tables.patches += 1
        return True

    # -- the SNAT port pool (pkg/maps/nat analogue) -----------------------
    def _nat_table(self):
        # called under the dispatch lock
        from ..service.nat import NAT_DEFAULT_CAPACITY, NATTable

        if self.nat_state is None:
            self.nat_state = NATTable.create(
                self.nat_capacity or NAT_DEFAULT_CAPACITY, self.device)
        return self.nat_state

    def masquerade(self, nat, hdr, now: int):
        """CT-aware egress SNAT with port allocation (service/nat.py
        ``snat_egress``, K11 on the card): returns (rewritten rows on
        the device, [N] bool exhaustion drop mask); the mask feeds
        ``step(pre_drop=...)``.  Enqueued under the dispatch lock, so
        the CT it probes is the one the last step left, before this
        batch's update."""
        from ..service.nat import snat_egress

        hdr = self._to_device(hdr)
        with self._lock:
            hdr, _tbl, dropped = snat_egress(self._nat_table(), nat,
                                             self.state.ct, hdr, now)
        return hdr, dropped

    def reverse_nat(self, nat, hdr, now: int):
        """Ingress reverse translation after the verdict (service/nat.py
        ``snat_reverse``, K12 on the card): replies to allocated node
        ports get their pod destination back."""
        from ..service.nat import snat_reverse

        hdr = self._to_device(hdr)
        with self._lock:
            hdr, _tbl = snat_reverse(self._nat_table(), nat, hdr, now)
        return hdr

    def nat_snapshot(self) -> Optional[np.ndarray]:
        """The NAT table as u32 [P, 6] (None before the first use)."""
        with self._lock:
            if self.nat_state is None:
                return None
            return to_numpy(self.nat_state.table).copy()

    def nat_restore(self, table: np.ndarray) -> None:
        """Reload a NAT snapshot (``nat_snapshot``'s [P, 6] u32 table):
        replies to allocated node ports keep reverse-translating across
        a restart.  The failure count starts again at 0."""
        from ..service.nat import NATTable

        table = np.ascontiguousarray(table, dtype=np.uint32)
        with self._lock, self._on_stream():
            self.nat_state = NATTable(
                table=from_numpy(table, self.device),
                failed=torch.zeros((), dtype=torch.int32,
                                   device=self.device))

    def nat_status(self, now: int) -> Optional[dict]:
        from ..service.nat import NAT_PORT_MIN, nat_live_count

        with self._lock:
            if self.nat_state is None:
                return None
            return {
                "capacity": self.nat_state.capacity,
                "port-min": NAT_PORT_MIN,
                "live": nat_live_count(self.nat_state, now),
                "alloc-failed": int(self.nat_state.failed) & 0xFFFFFFFF,
            }

