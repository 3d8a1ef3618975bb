"""Mutual authentication manager (reference: upstream ``pkg/auth``,
cilium 1.14+; a copy of the JAX package's module, host code only).

Upstream flow: a policy entry carrying ``authentication.mode:
required`` makes the datapath drop un-authenticated NEW flows with
``DROP_POLICY_AUTH_REQUIRED`` and queue an auth request; the agent's
auth manager runs a mutual-TLS handshake between the two identities'
SPIFFE certificates (SPIRE-issued) and writes the negotiated
expiration into the BPF authmap; retried traffic forwards until the
entry expires, and a GC job sweeps expired/orphaned entries.

Here the same loop rides the batch world: the daemon hands every
``REASON_AUTH_REQUIRED`` drop batch to :meth:`AuthManager.observe`,
the configured provider performs the handshake (the default validates
both identities against the live allocator — the certificate-issuance
analogue in a sandbox with no SPIRE; providers are pluggable exactly
so a real mTLS implementation can slot in), and the grant lands in
the loader's auth table (``Loader.auth_upsert``: one [1, 1] cell
written by the ``dus`` kernel on the card) keyed (subject identity,
remote identity) with ``now + ttl``.  Failed handshakes are
counted and retried no sooner than ``retry_s``.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np


class AuthError(Exception):
    """Handshake failure (unknown identity, provider refusal)."""


class MutualAuthProvider:
    """The default provider: both identities must be LIVE in the
    allocator (the 'both sides hold a valid certificate' check —
    identity liveness is what SPIRE attestation derives from here).
    Reserved identities (world, host...) hold no workload certificate
    upstream and fail the handshake."""

    name = "mutual-identity"

    def __init__(self, allocator, ttl: int = 3600):
        self.allocator = allocator
        self.ttl = ttl

    def handshake(self, subject_id: int, remote_id: int) -> int:
        from ..identity import RESERVED_LABELSETS

        for num in (subject_id, remote_id):
            if num in RESERVED_LABELSETS:
                raise AuthError(
                    f"identity {num} is reserved: no workload "
                    "certificate to handshake with")
            if self.allocator.lookup_by_id(num) is None:
                raise AuthError(f"identity {num} unknown to the "
                                "allocator (no live certificate)")
        return self.ttl


class DenyAuthProvider:
    """Test/fail-safe provider: every handshake fails."""

    name = "deny"

    def __init__(self, *_a, **_kw):
        pass

    def handshake(self, subject_id: int, remote_id: int) -> int:
        raise AuthError("auth provider denies all handshakes")


class AuthManager:
    """Observes AUTH_REQUIRED drops, handshakes, grants.

    ``observe`` is synchronous by design: the batch that dropped is
    gone either way (upstream drops too while the handshake runs);
    the grant is live before the next batch, which is this world's
    'retried traffic forwards'."""

    def __init__(self, daemon, provider=None, retry_s: int = 30):
        self.daemon = daemon
        self.provider = provider or MutualAuthProvider(
            daemon.allocator, ttl=daemon.config.auth_ttl)
        self.retry_s = retry_s
        self.granted = 0
        self.failed = 0
        self.deferred = 0  # handshake OK but device apply deferred
        self._lock = threading.Lock()
        # (ep, remote) -> earliest retry time, for failed handshakes
        self._backoff: Dict[Tuple[int, int], int] = {}

    def observe(self, ev, now: int) -> int:
        """Handshake every distinct (endpoint, remote identity) pair
        that dropped AUTH_REQUIRED in this batch.  Returns grants."""
        from ..core.packets import COL_EP
        from ..datapath.verdict import REASON_AUTH_REQUIRED

        rows = np.flatnonzero(ev.reason == REASON_AUTH_REQUIRED)
        if rows.size == 0:
            return 0
        pairs = {(int(ev.hdr[i, COL_EP]), int(ev.identity[i]))
                 for i in rows}
        n = 0
        for ep_id, remote in sorted(pairs):
            if self._grant(ep_id, remote, now):
                n += 1
        return n

    def _grant(self, ep_id: int, remote: int, now: int) -> bool:
        with self._lock:
            if self._backoff.get((ep_id, remote), 0) > now:
                return False
        ep = self.daemon.endpoints.get(ep_id)
        subject = ep.identity.numeric_id if ep is not None else 0
        try:
            ttl = self.provider.handshake(subject, remote)
        except AuthError:
            with self._lock:
                self.failed += 1
                self._backoff[(ep_id, remote)] = now + self.retry_s
            return False
        ok = self.daemon.loader.auth_upsert(ep_id, remote, now + ttl)
        with self._lock:
            if ok:
                self.granted += 1
                self._backoff.pop((ep_id, remote), None)
            else:
                # handshake succeeded but the loader could not apply
                # (endpoint/identity row gone or not yet attached):
                # damp retries like a failure, count separately
                self.deferred += 1
                self._backoff[(ep_id, remote)] = now + self.retry_s
        return ok

    def gc(self, now: int) -> int:
        """Sweep expired grants + stale backoff entries (upstream:
        the authmap GC job)."""
        with self._lock:
            for k in [k for k, t in self._backoff.items() if t <= now]:
                del self._backoff[k]
        return self.daemon.loader.auth_gc(now)

    def status(self) -> dict:
        with self._lock:
            return {"provider": self.provider.name,
                    "granted": self.granted, "failed": self.failed,
                    "deferred": self.deferred,
                    "pending-backoff": len(self._backoff)}
