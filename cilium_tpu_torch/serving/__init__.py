"""Serving front-end: the stream -> batch admission layer.

Reference: upstream cilium absorbs variable-rate traffic with the
XDP/RSS front end and per-CPU rings before any per-packet program
runs; production inference stacks solve the same problem with
continuous batching.  This package is that layer for the port's
datapath: a packet *stream* enters, fixed-shape batches leave.

Pieces (PARITY.md row 54):

- :mod:`.ingress` — bounded admission queue (the XDP ring analogue)
  with a configurable overflow policy; sheds are counted and surface
  as monitor DROP events (``REASON_INGRESS_OVERFLOW``), never lost
  silently.
- :mod:`.batcher` — adaptive batcher padding to a small ladder of
  power-of-two bucket sizes (bounds the batch shapes the device
  sees to the ladder length) and flushing on bucket-full OR a max-wait deadline.
  Assembles into a preallocated per-bucket arena (allocation-free hot
  path) and, with ``pack=True``, emits eligible IPv4 single-stream
  batches as the packed 16 B/packet h2d wire format.
- :mod:`.runtime` — the drain loop: assemble batch N+1 on the host
  while batch N executes on device (``Daemon.serve_batch``), with
  clean start/stop/drain semantics.
- :mod:`.stats` — per-batch telemetry: queue wait, pad efficiency,
  batches/sec, verdicts/sec, p50/p95/p99 end-to-end latency.
"""

from __future__ import annotations


class ServingError(RuntimeError):
    """Base of the serving plane's typed errors.  Subclasses
    RuntimeError so pre-existing ``except RuntimeError`` callers (and
    tests matching it) keep working."""


class ServingNotStartedError(ServingError):
    """serve_batch()/submit() before start_serving()."""


class ServingAlreadyActiveError(ServingError):
    """start_serving() while a serving session is live — silently
    replacing the drainer would drop its in-flight window without any
    loss accounting."""


class ServingBackendError(ServingError):
    """The serving path needs the tpu backend (the interpreter loader
    has no device event ring)."""


class DispatchFailedError(ServingError):
    """A dispatch callable's device leg failed in a CONTAINED way (the
    degraded-mode ladder saw the failure, counted it toward its
    demotion threshold, and did not — or could not yet — demote).  The
    drain runtime accounts the batch's rows as recovery drops
    (``REASON_RECOVERY_DROP``, counted + surfaced as DROP events) and
    KEEPS THE LOOP ALIVE: no thread death, no restart burned.  Wrap
    the original exception as ``__cause__``."""


def validate_serving_config(queue_depth: int, bucket_ladder,
                            max_wait_us, overflow_policy: str) -> tuple:
    """Validate the DaemonConfig serving knobs; returns the normalized
    ``(queue_depth, ladder, max_wait_us, overflow_policy)`` tuple.
    Raises ValueError with an actionable message — a typo'd policy or
    a non-power-of-two bucket must fail at construction, not as a
    recompile storm (or an assert) under load."""
    ladder = tuple(int(b) for b in bucket_ladder)
    if not ladder:
        raise ValueError("serving_bucket_ladder must name at least "
                         "one bucket size")
    for b in ladder:
        if b <= 0 or b & (b - 1):
            raise ValueError(
                f"serving bucket size {b} is not a power of two "
                "(each distinct batch shape has its own staging slots; the "
                "ladder exists to bound them)")
    if list(ladder) != sorted(set(ladder)):
        raise ValueError(
            f"serving_bucket_ladder {ladder} must be strictly "
            "ascending with no duplicates")
    depth = int(queue_depth)
    if depth < ladder[-1]:
        raise ValueError(
            f"serving_queue_depth {depth} is smaller than the largest "
            f"bucket {ladder[-1]}; a full bucket could never assemble")
    wait = float(max_wait_us)
    if wait < 0:
        raise ValueError("serving_max_wait_us must be >= 0")
    if overflow_policy not in ("drop-tail", "drop-oldest"):
        raise ValueError(
            f"serving_overflow_policy must be drop-tail|drop-oldest, "
            f"got {overflow_policy!r}")
    return depth, ladder, wait, overflow_policy


def validate_superbatch_config(superbatch_k) -> tuple:
    """Validate ``serving_superbatch_k``; returns ``(k_max,
    k_ladder)`` where ``k_ladder`` is the power-of-two K rung set
    {1, 2, ..., k_max} the fallback ladder walks.  Same contract as
    the validators above: a bad K fails at daemon construction, not
    as a compiled-shape explosion under load (each K is one
    executable per bucket rung)."""
    k = int(superbatch_k)
    if k < 1 or k & (k - 1):
        raise ValueError(
            f"serving_superbatch_k {k} must be a power of two >= 1 "
            "(each K is one compiled executable per bucket rung; the "
            "K ladder exists to bound them; 1 disables superbatching)")
    ladder, v = [], 1
    while v <= k:
        ladder.append(v)
        v <<= 1
    return k, tuple(ladder)


def validate_recovery_config(dispatch_deadline_ms, restart_budget,
                             restart_backoff_ms, demote_threshold,
                             promote_after,
                             promote_cooldown_s) -> tuple:
    """Validate the fault-tolerance knobs; returns the normalized
    tuple.  Same contract as :func:`validate_serving_config`: a bad
    knob fails at daemon construction with an actionable message, not
    as a watchdog that silently never fires under load."""
    deadline = float(dispatch_deadline_ms)
    if deadline < 0:
        raise ValueError("serving_dispatch_deadline_ms must be >= 0 "
                         "(0 disables hang detection)")
    budget = int(restart_budget)
    if budget < 0:
        raise ValueError("serving_restart_budget must be >= 0 "
                         "(0 disables the recovery supervisor)")
    backoff = float(restart_backoff_ms)
    if backoff < 0:
        raise ValueError("serving_restart_backoff_ms must be >= 0")
    demote = int(demote_threshold)
    if demote < 1:
        raise ValueError("serving_demote_threshold must be >= 1 "
                         "(consecutive dispatch failures per rung)")
    promote = int(promote_after)
    if promote < 1:
        raise ValueError("serving_promote_after must be >= 1 "
                         "(consecutive healthy batches)")
    cooldown = float(promote_cooldown_s)
    if cooldown < 0:
        raise ValueError("serving_promote_cooldown_s must be >= 0")
    return deadline, budget, backoff, demote, promote, cooldown


from .batcher import AdaptiveBatcher, BucketArena  # noqa: E402
from .ingress import IngressQueue  # noqa: E402
from .ladder import FallbackLadder  # noqa: E402
from .runtime import ServingRuntime  # noqa: E402
from .stats import LatencyHistogram, ServingStats  # noqa: E402

__all__ = [
    "AdaptiveBatcher",
    "BucketArena",
    "DispatchFailedError",
    "FallbackLadder",
    "IngressQueue",
    "LatencyHistogram",
    "ServingError",
    "ServingAlreadyActiveError",
    "ServingBackendError",
    "ServingNotStartedError",
    "ServingRuntime",
    "ServingStats",
    "validate_recovery_config",
    "validate_serving_config",
    "validate_superbatch_config",
]
