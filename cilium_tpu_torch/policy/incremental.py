"""Incremental policy updates: identity churn -> tensor row patches.

Reference: upstream cilium's SelectorCache notifies L4Filters of
identity deltas and the endpoint applies *incremental* policy-map
updates (``pkg/policy/mapstate.go`` ``ApplyPolicyMapChanges``) — it
never recompiles the map on identity churn.  Here an identity
add/remove patches ONE row of the device verdict tensor and its LPM
slots in place (``datapath/loader.py`` ``patch_identity``,
``patch_ipcache``), with no full ``compile_policy`` and no re-attach.
A copy of the JAX package's module.

- :func:`update_contributions` — apply the delta to the resolved
  policies' frozen peer sets (via the live selectors each contribution
  carries), keeping the MapState view consistent with the patched
  tensors.
- :func:`compose_row` — compute the [n_pol, 2, n_classes] verdict
  vector for one identity row, mirroring the full compiler's
  precedence (plain allows, then redirects, then denies) exactly; a
  test asserts equality with ``compile_policy`` output.
- :func:`delta_compile` — the delta attach's plan: repaint only the
  policies whose fingerprints changed (:class:`DeltaPlan`).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence

import numpy as np

from .compiler import (ClassStructure, IdentityRowMap, PolicyTensors,
                       class_structure, ensure_identity_rows,
                       pack_entry, packed_scatter_order, paint_policy)
from .mapstate import N_PROTO, PROTO_ANY, VERDICT_ALLOW, VERDICT_DEFAULT_DENY
from .resolve import EndpointPolicy


def update_contributions(policies: Sequence[EndpointPolicy], kind: str,
                         numeric_id: int, labels) -> bool:
    """Apply one identity add/remove to the resolved policies in place.

    Membership is re-evaluated from each contribution's live selectors
    (``Contribution.selects_labels``); the frozen ``identities`` sets
    are swapped for updated ones.  Returns True when any contribution
    changed (i.e. the identity's verdict row differs from the default
    row and a tensor patch is needed)."""
    changed = False
    for pol in policies:
        for ms in (pol.ingress, pol.egress):
            for i, c in enumerate(ms.contributions):
                if c.identities is None:
                    continue
                if kind == "add":
                    if (numeric_id not in c.identities
                            and c.selects_labels(labels)):
                        ms.contributions[i] = replace(
                            c, identities=c.identities | {numeric_id})
                        changed = True
                else:
                    if numeric_id in c.identities:
                        ms.contributions[i] = replace(
                            c, identities=c.identities - {numeric_id})
                        changed = True
    return changed


@dataclass
class DeltaPlan:
    """The outcome of :func:`delta_compile`: which policy rows must
    repaint, their freshly painted slices, and the (possibly
    unchanged) class structure.  The loader stages the slices off the
    dispatch lock, writes each with one ``dus`` launch under it, and
    paints the host mirror only AFTER the generation flip — a failed
    build must leave both the published tables and their mirrors
    untouched."""

    changed: List[int]  # policy rows whose fingerprints differ
    slices: Dict[int, np.ndarray]  # pi -> [2, n_rows, width] paint
    struct: ClassStructure
    # True when the GLOBAL partition moved (a changed policy added or
    # removed port boundaries): port_class/class_map must re-upload;
    # False reuses the active device arrays byte-for-byte
    class_structure_changed: bool
    policy_index: Dict[str, int] = field(default_factory=dict)

    def apply_structure(self, old: PolicyTensors) -> PolicyTensors:
        """The successor host mirror: SHARES ``old.verdict`` (the
        caller painted ``slices`` into it post-publish) and carries
        the plan's class structure."""
        return PolicyTensors(
            proto_table=old.proto_table,
            port_class=self.struct.port_class,
            n_classes=self.struct.n_classes,
            verdict=old.verdict,
            policy_index=self.policy_index,
            row_map=old.row_map,
            class_intervals=self.struct.class_intervals,
            class_map=self.struct.class_map,
        )


def delta_compile(old: PolicyTensors,
                  policies: Sequence[EndpointPolicy],
                  row_map: IdentityRowMap,
                  fps_old: Optional[Sequence[tuple]],
                  fps_new: Sequence[tuple],
                  class_pad: int = 128) -> Optional[DeltaPlan]:
    """Plan an attach that repaints ONLY the policies whose
    fingerprints changed (selector churn, rule edits), reusing every
    unchanged policy's verdict slice from the previous attach.

    The r05 per-policy class compaction makes this sound: a policy's
    verdict slice addresses its own LOCAL classes, which depend only
    on its own port boundaries — all inside the fingerprint — so an
    unchanged fingerprint implies a byte-identical slice (a property
    test pins this against :func:`~.compiler.compile_policy`).

    Returns None (caller falls back to a full compile) when the
    shapes cannot be reused: policy count changed, a different row
    map, row capacity grew (a new identity spilled past the headroom),
    or the widest policy outgrew the tensor's local-class padding.
    """
    if old is None or fps_old is None:
        return None
    if len(policies) != len(fps_old):
        return None
    if old.verdict.shape[0] != len(policies):
        return None
    if row_map is not old.row_map:
        return None
    if row_map.capacity != old.verdict.shape[2]:
        return None
    changed = [i for i, (a, b) in enumerate(zip(fps_old, fps_new))
               if a != b]
    # rows for any newly referenced identities; growth past the
    # tensor's row capacity forces the full path (the add itself is
    # harmless either way — full compile redoes it idempotently)
    ensure_identity_rows(policies, row_map)
    if row_map.capacity != old.verdict.shape[2]:
        return None
    struct = class_structure(policies, class_pad)
    width = old.verdict.shape[3]
    if struct.n_local_padded > width:
        return None  # widest policy outgrew the local-class padding
    class_structure_changed = (
        struct.class_map.shape != old.class_map.shape
        or not np.array_equal(struct.class_map, old.class_map)
        or not np.array_equal(struct.port_class, old.port_class))
    slices = {pi: paint_policy(policies[pi], pi, struct, row_map,
                               width=width)
              for pi in changed}
    policy_index = {p.subject_labels.sorted_key(): i
                    for i, p in enumerate(policies)}
    return DeltaPlan(changed=changed, slices=slices, struct=struct,
                     class_structure_changed=class_structure_changed,
                     policy_index=policy_index)


def compose_row(policies: Sequence[EndpointPolicy], numeric_id: int,
                tensors: PolicyTensors) -> np.ndarray:
    """Verdict vector [n_pol, 2, n_local_padded] for ONE identity.

    Must stay the per-row mirror of ``compile_policy``'s scatter order:
    default fill, plain allows, redirects (reversed: first covering
    redirect's port wins), denies last.  Classes are the PER-POLICY
    local classes (compiler class_map): global classes mapped through
    the policy's row of the map."""
    n_cls = tensors.verdict.shape[3]
    out = np.zeros((len(policies), 2, n_cls), dtype=np.int32)

    for pi, pol in enumerate(policies):
        cmap = tensors.class_map[pi]

        def classes_for(proto: int, lo: int, hi: int) -> np.ndarray:
            return np.unique(
                cmap[tensors.port_class[proto, lo:hi + 1]])

        for di, ms in ((0, pol.ingress), (1, pol.egress)):
            default = (pack_entry(VERDICT_DEFAULT_DENY) if ms.enforcing
                       else pack_entry(VERDICT_ALLOW))
            out[pi, di, :] = default
            for c, val in packed_scatter_order(ms):
                if (c.identities is not None
                        and numeric_id not in c.identities):
                    continue
                protos = (range(N_PROTO) if c.proto == PROTO_ANY
                          else [c.proto])
                cls = np.unique(np.concatenate(
                    [classes_for(p, c.lo, c.hi) for p in protos]))
                out[pi, di, cls] = val
    return out
