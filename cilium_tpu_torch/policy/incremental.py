"""Incremental policy updates: identity churn -> tensor row patches.

Reference: upstream cilium's SelectorCache notifies L4Filters of
identity deltas and the endpoint applies *incremental* policy-map
updates (``pkg/policy/mapstate.go`` ``ApplyPolicyMapChanges``) — it
never recompiles the map on identity churn.  Here an identity
add/remove patches ONE row of the device verdict tensor and its LPM
slots in place (``datapath/loader.py`` ``patch_identity``,
``patch_ipcache``), with no full ``compile_policy`` and no re-attach.
A copy of the JAX package's module, less the delta attach
(``DeltaPlan``/``delta_compile``, ROADMAP A2).

- :func:`update_contributions` — apply the delta to the resolved
  policies' frozen peer sets (via the live selectors each contribution
  carries), keeping the MapState view consistent with the patched
  tensors.
- :func:`compose_row` — compute the [n_pol, 2, n_classes] verdict
  vector for one identity row, mirroring the full compiler's
  precedence (plain allows, then redirects, then denies) exactly; a
  test asserts equality with ``compile_policy`` output.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Sequence

import numpy as np

from .compiler import PolicyTensors, pack_entry, packed_scatter_order
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
