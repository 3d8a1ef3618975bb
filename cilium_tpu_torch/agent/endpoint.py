"""Endpoint: one managed workload and its lifecycle state machine.

Reference: upstream cilium ``pkg/endpoint`` — an endpoint owns its
identity, datapath config, and policy realization, moving through
restoring -> waiting-for-identity -> regenerating -> ready (SURVEY.md
§2b).  Regeneration itself is centralized in the EndpointManager here
(the whole node shares one set of device tensors, so "regenerate" is a
node-level tensor swap, not a per-endpoint program compile).
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..labels import LabelSet
from ..identity.identity import Identity


class EndpointState(str, enum.Enum):
    # reference: pkg/endpoint state constants
    WAITING_FOR_IDENTITY = "waiting-for-identity"
    REGENERATING = "regenerating"
    READY = "ready"
    DISCONNECTING = "disconnecting"
    RESTORING = "restoring"


@dataclass
class Endpoint:
    id: int
    name: str
    ips: Tuple[str, ...]
    labels: LabelSet
    identity: Optional[Identity] = None
    state: EndpointState = EndpointState.WAITING_FOR_IDENTITY
    policy_revision: int = 0  # realized revision
    created_at: float = field(default_factory=time.time)
    policy_row: int = 0  # row into the loader's policy list
    # container port names (reference: pod spec containerPort names;
    # named ports in policy resolve against these)
    named_ports: Dict[str, int] = field(default_factory=dict)
    # policy enforcement mode (reference: pkg/option per-endpoint
    # PolicyEnforcement): "default" | "always" | "never"
    enforcement: str = "default"
    # per-endpoint runtime options (reference: pkg/option endpoint
    # options Debug / DropNotification / TraceNotification).  Debug
    # exempts this endpoint from monitor trace aggregation.
    options: Dict[str, bool] = field(default_factory=lambda: {
        "Debug": False,
        "DropNotification": True,
        "TraceNotification": True,
    })

    def to_dict(self) -> dict:
        """API rendering (GET /endpoint/{id})."""
        return {
            "id": self.id,
            "name": self.name,
            "ips": list(self.ips),
            "labels": [str(l) for l in self.labels],
            "identity": (self.identity.numeric_id if self.identity
                         else None),
            "state": self.state.value,
            "policy-revision": self.policy_revision,
            "policy-enforcement": self.enforcement,
            "options": dict(self.options),
            **({"named-ports": dict(self.named_ports)}
               if self.named_ports else {}),
        }
