"""Numeric security identities and the reserved-identity space.

Reference: upstream cilium ``pkg/identity`` — reserved identities
(1=host, 2=world, 3=unmanaged, 4=health, 5=init, 6=remote-node,
7=kube-apiserver, 8=ingress), the cluster-wide allocation range
[256, 65536), and locally-scoped CIDR identities carrying a scope flag
in the high bits.

TPU-first note: numeric identities are the *API-boundary* currency.  On
device, the datapath works in **dense identity rows** (0..n_rows-1)
assigned by the IdentityRowMap so the policy verdict tensor can be a
dense ``[rows, classes]`` array instead of a 16M-sparse one.  The
ipcache LPM tables store rows directly; numeric IDs only appear in
events surfaced back to the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from ..labels import Label, LabelSet, SOURCE_RESERVED

ID_INVALID = 0
ID_HOST = 1
ID_WORLD = 2
ID_UNMANAGED = 3
ID_HEALTH = 4
ID_INIT = 5
ID_REMOTE_NODE = 6
ID_KUBE_APISERVER = 7
ID_INGRESS = 8

# First identity the cluster-wide allocator may hand out.
MIN_ALLOCATED = 256
MAX_ALLOCATED = 65536

# Locally-scoped identities (CIDR-derived) carry this flag — they are
# node-local and never synced to the cluster store.
LOCAL_IDENTITY_FLAG = 1 << 24

_RESERVED_NAMES = {
    ID_HOST: "host",
    ID_WORLD: "world",
    ID_UNMANAGED: "unmanaged",
    ID_HEALTH: "health",
    ID_INIT: "init",
    ID_REMOTE_NODE: "remote-node",
    ID_KUBE_APISERVER: "kube-apiserver",
    ID_INGRESS: "ingress",
}

RESERVED_LABELSETS: Dict[int, LabelSet] = {
    num: LabelSet([Label(SOURCE_RESERVED, name)])
    for num, name in _RESERVED_NAMES.items()
}
RESERVED_BY_LABELS: Dict[str, int] = {
    ls.sorted_key(): num for num, ls in RESERVED_LABELSETS.items()
}


def is_reserved(numeric_id: int) -> bool:
    return 0 < numeric_id < MIN_ALLOCATED


def is_local_cidr(numeric_id: int) -> bool:
    return bool(numeric_id & LOCAL_IDENTITY_FLAG)


def reserved_identity_labels(numeric_id: int) -> Optional[LabelSet]:
    return RESERVED_LABELSETS.get(numeric_id)


def reserved_name(numeric_id: int) -> Optional[str]:
    return _RESERVED_NAMES.get(numeric_id)


@dataclass(frozen=True)
class Identity:
    """A numeric security identity bound to the label set it encodes."""

    numeric_id: int
    labels: LabelSet

    @property
    def is_reserved(self) -> bool:
        return is_reserved(self.numeric_id)

    @property
    def is_local(self) -> bool:
        return is_local_cidr(self.numeric_id)

    def __str__(self) -> str:
        name = reserved_name(self.numeric_id)
        return f"Identity({self.numeric_id}{'/' + name if name else ''})"


@dataclass(frozen=True)
class ReservedIdentity(Identity):
    pass
