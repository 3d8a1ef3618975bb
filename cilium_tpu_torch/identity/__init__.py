from .identity import (  # noqa: F401
    Identity,
    ReservedIdentity,
    ID_INVALID,
    ID_HOST,
    ID_WORLD,
    ID_UNMANAGED,
    ID_HEALTH,
    ID_INIT,
    ID_REMOTE_NODE,
    ID_KUBE_APISERVER,
    ID_INGRESS,
    LOCAL_IDENTITY_FLAG,
    RESERVED_LABELSETS,
    is_reserved,
    is_local_cidr,
    reserved_identity_labels,
)
from .allocator import CachingIdentityAllocator  # noqa: F401
