from .api import (  # noqa: F401
    EndpointSelector,
    Rule,
    IngressRule,
    EgressRule,
    PortProtocol,
    PortRule,
    PortRuleHTTP,
    PortRuleDNS,
    CIDRRule,
    Entity,
    rule_from_dict,
    rules_from_obj,
)
from .selectorcache import SelectorCache, CachedSelector  # noqa: F401
from .repository import PolicyRepository  # noqa: F401
from .mapstate import (  # noqa: F401
    MapState,
    PolicyKey,
    PolicyEntry,
    VERDICT_DEFAULT_DENY,
    VERDICT_ALLOW,
    VERDICT_DENY,
    VERDICT_REDIRECT,
    PROTO_TCP,
    PROTO_UDP,
    PROTO_ICMP,
    PROTO_SCTP,
    PROTO_OTHER,
    PROTO_ANY,
    DIR_INGRESS,
    DIR_EGRESS,
)
from .resolve import resolve_policy, EndpointPolicy  # noqa: F401
from .compiler import PolicyTensors, IdentityRowMap, compile_policy  # noqa: F401
