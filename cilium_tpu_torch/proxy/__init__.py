"""L7 request enforcement: the Envoy/proxylib plane.

Reference: upstream cilium redirects L7-policied connections to an
Envoy listener (``pkg/proxy`` allocates the ports, ``pkg/envoy`` pushes
``NetworkPolicy`` over xDS, ``proxylib/`` parses requests and returns
per-request verdicts, the DNS proxy lives in ``pkg/fqdn``).  Here
parsers become *featurizers* that emit fixed-width L7 feature rows;
``L7Rules`` compile into per-rule match tensors; request verdicts are
one batched pass on the card (the ``l7_verdict`` kernel), with a host
fallback only for regex/glob rules that cannot compile to exact
hashes.  The xDS push surface and the socket listeners are not ported
yet (ROADMAP A17).
"""

from .l7policy import (
    L7PolicyTensors,
    METHOD_IDS,
    compile_l7,
    l7_verdict,
    l7_verdict_plain,
)
from .featurize import featurize_dns, featurize_http, fnv64
from .proxy import L7Proxy, L7Record
from .registry import L7Protocol, register
from . import plugins  # noqa: F401 — registers cassandra/memcached

__all__ = [
    "L7Protocol",
    "register",
    "L7PolicyTensors",
    "METHOD_IDS",
    "compile_l7",
    "l7_verdict",
    "l7_verdict_plain",
    "featurize_http",
    "featurize_dns",
    "fnv64",
    "L7Proxy",
    "L7Record",
]
