"""Flow plane: Hubble-equivalent observability.

A copy of the JAX package's ``flow/`` (itself upstream cilium's
``pkg/hubble`` — ``parser/threefour``
decodes monitor events into ``flow.Flow`` records enriched with
identity/endpoint metadata; the observer keeps a ring buffer served
over an API; metrics and exporters consume the same stream).  All of
it is host code over the monitor's decoded event batches.

Flows live as struct-of-arrays in a fixed-size ring (one vectorized
append per device batch); typed Flow objects are materialized only at
the query/export edge.  ``grpc_server`` is not imported here: it needs
``grpc``, which a host may not have.
"""

from .flow import Flow, VERDICT_NAMES  # noqa: F401
from .parser import ThreeFourParser  # noqa: F401
from .observer import FlowFilter, Observer  # noqa: F401
from .metrics import FlowMetrics  # noqa: F401
from .exporter import FlowExporter  # noqa: F401
from .seven import SevenParser  # noqa: F401
from .relay import Relay  # noqa: F401
