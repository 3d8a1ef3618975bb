"""The agent: the per-node control plane (the cilium-agent analogue),
reduced to what the port's serving path needs: endpoints, their
regeneration, and the daemon wiring (``daemon.Daemon``)."""

from .endpoint import Endpoint, EndpointState  # noqa: F401
from .endpointmanager import EndpointManager  # noqa: F401
from .daemon import Daemon, DaemonConfig  # noqa: F401
