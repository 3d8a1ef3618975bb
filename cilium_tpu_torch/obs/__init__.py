"""Observability plane: the flow analytics engine.

- :mod:`.analytics` — windowed per-identity aggregation, space-saving
  top-K talkers, and drop-spike detection over the decoded event
  stream; all aggregation runs OFF the dispatch path (event-join
  worker / query threads).  ``Daemon.flows_aggregate()`` renders it.
"""

from __future__ import annotations

from .analytics import (FlowAnalytics, SpaceSavingSketch,  # noqa: F401
                        SpikeDetector, WindowAggregator,
                        validate_analytics_config)

__all__ = [
    "FlowAnalytics",
    "SpaceSavingSketch",
    "SpikeDetector",
    "WindowAggregator",
    "validate_analytics_config",
]
