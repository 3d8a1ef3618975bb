"""Flow metrics: Prometheus-style counters from the flow stream.

Reference: upstream cilium ``pkg/hubble/metrics`` — pluggable handlers
("flow", "drop", "port-distribution", "policy-verdict", ...) turning
flows into Prometheus series, plus ``pkg/metrics``' agent registry.
Vectorized: handlers aggregate whole EventBatches with numpy bincount,
not per-flow callbacks.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Tuple

import numpy as np

from ..core.packets import COL_DIR, COL_DPORT, COL_PROTO
from ..monitor.api import MSG_DROP, MSG_POLICY_VERDICT, EventBatch
from ..policy.mapstate import VERDICT_ALLOW, VERDICT_REDIRECT


class FlowMetrics:
    """Aggregates the monitor stream (a MonitorAgent consumer)."""

    def __init__(self):
        self.flows_total: Dict[Tuple[str, str], int] = defaultdict(int)
        self.drops_total: Dict[Tuple[int, str], int] = defaultdict(int)
        self.port_distribution: Dict[Tuple[int, int], int] = defaultdict(int)
        self.policy_verdicts: Dict[Tuple[str, str], int] = defaultdict(int)

    def consume(self, batch: EventBatch) -> None:
        if len(batch) == 0:
            return
        dirs = batch.hdr[:, COL_DIR]
        fwd = (batch.verdict == VERDICT_ALLOW) | \
              (batch.verdict == VERDICT_REDIRECT)
        for d in (0, 1):
            dname = "ingress" if d == 0 else "egress"
            sel = dirs == d
            self.flows_total[("forwarded", dname)] += int((fwd & sel).sum())
            self.flows_total[("dropped", dname)] += int((~fwd & sel).sum())
        dropped = batch.msg_type == MSG_DROP
        if dropped.any():
            for d in (0, 1):
                dname = "ingress" if d == 0 else "egress"
                sel = dropped & (dirs == d)
                if not sel.any():
                    continue
                reasons, counts = np.unique(batch.reason[sel],
                                            return_counts=True)
                for r, n in zip(reasons.tolist(), counts.tolist()):
                    self.drops_total[(int(r), dname)] += n
        # vectorized (proto, dport) histogram: one bincount per batch
        key = (batch.hdr[:, COL_PROTO].astype(np.int64) << 16) \
            | batch.hdr[:, COL_DPORT].astype(np.int64)
        uniq, counts = np.unique(key, return_counts=True)
        for k, n in zip(uniq.tolist(), counts.tolist()):
            self.port_distribution[(k >> 16, k & 0xFFFF)] += n
        verdict_ev = batch.msg_type == MSG_POLICY_VERDICT
        if verdict_ev.any():
            allowed = fwd & verdict_ev
            self.policy_verdicts[("allowed", "L3_L4")] += int(allowed.sum())
            self.policy_verdicts[("denied", "L3_L4")] += int(
                (verdict_ev & ~fwd).sum())

    def render(self) -> str:
        """Prometheus text exposition of the flow series, the text the
        JAX package's metrics registry renders for them (its
        ``register_flow_metrics``: HELP and TYPE lines, then one sample
        a key in sorted order).  The port has no agent-wide registry
        yet (ROADMAP A14), so the series render here."""
        series = (
            ("hubble_flows_processed_total",
             "flows seen on the monitor stream by verdict/direction",
             ("verdict", "direction"), self.flows_total),
            ("hubble_drop_total",
             "dropped flows by datapath reason code/direction",
             ("reason", "direction"), self.drops_total),
            ("hubble_port_distribution_total",
             "destination (protocol, port) histogram over the flow stream",
             ("protocol", "port"), self.port_distribution),
            ("hubble_policy_verdicts_total",
             "policy-verdict events by verdict/match type",
             ("verdict", "match"), self.policy_verdicts),
        )
        lines = []
        for name, help_, keys, counts in series:
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} counter")
            for key, n in sorted(counts.items()):
                labels = ",".join(f'{k}="{_escape(v)}"'
                                  for k, v in zip(keys, key))
                lines.append(f"{name}{{{labels}}} {n}")
        return "\n".join(lines) + "\n"


def _escape(v) -> str:
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))
