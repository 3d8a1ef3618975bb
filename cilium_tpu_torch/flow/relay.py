"""Relay: cluster-wide flow aggregation across agents.

Reference: upstream ``hubble-relay`` — fans GetFlows out to every
node's hubble server and merges the streams time-ordered, stamping
each flow with its node of origin.  Peers here are anything with the
Observer ``get_flows`` protocol: in-process Observers, or
:class:`cilium_tpu_torch.flow.grpc_server.ObserverClient` handles to remote
agents' gRPC servers.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from .flow import Flow
from .observer import FlowFilter


class Relay:
    def __init__(self, peers: Dict[str, object]):
        """``peers``: node name -> Observer-protocol object."""
        self.peers = dict(peers)

    def add_peer(self, name: str, obs) -> None:
        self.peers[name] = obs

    def remove_peer(self, name: str) -> None:
        self.peers.pop(name, None)

    def get_flows(self, filters: Sequence[FlowFilter] = (),
                  number: int = 100,
                  oldest_first: bool = False,
                  blacklist: Sequence[FlowFilter] = ()) -> List[dict]:
        """Merged, time-ordered flows as dicts with ``node_name``
        stamped (relay adds the node dimension the per-agent API
        lacks)."""
        merged: List[dict] = []
        for name, obs in self.peers.items():
            for f in obs.get_flows(filters=filters, number=number,
                                   oldest_first=oldest_first,
                                   blacklist=blacklist):
                d = f.to_dict() if isinstance(f, Flow) else dict(f)
                d["node_name"] = name
                merged.append(d)
        merged.sort(key=lambda d: d.get("time", 0.0),
                    reverse=not oldest_first)
        return merged[:number]

    def nodes(self) -> List[dict]:
        """The GetNodes surface (``hubble list nodes``): per-peer
        availability + flow counts; a dead peer reports unavailable
        instead of failing the listing."""
        out = []
        for name, obs in sorted(self.peers.items()):
            try:
                st = (obs.server_status()
                      if hasattr(obs, "server_status") else {})
                n = st.get("num_flows",
                           len(obs) if hasattr(obs, "__len__") else 0)
                out.append({"name": name, "state": "connected",
                            "num_flows": int(n),
                            "seen_flows": int(st.get("seen_flows", n))})
            except Exception as e:
                out.append({"name": name, "state": "unavailable",
                            "error": str(e)[:100]})
        return out

    def server_status(self) -> dict:
        """hubble-relay ServerStatus: aggregate over peers."""
        total = seen = 0
        nodes = []
        for name, obs in self.peers.items():
            try:
                n = len(obs) if hasattr(obs, "__len__") else 0
                s = getattr(obs, "seq", n)
                nodes.append({"name": name, "flows": n, "seen": s})
                total += n
                seen += s
            except Exception as e:  # a dead peer must not kill status
                nodes.append({"name": name, "error": str(e)[:100]})
        return {"num_flows": total, "seen_flows": seen,
                "num_connected_nodes": len(self.peers), "nodes": nodes}
