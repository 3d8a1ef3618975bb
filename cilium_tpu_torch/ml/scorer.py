"""AnomalyScorer: the learned path wired into the monitor plane.

A port of the JAX package's ``ml/scorer.py``.  The scorer consumes
EventBatches (a ``MonitorAgent`` consumer), scores them with the model
(K18 ``flow_features`` then K19 ``anomaly_score`` on the card) and keeps
rolling statistics and the most anomalous recent flows.  Scores are
advisory: they never change a verdict.

Under serving it runs on the event-join worker.  Its kernels and its
one fetch of the scores run on the scorer's own CUDA stream, so the
fetch waits for the scorer's work alone, not for the serve steps queued
on the loader's stream.  Identities map to embedding rows with one
vectorized lookup a batch (``IdentityRowMap.rows_of``), not a Python
call an event.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Tuple

import numpy as np
import torch

from .. import u32
from ..device import resolve_device
from ..monitor.api import EventBatch, materialize
from .features import flow_features
from .model import AnomalyModel, score_packets


class AnomalyScorer:
    def __init__(self, params: AnomalyModel,
                 row_of_identity: Callable[[np.ndarray], np.ndarray],
                 threshold: float = 0.8, top_k: int = 64, device=None):
        """``row_of_identity``: numeric identities [N] -> embedding rows
        [N], 0 for an unknown identity (``IdentityRowMap.rows_of``).
        ``device`` (None: the card) holds the model and runs the
        kernels; ``"cpu"`` runs the plain versions."""
        self.device = resolve_device(device)
        # a copy on the scorer's device: the caller's model stays put
        self.params = params.replace().to(self.device)
        self.row_of_identity = row_of_identity
        self.threshold = threshold
        self.top_k = top_k
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(device=self.device)
            # the weights' upload ran on the current stream
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self._lock = threading.Lock()
        # guarded-by: _lock: scored, flagged, _score_sum, _top
        self.scored = 0
        self.flagged = 0
        self._score_sum = 0.0
        self._top: List[Tuple[float, dict]] = []

    def _scores(self, hdr: np.ndarray, out: np.ndarray) -> np.ndarray:
        id_row, feats = flow_features(u32.from_numpy(hdr, self.device),
                                      u32.from_numpy(out, self.device))
        return score_packets(self.params, id_row, feats).cpu().numpy()

    def inputs(self, batch: EventBatch) -> Tuple[np.ndarray, np.ndarray]:
        # thread-affinity: any
        """The device inputs rebuilt from the SoA batch: (header rows
        [N, 16], out rows [N, 6]) as u32, with the identities mapped
        back to embedding rows."""
        out_cols = np.stack([
            batch.verdict.astype(np.uint32),
            batch.proxy_port.astype(np.uint32),
            batch.ct_state.astype(np.uint32),
            np.asarray(self.row_of_identity(batch.identity),
                       dtype=np.uint32),
            batch.reason.astype(np.uint32),
            batch.msg_type.astype(np.uint32),
        ], axis=1)
        return batch.hdr, out_cols

    def scores(self, hdr: np.ndarray, out: np.ndarray) -> np.ndarray:
        # thread-affinity: any
        """K18 then K19 over :meth:`inputs`' arrays, on the scorer's
        stream; one fetch.  Touches no statistics."""
        if self._stream is None:
            return self._scores(hdr, out)
        with torch.cuda.stream(self._stream):
            return self._scores(hdr, out)

    def consume(self, batch: EventBatch) -> np.ndarray:
        # thread-affinity: event-worker, offline, api
        """Score a batch; returns the scores [N] float32."""
        if len(batch) == 0:
            return np.zeros(0, dtype=np.float32)
        scores = self.scores(*self.inputs(batch))
        hot = np.nonzero(scores >= self.threshold)[0]
        with self._lock:
            self.scored += len(scores)
            self.flagged += len(hot)
            self._score_sum += float(scores.sum())
            for i in hot[:32]:
                ev = materialize(batch, int(i))
                self._top.append((float(scores[i]), {
                    "score": round(float(scores[i]), 4),
                    "src": f"{ev.src_ip}:{ev.sport}",
                    "dst": f"{ev.dst_ip}:{ev.dport}",
                    "proto": ev.proto,
                    "identity": ev.identity,
                    "time": ev.timestamp,
                }))
            self._top.sort(key=lambda t: -t[0])
            del self._top[self.top_k:]
        return scores

    def stats(self) -> dict:
        with self._lock:
            return {
                "scored": self.scored,
                "flagged": self.flagged,
                "threshold": self.threshold,
                "mean-score": round(self._score_sum / self.scored, 4)
                if self.scored else 0.0,
                "top": [rec for _, rec in self._top[:10]],
            }
