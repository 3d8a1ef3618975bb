"""Anomaly evaluation: replay headers through the datapath and score.

The replay half of the JAX package's ``ml/evaluate.py``:
:func:`score_capture` (the datapath step, then K18 ``flow_features`` and
K19 ``anomaly_score`` per batch, one fetch at the end),
:func:`score_scenario` and :func:`fit_novelty_from_world`.  Each runs on
the device that holds the world's state (``testing.fixtures.build_world``
puts it on the card unless asked for the CPU); the model must live
there too.

Not ported yet: ``evaluate_capture``, ``synth_labeled_capture`` and
``load_labels`` need ``core/pcap.py`` (ROADMAP A13);
``train_and_evaluate``, ``round_robin_holdouts``, ``train_on_capture``
and ``evaluate_real_dataset`` need training (ROADMAP A11b).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .. import u32
from ..datapath.verdict import datapath_step
from .features import flow_features
from .model import AnomalyModel, fit_novelty, score_packets


def _world_device(model: AnomalyModel, world) -> torch.device:
    dev = world.state.metrics.device
    if model.device != dev:
        raise ValueError(f"the model is on {model.device}, the world's "
                         f"state on {dev}")
    return dev


def score_capture(model: AnomalyModel, world, hdr: np.ndarray,
                  batch_size: int = 4096, now: int = 50_000
                  ) -> np.ndarray:
    """Replay a header tensor [N, N_COLS] through the real datapath
    (``world.state`` updated in place) and score every packet; fetch-free
    until the one copy of the scores at the end.  The last batch is
    padded by repeating the last row: the pad rows are masked out of
    the datapath step (no CT or metrics side effects) but, as on the
    reference, count in that batch's feature aggregates."""
    dev = _world_device(model, world)
    n = len(hdr)
    pad = (-n) % batch_size
    if pad:
        hdr = np.concatenate([hdr, np.repeat(hdr[-1:], pad, axis=0)])
    valid_full = np.ones(len(hdr), dtype=bool)
    valid_full[n:] = False
    valid_dev = torch.from_numpy(valid_full).to(dev)
    state = world.state
    chunks = []
    for i in range(0, len(hdr), batch_size):
        jb = u32.from_numpy(hdr[i:i + batch_size], dev)
        out, state = datapath_step(state, jb, now + i,
                                   valid_dev[i:i + batch_size])
        chunks.append(score_packets(model, *flow_features(jb, out)))
    world.state = state
    scores = torch.cat(chunks).cpu().numpy()  # the one fetch
    return scores[:n]


def score_scenario(model: AnomalyModel, world, scenario, ep: int = 0,
                   n_batches: int = 8, threshold: float = 0.8) -> dict:
    """Replay a scenario's deterministic traffic (``testing/workloads.py``
    ``syn_flood``, ``port_scan``) through the datapath and score it."""
    hdr = np.concatenate(list(
        itertools.islice(scenario.iter_batches(ep), n_batches)))
    scores = score_capture(model, world, hdr)
    return {
        "scenario": scenario.name,
        "packets": int(len(hdr)),
        "mean_score": round(float(scores.mean()), 4),
        "p95_score": round(float(np.percentile(scores, 95)), 4),
        "flagged_frac": round(float((scores >= threshold).mean()), 4),
        "scores": scores,
    }


def fit_novelty_from_world(model: AnomalyModel, world, seed: int = 99,
                           batches: int = 8,
                           batch: int = 4096) -> AnomalyModel:
    """Fit the benign-novelty stats: run benign-only traffic (with the
    hard-negative patterns) through the datapath and hand the features
    to ``fit_novelty``.  Labels are never consulted."""
    from .train import synth_labeled_traffic

    dev = _world_device(model, world)
    rng = np.random.default_rng(seed)
    state = world.state
    chunks = []
    for b in range(batches):
        hdr, _ = synth_labeled_traffic(world, batch, rng, attack_frac=0.0)
        jb = u32.from_numpy(hdr, dev)
        out, state = datapath_step(state, jb, 90_000 + b)
        chunks.append(flow_features(jb, out)[1])
    world.state = state
    benign = torch.cat(chunks).cpu().numpy()  # one fetch
    return fit_novelty(model, benign)
