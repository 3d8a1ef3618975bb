"""CIC-IDS2017-style anomaly evaluation: labeled pcap -> AUC.

A port of the JAX package's ``ml/evaluate.py``.  BASELINE.md's config
#5 is "anomaly AUC on CIC-IDS2017 pcap replay": this module synthesizes
a labeled capture with the same attack taxonomy (port scans, SYN floods,
exfiltration) against benign steady-state traffic, and evaluates any
labeled capture of the same shape, a pcap plus a label sidecar (``.npz``
with ``labels`` and optional ``dir``/``ep``, or a CIC-IDS2017 flow CSV
whose 5-tuples label the packets).

:func:`score_capture` replays header rows through the datapath step,
then K18 ``flow_features`` and K19 ``anomaly_score`` per batch, one
fetch at the end; :func:`train_on_capture` trains on a capture's
time-ordered head (K20-K22 each batch); :func:`train_and_evaluate` and
:func:`round_robin_holdouts` run the whole config #5 pipeline on
synthetic captures through ``core/pcap.py``, and
:func:`evaluate_real_dataset` on a real one.  Each runs on the device
that holds the world's state (``testing.fixtures.build_world`` puts it
on the card unless asked for the CPU); the model must live there too.

``python -m cilium_tpu_torch.ml.evaluate`` runs on the card and prints
one JSON line ``{"metric": "anomaly_auc", ...}``: on the capture named
by ``CILIUM_TPU_CIC_PCAP``/``CILIUM_TPU_CIC_LABELS`` (or
``data/cic-ids2017.pcap`` beside a ``.csv``/``.npz``), else the
round-robin holdouts on synthetic captures.
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from .. import u32
from ..core.packets import (COL_DIR, COL_DPORT, COL_DST_IP3, COL_EP,
                            COL_PROTO, COL_SPORT, COL_SRC_IP3, HeaderBatch)
from ..core.pcap import read_pcap, write_pcap
from ..datapath.verdict import datapath_step
from .features import flow_features
from .model import (TRAINABLE, AnomalyModel, fit_novelty, init_params,
                    save_model, score_packets)
from .train import (ATTACK_KINDS, Adam, auc, make_train_step,
                    synth_labeled_traffic, train)


def synth_labeled_capture(pcap_path: str, labels_path: str, world,
                          n: int = 65536, seed: int = 1,
                          attack_frac: float = 0.25,
                          kinds=(0, 1, 2)) -> None:
    """Write a labeled pcap + npz sidecar with the synthetic attack mix
    (the in-repo stand-in for CIC-IDS2017).  ``kinds`` selects which
    attack kinds appear (per-kind held-out evaluation)."""
    rng = np.random.default_rng(seed)
    hdr, labels = synth_labeled_traffic(world, n, rng,
                                        attack_frac=attack_frac,
                                        kinds=kinds)
    write_pcap(pcap_path, HeaderBatch(hdr))
    np.savez_compressed(labels_path, labels=labels,
                        dir=hdr[:, COL_DIR].astype(np.uint8),
                        ep=hdr[:, COL_EP].astype(np.uint16))


def load_labels(path: str, hdr: np.ndarray) -> np.ndarray:
    """Label sidecar -> per-packet labels aligned with ``hdr`` rows.

    Also applies ``dir``/``ep`` ingest metadata from npz sidecars onto
    the header rows in place (direction is not recoverable from wire
    bytes alone)."""
    if path.endswith(".npz"):
        z = np.load(path)
        labels = np.asarray(z["labels"], dtype=np.float32)
        if len(labels) != len(hdr):
            raise ValueError(
                f"label count {len(labels)} != packet count {len(hdr)}")
        if "dir" in z:
            hdr[:, COL_DIR] = z["dir"]
        if "ep" in z:
            hdr[:, COL_EP] = z["ep"]
        return labels
    # CIC-IDS2017 flow CSV: map 5-tuples to labels
    import csv
    import ipaddress

    flow_label: Dict[tuple, float] = {}
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        cols = {c.strip().lower(): c for c in reader.fieldnames or ()}

        def col(row, *names):
            for nm in names:
                c = cols.get(nm)
                if c is not None:
                    return row[c].strip()
            raise KeyError(names)

        for row in reader:
            try:
                key = (int(ipaddress.ip_address(
                           col(row, "source ip", "src ip"))),
                       int(ipaddress.ip_address(
                           col(row, "destination ip", "dst ip"))),
                       int(col(row, "source port", "src port")),
                       int(col(row, "destination port", "dst port")),
                       int(col(row, "protocol")))
            except (ValueError, KeyError):
                continue
            lab = col(row, "label").upper()
            flow_label[key] = 0.0 if lab == "BENIGN" else 1.0
    labels = np.zeros(len(hdr), dtype=np.float32)
    for i in range(len(hdr)):
        src, dst = int(hdr[i, COL_SRC_IP3]), int(hdr[i, COL_DST_IP3])
        sp, dp = int(hdr[i, COL_SPORT]), int(hdr[i, COL_DPORT])
        proto = int(hdr[i, COL_PROTO])
        lab = flow_label.get((src, dst, sp, dp, proto))
        if lab is None:
            # CSVs record flows in one direction; reply packets of a
            # bidirectional attack flow inherit its label
            lab = flow_label.get((dst, src, dp, sp, proto), 0.0)
        labels[i] = lab
    return labels


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


def evaluate_capture(model: AnomalyModel, world, pcap_path: str,
                     labels_path: str) -> dict:
    """pcap + labels -> {"anomaly_auc": ...} (BASELINE config #5)."""
    hdr = read_pcap(pcap_path).data
    labels = load_labels(labels_path, hdr)
    scores = score_capture(model, world, hdr)
    return {
        "anomaly_auc": round(float(auc(scores, labels)), 4),
        "packets": int(len(hdr)),
        "attack_packets": int((labels > 0.5).sum()),
    }


def train_and_evaluate(n_identities: int = 1024, train_steps: int = 150,
                       train_batch: int = 4096, eval_packets: int = 65536,
                       seed: int = 0, model_out: Optional[str] = None,
                       workdir: Optional[str] = None,
                       holdout_kind: int = 2, device=None) -> dict:
    """The full BASELINE config-#5 pipeline on ``device`` (None: the
    card).  Training sees every attack kind except ``holdout_kind``; the
    evaluation reports AUC per kind on kind-pure captures written and
    read back through ``core/pcap.py``.  The held-out kind's AUC is the
    generalization result; the same-mix number is a smoke test (train
    and eval draw from the same generator) and is labeled as such."""
    import tempfile

    from ..testing.fixtures import build_world

    world = build_world(n_identities=n_identities, n_rules=16,
                        ct_capacity=1 << 18, device=device)
    labels_by_row = {
        world.row_map.row(i.numeric_id): tuple(str(l) for l in i.labels)
        for i in world.alloc.all_identities()}
    model = init_params(torch.Generator().manual_seed(seed),
                        world.row_map.capacity, labels_by_row=labels_by_row,
                        device=world.state.metrics.device)
    train_kinds = tuple(k for k in ATTACK_KINDS if k != holdout_kind)
    model, losses = train(model, world, steps=train_steps,
                          batch=train_batch, seed=seed, kinds=train_kinds)
    model = fit_novelty_from_world(model, world, seed=seed + 99)
    workdir = workdir or tempfile.mkdtemp(prefix="cilium-anomaly-")

    # per-kind captures: each eval pcap carries ONE attack kind (plus
    # the hard-negative benign mix), so each AUC isolates one kind
    auc_by_kind = {}
    pcap = None
    for kind, kname in ATTACK_KINDS.items():
        pcap_k = os.path.join(workdir, f"eval_{kname}.pcap")
        sidecar_k = os.path.join(workdir, f"eval_{kname}.npz")
        per_kind_n = max(eval_packets // len(ATTACK_KINDS), 4096)
        synth_labeled_capture(pcap_k, sidecar_k, world, n=per_kind_n,
                              seed=seed + 1 + kind, kinds=(kind,))
        r = evaluate_capture(model, world, pcap_k, sidecar_k)
        auc_by_kind[kname] = r["anomaly_auc"]
        if kind == holdout_kind:
            pcap = pcap_k

    # the same-mix smoke number (train kinds only)
    pcap_mix = os.path.join(workdir, "eval_mix.pcap")
    sidecar_mix = os.path.join(workdir, "eval_mix.npz")
    synth_labeled_capture(pcap_mix, sidecar_mix, world, n=eval_packets,
                          seed=seed + 17, kinds=train_kinds)
    smoke = evaluate_capture(model, world, pcap_mix, sidecar_mix)

    holdout_name = ATTACK_KINDS[holdout_kind]
    result = {
        # headline = generalization to the UNSEEN attack kind
        "anomaly_auc": auc_by_kind[holdout_name],
        "auc_heldout_kind": auc_by_kind[holdout_name],
        "holdout_kind": holdout_name,
        "auc_by_kind": auc_by_kind,
        "auc_same_mix_smoke": smoke["anomaly_auc"],
        "smoke_note": ("same-mix AUC shares the generator with "
                       "training; it is a smoke test, not a result"),
        "packets": smoke["packets"],
        "attack_packets": smoke["attack_packets"],
        "train_kinds": [ATTACK_KINDS[k] for k in train_kinds],
        "train_steps": train_steps,
        "final_loss": round(losses[-1], 4),
        "eval_pcap": pcap,
    }
    if model_out:
        save_model(model_out, model)
        result["model"] = model_out
    return result


def round_robin_holdouts(**kwargs) -> dict:
    """Train three models, each with one attack kind held out, and
    report every held-out AUC; the headline is the minimum, the weakest
    unseen-kind generalization."""
    per_holdout = {}
    details = {}
    for kind, kname in ATTACK_KINDS.items():
        r = train_and_evaluate(holdout_kind=kind, **kwargs)
        per_holdout[kname] = r["auc_heldout_kind"]
        details[kname] = {
            "auc_by_kind": r["auc_by_kind"],
            "auc_same_mix_smoke": r["auc_same_mix_smoke"],
            "final_loss": r["final_loss"],
        }
    worst = min(per_holdout, key=per_holdout.get)
    return {
        "anomaly_auc": per_holdout[worst],
        "holdout_kind": worst,
        "auc_heldout_by_kind": per_holdout,
        "auc_heldout_mean": round(sum(per_holdout.values())
                                  / len(per_holdout), 4),
        "per_holdout_detail": details,
        "note": ("round-robin holdout: three trainings, each scored on "
                 "the kind it never saw; headline = worst kind"),
    }


def train_on_capture(model: AnomalyModel, world, hdr: np.ndarray,
                     labels: np.ndarray, epochs: int = 4,
                     batch: int = 4096, lr: float = 3e-3,
                     now: int = 10_000):
    """Supervised training on a real labeled capture slice: replay it
    through the datapath in time order (CT state builds up as it did on
    the wire), one optimizer step per full batch, ``epochs`` passes.
    Returns (a trained copy of ``model`` with novelty fitted on the
    last pass's benign rows, the final loss), one fetch at the end."""
    dev = _world_device(model, world)
    model = model.replace(**{k: t.clone() for k, t in zip(
        TRAINABLE, model.leaves())})
    optimizer = Adam(lr)
    opt_state = optimizer.init(model)
    step_fn = make_train_step(optimizer)
    state = world.state
    loss = None
    benign_feats = []
    n = (len(hdr) // batch) * batch  # full batches only
    labels_dev = torch.from_numpy(np.ascontiguousarray(
        labels[:n], dtype=np.float32)).to(dev)
    for e in range(epochs):
        for i in range(0, n, batch):
            jb = u32.from_numpy(hdr[i:i + batch], dev)
            out, state = datapath_step(state, jb, now + e * n + i)
            id_row, feats = flow_features(jb, out)
            model, opt_state, loss = step_fn(model, opt_state, id_row,
                                             feats, labels_dev[i:i + batch])
            if e == epochs - 1:
                benign_feats.append(feats)
    world.state = state
    feats_h = torch.cat(benign_feats).cpu().numpy()  # the one fetch
    benign = feats_h[labels[:n] < 0.5]
    model = fit_novelty(model, benign)
    return model, float(loss.item()) if loss is not None else None


def evaluate_real_dataset(pcap_path: str, labels_path: str,
                          local_cidr: str = "192.168.10.0/24",
                          n_identities: int = 256,
                          train_frac: float = 0.7,
                          epochs: int = 4, batch: int = 4096,
                          seed: int = 0, device=None) -> dict:
    """BASELINE config #5 on a real labeled pcap (CIC-IDS2017 CSV
    schema), on ``device`` (None: the card): the capture replays through
    the wire parsers (``core/pcap.py``) into header rows, the first
    ``train_frac`` of the packets (time order, never shuffled across the
    boundary) trains the model on the sidecar labels, and the held-out
    tail is scored.  ``local_cidr`` supplies the ingest metadata a
    wire-only capture lacks: packets sourced inside it are egress of the
    monitored network (CIC-IDS2017's victim LAN is 192.168.10.0/24)."""
    import ipaddress

    from ..testing.fixtures import build_world

    world = build_world(n_identities=n_identities, n_rules=16,
                        ct_capacity=1 << 18, device=device)
    hdr = read_pcap(pcap_path).data
    labels = load_labels(labels_path, hdr)
    net = ipaddress.ip_network(local_cidr)
    mask = int(net.netmask)
    base = int(net.network_address)
    src_local = (hdr[:, COL_SRC_IP3] & mask) == base
    dst_local = (hdr[:, COL_DST_IP3] & mask) == base
    hdr[:, COL_DIR] = np.where(src_local & ~dst_local, 1, 0)

    n_train = int(len(hdr) * train_frac)
    model = init_params(torch.Generator().manual_seed(seed),
                        world.row_map.capacity,
                        device=world.state.metrics.device)
    model, final_loss = train_on_capture(
        model, world, hdr[:n_train], labels[:n_train],
        epochs=epochs, batch=batch)
    scores = score_capture(model, world, hdr[n_train:], batch_size=batch)
    tail = labels[n_train:]
    return {
        "anomaly_auc": round(float(auc(scores, tail)), 4),
        "source": "real-pcap",
        "pcap": pcap_path,
        "packets": int(len(hdr)),
        "train_packets": int(n_train),
        "eval_packets": int(len(hdr) - n_train),
        "eval_attack_packets": int((tail > 0.5).sum()),
        "final_loss": final_loss,
        "note": ("time-ordered train/eval split through the real "
                 "parsers and datapath; labels from the CIC-schema "
                 "sidecar"),
    }


def _find_real_dataset():
    """File gate for the real-dataset path: env vars first, then the
    conventional data/ location at the root of the checkout."""
    pcap = os.environ.get("CILIUM_TPU_CIC_PCAP")
    labels = os.environ.get("CILIUM_TPU_CIC_LABELS")
    if pcap and labels and os.path.exists(pcap) \
            and os.path.exists(labels):
        return pcap, labels
    root = os.path.join(os.path.dirname(__file__), "..", "..", "data")
    for ext in (".csv", ".npz"):
        p = os.path.join(root, "cic-ids2017.pcap")
        lab = os.path.join(root, "cic-ids2017" + ext)
        if os.path.exists(p) and os.path.exists(lab):
            return p, lab
    return None, None


def main() -> None:
    pcap, labels = _find_real_dataset()
    if pcap:
        result = evaluate_real_dataset(pcap, labels)
        print(json.dumps({
            "metric": "anomaly_auc",
            "value": result["anomaly_auc"],
            "unit": "auc",
            **{k: v for k, v in result.items() if k != "anomaly_auc"},
        }))
        return
    result = round_robin_holdouts()
    print(json.dumps({
        "metric": "anomaly_auc",
        "value": result["anomaly_auc"],
        "unit": "auc",
        "source": ("synthetic fallback (no CIC-IDS2017 on disk; set "
                   "CILIUM_TPU_CIC_PCAP/CILIUM_TPU_CIC_LABELS)"),
        **{k: v for k, v in result.items() if k != "anomaly_auc"},
    }))


if __name__ == "__main__":
    main()
