"""The port's anomaly plane end to end against the JAX package's, with a
model trained by the JAX package (``ml/train.py`` ``train``, one
module-scoped fixture) and carried over through a checkpoint:

- ``score_capture`` on one world and one header tensor in both packages
  (the world's state carried across with ``convert``): scores within
  2e-3, and 99.9% of them within 1e-5 (the features' ``log1p`` columns
  differ by an ulp between XLA and torch, and ``d2`` carries that into
  the novelty score; ``tests/test_torch_ml.py`` states the per-module
  tolerances), AUC within 0.005, and the CT tables equal as
  placement-free row sets;
- the reference's ``tests/test_ml.py`` ``test_label_embedding_correlates``,
  ``test_auc_sanity`` and ``test_scorer_advisory``, through the port;
- ``tests/test_adversarial_scenarios.py`` ``TestAnomalyModelSeesScenarios``,
  both cases, through the port's ``score_scenario`` and the port's
  ``Daemon(anomaly_model_path=...)`` on ``process_batch``;
- the armed daemon scores every event the monitor publishes while it
  serves (``submit`` -> ``stop_serving``);
- the port's scenario copies give the reference's batches bit for bit.
"""

import numpy as np
import pytest
import torch

import jax

from cilium_tpu.datapath.conntrack import ct_rows_from_table as jct_rows
from cilium_tpu.ml import evaluate as jeval
from cilium_tpu.ml import model as jmod
from cilium_tpu.ml.train import auc as jauc, train as jtrain
from cilium_tpu.testing import fixtures as jfix
from cilium_tpu.testing import workloads as jwl
from cilium_tpu_torch import convert, u32
from cilium_tpu_torch.datapath.conntrack import ct_rows_from_table
from cilium_tpu_torch.datapath.verdict import datapath_step
from cilium_tpu_torch.ml import (AnomalyScorer, auc, evaluate,
                                 label_embedding_init, load_model,
                                 save_model, synth_labeled_traffic)
from cilium_tpu_torch.monitor.api import decode_out
from cilium_tpu_torch.testing import fixtures as tfix
from cilium_tpu_torch.testing import workloads as twl

torch.set_num_threads(1)

WORLD = dict(n_identities=128, n_rules=16, ct_capacity=1 << 14)


def _state_arrays(js):
    arrays = {g: {f: (v if f == "default" else np.array(v))
                  for f, v in vars(getattr(js, g)).items()}
              for g in ("policy", "ipcache", "ct")}
    arrays["metrics"] = np.array(js.metrics)
    return arrays


def _port_world(jw):
    """The port's copy of ``jw``: the same build, with the JAX world's
    state (the CT entries training left) carried across."""
    tw = tfix.build_world(**WORLD, device="cpu")
    tw.state = convert.datapath_state_from_numpy(_state_arrays(jw.state),
                                                 "cpu")
    return tw


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A JAX model trained by the JAX package on every attack kind (the
    embedding from the world's labels), its novelty fitted, saved; the
    port's model loaded from that checkpoint, and the port's model saved
    again for the daemon that loads the port's format."""
    jw = jfix.build_world(**WORLD)
    labels_by_row = {jw.row_map.row(i.numeric_id):
                     tuple(str(l) for l in i.labels)
                     for i in jw.alloc.all_identities()}
    params = jmod.init_params(jax.random.PRNGKey(0), jw.row_map.capacity,
                              labels_by_row=labels_by_row)
    params, losses = jtrain(params, jw, steps=40, batch=1024, seed=0)
    params = jeval.fit_novelty_from_world(params, jw, seed=99)
    d = tmp_path_factory.mktemp("model")
    jpath, tpath = str(d / "jax.npz"), str(d / "torch.npz")
    jmod.save_model(jpath, params)
    model = load_model(jpath, "cpu")
    save_model(tpath, model)
    return dict(jw=jw, params=params, model=model, jpath=jpath,
                tpath=tpath, losses=losses)


# -- the reference's tests/test_ml.py, through the port ------------------


def test_label_embedding_correlates():
    rows = {0: ("k8s:app=web", "k8s:ns=prod"),
            1: ("k8s:app=web", "k8s:ns=dev"),
            2: ("k8s:app=db", "k8s:zone=z9")}
    t = label_embedding_init(rows, 4, 64)
    sim01 = float(t[0] @ t[1])
    sim02 = float(t[0] @ t[2])
    assert sim01 > sim02  # shared app=web label -> closer rows
    assert np.allclose(np.linalg.norm(t[:3], axis=1), 1.0, atol=1e-5)


def test_auc_sanity():
    assert auc(np.array([0.9, 0.8, 0.2, 0.1]),
               np.array([1, 1, 0, 0])) == 1.0
    assert abs(auc(np.array([0.1, 0.9, 0.2, 0.8]),
                   np.array([1, 0, 0, 1])) - 0.5) < 0.51
    rng = np.random.default_rng(3)
    s, lab = rng.random(500).round(2), rng.random(500) < 0.3  # with ties
    assert auc(s, lab) == jauc(s, lab)


def test_scorer_advisory(trained):
    """Scores flow back via the monitor plane and never mutate
    verdicts."""
    tw = _port_world(trained["jw"])
    rng = np.random.default_rng(77)
    hdr, labels = synth_labeled_traffic(tw, 1024, rng)
    out, tw.state = datapath_step(tw.state, u32.from_numpy(hdr, "cpu"),
                                  60_000)
    out_np = u32.to_numpy(out)
    batch = decode_out(out_np, hdr, tw.row_map.numeric_array(),
                       timestamp=1.0)
    verdicts = batch.verdict.copy()
    scorer = AnomalyScorer(trained["model"], tw.row_map.rows_of,
                           threshold=0.5, device="cpu")
    scores = scorer.consume(batch)
    assert len(scores) == 1024
    a = auc(scores, labels)
    assert a > 0.85
    st = scorer.stats()
    assert st["scored"] == 1024 and st["flagged"] > 0
    assert len(st["top"]) > 0 and st["top"][0]["score"] >= 0.5
    np.testing.assert_array_equal(batch.verdict, verdicts)


# -- score_capture against the reference ---------------------------------


def test_score_capture_matches_jax(trained):
    """One world state, one header tensor (its last batch padded), both
    packages: scores, AUC, and the CT row sets after the replay."""
    jw = trained["jw"]
    tw = _port_world(jw)
    rng = np.random.default_rng(8)
    hdr, labels = synth_labeled_traffic(tw, 5000, rng)
    js = jeval.score_capture(trained["params"], jw, hdr)
    ts = evaluate.score_capture(trained["model"], tw, hdr)
    assert ts.shape == (5000,) and ts.dtype == np.float32
    diff = np.abs(js - ts)
    assert diff.max() <= 2e-3 and (diff <= 1e-5).mean() >= 0.999
    assert abs(auc(ts, labels) - jauc(js, labels)) <= 0.005
    np.testing.assert_array_equal(
        ct_rows_from_table(u32.to_numpy(tw.state.ct.table)),
        jct_rows(np.asarray(jw.state.ct.table)))
    np.testing.assert_array_equal(u32.to_numpy(tw.state.metrics),
                                  np.asarray(jw.state.metrics))


# -- tests/test_adversarial_scenarios.py TestAnomalyModelSeesScenarios ---


def test_scenario_attacks_separate_from_benign(trained):
    tw = _port_world(trained["jw"])
    model = trained["model"]
    rng = np.random.default_rng(5)
    benign = tfix.bench_traffic(tw, 4096, rng)
    benign_scores = evaluate.score_capture(model, tw, benign)
    for name in ("port_scan", "syn_flood"):
        sc = twl.make_scenario(name, seed=21)
        got = evaluate.score_scenario(model, tw, sc, ep=0, n_batches=4)
        scores = got.pop("scores")
        labels = np.concatenate([
            np.ones(len(scores)), np.zeros(len(benign_scores))])
        a = auc(np.concatenate([scores, benign_scores]), labels)
        assert a > 0.85, (name, a, got)
        assert got["mean_score"] > float(benign_scores.mean()), (name, got)


@pytest.mark.parametrize("saved_by", ["jax", "torch"])
def test_monitor_scorer_flags_port_scan(trained, saved_by):
    """A daemon with the trained model armed on the monitor stream flags
    the scan live, from a checkpoint of either package."""
    path = trained["jpath" if saved_by == "jax" else "tpath"]
    sc = twl.make_scenario("port_scan", seed=23, n_packets=1024, batch=256)
    d = twl.scenario_daemon(sc, device="cpu", map_pressure_interval=0.0,
                            anomaly_model_path=path, anomaly_threshold=0.5)
    d.start()
    try:
        ctx = sc.setup(d)
        for b in sc.iter_batches(ctx["ep"]):
            d.process_batch(b)
        st = d.anomaly.stats()
        assert st["scored"] >= 1024
        assert st["scored"] == d.monitor.published
        assert st["flagged"] > 0, st
        # the flagged-top entries point at the scanner source
        assert any(rec["src"].startswith("172.20.0.7")
                   for rec in st["top"]), st["top"]
        assert d.monitor.lost_count("anomaly") == 0
    finally:
        d.shutdown()


def test_serving_daemon_scores_every_published_event(trained):
    """Under serving the scorer runs on the event-join worker: every
    event the monitor publishes is scored, none lost."""
    sc = twl.make_scenario("port_scan", seed=29, n_packets=3000, batch=500)
    d = twl.scenario_daemon(sc, device="cpu", map_pressure_interval=0.0,
                            serving_bucket_ladder=(256, 1024),
                            anomaly_model_path=trained["tpath"])
    try:
        ctx = sc.setup(d)
        d.start_serving(ingress=True, ring_capacity=1 << 12)
        rows = np.concatenate(list(sc.iter_batches(ctx["ep"])))
        assert d.submit(rows) == len(rows)
        out = d.stop_serving()
        fe = out["front-end"]
        assert fe["submitted"] == fe["verdicts"] == len(rows)
        assert out["lost"] == 0 and out["events"] == len(rows)
        st = d.anomaly.stats()
        assert st["scored"] == d.monitor.published == len(rows)
        assert d.monitor.lost_count("anomaly") == 0
        assert st["flagged"] > 0
    finally:
        d.shutdown()


# -- the scenario copies -------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("syn_flood", dict(n_flows=3000, batch=512)),
    ("port_scan", dict(n_packets=2000, batch=256)),
    ("port_scan", dict(open_port=80)),
    ("syn_flood", dict(dport=443)),
    ("l7_abuse", dict(n_packets=2000, batch=256)),
    ("elephant_mice", dict(n_flows=128, n_packets=3000, zipf_a=1.4)),
    ("endpoint_churn", dict(n_slots=5, rate_hz=100.0)),
])
def test_scenario_batches_equal_the_reference(name, kw):
    for seed in (0, 21):
        ours = twl.make_scenario(name, seed=seed, **kw)
        ref = jwl.make_scenario(name, seed=seed, **kw)
        got, want = list(ours.iter_batches(5)), list(ref.iter_batches(5))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert ours.signature() == ref.signature()
        assert ours.criteria == ref.criteria and ours.path == ref.path
    with pytest.raises(NotImplementedError, match="ROADMAP A21"):
        twl.make_scenario("rotation_storm")
