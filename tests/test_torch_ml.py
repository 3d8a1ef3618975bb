"""The port's anomaly plane against the JAX package's, module by module:
``ml/features.py`` (K18's plain version), ``ml/model.py`` (K19's plain
version, ``fit_novelty``, the checkpoint format) and the vectorized
identity-row lookup.  The same numpy inputs, made from a seed, go
through the JAX function (on the CPU) and its port (``device="cpu"``).

Tolerances:
- ``_bucket``, ``_seg_count``, ``id_row`` and every feature column but
  the ``log1p`` ones: bit-exact.  The ``log1p`` columns (3, 4, 6, 19,
  24) within 1 ulp (2.4e-7 absolute for values below 2): XLA's and
  torch's ``log1p`` differ by an ulp on some inputs.
- Logits within 1e-2 (one bf16 ulp near 1: the rounding points are the
  reference's, the float32 sums' order is not), and at least 99.9% of
  them bit-identical.  Scores within 2e-3, and at least 99.9% of them
  within 2 float32 ulps: XLA's and torch's ``exp`` differ by an ulp on
  ~0.4% of sigmoid inputs, and ``d2``'s cancelling float32 sums run in
  another order on XLA.  ``d2`` within 1e-4 relative.  (On the card,
  K19 against its plain version: scores 99.9% bit-identical,
  ``tests/test_torch_gpu.py``.)
- ``fit_novelty``: float64 on the host in both, then float32: equal
  within 1 float32 ulp.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cilium_tpu.datapath import datapath_step_jit
from cilium_tpu.ml import features as jfeat
from cilium_tpu.ml import model as jmod
from cilium_tpu.testing import fixtures as jfix
from cilium_tpu_torch import convert, u32
from cilium_tpu_torch.ml import features as tfeat
from cilium_tpu_torch.ml import model as tmod
from cilium_tpu_torch.ml.train import synth_labeled_traffic

torch.set_num_threads(1)

LOG1P_COLS = [3, 4, 6, 19, 24]
EXACT_COLS = [c for c in range(tfeat.FEAT_DIM) if c not in LOG1P_COLS]
N = 1024  # rows a batch: one JAX compile for the features and the model


def assert_features_match(jid, jfe, tid, tfe):
    np.testing.assert_array_equal(np.asarray(jid), tid.numpy())
    jfe, tfe = np.asarray(jfe), tfe.numpy()
    np.testing.assert_array_equal(jfe[:, EXACT_COLS], tfe[:, EXACT_COLS])
    np.testing.assert_allclose(tfe[:, LOG1P_COLS], jfe[:, LOG1P_COLS],
                               rtol=0, atol=2.4e-7)


def assert_scores_match(js, ts):
    js, ts = np.asarray(js), np.asarray(ts)
    diff = np.abs(js - ts)
    assert diff.max() <= 2e-3
    assert (diff <= 2 * np.spacing(js)).mean() >= 0.999, (
        (js == ts).mean(), (diff <= 2 * np.spacing(js)).mean())


@pytest.fixture(scope="module")
def world_batch():
    """A small world's datapath outputs on labelled traffic (every
    attack kind and hard negatives), from the JAX step."""
    jw = jfix.build_world(64, 8, ct_capacity=1 << 12)
    rng = np.random.default_rng(11)
    hdr, labels = synth_labeled_traffic(jw, N, rng)
    out, jw.state = datapath_step_jit(jw.state, jnp.asarray(hdr),
                                      jnp.uint32(100))
    return jw, hdr, np.array(out), labels


@pytest.fixture(scope="module")
def models(world_batch):
    """The JAX model from its own init (labels in the embedding) and its
    novelty fit on the batch's benign rows, with the port's carry-over."""
    jw, hdr, out, labels = world_batch
    labels_by_row = {jw.row_map.row(i.numeric_id):
                     tuple(str(l) for l in i.labels)
                     for i in jw.alloc.all_identities()}
    jp = jmod.init_params(jax.random.PRNGKey(3), jw.row_map.capacity,
                          labels_by_row=labels_by_row)
    # non-zero biases, so the bf16 "+ b" rounding points are exercised
    rng = np.random.default_rng(12)
    jp = jmod.AnomalyModel(**{
        k: (jnp.asarray(rng.normal(0, 0.3, getattr(jp, k).shape),
                        jnp.float32) if k in ("b1", "b2", "b3")
            else getattr(jp, k)) for k in tmod._FIELDS})
    _, feats = jfeat.flow_features(jnp.asarray(hdr), jnp.asarray(out))
    jp = jmod.fit_novelty(jp, np.asarray(feats)[labels < 0.5])
    tp = convert.anomaly_model_from_numpy(
        {k: np.asarray(getattr(jp, k)) for k in tmod._FIELDS}, "cpu")
    return jp, tp, np.array(feats)


# -- features ------------------------------------------------------------


def test_bucket_and_seg_count_bit_exact():
    rng = np.random.default_rng(1)
    words = rng.integers(0, 1 << 32, (4, 4096), dtype=np.uint64).astype(
        np.uint32)
    words[:, :64] = 0xFFFFFFFF  # the top of the range
    for k in range(1, 5):
        jb = np.asarray(jfeat._bucket(*(jnp.asarray(w) for w in words[:k])))
        tb = tfeat._bucket(*(u32.widen(u32.from_numpy(w, "cpu"))
                             for w in words[:k]))
        np.testing.assert_array_equal(jb, tb.numpy())
    # hot buckets: a few keys carry most rows
    key = np.where(rng.random(4096) < 0.7, 5, rng.integers(0, 4096, 4096))
    weight = (rng.random(4096) < 0.5).astype(np.float32)
    js = jfeat._seg_count(jnp.asarray(key, jnp.int32), jnp.asarray(weight))
    ts = tfeat._seg_count(torch.from_numpy(key), torch.from_numpy(weight))
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())


def test_flow_features_on_datapath_out_rows(world_batch):
    _, hdr, out, _ = world_batch
    jid, jfe = jfeat.flow_features(jnp.asarray(hdr), jnp.asarray(out))
    tid, tfe = tfeat.flow_features(u32.from_numpy(hdr, "cpu"),
                                   u32.from_numpy(out, "cpu"))
    assert tfe.shape == (N, tfeat.FEAT_DIM) and tfe.dtype == torch.float32
    assert_features_match(jid, jfe, tid, tfe)


def test_flow_features_on_a_padded_batch(world_batch):
    """score_capture's last batch repeats its last row: the pad rows
    count in the aggregates on both sides (the reference has no mask)."""
    _, hdr, out, _ = world_batch
    hdr_p = np.concatenate([hdr[:600], np.repeat(hdr[599:600], N - 600, 0)])
    out_p = np.concatenate([out[:600], np.repeat(out[599:600], N - 600, 0)])
    jid, jfe = jfeat.flow_features(jnp.asarray(hdr_p), jnp.asarray(out_p))
    tid, tfe = tfeat.flow_features(u32.from_numpy(hdr_p, "cpu"),
                                   u32.from_numpy(out_p, "cpu"))
    assert_features_match(jid, jfe, tid, tfe)
    # the pads are in the aggregates: the last row's service count
    # carries the N - 600 repeats
    assert float(tfe[-1, 19]) >= float(np.log1p(np.float32(N - 600)) / 12)


def test_flow_features_extreme_words():
    """u32 words at the top of the range (float32 rounding of the
    columns, the hash's wrap) and every flag bit."""
    rng = np.random.default_rng(2)
    hdr = rng.integers(0, 1 << 32, (N, 16), dtype=np.uint64).astype(np.uint32)
    hdr[::3, 10] = rng.choice([1, 6, 17, 58], len(hdr[::3]))
    hdr[::2, 9] = rng.integers(0, 2048, len(hdr[::2]))
    out = rng.integers(0, 4, (N, 6), dtype=np.uint64).astype(np.uint32)
    out[:, 3] = rng.integers(0, 1 << 32, N, dtype=np.uint64)
    jid, jfe = jfeat.flow_features(jnp.asarray(hdr), jnp.asarray(out))
    tid, tfe = tfeat.flow_features(u32.from_numpy(hdr, "cpu"),
                                   u32.from_numpy(out, "cpu"))
    assert_features_match(jid, jfe, tid, tfe)


# -- the model -----------------------------------------------------------


def test_label_embedding_init_bit_exact():
    rows = {0: ("k8s:app=web", "k8s:ns=prod"),
            1: ("k8s:app=web", "k8s:ns=dev"),
            3: ("k8s:app=db", "k8s:zone=z9", "reserved:world"),
            9: ("k8s:app=gone",)}  # past the table: skipped
    for dim in (8, 32):
        np.testing.assert_array_equal(
            tmod.label_embedding_init(rows, 5, dim),
            jmod.label_embedding_init(rows, 5, dim))


def test_fit_novelty_matches(models):
    jp, _, feats = models
    tp0 = convert.anomaly_model_from_numpy(
        {k: np.asarray(getattr(jp, k)) for k in tmod._FIELDS}, "cpu")
    jfit = jmod.fit_novelty(jp, feats)
    tfit = tmod.fit_novelty(tp0, feats)
    for k in ("feat_mean", "feat_prec", "nov_thresh"):
        a, b = np.asarray(getattr(jfit, k)), getattr(tfit, k).numpy()
        np.testing.assert_allclose(b, a, rtol=1.2e-7, atol=0)
    assert tp0.nov_thresh.item() == np.float32(jp.nov_thresh)  # untouched


def test_forward_novelty_and_scores_match(world_batch, models):
    _, hdr, out, _ = world_batch
    jp, tp, feats = models
    jid = np.asarray(out[:, 3], np.int32)
    jargs = (jnp.asarray(jid), jnp.asarray(feats))
    targs = (torch.from_numpy(jid), torch.from_numpy(feats))
    jl = np.asarray(jmod.forward(jp, *jargs))
    tl = tmod.forward(tp, *targs).numpy()
    assert np.abs(jl - tl).max() <= 1e-2 and (jl == tl).mean() >= 0.999
    jd = np.asarray(jmod.novelty_d2(jp, jargs[1]))
    td = tmod.novelty_d2(tp, targs[1]).numpy()
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-4)
    js = np.asarray(jmod.score_packets(jp, *jargs))
    ts = tmod.score_packets(tp, *targs)
    # both branches of the max are live on this batch
    p = torch.sigmoid(tmod.forward(tp, *targs))
    novel = (ts > p).numpy()
    assert novel.any() and not novel.all()
    assert_scores_match(js, ts)


def test_unfitted_novelty_contributes_exactly_zero(world_batch, models):
    _, _, out, _ = world_batch
    jp, tp, feats = models
    jp0 = jmod.AnomalyModel(*(getattr(jp, k) for k in tmod._FIELDS[:7]),
                            jnp.zeros(27), jnp.zeros((27, 27)),
                            jnp.asarray(tmod.NOV_DISABLED, jnp.float32))
    tp0 = tp.replace(feat_mean=torch.zeros(27),
                     feat_prec=torch.zeros(27, 27),
                     nov_thresh=torch.tensor(tmod.NOV_DISABLED))
    rows = torch.from_numpy(np.asarray(out[:, 3], np.int32))
    ts = tmod.score_packets(tp0, rows, torch.from_numpy(feats))
    # the score is the supervised probability alone, even where it is
    # below sigmoid(-4): no floor from the novelty branch
    p = torch.sigmoid(tmod.forward(tp0, rows, torch.from_numpy(feats)))
    assert torch.equal(ts, p)
    js = jmod.score_packets(jp0, jnp.asarray(rows.numpy()),
                            jnp.asarray(feats))
    assert_scores_match(js, ts)


def test_embedding_gather_clamps_past_the_table(models):
    """id_row >= V (the row map grew past the trained table) reads the
    last row, as XLA's gather does, and a negative id counts from the
    end once; nothing raises."""
    jp, tp, feats = models
    v = tp.embed.shape[0]
    rng = np.random.default_rng(4)
    ids = rng.integers(0, v, N).astype(np.int32)
    ids[:100] = v + rng.integers(0, 1 << 20, 100)
    ids[100:110] = -rng.integers(1, v, 10)
    ids[110:120] = np.iinfo(np.int32).max
    targs = (torch.from_numpy(ids), torch.from_numpy(feats))
    tl = tmod.forward(tp, *targs)
    jl = np.asarray(jmod.forward(jp, jnp.asarray(ids), jnp.asarray(feats)))
    assert np.abs(jl - tl.numpy()).max() <= 1e-2
    last = np.full(100, v - 1, np.int32)
    np.testing.assert_array_equal(
        tl[:100].numpy(),
        tmod.forward(tp, torch.from_numpy(last),
                     torch.from_numpy(feats[:100])).numpy())
    assert_scores_match(jmod.score_packets(jp, jnp.asarray(ids),
                                           jnp.asarray(feats)),
                        tmod.score_packets(tp, *targs))


# -- checkpoints ---------------------------------------------------------


def test_checkpoints_cross_both_ways(tmp_path, models):
    jp, tp, feats = models
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jmod.save_model(jpath, jp)
    tmod.save_model(tpath, tp)
    from_jax = tmod.load_model(jpath, "cpu")
    from_torch = jmod.load_model(tpath)
    for k in tmod._FIELDS:
        ref = np.asarray(getattr(jp, k))
        np.testing.assert_array_equal(getattr(from_jax, k).numpy(), ref)
        np.testing.assert_array_equal(np.asarray(getattr(from_torch, k)),
                                      ref)
        assert getattr(from_jax, k).dtype == torch.float32
    # the two files hold the same arrays under the same keys
    a, b = np.load(jpath), np.load(tpath)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].shape == b[k].shape


def test_checkpoint_guards_and_defaults(tmp_path, models):
    jp, tp, _ = models
    arrays = convert.anomaly_model_to_numpy(tp)
    bad = str(tmp_path / "bad.npz")
    np.savez_compressed(bad, feat_dim=np.int32(26), **arrays)
    with pytest.raises(ValueError, match="FEAT_DIM=26"):
        tmod.load_model(bad, "cpu")
    with pytest.raises(ValueError, match="FEAT_DIM=26"):
        jmod.load_model(bad)
    # a pre-novelty, pre-stamp checkpoint: fan-in gives the width, the
    # novelty stats default to unfitted
    old = str(tmp_path / "old.npz")
    np.savez_compressed(old, **{k: arrays[k] for k in tmod._FIELDS[:7]})
    m = tmod.load_model(old, "cpu")
    j = jmod.load_model(old)
    assert m.nov_thresh.item() == tmod.NOV_DISABLED
    for k in ("feat_mean", "feat_prec", "nov_thresh"):
        np.testing.assert_array_equal(getattr(m, k).numpy(),
                                      np.asarray(getattr(j, k)))
    wide = str(tmp_path / "wide.npz")
    np.savez_compressed(wide, **{k: (np.zeros((60, 64), np.float32)
                                     if k == "w1" else arrays[k])
                                 for k in tmod._FIELDS[:7]})
    with pytest.raises(ValueError, match="retrain"):
        tmod.load_model(wide, "cpu")


# -- the identity -> row lookup ------------------------------------------


def test_rows_of_equals_row_on_known_and_unknown_identities():
    from cilium_tpu_torch.policy.compiler import IdentityRowMap

    rm = IdentityRowMap(capacity=4)
    rng = np.random.default_rng(6)
    ids = rng.choice(np.arange(1, 1 << 20), 300, replace=False)
    for i in ids[:200]:
        rm.add(int(i))
    for i in ids[:20]:  # released rows, recycled below
        rm.remove(int(i))
    for i in ids[200:230]:
        rm.add(int(i))
    probe = np.concatenate([ids, [0, 1 << 24, 7]]).astype(np.uint32)
    got = rm.rows_of(probe)
    np.testing.assert_array_equal(got, [rm.row(int(i)) for i in probe])
    assert (got[20:200] > 0).all() and (got[:20] == 0).all()
    rm.add(int(ids[250]))  # a new version rebuilds the index
    assert rm.rows_of(np.array([ids[250]]))[0] == rm.row(int(ids[250])) > 0
    assert rm.rows_of(np.zeros(0, np.int64)).shape == (0,)


# -- devices -------------------------------------------------------------


def test_entry_points_default_to_the_card(tmp_path, models):
    _, tp, _ = models
    path = str(tmp_path / "m.npz")
    tmod.save_model(path, tp)
    from cilium_tpu_torch.ml import AnomalyScorer

    makes = [lambda: tmod.load_model(path),
             lambda: tmod.init_params(torch.Generator().manual_seed(0), 8),
             lambda: AnomalyScorer(tp, lambda n: np.zeros(len(n)))]
    for make in makes:
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    # a tensor on a device with no kernel and no plain path raises
    meta = torch.zeros((4, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfeat.flow_features(meta, meta[:, :6])
    with pytest.raises(ValueError, match="no kernel"):
        tmod.score_packets(tp, meta[:, 0], meta[:, :27].float())
