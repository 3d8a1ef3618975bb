"""The port's trainer against the JAX package's: ``ml/model.py``
``bce_loss`` and its gradient (K20/K21's plain versions), ``ml/train.py``
``Adam`` (K22's plain version), ``make_train_step`` and ``train``, and
``ml/evaluate.py``'s training pipelines, all on the CPU.  The same numpy
inputs, made from a seed, go through the JAX function and the port
(``device="cpu"``); parameters and optimizer states cross by
``convert``.

Tolerances, and why:
- The loss within 2e-6 relative: K20 and XLA sum the rows' terms in
  other orders.
- Weight gradients (w1, w2, w3) and the embedding's: bit-identical on
  at least 99% of the entries, the rest within one bf16 ulp of the
  reference's value (2^-7 relative): each is a float32 sum rounded to
  bf16 once, and a sum in another order can land on the other side of
  a rounding boundary.
- Bias gradients (b1, b2, b3) within 2^-5 of the leaf's largest |db|:
  XLA on the CPU sums a bf16 reduce in bf16 (windows of 32 rows, a bf16
  rounding each add); the port sums in float32 and rounds once.
- Adam: moments within 1e-6 relative, parameters within 1e-6 relative
  plus 1e-8 (XLA's and torch's pow and division differ in the last
  bit); the novelty fields bit for bit unchanged.
- One train step at lr 1e-3: parameters within 1e-2, the reference's
  own bound for ``test_mesh_dp_train_step``, and within lr / 1000 of
  the reference's (adam's first step moves a parameter by ~lr, so a
  wrong sign or leaf fails); the moments within the gradients' bounds
  against the leaf's largest entry (2^-7, biases 2^-5; twice that for
  ``nu``, a square).
- Five steps of ``train``: each loss within 1e-4 relative, parameters
  within 2 lr (one adam step taken the other way): the features'
  ``log1p`` columns sit an ulp apart between XLA and torch
  (``tests/test_torch_ml.py``), which moves a bf16 rounding of x now and
  then, and adam's first steps follow the gradients' signs.
- The reference's thresholds for convergence (last loss < 0.6 x the
  first), AUC (> 0.9 held out, > 0.85 on the golden capture, > 0.95 per
  trained kind), and scores of a port-trained checkpoint under the JAX
  package within 2e-3 of the port's (``tests/test_torch_anomaly.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cilium_tpu.datapath import datapath_step_jit
from cilium_tpu.ml import evaluate as jeval
from cilium_tpu.ml import features as jfeat
from cilium_tpu.ml import model as jmod
from cilium_tpu.ml.train import make_train_step as jstep
from cilium_tpu.ml.train import synth_labeled_traffic as jsynth
from cilium_tpu.ml.train import train as jtrain
from cilium_tpu.testing import fixtures as jfix
from cilium_tpu_torch import convert, u32
from cilium_tpu_torch.datapath.verdict import datapath_step
from cilium_tpu_torch.ml import evaluate as teval
from cilium_tpu_torch.ml import model as tmod
from cilium_tpu_torch.ml.train import (Adam, auc, make_train_step,
                                       synth_labeled_traffic, train)
from cilium_tpu_torch.ml.features import flow_features
from cilium_tpu_torch.parallel import make_mesh
from cilium_tpu_torch.testing import fixtures as tfix

torch.set_num_threads(1)

FIELDS = jmod._FIELDS
BIASES = ("b1", "b2", "b3")
PCAP = "tests/data/golden_cic.pcap"
CSV = "tests/data/golden_cic.csv"


def _jax_model(arrays):
    return jmod.AnomalyModel(**{k: jnp.asarray(arrays[k]) for k in FIELDS})


def _arrays(model):
    return {k: np.array(getattr(model, k)) for k in FIELDS}


def _params(v, seed=1):
    """A JAX init at V rows with non-zero biases and embedding rows (the
    default zero biases would hide a bias-gradient fault)."""
    rng = np.random.default_rng(seed)
    arrays = _arrays(jmod.init_params(jax.random.PRNGKey(seed), v))
    for b in BIASES:
        arrays[b] = (rng.normal(size=arrays[b].shape) * 0.1).astype(
            np.float32)
    arrays["embed"] = (rng.normal(size=(v, 32)) * 0.5).astype(np.float32)
    return arrays


def _batch(v, n, seed=2):
    """Features, labels and rows with a hot identity (half the batch),
    ids past V, negative ones (one wrap and more) and INT32_MAX."""
    rng = np.random.default_rng(seed)
    feats = rng.random((n, 27)).astype(np.float32)
    labels = (rng.random(n) < 0.3).astype(np.float32)
    ids = rng.integers(0, v, n).astype(np.int32)
    ids[: n // 2] = 5
    ids[:6] = [v + 3, -1, -v - 5, 2 ** 31 - 1, -(2 ** 31), v]
    rng.shuffle(ids)
    return ids, feats, labels


def _assert_grads(jg, tg):
    for k, t in zip(tmod.TRAINABLE, tg):
        j, t = np.asarray(getattr(jg, k)), t.numpy()
        assert t.shape == j.shape and t.dtype == np.float32, k
        diff = np.abs(j - t)
        if k in BIASES:
            assert diff.max() <= 2 ** -5 * np.abs(j).max(), (k, diff.max())
            continue
        assert (diff == 0).mean() >= 0.99, (k, (diff == 0).mean())
        assert (diff <= 2 ** -7 * np.abs(j)).all(), (k, diff.max())


@pytest.mark.parametrize("case", ["trained_head", "zero_logits"])
def test_gradients_match_jax_grad(case):
    """``value_and_grad`` (K20/K21's plain versions) against
    ``jax.value_and_grad(bce_loss)``, leaf by leaf: a hot identity, ids
    past V and negative (the gather clamps them; the scatter-add that is
    its transpose drops the ones out of range after one wrap), and, with
    w3 = b3 = 0, every logit exactly 0 (the maximum/abs tie rules)."""
    v, n = 64, 512
    arrays = _params(v)
    if case == "zero_logits":
        arrays["w3"][:] = 0
        arrays["b3"][:] = 0
    ids, feats, labels = _batch(v, n)
    jl, jg = jax.value_and_grad(jmod.bce_loss)(
        _jax_model(arrays), jnp.asarray(ids), jnp.asarray(feats),
        jnp.asarray(labels))
    model = convert.anomaly_model_from_numpy(arrays, "cpu")
    tl, tg = tmod.value_and_grad(model, torch.from_numpy(ids),
                                 torch.from_numpy(feats),
                                 torch.from_numpy(labels))
    assert tl.shape == () and tl.dtype == torch.float32
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-6)
    _assert_grads(jg, tg)
    if case == "zero_logits":
        assert float(np.abs(np.asarray(jg.w3)).max()) > 0
        assert float(np.abs(np.asarray(jg.embed)).max()) == 0
    else:
        # the hot row's gradient is the sum of half the batch's rows
        assert np.abs(tg[0][5].numpy()).max() > 0
    # the autograd node: bce_loss over a model whose leaves carry grads
    leaves = model.trainable()
    loss = tmod.bce_loss(model.replace(**leaves), torch.from_numpy(ids),
                         torch.from_numpy(feats), torch.from_numpy(labels))
    again = torch.autograd.grad(loss, list(leaves.values()))
    for a, b in zip(again, tg):
        assert torch.equal(a, b)


# d_embed against the plain version's index_add_ (chip_smoke.py's bound):
# a float32 sum of the same rows in another grouping, against the
# table's largest entry
EMBED_TOL = 1e-5


def _sorted_embed_reference(de_blocks, id_blocks, v):
    """K21's d_embed by explicit float32 loops: each block's kept rows
    in (key, row) order, cut at every 32nd position; a cut's rows added
    from 0, a key's cuts added in order, 0 plus that; then the blocks'
    values added in block order and divided by their count."""
    parts = []
    for de, ids in zip(de_blocks, id_blocks):
        kept = []
        for i, k in enumerate(int(x) for x in ids):
            k = k + v if k < 0 else k
            if 0 <= k < v:
                kept.append((k, i))
        kept.sort()
        cuts = {}  # key -> [(piece, sum)]
        for pos, (k, i) in enumerate(kept):
            c = cuts.setdefault(k, [])
            if not c or c[-1][0] != pos // 32:
                c.append((pos // 32, np.zeros(32, np.float32)))
            c[-1] = (c[-1][0], c[-1][1] + de[i])
        out = np.zeros((v, 32), np.float32)
        for k, c in cuts.items():
            total = np.zeros(32, np.float32)
            for _, part in c:
                total = total + part
            out[k] = np.float32(0) + total
        parts.append(out)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total / np.float32(len(parts))


# (rows, shards): the reference test's batch shape; four shards; shard
# blocks of 75 rows (not a multiple of a 32-row piece); a hot identity
# on half of each batch and dropped ids in all
SORTED_EMBED_CASES = {"unsharded": (512, None), "four-shards": (512, 4),
                      "ragged-blocks": (300, 4)}


@pytest.mark.parametrize("case", sorted(SORTED_EMBED_CASES))
def test_embed_grad_sorted_plain_sums_in_k21s_grouping(case):
    """``embed_grad_sorted_plain`` (K21's grouping of d_embed) equals an
    explicit float32 loop over the sorted rows bit for bit, and is within
    EMBED_TOL of ``train_backward_plain``'s ``index_add_`` at S = 1 and
    S = 4; the hot row spans several 32-row pieces."""
    n, n_shards = SORTED_EMBED_CASES[case]
    v = 64
    model = convert.anomaly_model_from_numpy(_params(v), "cpu")
    ids, feats, labels = (torch.from_numpy(a) for a in _batch(v, n))
    leaves = model.leaves()
    gloss = torch.ones(1)
    _, saved = tmod.train_forward_plain(leaves, ids, feats, labels,
                                        n_shards)
    got = tmod.embed_grad_sorted_plain(leaves, saved, ids, labels, gloss,
                                       n_shards)
    blk = n // (n_shards or 1)
    blocks = [slice(z * blk, (z + 1) * blk) for z in range(n_shards or 1)]
    de = [tmod._backward_rows_plain(leaves, tuple(t[b] for t in saved),
                                    labels[b], gloss)[3].numpy()
          for b in blocks]
    want = _sorted_embed_reference(de, [ids[b].numpy() for b in blocks], v)
    np.testing.assert_array_equal(got.numpy(), want)
    assert max(int((ids[b] == 5).sum()) for b in blocks) > 32  # hot
    plain = tmod.train_backward_plain(leaves, saved, ids, labels, gloss,
                                      n_shards)[0]
    assert float((got - plain).abs().max()) <= EMBED_TOL * float(
        plain.abs().max())
    assert float(got[5].abs().max()) > 0


def test_embed_grad_sorted_plain_matches_jax_grad():
    """At S = 1, K21's grouping of d_embed against the JAX package's
    ``jax.grad`` embedding gradient, under the single-step test's bounds
    for a weight gradient."""
    v, n = 64, 512
    arrays = _params(v)
    ids, feats, labels = _batch(v, n)
    jg = jax.grad(jmod.bce_loss)(_jax_model(arrays), jnp.asarray(ids),
                                 jnp.asarray(feats), jnp.asarray(labels))
    leaves = convert.anomaly_model_from_numpy(arrays, "cpu").leaves()
    tb = tuple(torch.from_numpy(a) for a in (ids, feats, labels))
    _, saved = tmod.train_forward_plain(leaves, *tb)
    got = tmod.embed_grad_sorted_plain(leaves, saved, tb[0], tb[2],
                                       torch.ones(1)).numpy()
    j = np.asarray(jg.embed)
    diff = np.abs(j - got)
    assert (diff == 0).mean() >= 0.99, (diff == 0).mean()
    assert (diff <= 2 ** -7 * np.abs(j)).all(), diff.max()


def test_no_kernel_for_another_device():
    """The CPU path is the plain version for CPU tensors only."""
    model = convert.anomaly_model_from_numpy(_params(8), "cpu")
    feats = torch.zeros((4, 27), device="meta")
    with pytest.raises(ValueError, match="anomaly_train_fwd"):
        tmod.value_and_grad(model, torch.zeros(4, dtype=torch.int32),
                            feats, torch.zeros(4))


def _adam_state_arrays(state):
    s = state[0]
    return {"count": np.asarray(s.count),
            "mu": {k: np.asarray(getattr(s.mu, k)) for k in FIELDS},
            "nu": {k: np.asarray(getattr(s.nu, k)) for k in FIELDS}}


def test_adam_matches_optax_from_a_mid_training_state():
    """Five ``Adam.apply_`` steps against ``optax.adam`` from a state
    three steps in (count > 1), the state carried by ``convert``; grads
    zero on half the embedding's rows (dense moments still decay)."""
    v = 64
    arrays = _params(v)
    params = _jax_model(arrays)
    opt = optax.adam(3e-3)
    state = opt.init(params)

    def grads(seed):
        r = np.random.default_rng(seed)
        g = {k: (r.normal(size=np.shape(arrays[k])) * 1e-2).astype(
            np.float32) for k in FIELDS}
        for k in ("feat_mean", "feat_prec", "nov_thresh"):
            g[k] = np.zeros(np.shape(arrays[k]), np.float32)
        g["embed"][r.random(v) < 0.5] = 0
        return g

    for i in range(3):
        u, state = opt.update(_jax_model(grads(i)), state, params)
        params = optax.apply_updates(params, u)
    model = convert.anomaly_model_from_numpy(_arrays(params), "cpu")
    tstate = convert.adam_state_from_numpy(_adam_state_arrays(state), "cpu")
    assert int(tstate.count) == 3
    adam = Adam(3e-3)
    novelty = {k: getattr(model, k).clone()
               for k in ("feat_mean", "feat_prec", "nov_thresh")}
    for i in range(3, 8):
        g = grads(i)
        u, state = opt.update(_jax_model(g), state, params)
        params = optax.apply_updates(params, u)
        adam.apply_(model, [torch.from_numpy(g[k]) for k in tmod.TRAINABLE],
                    tstate)
    back = convert.adam_state_to_numpy(tstate, model)
    want = _adam_state_arrays(state)
    assert int(back["count"]) == int(want["count"]) == 8
    for group in ("mu", "nu"):
        for k in FIELDS:
            np.testing.assert_allclose(back[group][k], want[group][k],
                                       rtol=1e-6, atol=0, err_msg=k)
    for k in tmod.TRAINABLE:
        np.testing.assert_allclose(getattr(model, k).numpy(),
                                   np.asarray(getattr(params, k)),
                                   rtol=1e-6, atol=1e-8, err_msg=k)
    for k, t in novelty.items():
        assert torch.equal(getattr(model, k), t), k


def test_adam_count_saturates_like_optax():
    """Three ``adam_update_plain`` steps against ``optax.adam`` from a
    count of 2^31 - 2: the count saturates at INT32_MAX (optax's
    safe_int32_increment) and the bias corrections 1 - b^count stay
    those of the saturated count; moments and params agree."""
    from cilium_tpu_torch.ml.train import adam_update_plain

    v = 64
    arrays = _params(v, seed=4)
    params = _jax_model(arrays)
    opt = optax.adam(3e-3)
    rng = np.random.default_rng(9)
    state = opt.init(params)
    state = (state[0]._replace(
        count=jnp.asarray(2 ** 31 - 2, dtype=jnp.int32),
        mu=_jax_model({k: (rng.normal(size=np.shape(arrays[k])) * 1e-3)
                       .astype(np.float32) for k in FIELDS}),
        nu=_jax_model({k: (rng.random(np.shape(arrays[k])) * 1e-6)
                       .astype(np.float32) for k in FIELDS})),
             *state[1:])
    tstate = convert.adam_state_from_numpy(_adam_state_arrays(state), "cpu")
    model = convert.anomaly_model_from_numpy(_arrays(params), "cpu")
    leaves = list(model.leaves())
    mu = [tstate.mu[k] for k in tmod.TRAINABLE]
    nu = [tstate.nu[k] for k in tmod.TRAINABLE]
    for i in range(3):
        g = {k: (rng.normal(size=np.shape(arrays[k])) * 1e-2).astype(
            np.float32) for k in FIELDS}
        u, state = opt.update(_jax_model(g), state, params)
        params = optax.apply_updates(params, u)
        adam_update_plain(leaves, [torch.from_numpy(g[k])
                                   for k in tmod.TRAINABLE],
                          mu, nu, tstate.count, 3e-3)
        assert int(tstate.count) == int(state[0].count) == 2 ** 31 - 1, i
    back = convert.adam_state_to_numpy(tstate, model)
    want = _adam_state_arrays(state)
    for group in ("mu", "nu"):
        for k in tmod.TRAINABLE:
            np.testing.assert_allclose(back[group][k], want[group][k],
                                       rtol=1e-6, atol=0, err_msg=k)
    for k in tmod.TRAINABLE:
        np.testing.assert_allclose(getattr(model, k).numpy(),
                                   np.asarray(getattr(params, k)),
                                   rtol=1e-6, atol=1e-8, err_msg=k)

def _world_batch(n_identities, n_rules, ct_capacity, n, seed, now):
    """One batch through the JAX datapath and features; -> (JAX world,
    id_row, feats, labels) as numpy."""
    jw = jfix.build_world(n_identities=n_identities, n_rules=n_rules,
                          ct_capacity=ct_capacity)
    hdr, labels = jsynth(
        jw, n, np.random.default_rng(seed))
    out, jw.state = datapath_step_jit(jw.state, jnp.asarray(hdr),
                                      jnp.uint32(now))
    ids, feats = jfeat.flow_features(jnp.asarray(hdr), out)
    return jw, np.array(ids), np.array(feats), labels


def test_one_train_step_matches_the_reference():
    """One ``make_train_step`` step against the reference's at
    ``test_mesh_dp_train_step``'s shapes (16 identities, 512 rows, lr
    1e-3), from the same params and inputs."""
    jw, ids, feats, labels = _world_batch(16, 2, 1 << 12, 512, 3, 10)
    params = jmod.init_params(jax.random.PRNGKey(1), jw.row_map.capacity)
    opt = optax.adam(1e-3)
    p1, s1, loss1 = jstep(opt)(
        params, opt.init(params), jnp.asarray(ids), jnp.asarray(feats),
        jnp.asarray(labels))
    model = convert.anomaly_model_from_numpy(_arrays(params), "cpu")
    before = {k: getattr(model, k).clone() for k in FIELDS}
    step = make_train_step(1e-3)
    adam = Adam(1e-3)
    model, state, loss = step(model, adam.init(model),
                              torch.from_numpy(ids), torch.from_numpy(feats),
                              torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(loss1), rtol=2e-6)
    assert int(state.count) == 1
    back = convert.adam_state_to_numpy(state, model)
    want_state = _adam_state_arrays(s1)
    for k in tmod.TRAINABLE:
        bound = 2 ** -5 if k in BIASES else 2 ** -7
        for group, scale in (("mu", bound), ("nu", 2 * bound)):
            got, want = back[group][k], want_state[group][k]
            assert np.abs(got - want).max() <= scale * np.abs(want).max(), \
                (group, k)
    for k in FIELDS:
        got, want = getattr(model, k).numpy(), np.asarray(getattr(p1, k))
        assert np.abs(got - want).max() < 1e-2, k
        assert np.abs(got - want).max() <= 1e-3 / 1000, k
        if k in tmod.TRAINABLE:
            assert not torch.equal(getattr(model, k), before[k]), k
        else:
            assert torch.equal(getattr(model, k), before[k]), k
    # the same step over a one-shard mesh is this step, bit for bit
    again = convert.anomaly_model_from_numpy(_arrays(params), "cpu")
    again, again_state, again_loss = make_train_step(
        1e-3, mesh=make_mesh(1, "cpu"))(
        again, adam.init(again), torch.from_numpy(ids),
        torch.from_numpy(feats), torch.from_numpy(labels))
    assert torch.equal(again_loss, loss)
    for k in FIELDS:
        assert torch.equal(getattr(again, k), getattr(model, k)), k


def test_five_train_steps_match_the_reference():
    """``train`` for five steps of 512 rows in both packages from the
    same params on the same world: per-step losses and final params."""
    kw = dict(n_identities=64, n_rules=8, ct_capacity=1 << 14)
    jw = jfix.build_world(**kw)
    tw = tfix.build_world(**kw, device="cpu")
    arrays = _arrays(jmod.init_params(jax.random.PRNGKey(4),
                                      jw.row_map.capacity))
    jp, jl = jtrain(_jax_model(arrays), jw, steps=5, batch=512,
                          seed=7)
    model = convert.anomaly_model_from_numpy(arrays, "cpu")
    tp, tl = train(model, tw, steps=5, batch=512, seed=7)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for k in FIELDS:
        np.testing.assert_allclose(getattr(tp, k).numpy(),
                                   np.asarray(getattr(jp, k)), rtol=0,
                                   atol=2 * 3e-3, err_msg=k)
    # train works on a copy: the caller's model is as it was
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(model, k).numpy(), arrays[k])
    # over a one-shard mesh, train takes the same steps bit for bit
    mp, ml = train(model, tfix.build_world(**kw, device="cpu"), steps=5,
                   batch=512, seed=7, mesh=make_mesh(1, "cpu"))
    assert ml == tl
    for k in FIELDS:
        assert torch.equal(getattr(mp, k), getattr(tp, k)), k


@pytest.fixture(scope="module")
def trained():
    """The reference's ``tests/test_ml.py`` fixture through the port."""
    world = tfix.build_world(n_identities=64, n_rules=8, ct_capacity=1 << 14,
                             device="cpu")
    labels_by_row = {world.row_map.row(i.numeric_id):
                     tuple(str(l) for l in i.labels)
                     for i in world.alloc.all_identities()}
    model = tmod.init_params(torch.Generator().manual_seed(0),
                             world.row_map.capacity,
                             labels_by_row=labels_by_row, device="cpu")
    model, losses = train(model, world, steps=60, batch=1024)
    return world, model, losses


def test_training_converges(trained):
    world, model, losses = trained
    assert len(losses) == 60 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.6, losses[::10]


def test_auc_on_heldout(trained):
    world, model, losses = trained
    hdr, labels = synth_labeled_traffic(
        world, 4096, np.random.default_rng(999))
    h = u32.from_numpy(hdr, "cpu")
    out, world.state = datapath_step(world.state, h, 50_000)
    scores = tmod.forward(model, *flow_features(h, out)).numpy()
    a = auc(scores, labels)
    assert a > 0.9, f"anomaly AUC too low: {a}"


def test_evaluate_real_dataset_on_golden_capture():
    r = teval.evaluate_real_dataset(PCAP, CSV, n_identities=64, epochs=2,
                                    batch=1024, train_frac=0.7,
                                    device="cpu")
    assert r["source"] == "real-pcap"
    assert r["packets"] == 6144
    assert r["train_packets"] == 4300
    assert r["eval_packets"] == 1844
    assert r["eval_attack_packets"] > 100
    assert np.isfinite(r["final_loss"])
    assert r["anomaly_auc"] > 0.85, r


def test_train_and_evaluate_end_to_end(tmp_path):
    """The reference's test at its size through the port on the CPU;
    then the port-trained checkpoint reloads in the JAX package and
    scores the held-out capture within tolerance of the port."""
    result = teval.train_and_evaluate(
        n_identities=128, train_steps=40, train_batch=1024,
        eval_packets=8192, model_out=str(tmp_path / "m.npz"),
        workdir=str(tmp_path), device="cpu")
    assert result["holdout_kind"] == "exfil"
    assert result["holdout_kind"] not in result["train_kinds"]
    assert result["auc_heldout_kind"] > 0.9
    for kind in result["train_kinds"]:
        assert result["auc_by_kind"][kind] > 0.95
    assert result["auc_same_mix_smoke"] > 0.95
    assert (tmp_path / "m.npz").exists()
    sidecar = result["eval_pcap"].replace(".pcap", ".npz")
    kw = dict(n_identities=128, n_rules=16, ct_capacity=1 << 14)
    tw = tfix.build_world(**kw, device="cpu")
    again = teval.evaluate_capture(
        tmod.load_model(str(tmp_path / "m.npz"), "cpu"), tw,
        result["eval_pcap"], sidecar)
    assert again["anomaly_auc"] > 0.9
    # the JAX package reloads the port's checkpoint and scores alike
    jw = jfix.build_world(**kw)
    jmodel = jmod.load_model(str(tmp_path / "m.npz"))
    hdr = teval.read_pcap(result["eval_pcap"]).data
    teval.load_labels(sidecar, hdr)
    js = jeval.score_capture(jmodel, jw, hdr.copy())
    ts = teval.score_capture(tmod.load_model(str(tmp_path / "m.npz"), "cpu"),
                             tfix.build_world(**kw, device="cpu"), hdr.copy())
    assert np.abs(js - ts).max() <= 2e-3
    jr = jeval.evaluate_capture(jmodel, jfix.build_world(**kw),
                                result["eval_pcap"], sidecar)
    assert jr["anomaly_auc"] > 0.9


def test_main_prints_one_json_line(monkeypatch, capsys):
    """``python -m cilium_tpu_torch.ml.evaluate``'s ``main``: on the
    capture the environment names, one JSON line with the metric (here
    its evaluation asked for the CPU), and the synthetic fallback's
    round-robin holdouts reported by their worst kind."""
    import json

    real = teval.evaluate_real_dataset
    monkeypatch.setenv("CILIUM_TPU_CIC_PCAP", PCAP)
    monkeypatch.setenv("CILIUM_TPU_CIC_LABELS", CSV)
    monkeypatch.setattr(teval, "evaluate_real_dataset",
                        lambda p, l: real(p, l, n_identities=64, epochs=2,
                                          batch=1024, device="cpu"))
    teval.main()
    out = json.loads(capsys.readouterr().out.strip())
    assert out["metric"] == "anomaly_auc" and out["source"] == "real-pcap"
    assert out["value"] > 0.85 and out["packets"] == 6144

    aucs = {0: 0.97, 1: 0.91, 2: 0.99}
    monkeypatch.delenv("CILIUM_TPU_CIC_PCAP")
    monkeypatch.setattr(teval, "train_and_evaluate", lambda holdout_kind,
                        **kw: {"auc_heldout_kind": aucs[holdout_kind],
                               "auc_by_kind": {}, "final_loss": 0.1,
                               "auc_same_mix_smoke": 1.0})
    teval.main()
    out = json.loads(capsys.readouterr().out.strip())
    assert out["value"] == 0.91 and out["holdout_kind"] == "flood"
    assert out["auc_heldout_mean"] == round(sum(aucs.values()) / 3, 4)
    assert out["source"].startswith("synthetic fallback")
