"""The port's data-parallel train step (``make_train_step(mesh=...)``,
``train(mesh=...)``: K20s/K21s's plain versions) against the JAX
package's ``shard_map`` step over the 8 virtual CPU devices that
``tests/conftest.py`` sets, on the CPU.  The same numpy inputs, made
from a seed, go through both; the reference's mesh is built once for the
module.

The port's step takes each block's loss and gradients as the unsharded
step gives them and their mean in shard order.  The reference's own
mesh gradient under this JAX is the SUM of the shards' (the gradient of
a replicated leaf inside ``shard_map`` comes back psum-ed, and its
``pmean`` leaves the sum): test (c) shows it, ROADMAP C4 records it.

Tolerances, and why:
- (a) One adam step at ``test_mesh_dp_train_step``'s shapes: the loss
  within 2e-6 relative (the sum order; it is equal today), parameters
  within the reference's own 1e-2, and within lr / 1000 wherever the
  reference's gradient exceeds 1e-4 in magnitude.  Adam's first step is
  ``-lr g / (|g| + eps)``: with the reference's g eight times the
  port's, the two steps differ by about lr * 7 eps / (8 |g_port|), under
  lr / 1000 once the reference's |g| passes 7e-5 (at 1e-5 they differ
  by up to 0.007 lr, so the bound takes 1e-4).
- (b) The port's mesh gradients times S (a float32 sum of the shards'
  bf16 gradients, exact since S is a power of two) against the
  reference's ``shard_map`` gradients, which sum the shards' bf16
  weight cotangents at the bf16 cast: bf16(S x port) for w1, w2, w3
  bit-identical on at least 99% of the entries, the rest within one
  bf16 ulp (2^-7 relative; the single-step test's bounds); the biases
  within 2^-5 of the leaf's largest |db| (XLA on the CPU sums a bf16
  reduce in bf16); d_embed within 2^-7 of its largest entry: XLA's
  CPU dot for ``dx`` at a 64-row block rounds to bf16 in another order
  than at 512 rows (where the single-step test finds 99% identical), so
  per-row bf16 roundings flip, and a table row sums up to 99 rows.
- (c) The reference's mesh step under ``optax.sgd(1.0)`` moves w1, b3
  and the embedding by 8x its unsharded step (median ratio within
  8 +- 0.05); the port's mesh gradient is its unsharded gradient within
  the per-shard bf16 rounding: |mesh - unsharded| <= 2^-8 (mean_s
  |g_s| + |g_unsharded|) plus 1e-6 of the leaf's largest entry for the
  float32 sum order (d_embed, which no shard rounds, within that 1e-6).
- (d) Bit for bit: the mesh gradients equal the shard-order mean of S
  unsharded ``value_and_grad`` calls on the blocks, and S = 1 is the
  unsharded step.
- (e) Five steps of ``train(mesh=...)`` against the reference's: the
  five-step test's bounds, losses within 1e-4 relative, parameters
  within 2 lr (the features' ``log1p`` columns sit an ulp apart between
  XLA and torch, and adam's first steps follow the gradients' signs).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from cilium_tpu.datapath import datapath_step_jit
from cilium_tpu.ml import features as jfeat
from cilium_tpu.ml import model as jmod
from cilium_tpu.ml.train import make_train_step as jstep
from cilium_tpu.ml.train import synth_labeled_traffic as jsynth
from cilium_tpu.ml.train import train as jtrain
from cilium_tpu.parallel import make_mesh as jmesh
from cilium_tpu.testing import fixtures as jfix
from cilium_tpu_torch import convert
from cilium_tpu_torch.ml import model as tmod
from cilium_tpu_torch.ml.train import Adam, make_train_step, train
from cilium_tpu_torch.parallel import ShardMesh, make_mesh
from cilium_tpu_torch.testing import fixtures as tfix

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

torch.set_num_threads(1)

FIELDS = jmod._FIELDS
BIASES = ("b1", "b2", "b3")
S = 8


@pytest.fixture(scope="module")
def ref():
    """The reference's 8-shard mesh, one batch of 512 rows at
    ``test_mesh_dp_train_step``'s shapes (16 identities, seed 3) through
    its datapath and features, its init params (PRNGKey(1)), and the
    ``shard_map`` of ``value_and_grad(bce_loss)`` with the pmean that
    its mesh step runs (``cilium_tpu/ml/train.py:124-143``)."""
    mesh = jmesh(S)
    jw = jfix.build_world(n_identities=16, n_rules=2, ct_capacity=1 << 12)
    hdr, labels = jsynth(jw, 512, np.random.default_rng(3))
    out, jw.state = datapath_step_jit(jw.state, jnp.asarray(hdr),
                                      jnp.uint32(10))
    ids, feats = jfeat.flow_features(jnp.asarray(hdr), out)
    params = jmod.init_params(jax.random.PRNGKey(1), jw.row_map.capacity)

    def _grads(p, i, f, l):
        loss, g = jax.value_and_grad(jmod.bce_loss)(p, i, f, l)
        g = jax.tree.map(partial(jax.lax.pmean, axis_name="data"), g)
        return jax.lax.pmean(loss, "data"), g

    grads = jax.jit(shard_map(
        _grads, mesh=mesh,
        in_specs=(P(), P("data"), P("data", None), P("data")),
        out_specs=(P(), P())))
    batch = (np.array(ids), np.array(feats), labels)
    return mesh, params, batch, grads(params, *map(jnp.asarray, batch))


def _arrays(model):
    return {k: np.array(getattr(model, k)) for k in FIELDS}


def _jax_model(arrays):
    return jmod.AnomalyModel(**{k: jnp.asarray(arrays[k]) for k in FIELDS})


def _port(params):
    return convert.anomaly_model_from_numpy(_arrays(params), "cpu")


def _torch(batch):
    return tuple(torch.from_numpy(a) for a in batch)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def test_one_mesh_step_matches_the_reference(ref):
    """(a) ``make_train_step(Adam(1e-3), mesh=make_mesh(8, "cpu"))``
    against the reference's ``make_train_step(optax.adam(1e-3),
    make_mesh(8))``, one step from the same params and inputs."""
    mesh, params, batch, (_, jg) = ref
    opt = optax.adam(1e-3)
    p8, _, jloss = jstep(opt, mesh)(params, opt.init(params),
                                    *map(jnp.asarray, batch))
    model = _port(params)
    adam = Adam(1e-3)
    model, state, loss = make_train_step(adam, make_mesh(S, "cpu"))(
        model, adam.init(model), *_torch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-6)
    assert int(state.count) == 1
    for k in FIELDS:
        got, want = getattr(model, k).numpy(), np.asarray(getattr(p8, k))
        diff = np.abs(got - want)
        assert diff.max() < 1e-2, k
        if k in tmod.TRAINABLE:
            big = np.abs(np.asarray(getattr(jg, k))) > 1e-4
            assert big.any(), k
            assert diff[big].max() <= 1e-3 / 1000, (k, diff[big].max())


def test_mesh_gradients_times_s_match_the_reference_shard_map(ref):
    """(b) S x the port's mesh gradients against the reference's
    ``shard_map`` gradients (the sum of the shards')."""
    _, params, batch, (jl, jg) = ref
    loss, grads = tmod.value_and_grad(_port(params), *_torch(batch),
                                      n_shards=S)
    np.testing.assert_allclose(float(loss), float(jl), rtol=2e-6)
    for k, g in zip(tmod.TRAINABLE, grads):
        j = np.asarray(getattr(jg, k))
        total = g * S
        if k == "embed":
            diff = np.abs(total.numpy() - j)
            assert diff.max() <= 2 ** -7 * np.abs(j).max(), diff.max()
            continue
        diff = np.abs(_bf16(total).numpy() - j)
        if k in BIASES:
            assert diff.max() <= 2 ** -5 * np.abs(j).max(), (k, diff.max())
            continue
        assert (diff == 0).mean() >= 0.99, (k, (diff == 0).mean())
        assert (diff <= 2 ** -7 * np.abs(j)).all(), (k, diff.max())


def test_reference_mesh_step_moves_s_times_the_port_does_not(ref):
    """(c) The C4 divergence: under ``optax.sgd(1.0)`` the reference's
    mesh step moves the parameters 8x its unsharded step; the port's mesh
    gradient is its unsharded gradient up to the per-shard bf16
    rounding."""
    mesh, params, batch, _ = ref
    sgd = optax.sgd(1.0)
    jb = tuple(map(jnp.asarray, batch))
    single = jstep(sgd)(params, sgd.init(params), *jb)[0]
    meshed = jstep(sgd, mesh)(params, sgd.init(params), *jb)[0]
    for k in ("w1", "b3", "embed"):
        p0 = np.asarray(getattr(params, k))
        d1 = p0 - np.asarray(getattr(single, k))
        d8 = p0 - np.asarray(getattr(meshed, k))
        moved = np.abs(d1) > 1e-6
        assert moved.any(), k
        ratio = float(np.median(d8[moved] / d1[moved]))
        assert abs(ratio - S) <= 0.05, (k, ratio)

    model = _port(params)
    tb = _torch(batch)
    _, g1 = tmod.value_and_grad(model, *tb)
    _, g8 = tmod.value_and_grad(model, *tb, n_shards=S)
    blk = len(batch[0]) // S
    parts = [tmod.value_and_grad(model, *(t[z * blk:(z + 1) * blk]
                                          for t in tb))[1]
             for z in range(S)]
    for i, (k, a, u) in enumerate(zip(tmod.TRAINABLE, g8, g1)):
        diff = (a - u).abs()
        slack = 1e-6 * u.abs().max()
        if k == "embed":
            assert diff.max() <= slack, diff.max()
            continue
        mean_abs = sum(p[i].abs() for p in parts) / S
        assert (diff <= 2 ** -8 * (mean_abs + u.abs()) + slack).all(), k
        moved = u.abs() > 1e-6
        ratio = float((a[moved] / u[moved]).median())
        assert abs(ratio - 1) <= 0.01, (k, ratio)


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_mesh_gradients_are_the_shard_order_mean(ref, n_shards):
    """(d) The mesh loss and gradients equal the shard-order mean of S
    unsharded ``value_and_grad`` calls on the blocks, bit for bit; S = 1
    is the unsharded step, bit for bit, for the gradients and for a
    whole ``make_train_step`` step."""
    _, params, batch, _ = ref
    model = _port(params)
    tb = _torch(batch)
    loss, grads = tmod.value_and_grad(model, *tb, n_shards=n_shards)
    blk = len(batch[0]) // n_shards
    parts = [tmod.value_and_grad(model, *(t[z * blk:(z + 1) * blk]
                                          for t in tb))
             for z in range(n_shards)]
    s = torch.tensor(float(n_shards))

    def mean(ts):
        total = ts[0]
        for t in ts[1:]:
            total = total + t
        return total / s

    assert torch.equal(loss, mean([l for l, _ in parts]))
    for i, g in enumerate(grads):
        assert torch.equal(g, mean([p[1][i] for p in parts])), i
    if n_shards == 1:
        adam = Adam(1e-3)
        runs = []
        for mesh in (None, make_mesh(1, "cpu")):
            m = _port(params)
            m, st, l = make_train_step(adam, mesh)(m, adam.init(m), *tb)
            runs.append((l, m.leaves(), st))
        (l0, p0, s0), (l1, p1, s1) = runs
        assert torch.equal(l0, l1)
        for a, b in zip(p0, p1):
            assert torch.equal(a, b)
        for k in tmod.TRAINABLE:
            assert torch.equal(s0.mu[k], s1.mu[k])
            assert torch.equal(s0.nu[k], s1.nu[k])


@pytest.mark.parametrize("n_shards", [4, 8])
def test_sorted_embed_grad_is_the_shard_order_mean(ref, n_shards):
    """K21s's grouping of d_embed (``embed_grad_sorted_plain``) over S
    blocks: bit for bit the shard-order mean of its unsharded value on
    each block, and within 1e-5 of the largest entry of the mean of S
    unsharded plain gradients (``index_add_``).  The reference's own
    mesh gradient is S times that mean (C4): at the fixture's 8 shards,
    S x it stays within (b)'s 2^-7 of the reference's largest entry."""
    _, params, batch, (_, jg) = ref
    leaves = _port(params).leaves()
    ids, feats, labels = _torch(batch)
    gloss = torch.ones(1)
    _, saved = tmod.train_forward_plain(leaves, ids, feats, labels,
                                        n_shards)
    got = tmod.embed_grad_sorted_plain(leaves, saved, ids, labels, gloss,
                                       n_shards)
    blk = len(batch[0]) // n_shards
    blocks = [slice(z * blk, (z + 1) * blk) for z in range(n_shards)]
    s = torch.tensor(float(n_shards))
    singles, plains = [], []
    for b in blocks:
        sv = tuple(t[b] for t in saved)
        singles.append(tmod.embed_grad_sorted_plain(leaves, sv, ids[b],
                                                    labels[b], gloss))
        plains.append(tmod.train_backward_plain(leaves, sv, ids[b],
                                                labels[b], gloss)[0])
    mean = singles[0]
    plain = plains[0]
    for a, b in zip(singles[1:], plains[1:]):
        mean, plain = mean + a, plain + b
    assert torch.equal(got, mean / s)
    plain = plain / s
    assert float((got - plain).abs().max()) <= 1e-5 * float(
        plain.abs().max())
    if n_shards == S:
        j = np.asarray(jg.embed)
        diff = np.abs((got * S).numpy() - j)
        assert diff.max() <= 2 ** -7 * np.abs(j).max(), diff.max()


def test_five_mesh_train_steps_match_the_reference():
    """(e) ``train(mesh=make_mesh(8, "cpu"))`` for five steps of 512 rows
    against the reference's ``train(mesh=make_mesh(8))`` from the same
    params on the same world: per-step losses and final params."""
    kw = dict(n_identities=64, n_rules=8, ct_capacity=1 << 14)
    jw = jfix.build_world(**kw)
    tw = tfix.build_world(**kw, device="cpu")
    arrays = _arrays(jmod.init_params(jax.random.PRNGKey(4),
                                      jw.row_map.capacity))
    jp, jl = jtrain(_jax_model(arrays), jw, steps=5, batch=512, seed=7,
                    mesh=jmesh(S))
    model = convert.anomaly_model_from_numpy(arrays, "cpu")
    tp, tl = train(model, tw, steps=5, batch=512, seed=7,
                   mesh=make_mesh(S, "cpu"))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for k in FIELDS:
        np.testing.assert_allclose(getattr(tp, k).numpy(),
                                   np.asarray(getattr(jp, k)), rtol=0,
                                   atol=2 * 3e-3, err_msg=k)


def test_mesh_step_refuses_a_ragged_batch_or_another_device(ref):
    """(f) A batch that does not split into the mesh's blocks, and a mesh
    on another device than the model, raise ``ValueError``."""
    _, params, batch, _ = ref
    model = _port(params)
    adam = Adam(1e-3)
    ids, feats, labels = (t[:500] for t in _torch(batch))
    with pytest.raises(ValueError, match="500 rows do not split into 8"):
        make_train_step(adam, make_mesh(S, "cpu"))(
            model, adam.init(model), ids, feats, labels)
    with pytest.raises(ValueError, match="500 rows do not split into 8"):
        tmod.value_and_grad(model, ids, feats, labels, n_shards=S)
    elsewhere = ShardMesh(S, torch.device("meta"))
    with pytest.raises(ValueError, match="the mesh on meta"):
        make_train_step(adam, elsewhere)(model, adam.init(model),
                                         *_torch(batch))
    world = tfix.build_world(n_identities=16, n_rules=2,
                             ct_capacity=1 << 12, device="cpu")
    with pytest.raises(ValueError, match="the mesh on meta"):
        train(model, world, steps=1, batch=512, mesh=elsewhere)
