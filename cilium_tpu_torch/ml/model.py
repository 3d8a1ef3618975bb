"""The anomaly model: identity embedding + MLP head + benign novelty.

A port of the JAX package's ``ml/model.py``.  The embedding table's
rows start from each identity's label set (feature-hashed multi-hot
projected to the embedding dim), so label-similar workloads start near
each other before any gradient step.

:func:`score_packets` (and :func:`forward`, :func:`novelty_d2`) send
CUDA tensors to K19 ``anomaly_score`` (``csrc/ml.cu``) and CPU tensors
to the plain versions beside it.  Both round where the reference does:
the inputs and weights to bfloat16, each product (accumulated in
float32) to bfloat16, ``+ b`` in bfloat16, ReLU; the logit to float32,
then the sigmoids and the Mahalanobis distance in float32.

Training (:func:`bce_loss`, :func:`value_and_grad`) goes through one
``torch.autograd.Function``: its forward is K20 ``anomaly_train_fwd``
and its backward K21 ``anomaly_train_bwd`` (``csrc/mltrain.cu``) for
CUDA tensors, the plain versions beside them for CPU tensors.  The
backward's dtypes are those ``jax.grad`` gives the reference: the
cotangents are bfloat16 wherever the forward cast to bfloat16, each
weight gradient a float32 sum over the batch rounded to bfloat16 once,
and the embedding's gradient the float32 sum of each row's bfloat16
``dx[:, :32]``.  With ``n_shards`` (the data-parallel step over a mesh)
the batch is S blocks: the node runs K20s/K21s, or the plain versions
block by block, and the loss and each gradient are the mean of the
blocks' own, in shard order.

Checkpoints are the reference's ``.npz`` format, field for field, so a
model saved by either package loads in the other.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..u32 import as_index
from .features import FEAT_DIM

_FIELDS = ("embed", "w1", "b1", "w2", "b2", "w3", "b3",
           "feat_mean", "feat_prec", "nov_thresh")
# the leaves training updates; the novelty fields get zero gradients
TRAINABLE = _FIELDS[:7]

# sentinel threshold meaning "novelty stats not fitted": the novelty
# branch then contributes exactly 0 and scoring is purely supervised
NOV_DISABLED = 1e9


class AnomalyModel(nn.Module):
    """Supervised head + benign-novelty detector, as buffers.

    embed [V, D]; w1 [D + FEAT_DIM, H], b1 [H]; w2 [H, H], b2 [H];
    w3 [H, 1], b3 [1]; feat_mean [FEAT_DIM]; feat_prec [FEAT_DIM,
    FEAT_DIM]; nov_thresh [] (all float32)."""

    def __init__(self, **fields: torch.Tensor):
        super().__init__()
        for name in _FIELDS:
            self.register_buffer(name, fields[name])

    def replace(self, **fields: torch.Tensor) -> "AnomalyModel":
        """A new model with ``fields`` swapped in; the others shared."""
        kw = {name: getattr(self, name) for name in _FIELDS}
        kw.update(fields)
        return AnomalyModel(**kw)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        """The seven trainable leaves, in ``TRAINABLE`` order."""
        return tuple(getattr(self, name) for name in TRAINABLE)

    def trainable(self) -> Dict[str, torch.Tensor]:
        """The trainable leaves by name as tensors that carry gradients
        (each shares its storage with the model's buffer):
        ``bce_loss(model.replace(**leaves), ...)`` is differentiable in
        them."""
        return {name: t.detach().requires_grad_()
                for name, t in zip(TRAINABLE, self.leaves())}


def label_embedding_init(labels_by_row: Dict[int, Tuple[str, ...]],
                         n_rows: int, dim: int,
                         seed: int = 7) -> np.ndarray:
    """Identity labels -> embedding rows by feature hashing.

    Each label string hashes to ``dim`` signed buckets; a row is the
    normalized sum over its labels, so identities sharing labels get
    correlated rows (the SelectorCache compilation)."""
    table = np.zeros((n_rows, dim), dtype=np.float32)
    for row, labels in labels_by_row.items():
        if row >= n_rows:
            continue
        v = np.zeros(dim, dtype=np.float32)
        for lab in labels:
            h = hashlib.blake2b(f"{seed}:{lab}".encode(),
                                digest_size=8).digest()
            idx = int.from_bytes(h[:4], "little") % dim
            sign = 1.0 if h[4] & 1 else -1.0
            v[idx] += sign
        norm = np.linalg.norm(v)
        if norm > 0:
            table[row] = v / norm
    return table


def init_params(generator: torch.Generator, n_rows: int, dim: int = 32,
                hidden: int = 64,
                labels_by_row: Optional[Dict[int, Tuple[str, ...]]] = None,
                device=None) -> AnomalyModel:
    """He-scaled random weights from ``generator`` (a CPU generator), the
    embedding from the labels when given; the novelty stats unfitted.
    The reference draws from ``jax.random``, so the two packages' inits
    differ for one seed; carry weights over with
    ``convert.anomaly_model_from_numpy``."""

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32)

    if labels_by_row is not None:
        embed = torch.from_numpy(label_embedding_init(labels_by_row,
                                                      n_rows, dim))
    else:
        embed = normal(n_rows, dim) * 0.05
    fan_in = dim + FEAT_DIM
    m = AnomalyModel(
        embed=embed,
        w1=normal(fan_in, hidden) * (2.0 / fan_in) ** 0.5,
        b1=torch.zeros(hidden),
        w2=normal(hidden, hidden) * (2.0 / hidden) ** 0.5,
        b2=torch.zeros(hidden),
        w3=normal(hidden, 1) * (2.0 / hidden) ** 0.5,
        b3=torch.zeros(1),
        feat_mean=torch.zeros(FEAT_DIM),
        feat_prec=torch.zeros((FEAT_DIM, FEAT_DIM)),
        nov_thresh=torch.tensor(NOV_DISABLED, dtype=torch.float32))
    return m.to(resolve_device(device))


def _ordered_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in float32 for bf16-valued ``x`` [N, K] and ``w`` [K, M],
    the sum over k in order, one float32 add a term: a product of two
    bf16 values is exact in float32, so this equals the kernels' FMA
    chains bit for bit (a library product sums in another order and
    moves a bf16 rounding now and then)."""
    x, w = x.float(), w.float()
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    for k in range(w.shape[0]):
        acc = acc + x[:, k:k + 1] * w[k]
    return acc


def _bf16_layer(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """bf16(x @ bf16(w)) for bf16 ``x``, accumulated in float32 in
    order (``_ordered_dot``), then ``+ bf16(b)`` in bfloat16."""
    bf = torch.bfloat16
    return _ordered_dot(x, w.to(bf)).to(bf) + b.to(bf)


def forward_plain(model: AnomalyModel, id_row: torch.Tensor,
                  feats: torch.Tensor) -> torch.Tensor:
    """-> anomaly logits [N] float32 (plain version).  An ``id_row``
    past the table clamps to its last row, as the reference's gather
    does."""
    e = model.embed[as_index(id_row, model.embed.shape[0])]
    x = torch.cat([e, feats], dim=1).to(torch.bfloat16)
    h = torch.relu(_bf16_layer(x, model.w1, model.b1))
    h = torch.relu(_bf16_layer(h, model.w2, model.b2))
    return _bf16_layer(h, model.w3, model.b3)[:, 0].float()


def novelty_d2_plain(model: AnomalyModel,
                     feats: torch.Tensor) -> torch.Tensor:
    """Mahalanobis distance^2 of each row from the benign manifold, d . P
    . d with d = feats - feat_mean.  The sums run in a fixed order, a
    float32 product and a float32 add a term (K19 computes the same
    terms in the same order, so the two agree bit for bit: d2's terms
    cancel, and another order moves its last bits)."""
    d = feats - model.feat_mean
    prec = model.feat_prec
    t = torch.zeros_like(d)
    for f in range(d.shape[1]):  # t = d @ P
        t = t + d[:, f:f + 1] * prec[f]
    d2 = torch.zeros_like(d[:, 0])
    for g in range(d.shape[1]):
        d2 = d2 + t[:, g] * d[:, g]
    return d2


def score_packets_plain(model: AnomalyModel, id_row: torch.Tensor,
                        feats: torch.Tensor) -> torch.Tensor:
    """Per-packet anomaly score in [0, 1]: the max of the supervised
    probability and the benign-novelty score (plain version)."""
    p = torch.sigmoid(forward_plain(model, id_row, feats))
    d2 = novelty_d2_plain(model, feats)
    t = model.nov_thresh
    nov = torch.sigmoid((d2 - t) / (t * 0.25 + 1e-6))
    # unfitted stats: the novelty branch contributes EXACTLY zero, or
    # max() floors every low supervised score at sigmoid(-4)
    nov = torch.where(t >= NOV_DISABLED, torch.zeros_like(nov), nov)
    return torch.maximum(p, nov)


def _on_card(model: Optional[AnomalyModel], feats: torch.Tensor,
             what: str = "anomaly_score") -> bool:
    if feats.is_cuda:
        return True
    from ..datapath.conntrack import _require_cpu

    _require_cpu(feats, what)
    return False


def forward(model: AnomalyModel, id_row: torch.Tensor,
            feats: torch.Tensor) -> torch.Tensor:
    """-> anomaly logits [N]: see :func:`forward_plain`.  CUDA tensors
    launch K19 ``anomaly_score`` (``csrc/ml.cu``) for its logits."""
    if _on_card(model, feats):
        from ..kernels import launch_anomaly_score

        return launch_anomaly_score(model, id_row, feats,
                                    outputs=("logit",))["logit"]
    return forward_plain(model, id_row, feats)


def novelty_d2(model: AnomalyModel, feats: torch.Tensor) -> torch.Tensor:
    """See :func:`novelty_d2_plain`.  CUDA tensors launch K19 for its
    distances."""
    if _on_card(model, feats):
        from ..kernels import launch_anomaly_score

        rows = torch.zeros(feats.shape[0], dtype=torch.int32,
                           device=feats.device)
        return launch_anomaly_score(model, rows, feats,
                                    outputs=("d2",))["d2"]
    return novelty_d2_plain(model, feats)


def score_packets(model: AnomalyModel, id_row: torch.Tensor,
                  feats: torch.Tensor) -> torch.Tensor:
    """See :func:`score_packets_plain`.  CUDA tensors launch K19
    ``anomaly_score`` (``csrc/ml.cu``)."""
    if _on_card(model, feats):
        from ..kernels import launch_anomaly_score

        return launch_anomaly_score(model, id_row, feats)["score"]
    return score_packets_plain(model, id_row, feats)


# ---- training: K20 forward, K21 backward ---------------------------------

WGRAD_CHUNK = 64  # batch rows a block of K21's weight-gradient pass sums
EMBED_PIECE = 32  # sorted rows a piece of K21's embedding scatter


def _shard_blocks(n: int, n_shards: int, what: str):
    from ..kernels import shard_block

    block = shard_block(n, n_shards, what)
    return [slice(z * block, (z + 1) * block) for z in range(n_shards)]


def _shard_mean(parts):
    """The pmean on one device: the first shard's value, the others
    added in shard order, divided by S (a tensor, as K20s/K21s divide)."""
    total = parts[0]
    for t in parts[1:]:
        total = total + t
    return total / torch.tensor(float(len(parts)), device=total.device)


def train_forward_plain(leaves, id_row: torch.Tensor, feats: torch.Tensor,
                        labels: torch.Tensor, n_shards: Optional[int] = None):
    """The reference's ``bce_loss`` forward (plain version of K20): ->
    (loss [] float32, saved) where ``saved`` = (x [N, 59], h1 [N, 64],
    h2 [N, 64] bfloat16, logit [N] float32) for the backward.  The
    layers are :func:`forward_plain`'s; the loss is the mean of
    ``max(l, 0) - l * y + log1p(exp(-|l|))``.  ``n_shards`` (plain
    version of K20s): this function on each of S blocks of N / S rows,
    the losses' :func:`_shard_mean`, the activations concatenated."""
    if n_shards is not None:
        parts = [train_forward_plain(leaves, id_row[b], feats[b], labels[b])
                 for b in _shard_blocks(feats.shape[0], n_shards,
                                        "anomaly_train_fwd")]
        return (_shard_mean([loss for loss, _ in parts]),
                tuple(torch.cat(t) for t in zip(*(sv for _, sv in parts))))
    embed, w1, b1, w2, b2, w3, b3 = leaves
    e = embed[as_index(id_row, embed.shape[0])]
    x = torch.cat([e, feats], dim=1).to(torch.bfloat16)
    h1 = torch.relu(_bf16_layer(x, w1, b1))
    h2 = torch.relu(_bf16_layer(h1, w2, b2))
    logit = _bf16_layer(h2, w3, b3)[:, 0].float()
    term = (torch.clamp_min(logit, 0) - logit * labels) + torch.log1p(
        torch.exp(-logit.abs()))
    n = torch.tensor(float(logit.shape[0]), device=logit.device)
    return term.sum() / n, (x, h1, h2, logit)


def _dlogit_plain(logit: torch.Tensor, labels: torch.Tensor,
                 gloss: torch.Tensor) -> torch.Tensor:
    """The loss's cotangent at each logit, as ``jax.grad`` derives it
    from ``bce_loss``: with g = gloss / N and t = exp(-|l|),
    ``(-+ g / (1 + t) * t  - g * y) + g * [l > 0, 1/2 at l == 0]`` (the
    ``abs`` rule takes the + branch at 0, ``maximum`` splits its tie)."""
    n = torch.tensor(float(logit.shape[0]), device=logit.device)
    g = gloss.reshape(()).float() / n
    t = torch.exp(-logit.abs())
    ct = (g / (t + 1.0)) * t
    cz = torch.where(logit >= 0, -ct, ct)
    one, half, zero = (torch.tensor(v, device=logit.device)
                       for v in (1.0, 0.5, 0.0))
    cf = torch.where(logit > 0, one, torch.where(logit == 0, half, zero))
    return (cz + (-g) * labels) + g * cf


def _wgrad_plain(a: torch.Tensor, d: torch.Tensor):
    """(a^T d, column sums of d) for bf16 ``a`` [N, K], ``d`` [N, M], each
    a float32 sum rounded to bf16 once, then float32: K21's order (rows
    in chunks of WGRAD_CHUNK, each chunk's sum in row order, the
    chunks' sums in chunk order)."""
    n, k = a.shape
    c = -(-n // WGRAD_CHUNK)
    pad = c * WGRAD_CHUNK - n
    ones = torch.ones((n, 1), dtype=torch.float32, device=a.device)
    aa = torch.nn.functional.pad(torch.cat([a.float(), ones], 1),
                                 (0, 0, 0, pad))
    dd = torch.nn.functional.pad(d.float(), (0, 0, 0, pad))
    aa = aa.view(c, WGRAD_CHUNK, k + 1)
    dd = dd.view(c, WGRAD_CHUNK, d.shape[1])
    acc = torch.zeros((c, k + 1, d.shape[1]), dtype=torch.float32,
                      device=a.device)
    for r in range(WGRAD_CHUNK):
        acc = acc + aa[:, r, :, None] * dd[:, r, None, :]
    s = torch.zeros_like(acc[0])
    for i in range(c):
        s = s + acc[i]
    s = s.to(torch.bfloat16).float()
    return s[:k], s[k]


def _scatter_keys(id_row: torch.Tensor, v: int):
    """The table row the reference's scatter-add writes for each batch
    row, and whether it writes one: an index negative after one wrap,
    or past the table, is dropped (its gather clamps it)."""
    key = id_row.to(torch.int64)
    key = torch.where(key < 0, key + v, key)
    return key, (key >= 0) & (key < v)


def _backward_rows_plain(leaves, saved, labels: torch.Tensor,
                         gloss: torch.Tensor):
    """K21's row pass: -> (dz3 [N], dz2 [N, 64], dz1 [N, 64] bf16, de
    [N, 32] float32, the rows' bf16 ``dx[:, :32]``)."""
    bf = torch.bfloat16
    embed, w1, _, w2, _, w3, _ = leaves
    _, h1, h2, logit = saved
    zero = torch.zeros((), dtype=bf, device=logit.device)
    dz3 = _dlogit_plain(logit, labels, gloss).to(bf)
    dz2 = torch.where(h2 > 0, (dz3.float()[:, None]
                               * w3[:, 0].to(bf).float()).to(bf), zero)
    dz1 = torch.where(h1 > 0, _ordered_dot(dz2, w2.to(bf).t()).to(bf),
                      zero)
    d = embed.shape[1]
    de = _ordered_dot(dz1, w1[:d].to(bf).t()).to(bf).float()
    return dz3, dz2, dz1, de


def train_backward_plain(leaves, saved, id_row: torch.Tensor,
                         labels: torch.Tensor, gloss: torch.Tensor,
                         n_shards: Optional[int] = None):
    """The gradient of :func:`train_forward_plain`'s loss times
    ``gloss`` in each trainable leaf (plain version of K21), -> (d_embed
    [V, 32], dW1, db1, dW2, db2, dW3, db3), float32.  ``dlogit`` is
    rounded to bf16 where it crosses the logit's cast; each layer's
    cotangent is a bf16 product (float32 sums in K21's order); the ReLU
    passes the gradient where its input was > 0 (0 at exactly 0); an
    embedding row's gradient is the float32 sum of its rows' bf16 ``dx[:,
    :32]`` (``index_add_``; K21 sums in the grouping of
    :func:`embed_grad_sorted_plain`).  An ``id_row`` negative after one
    wrap, or past the table, contributes nothing: the reference's gather
    clamps it, but the scatter-add that is its transpose drops it.
    ``n_shards`` (plain version of K21s): this function on each of S
    blocks, ``gloss`` the cotangent of each block's own loss, and each
    gradient the blocks' :func:`_shard_mean` (the reference's pmean)."""
    if n_shards is not None:
        parts = [train_backward_plain(leaves, tuple(t[b] for t in saved),
                                      id_row[b], labels[b], gloss)
                 for b in _shard_blocks(id_row.shape[0], n_shards,
                                        "anomaly_train_bwd")]
        return tuple(_shard_mean(list(g)) for g in zip(*parts))
    embed = leaves[0]
    x, h1, h2, _ = saved
    dz3, dz2, dz1, de = _backward_rows_plain(leaves, saved, labels, gloss)
    dw1, db1 = _wgrad_plain(x, dz1)
    dw2, db2 = _wgrad_plain(h1, dz2)
    dw3, db3 = _wgrad_plain(h2, dz3[:, None])
    key, keep = _scatter_keys(id_row, embed.shape[0])
    d_embed = torch.zeros_like(embed).index_add_(
        0, torch.where(keep, key, 0),
        torch.where(keep[:, None], de, torch.zeros_like(de)))
    return d_embed, dw1, db1, dw2, db2, dw3, db3


def _sums_in_order(values: torch.Tensor, group: torch.Tensor,
                   n_groups: int) -> torch.Tensor:
    """Each group's float32 sum of ``values`` [M, D] from 0, its members
    added in position order; ``group`` [M] is nondecreasing.  One step a
    member rank, so each group's adds stay in order."""
    pos = torch.arange(group.shape[0], device=group.device)
    starts = torch.ones_like(group, dtype=torch.bool)
    starts[1:] = group[1:] != group[:-1]
    rank = pos - torch.cummax(torch.where(starts, pos, 0), 0).values
    acc = torch.zeros((n_groups, values.shape[1]), dtype=torch.float32,
                      device=values.device)
    for t in range(int(rank.max().item()) + 1 if rank.numel() else 0):
        sel = rank == t
        acc[group[sel]] = acc[group[sel]] + values[sel]
    return acc


def embed_grad_sorted_plain(leaves, saved, id_row: torch.Tensor,
                            labels: torch.Tensor, gloss: torch.Tensor,
                            n_shards: Optional[int] = None) -> torch.Tensor:
    """d_embed [V, 32] summed as K21 sums it (the plain version of its
    scatter; :func:`train_backward_plain`'s ``index_add_`` is within
    float32 rounding of it).  A block's rows that the scatter keeps are
    sorted stably by their table row; that order is cut into pieces of
    EMBED_PIECE positions; within a piece each key's rows are summed in
    row order from 0; a key's piece sums are added in piece order, and
    the block's value is 0 plus that (0 for an absent key).  With
    ``n_shards`` each of S blocks gets its own value (``gloss`` the
    cotangent of its own loss) and d_embed is their
    :func:`_shard_mean`."""
    if n_shards is not None:
        return _shard_mean([
            embed_grad_sorted_plain(leaves, tuple(t[b] for t in saved),
                                    id_row[b], labels[b], gloss)
            for b in _shard_blocks(id_row.shape[0], n_shards,
                                   "anomaly_train_bwd")])
    embed = leaves[0]
    de = _backward_rows_plain(leaves, saved, labels, gloss)[3]
    key, keep = _scatter_keys(id_row, embed.shape[0])
    key, order = torch.sort(key[keep], stable=True)
    de = de[keep][order]
    out = torch.zeros_like(embed)
    if key.numel() == 0:
        return out
    pos = torch.arange(key.shape[0], device=key.device)
    cut = torch.ones_like(key, dtype=torch.bool)  # a (piece, key) starts
    cut[1:] = (key[1:] != key[:-1]) | (pos[1:] % EMBED_PIECE == 0)
    piece_of = torch.cumsum(cut, 0) - 1
    pieces = _sums_in_order(de, piece_of, int(piece_of[-1].item()) + 1)
    piece_key = key[cut]
    new_key = torch.ones_like(piece_key, dtype=torch.bool)
    new_key[1:] = piece_key[1:] != piece_key[:-1]
    key_of = torch.cumsum(new_key, 0) - 1
    sums = _sums_in_order(pieces, key_of, int(key_of[-1].item()) + 1)
    out[piece_key[new_key]] = out[piece_key[new_key]] + sums
    return out


class _BCELoss(torch.autograd.Function):
    """The reference's ``bce_loss`` as one autograd node over the seven
    trainable leaves: K20 forward and K21 backward for CUDA tensors, the
    plain versions for CPU tensors (any other device raises).  With
    ``n_shards`` (not None) the loss of the data-parallel step over that
    many batch blocks: K20s and K21s, or the plain versions block by
    block."""

    @staticmethod
    def forward(ctx, n_shards, id_row, feats, labels, *leaves):
        if _on_card(None, feats, "anomaly_train_fwd"):
            from ..kernels import launch_anomaly_train_fwd

            loss, saved = launch_anomaly_train_fwd(leaves, id_row, feats,
                                                   labels, n_shards)
        else:
            loss, saved = train_forward_plain(leaves, id_row, feats, labels,
                                              n_shards)
        ctx.saved = saved
        ctx.n_shards = n_shards
        ctx.save_for_backward(id_row, labels, *leaves)
        return loss

    @staticmethod
    def backward(ctx, gloss):
        id_row, labels, *leaves = ctx.saved_tensors
        gloss = gloss.reshape(1).float().contiguous()
        if gloss.is_cuda:
            from ..kernels import launch_anomaly_train_bwd

            grads = launch_anomaly_train_bwd(leaves, ctx.saved, id_row,
                                             labels, gloss, ctx.n_shards)
        else:
            grads = train_backward_plain(leaves, ctx.saved, id_row, labels,
                                         gloss, ctx.n_shards)
        ctx.saved = None
        return (None, None, None, None, *grads)


def bce_loss(model: AnomalyModel, id_row: torch.Tensor,
             feats: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean binary cross-entropy of the model's logits against
    ``labels`` ([] float32), differentiable in the leaves of a model
    built from :meth:`AnomalyModel.trainable`."""
    return _BCELoss.apply(None, id_row, feats, labels, *model.leaves())


def value_and_grad(model: AnomalyModel, id_row: torch.Tensor,
                   feats: torch.Tensor, labels: torch.Tensor,
                   n_shards: Optional[int] = None):
    """-> (loss [] float32, the gradients in ``TRAINABLE`` order), as
    ``jax.value_and_grad(bce_loss)`` gives the reference's (on the card:
    K20 then K21, no host sync).  ``n_shards``: the reference's mesh
    step's ``value_and_grad`` and ``pmean`` over that many blocks of the
    batch (K20s then K21s; the batch must split evenly)."""
    leaves = list(model.trainable().values())
    with torch.enable_grad():
        loss = _BCELoss.apply(n_shards, id_row, feats, labels, *leaves)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


def fit_novelty(model: AnomalyModel, feats: np.ndarray,
                ridge: float = 1e-3,
                quantile: float = 0.995) -> AnomalyModel:
    """Fit the benign novelty stats from a benign feature sample
    (labels never consulted): mean + ridge-regularized precision + the
    d2 threshold at the given benign quantile, in float64 on the host.
    Returns a new model on ``model``'s device."""
    x = np.asarray(feats, dtype=np.float64)
    mu = x.mean(axis=0)
    xc = x - mu
    cov = xc.T @ xc / max(len(x) - 1, 1)
    cov += ridge * np.eye(cov.shape[0])
    prec = np.linalg.inv(cov)
    d2 = np.einsum("nf,fg,ng->n", xc, prec, xc)
    thresh = float(np.quantile(d2, quantile))
    dev = model.device
    return model.replace(
        feat_mean=torch.tensor(mu, dtype=torch.float32, device=dev),
        feat_prec=torch.tensor(prec, dtype=torch.float32, device=dev),
        nov_thresh=torch.tensor(max(thresh, 1e-3), dtype=torch.float32,
                                device=dev))


def save_model(path: str, model: AnomalyModel) -> None:
    """Persist to the reference's .npz (its fields plus ``feat_dim``, so
    a checkpoint from before a FEAT_DIM bump fails loudly at load)."""
    from ..convert import anomaly_model_to_numpy

    np.savez_compressed(path, feat_dim=np.asarray(FEAT_DIM, dtype=np.int32),
                        **anomaly_model_to_numpy(model))


def load_model(path: str, device=None) -> AnomalyModel:
    """A checkpoint of either package onto ``device`` (None: the card)."""
    from ..convert import anomaly_model_from_numpy

    z = np.load(path)
    # checkpoints before feat_dim stamping: infer from w1's fan-in
    saved_dim = (int(z["feat_dim"]) if "feat_dim" in z.files
                 else int(z["w1"].shape[0] - z["embed"].shape[1]))
    if saved_dim != FEAT_DIM:
        raise ValueError(
            f"anomaly model {path!r} was trained with FEAT_DIM="
            f"{saved_dim}, but this build uses FEAT_DIM={FEAT_DIM}; "
            "retrain required")
    kw = {k: z[k] for k in _FIELDS if k in z.files}
    # pre-novelty checkpoints: supervised-only scoring
    kw.setdefault("feat_mean", np.zeros(FEAT_DIM, np.float32))
    kw.setdefault("feat_prec", np.zeros((FEAT_DIM, FEAT_DIM), np.float32))
    kw.setdefault("nov_thresh", np.asarray(NOV_DISABLED, np.float32))
    return anomaly_model_from_numpy(kw, device)
