"""Training: synthetic labeled traffic, the adam optimizer, the train
step and the training loop.

A port of the JAX package's ``ml/train.py``.  ``synth_labeled_traffic``
makes port scans, volumetric floods and exfiltration against the benign
steady-state mix of ``testing.fixtures.bench_traffic``, with hard
negatives.  :class:`Adam` is ``optax.adam``: dense over every trainable
leaf (every row of the embedding table decays its moments every step),
K22 ``adam_update`` (``csrc/mltrain.cu``) on the card, the plain version
on the CPU.  :func:`make_train_step` takes one step (the loss and its
gradients through K20/K21, then adam) and :func:`train` runs the
reference's loop: traffic, the datapath step (K1 + K4), the flow
features (K18), the train step, with the losses kept on the device
until one fetch at the end.

The step updates the model's trainable leaves and the optimizer's
moments in place (the reference's are immutable); :func:`train` works
on its own copy of the leaves, so the caller's model is left as it was.

With a mesh (a ``parallel.ShardMesh`` of S shards on the model's
device) the step is the reference's data-parallel one: the batch in S
contiguous blocks, each block's loss and gradients as the unsharded step
gives them, and their ``pmean`` (the mean in shard order) into one adam
step on the one copy of the replicated leaves.  On the card that is
K20s/K21s, one launch sequence for every shard.  The reference's own
mesh gradient is S times the mean (ROADMAP C4); the port's is the mean.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.packets import (
    COL_DIR,
    COL_DPORT,
    COL_DST_IP3,
    COL_FLAGS,
    COL_LEN,
    COL_PROTO,
    COL_SRC_IP3,
    TCP_ACK,
    TCP_SYN,
)
from .. import u32
from ..datapath.verdict import datapath_step
from .features import flow_features
from .model import TRAINABLE, AnomalyModel, _on_card, value_and_grad

ATTACK_KINDS = {0: "portscan", 1: "flood", 2: "exfil"}
# optax.adam's defaults (eps_root 0), which every caller of the
# reference takes; K22 (csrc/mltrain.cu) holds the same constants
B1, B2, EPS = 0.9, 0.999, 1e-8


def synth_labeled_traffic(world, n: int, rng: np.random.Generator,
                          attack_frac: float = 0.25,
                          kinds: Tuple[int, ...] = (0, 1, 2),
                          hard_negatives: bool = True,
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (hdr [n, N_COLS] uint32, labels [n] float32 1=attack).

    ``kinds`` restricts which attack kinds appear (held-out-kind
    evaluation trains on a subset and tests generalization on the
    rest).  ``hard_negatives`` injects BENIGN traffic that resembles
    attacks along single features — reconnect storms (SYN bursts to a
    real service) and bulk transfers (MTU-size pushes on a well-known
    port) — so separability must come from feature conjunctions, not
    one trivial column."""
    import ipaddress

    from ..testing.fixtures import bench_traffic

    hdr = bench_traffic(world, n, rng)
    labels = np.zeros(n, dtype=np.float32)
    n_attack = int(n * attack_frac)
    idx = rng.choice(n, n_attack, replace=False)
    kind_of = rng.choice(np.asarray(kinds, dtype=np.int64), n_attack)
    ips = np.array([int(ipaddress.IPv4Address(ip))
                    for ip in world.pod_ips], dtype=np.uint32)
    scanner = ips[0]
    victim = ips[1]
    for i, kind in zip(idx, kind_of):
        labels[i] = 1.0
        if kind == 0:  # port scan: tiny SYNs sweeping the port space
            hdr[i, COL_SRC_IP3] = rng.choice(ips[:8])  # several scanners
            hdr[i, COL_DPORT] = rng.integers(1, 65535)
            hdr[i, COL_FLAGS] = TCP_SYN
            hdr[i, COL_LEN] = rng.integers(40, 60)
            hdr[i, COL_PROTO] = 6
        elif kind == 1:  # flood: spoofed sources hammering one service
            hdr[i, COL_SRC_IP3] = rng.choice(ips)
            hdr[i, COL_DST_IP3] = victim
            hdr[i, COL_DPORT] = 80
            hdr[i, COL_FLAGS] = TCP_SYN
            hdr[i, COL_LEN] = rng.integers(40, 60)
            hdr[i, COL_PROTO] = 6
        else:  # exfiltration: huge egress pushes to odd ports
            hdr[i, COL_DIR] = 1
            hdr[i, COL_DPORT] = rng.integers(20000, 65000)
            hdr[i, COL_FLAGS] = TCP_ACK | 0x08  # PSH|ACK
            hdr[i, COL_LEN] = rng.integers(1400, 1500)
            hdr[i, COL_PROTO] = 6
    if hard_negatives:
        # benign rows that share single attack features
        benign = np.nonzero(labels == 0)[0]
        n_hard = len(benign) // 5
        hard = rng.choice(benign, n_hard, replace=False)
        half = n_hard // 2
        # reconnect storm: SYNs to a real service port, normal sizes
        storm = hard[:half]
        hdr[storm, COL_DPORT] = 5432
        hdr[storm, COL_FLAGS] = TCP_SYN
        hdr[storm, COL_LEN] = rng.integers(52, 80, len(storm))
        # bulk transfer: MTU-size PSH|ACK egress on a well-known port
        bulk = hard[half:]
        hdr[bulk, COL_DIR] = 1
        hdr[bulk, COL_DPORT] = 443
        hdr[bulk, COL_FLAGS] = TCP_ACK | 0x08
        hdr[bulk, COL_LEN] = rng.integers(1400, 1500, len(bulk))
    return hdr, labels


@dataclass
class AdamState:
    """optax's ``ScaleByAdamState`` over the trainable leaves: ``count``
    ([] int32, on the leaves' device, so no step reads it on the host)
    and the first and second moments by leaf name."""

    count: torch.Tensor
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def adam_update_plain(params: Sequence[torch.Tensor],
                      grads: Sequence[torch.Tensor],
                      mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                      count: torch.Tensor, lr: float) -> None:
    """One ``optax.adam(lr)`` step in place (plain version of K22),
    float32: ``mu = (1 - B1) g + B1 mu``, ``nu = (1 - B2) g^2 + B2 nu``;
    ``count`` incremented (saturating) before the bias corrections
    ``1 - B**count``; ``p += -lr * mu_hat / (sqrt(nu_hat) + EPS)``."""
    dev = count.device
    c = torch.where(count < torch.iinfo(torch.int32).max, count + 1, count)
    cf = c.float()
    bc1 = 1.0 - torch.pow(torch.tensor(B1, device=dev), cf)
    bc2 = 1.0 - torch.pow(torch.tensor(B2, device=dev), cf)
    for p, g, m, v in zip(params, grads, mu, nu):
        m_new = (1.0 - B1) * g + B1 * m
        v_new = (1.0 - B2) * (g * g) + B2 * v
        u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + EPS)
        p.add_(-lr * u)
        m.copy_(m_new)
        v.copy_(v_new)
    count.copy_(c)


class Adam:
    """``optax.adam(lr)``: :meth:`init` zeroes the moments, :meth:`apply_`
    takes one step over every trainable leaf, densely, in place (K22
    ``adam_update`` for CUDA tensors)."""

    def __init__(self, lr: float):
        self.lr = float(lr)

    def init(self, model: AnomalyModel) -> AdamState:
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=model.device),
            mu={k: torch.zeros_like(t)
                for k, t in zip(TRAINABLE, model.leaves())},
            nu={k: torch.zeros_like(t)
                for k, t in zip(TRAINABLE, model.leaves())})

    def apply_(self, model: AnomalyModel, grads: Sequence[torch.Tensor],
               state: AdamState) -> None:
        """One step: the model's leaves, ``state``'s moments and count
        are updated in place; the novelty fields are not touched (their
        gradients are zero, so the reference leaves them bit for bit)."""
        params = list(model.leaves())
        mu = [state.mu[k] for k in TRAINABLE]
        nu = [state.nu[k] for k in TRAINABLE]
        if _on_card(model, params[0], "adam_update"):
            from ..kernels import launch_adam_update

            launch_adam_update(params, list(grads), mu, nu, state.count,
                               self.lr)
        else:
            adam_update_plain(params, grads, mu, nu, state.count, self.lr)


def _check_mesh(mesh, device: torch.device) -> None:
    """Raise unless ``mesh`` (if any) is on ``device`` (an index-less
    ``cuda`` is the current card)."""
    if mesh is None:
        return
    want = mesh.device
    if want.type == "cuda" and want.index is None:
        want = torch.device("cuda", torch.cuda.current_device())
    if device != want:
        raise ValueError(f"the model is on {device}, the mesh on "
                         f"{mesh.device}")


def make_train_step(optimizer, mesh=None) -> Callable:
    """The train step ``step(model, opt_state, id_row, feats, labels) ->
    (model, opt_state, loss)``: the loss and its gradients (K20, K21),
    then one adam step (K22), in place.  ``optimizer`` is an
    :class:`Adam` or a learning rate.  ``mesh`` (a ``parallel.ShardMesh``
    on the model's device): the data-parallel step, the loss and the
    gradients the pmean over the mesh's batch blocks (K20s, K21s); the
    batch must split into ``mesh.n_shards`` blocks."""
    opt = optimizer if isinstance(optimizer, Adam) else Adam(optimizer)
    n_shards = None if mesh is None else mesh.n_shards

    def step(model: AnomalyModel, opt_state: AdamState,
             id_row: torch.Tensor, feats: torch.Tensor,
             labels: torch.Tensor):
        _check_mesh(mesh, model.device)
        loss, grads = value_and_grad(model, id_row, feats, labels, n_shards)
        opt.apply_(model, grads, opt_state)
        return model, opt_state, loss

    return step


def train(model: AnomalyModel, world, steps: int = 200, batch: int = 4096,
          lr: float = 3e-3, mesh=None, seed: int = 0, now: int = 1000,
          kinds: Tuple[int, ...] = (0, 1, 2)
          ) -> Tuple[AnomalyModel, List[float]]:
    """Train on synthetic labeled traffic run through the real datapath
    (``world.state`` updated in place; features include CT state, so the
    model sees what the device sees), on the device that holds the
    world's state; ``kinds`` restricts the attack kinds seen.  ``mesh``:
    the data-parallel step over its shards (the datapath step and the
    features still run on the whole batch, as the reference's do).
    Returns (a trained copy of ``model``, the per-step losses)."""
    dev = world.state.metrics.device
    if model.device != dev:
        raise ValueError(f"the model is on {model.device}, the world's "
                         f"state on {dev}")
    _check_mesh(mesh, model.device)
    model = model.replace(**{k: t.clone() for k, t in zip(
        TRAINABLE, model.leaves())})
    rng = np.random.default_rng(seed)
    optimizer = Adam(lr)
    opt_state = optimizer.init(model)
    step_fn = make_train_step(optimizer, mesh)
    state = world.state
    losses = []
    for s in range(steps):
        hdr, labels = synth_labeled_traffic(world, batch, rng, kinds=kinds)
        jhdr = u32.from_numpy(hdr, dev)
        out, state = datapath_step(state, jhdr, now + s)
        id_row, feats = flow_features(jhdr, out)
        model, opt_state, loss = step_fn(model, opt_state, id_row, feats,
                                         torch.from_numpy(labels).to(dev))
        losses.append(loss)  # stays on the device: no sync a step
    world.state = state
    if losses:
        losses = torch.stack(losses).cpu().tolist()  # the one fetch
    return model, losses


def auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """ROC AUC by rank statistic (no sklearn dependency)."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels)
    pos = scores[labels > 0.5]
    neg = scores[labels <= 0.5]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    order = np.argsort(np.concatenate([pos, neg]), kind="mergesort")
    ranks = np.empty(len(order), dtype=np.float64)
    ranks[order] = np.arange(1, len(order) + 1)
    # average ties
    allscores = np.concatenate([pos, neg])
    sorted_scores = allscores[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and \
                sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    r_pos = ranks[:len(pos)].sum()
    n_pos, n_neg = len(pos), len(neg)
    return float((r_pos - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
