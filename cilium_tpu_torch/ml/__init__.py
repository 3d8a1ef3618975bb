"""Learned flow classification: the anomaly side of the datapath.

A port of the JAX package's ``ml/``: flow features (K18
``flow_features``), the identity-embedding + MLP + benign-novelty
scorer (K19 ``anomaly_score``), its training (``bce_loss`` with K20
``anomaly_train_fwd`` and K21 ``anomaly_train_bwd``, ``optax.adam`` as
:class:`Adam` with K22 ``adam_update``, ``make_train_step``, ``train``),
the checkpoint format shared with the reference, the monitor-plane
``AnomalyScorer`` and the config #5 evaluation (``evaluate``: captures
through ``core/pcap.py``, ``train_on_capture``,
``evaluate_real_dataset``, ``train_and_evaluate``).  The score is
advisory and never changes a verdict.  ``make_train_step(mesh=...)``
and ``train(mesh=...)`` take a ``parallel.ShardMesh``: the data-parallel
step over its batch blocks, K20s/K21s on the card.
"""

from .evaluate import (  # noqa: F401
    evaluate_capture,
    evaluate_real_dataset,
    fit_novelty_from_world,
    load_labels,
    round_robin_holdouts,
    score_capture,
    score_scenario,
    synth_labeled_capture,
    train_and_evaluate,
    train_on_capture,
)
from .features import FEAT_DIM, flow_features  # noqa: F401
from .model import (  # noqa: F401
    NOV_DISABLED,
    TRAINABLE,
    AnomalyModel,
    bce_loss,
    fit_novelty,
    forward,
    init_params,
    label_embedding_init,
    load_model,
    novelty_d2,
    save_model,
    score_packets,
    value_and_grad,
)
from .scorer import AnomalyScorer  # noqa: F401
from .train import (  # noqa: F401
    ATTACK_KINDS,
    Adam,
    AdamState,
    auc,
    make_train_step,
    synth_labeled_traffic,
    train,
)
