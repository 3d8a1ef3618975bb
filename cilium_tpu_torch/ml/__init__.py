"""Learned flow classification: the anomaly side of the datapath.

A port of the JAX package's ``ml/``, its inference half: flow features
(K18 ``flow_features``), the identity-embedding + MLP + benign-novelty
scorer (K19 ``anomaly_score``), the checkpoint format shared with the
reference, the monitor-plane ``AnomalyScorer`` and the replay helpers.
The score is advisory and never changes a verdict.

Not ported yet: ``bce_loss``, ``make_train_step`` and ``train`` (the
training slice, with backward kernels: ROADMAP A11b and B16b).
"""

from .evaluate import (  # noqa: F401
    fit_novelty_from_world,
    score_capture,
    score_scenario,
)
from .features import FEAT_DIM, flow_features  # noqa: F401
from .model import (  # noqa: F401
    NOV_DISABLED,
    AnomalyModel,
    fit_novelty,
    forward,
    init_params,
    label_embedding_init,
    load_model,
    novelty_d2,
    save_model,
    score_packets,
)
from .scorer import AnomalyScorer  # noqa: F401
from .train import ATTACK_KINDS, auc, synth_labeled_traffic  # noqa: F401
