"""End quality of the unsupervised (NCE) path against the JAX package's.

The parity tests (``tests/test_torch_unsupervised.py``) hold the NCE loss,
its gradient, the walks, the negatives, one step and the probe's solver to
the reference's one at a time. This test holds the end of training: both
packages train NCE from their own draws on one small SBM store, whose
communities the features alone do not give away (``p_in`` 0.8, feature
noise 2.0), and probe their frozen embeddings; the val accuracies agree
within ``MARGIN``.

``python tests/test_torch_nce_quality.py`` prints both packages' probe
accuracies over seeds 0-4: the spread of one package from seed to seed,
which the margin must cover, since the two packages draw different walks,
negatives and initial parameters from the same seed.
"""

import numpy as np

from tpu_sage.data.synthetic import sbm_problem as j_sbm_problem
from tpu_sage.train import unsupervised as jun
from tpu_sage.train.trainer import TrainConfig as JTrainConfig
from tpu_sage_torch.data.synthetic import sbm_problem
from tpu_sage_torch.train import unsupervised as un
from tpu_sage_torch.train.trainer import TrainConfig

MARGIN = 0.1  # val accuracy, port against reference
STORE = dict(n_nodes=600, n_classes=4, feat_dim=32, avg_degree=8, p_in=0.8, feat_noise=2.0,
             seed=11)
CONFIG = dict(batch_size=128, epochs=4, n_train_samples=(8, 4), n_val_samples=(8, 4),
              output_dims=(32, 32), lr_init=0.005)
UNSUP = dict(walk_length=2, n_negatives=5)


def _runs(seed):
    _, _, jhist = jun.fit_unsupervised(j_sbm_problem(**STORE), JTrainConfig(**CONFIG, seed=seed),
                                       jun.UnsupConfig(**UNSUP), log=lambda d: None)
    _, _, hist = un.fit_unsupervised(sbm_problem(**STORE), TrainConfig(**CONFIG, seed=seed),
                                     un.UnsupConfig(**UNSUP), log=lambda d: None, device="cpu")
    return jhist, hist


def test_nce_probe_accuracy_matches_the_reference():
    jhist, hist = _runs(0)
    for h in (jhist, hist):
        assert np.isfinite([r["unsup_loss"] for r in h]).all()
        assert h[-1]["unsup_loss"] < h[0]["unsup_loss"]
    want, got = jhist[-1]["probe_val_accuracy"], hist[-1]["probe_val_accuracy"]
    chance = 1.0 / STORE["n_classes"]
    assert want > 2 * chance and got > 2 * chance, (want, got)
    assert abs(got - want) <= MARGIN, (got, want)


if __name__ == "__main__":
    for seed in range(5):
        j, t = _runs(seed)
        print(f"seed {seed}: reference {j[-1]['probe_val_accuracy']:.3f}, "
              f"port {t[-1]['probe_val_accuracy']:.3f}", flush=True)
